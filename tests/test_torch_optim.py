"""senas_torch.train.optim against senas_tpu.train.optim (optax) on the CPU.

The same parameters and the same gradient sequence go through the port's
torch optimizer and the JAX package's optax chain for several steps, with
the learning rate reassigned between steps as the runner does between
epochs. Tolerance rtol 1e-6 / atol 1e-7: both update in f32 with the same
formulas in another order. The six other optimizers (adamax, adadelta,
adagrad, rmsprop, asgd, adabound) are held to optax, not to torch.optim's
namesakes, which differ from it."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from senas_tpu.train import optim as jopt
from senas_torch.train import optim as topt

CONFIGS = {
    "sgd_search": {"name": "sgd", "lr": 5e-3, "momentum": 0.9, "weight_decay": 3e-4},
    "sgd_plain": {"name": "sgd", "lr": 1e-2},
    "adam_search": {"name": "adam", "lr": 1e-4, "betas": (0.5, 0.999), "weight_decay": 1e-3},
    "adam_default": {"name": "adam", "lr": 1e-3, "eps": 1e-6},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_updates_match_optax(name):
    cfg = CONFIGS[name]
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(5, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32),
              "dead": rng.randn(3).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * (0.0 if k == "dead" else 1.0)).astype(np.float32)
              for k, v in params.items()} for _ in range(6)]
    lrs = [cfg["lr"], cfg["lr"], 0.5 * cfg["lr"], 0.5 * cfg["lr"], 0.1 * cfg["lr"], 0.0]

    tx = jopt.build_optimizer(dict(cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = topt.build_optimizer(list(tp.values()), dict(cfg))
    for g, lr in zip(grads, lrs):
        jopt.set_learning_rate(jstate, lr)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.set_learning_rate(opt, lr)
        assert topt.get_learning_rate(opt) == pytest.approx(jopt.get_learning_rate(jstate))
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.allclose(tp["w"].detach().numpy(), params["w"])


def test_set_learning_rate_reaches_every_group():
    a, b = torch.zeros(2, requires_grad=True), torch.zeros(3, requires_grad=True)
    opt = topt.build_optimizer([{"params": [a]}, {"params": [b]}],
                               {"name": "sgd", "lr": 0.1, "momentum": 0.9})
    topt.set_learning_rate(opt, 0.025)
    assert [g["lr"] for g in opt.param_groups] == [0.025, 0.025]
    assert topt.get_learning_rate(opt) == 0.025


OTHERS = ("adamax", "adadelta", "adagrad", "rmsprop", "asgd", "adabound")
OTHER_CFG = {"adamax": {"lr": 2e-3, "betas": (0.8, 0.99)},
             "adadelta": {"lr": 1.0, "rho": 0.8},
             "adagrad": {"lr": 0.05},
             "rmsprop": {"lr": 1e-3, "alpha": 0.9, "momentum": 0.5},
             "asgd": {"lr": 0.02},
             "adabound": {"lr": 1e-3, "betas": (0.8, 0.99), "final_lr": 0.05, "gamma": 0.1}}


def _five_steps(cfg, seed=0, resume_after=None):
    """Five steps of both packages' optimizers from one numpy state and
    gradient sequence, the lr halved between steps 2 and 3. With
    `resume_after`, the port's optimizer is rebuilt from its state_dict after
    that many steps. Returns (port params, JAX params) as numpy dicts."""
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(5, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32),
              "dead": rng.randn(3).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * (0.0 if k == "dead" else 1.0)).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    lrs = [cfg["lr"]] * 2 + [0.5 * cfg["lr"]] * 3

    tx = jopt.build_optimizer(dict(cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = topt.build_optimizer(list(tp.values()), dict(cfg))
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        if i == resume_after:
            saved = opt.state_dict()
            opt = topt.build_optimizer(list(tp.values()), dict(cfg))
            opt.load_state_dict(saved)
        jopt.set_learning_rate(jstate, lr)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.set_learning_rate(opt, lr)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    return ({k: t.detach().numpy() for k, t in tp.items()},
            {k: np.asarray(v) for k, v in jp.items()}, params)


@pytest.mark.parametrize("wd", [0.0, 3e-2])
@pytest.mark.parametrize("name", OTHERS)
def test_other_optimizers_match_optax(name, wd):
    """Each of the six other names, with and without coupled weight decay,
    through five steps and an lr change: within 1e-6 relative of optax."""
    cfg = dict(OTHER_CFG[name], name=name, weight_decay=wd)
    got, want, start = _five_steps(cfg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.allclose(got["w"], start["w"])
    # a zero gradient moves a parameter only through the weight decay
    assert np.array_equal(got["dead"], start["dead"]) == (wd == 0)


@pytest.mark.parametrize("name", OTHERS)
def test_state_dict_round_trip(name):
    """An optimizer rebuilt from its state_dict after two steps takes the
    same next steps as the one that was not."""
    cfg = dict(OTHER_CFG[name], name=name, weight_decay=1e-2)
    plain, _, _ = _five_steps(cfg)
    resumed, _, _ = _five_steps(cfg, resume_after=2)
    for k in plain:
        np.testing.assert_array_equal(resumed[k], plain[k], err_msg=k)


def test_config_eps_reaches_rmsprop_not_adamax():
    """The JAX package's build_optimizer hands a config eps to rmsprop and ignores it for
    adamax (optax's 1e-8 there); the port reads the config the same way."""
    for name, moves in (("adamax", False), ("rmsprop", True)):
        base = dict(OTHER_CFG[name], name=name)
        a, want, _ = _five_steps(base)
        b, want_eps, _ = _five_steps(dict(base, eps=0.5))
        assert (not np.array_equal(a["w"], b["w"])) == moves, name
        np.testing.assert_allclose(b["w"], want_eps["w"], rtol=1e-6, atol=1e-7)


def test_adabound_band_follows_lr_over_base_lr():
    """AdaBound's base_lr is the lr at build time: halving the lr halves the
    band. With a band at [final_lr*r, final_lr*r] (gamma huge) the step is
    -final_lr * lr/base_lr * mu."""
    p = torch.zeros(3, requires_grad=True)
    opt = topt.build_optimizer([p], {"name": "adabound", "lr": 0.2, "final_lr": 0.1,
                                     "gamma": 1e12, "betas": (0.0, 0.999)})
    assert opt.param_groups[0]["base_lr"] == 0.2
    topt.set_learning_rate(opt, 0.1)
    assert opt.param_groups[0]["base_lr"] == 0.2
    p.grad = torch.tensor([1.0, -2.0, 4.0])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), -0.1 * 0.5 * np.array([1.0, -2.0, 4.0]),
                               rtol=1e-5)


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match="Optimizer lamb not implemented"):
        topt.build_optimizer([torch.zeros(1, requires_grad=True)], {"name": "lamb", "lr": 0.1})


SCHEDULES = [
    None,
    {"name": "cos", "T_max": 10},
    {"name": "cos", "T_max": 7, "eta_min": 1e-4},
    {"name": "cos_restarts", "T_max": 4, "T_mult": 2},
    {"name": "poly_lr", "max_iter": 5, "decay_iter": 1},
    {"name": "multi_step", "milestones": [3, 7], "gamma": 0.5},
    {"name": "step_lr", "step_size": 4},
    {"name": "exp_lr", "gamma": 0.9},
    {"name": "constant_lr"},
    {"name": "cos", "T_max": 10, "warmup_iters": 4},
    {"name": "step_lr", "step_size": 3, "warmup_iters": 5, "warmup_mode": "constant",
     "warmup_factor": 0.5},
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: "none" if s is None else
                         s["name"] + ("_warm" if s and "warmup_iters" in s else ""))
def test_schedules_match(sched):
    want = jopt.build_scheduler(0.01, None if sched is None else dict(sched))
    got = topt.build_scheduler(0.01, None if sched is None else dict(sched))
    assert [got(e) for e in range(20)] == [want(e) for e in range(20)]
