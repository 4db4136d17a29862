"""senas_torch.train.optim against senas_tpu.train.optim (optax) on the CPU.

The same parameters and the same gradient sequence go through the port's
torch optimizer and the JAX package's optax chain for several steps, with
the learning rate reassigned between steps as the runner does between
epochs. Tolerance rtol 1e-6 / atol 1e-7: both update in f32 with the same
formulas in another order."""

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


@pytest.mark.parametrize("name", ["adamax", "adadelta", "adagrad", "rmsprop", "asgd",
                                  "adabound"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_optimizer([torch.zeros(1, requires_grad=True)], {"name": name, "lr": 0.1})


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
