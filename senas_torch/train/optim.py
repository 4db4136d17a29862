"""Optimizers and learning-rate schedules.

Port of `senas_tpu/train/optim.py`:

  * `build_optimizer(params, cfg)` for every name the JAX package builds:
    `sgd` (momentum, no Nesterov, no dampening), `adam` (the `betas` tuple
    from the YAML, `eps`), `adamax`, `adadelta`, `adagrad`, `rmsprop`,
    `asgd` and `adabound`. Weight decay is coupled L2 (wd*param added to
    the gradient before momentum or moment estimation), as optax's
    `add_decayed_weights` placed before the base transform does.
    `torch.optim.SGD`/`Adam` with `weight_decay` compute that for sgd, adam
    and asgd (plain SGD: the JAX package drops ASGD's averaging, which
    never feeds back into the trajectory). The other five follow optax
    0.2.6's transforms, which differ from `torch.optim`'s namesakes (eps
    inside the root, adagrad's 0.1 start, the lr scale before rmsprop's
    momentum), as `torch.optim.Optimizer` subclasses; adabound is the JAX
    package's own transform. tests/test_torch_optim.py holds each to optax.
  * `set_learning_rate` / `get_learning_rate` over the param groups, set by
    the host between epochs.
  * The epoch-indexed schedules, `warmup` and `build_scheduler`: plain
    Python, copied.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def _f32(x) -> float:
    """A scalar rounded to f32, as the JAX package's traced hyperparameters
    and step counts compute their coefficients."""
    return float(np.float32(x))


class _OptaxChain(torch.optim.Optimizer):
    """add_decayed_weights(wd) (where wd > 0) -> `_direction` -> p += u,
    per parameter, in the parameter's dtype. A subclass gives `_init` (its
    state of one parameter) and `_direction` (the update u added to the
    parameter, the lr's sign and scale included)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, **defaults):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, **defaults))

    def _init(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def _direction(self, g: torch.Tensor, state: dict, group: dict) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if wd <= 0 else p.grad + wd * p
                state = self.state[p]
                if not state:
                    state.update(self._init(p, group))
                p.add_(self._direction(g, state, group))
        return loss


class Adamax(_OptaxChain):
    """optax.adamax: mu = b1*mu + (1-b1)*g; nu = max(b2*nu, |g| + eps);
    u = -lr * mu / (1 - b1^t) / nu. The JAX package passes no eps (optax's
    1e-8), whatever the config says."""

    def __init__(self, params, lr, betas=(0.9, 0.999), weight_decay=0.0):
        super().__init__(params, lr, weight_decay, betas=tuple(betas), eps=1e-8)

    def _init(self, p, group):
        return dict(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))

    def _direction(self, g, state, group):
        b1, b2 = group["betas"]
        state["count"] += 1
        mu = state["mu"].mul_(b1).add_((1 - b1) * g)
        nu = torch.maximum(g.abs() + group["eps"], b2 * state["nu"])
        state["nu"] = nu
        bc1 = _f32(1 - np.float32(b1) ** np.float32(state["count"]))
        return (mu / bc1 / nu) * -group["lr"]


class Adadelta(_OptaxChain):
    """optax.adadelta: e_g = rho*e_g + (1-rho)*g^2; u = sqrt(e_x + eps) /
    sqrt(e_g + eps) * g; e_x = rho*e_x + (1-rho)*u^2; then -lr * u. eps is
    optax's 1e-6 (the JAX package passes none)."""

    def __init__(self, params, lr, rho=0.9, weight_decay=0.0):
        super().__init__(params, lr, weight_decay, rho=float(rho), eps=1e-6)

    def _init(self, p, group):
        return dict(e_g=torch.zeros_like(p), e_x=torch.zeros_like(p))

    def _direction(self, g, state, group):
        rho, eps = group["rho"], group["eps"]
        e_g = state["e_g"].mul_(rho).add_((1 - rho) * g * g)
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * g
        state["e_x"].mul_(rho).add_((1 - rho) * u * u)
        return u * -group["lr"]


class Adagrad(_OptaxChain):
    """optax.adagrad: the sum of squares starts at 0.1; u = g *
    rsqrt(sum + 1e-7) where sum > 0 (else 0); then -lr * u."""

    def __init__(self, params, lr, weight_decay=0.0):
        super().__init__(params, lr, weight_decay, initial_accumulator_value=0.1, eps=1e-7)

    def _init(self, p, group):
        return dict(sum_of_squares=torch.full_like(p, group["initial_accumulator_value"]))

    def _direction(self, g, state, group):
        s = state["sum_of_squares"].add_(g * g)
        scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
        return scale * g * -group["lr"]


class RMSprop(_OptaxChain):
    """optax.rmsprop (eps_in_sqrt, not centered): nu = decay*nu +
    (1-decay)*g^2; u = -lr * g * rsqrt(nu + eps); then trace(momentum):
    t = u + momentum * t, so the lr scales before the momentum, as in
    optax (torch.optim.RMSprop puts eps outside the root)."""

    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0, weight_decay=0.0):
        super().__init__(params, lr, weight_decay, alpha=float(alpha), eps=float(eps),
                         momentum=float(momentum))

    def _init(self, p, group):
        return dict(nu=torch.zeros_like(p), trace=torch.zeros_like(p))

    def _direction(self, g, state, group):
        a = group["alpha"]
        nu = state["nu"].mul_(a).add_((1 - a) * g * g)
        u = g * torch.rsqrt(nu + group["eps"]) * -group["lr"]
        return state["trace"].mul_(group["momentum"]).add_(u)


class AdaBound(_OptaxChain):
    """The JAX package's `scale_by_adabound` (Luo et al. 2019): Adam's
    moments, step_size = lr * sqrt(1 - b2^t) / (1 - b1^t), each element's
    step_size / (sqrt(nu) + eps) clipped to [lower, upper] with
        lower = final_lr * lr/base_lr * (1 - 1 / (gamma*t + 1)),
        upper = final_lr * lr/base_lr * (1 + 1 / (gamma*t)),
    u = -clip(...) * mu. `base_lr` is the lr at build time and stays put
    when `set_learning_rate` moves `lr`, so the band follows lr/base_lr."""

    def __init__(self, params, lr, betas=(0.9, 0.999), final_lr=0.1, gamma=1e-3,
                 weight_decay=0.0):
        super().__init__(params, lr, weight_decay, betas=tuple(betas), final_lr=float(final_lr),
                         gamma=float(gamma), base_lr=float(lr), eps=1e-8)

    def _init(self, p, group):
        return dict(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))

    def _direction(self, g, state, group):
        b1, b2 = group["betas"]
        state["count"] += 1
        mu = state["mu"].mul_(b1).add_((1 - b1) * g)
        nu = state["nu"].mul_(b2).add_((1 - b2) * g * g)
        f = np.float32
        c, lr = f(state["count"]), f(group["lr"])
        bc1, bc2 = f(1) - f(b1) ** c, f(1) - f(b2) ** c
        bound = f(group["final_lr"]) * (lr / f(group["base_lr"]))
        lower = _f32(bound * (f(1) - f(1) / (f(group["gamma"]) * c + f(1))))
        upper = _f32(bound * (f(1) + f(1) / (f(group["gamma"]) * c)))
        step_size = _f32(lr * np.sqrt(bc2) / bc1)
        step = torch.clamp(step_size / (torch.sqrt(nu) + group["eps"]), lower, upper)
        return -(step * mu)


def build_optimizer(params: Iterable, opt_cfg: Optional[Dict[str, Any]]
                    ) -> torch.optim.Optimizer:
    """A torch optimizer over `params` from a reference-schema config dict
    ({"name", "lr", "weight_decay", and per name "momentum", "betas", "eps",
    "rho", "alpha", "final_lr", "gamma"}), read as the JAX package's
    `build_optimizer` reads it."""
    if opt_cfg is None:
        opt_cfg = {"name": "sgd", "lr": 0.01}
    cfg = dict(opt_cfg)
    name = cfg.pop("name", "sgd").lower()
    lr = float(cfg.pop("lr", 1e-3))
    wd = float(cfg.pop("weight_decay", 0.0))
    betas = lambda: tuple(float(b) for b in cfg.pop("betas", (0.9, 0.999)))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg.pop("momentum", 0.0) or 0.0),
                               weight_decay=wd, nesterov=False)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas(),
                                eps=float(cfg.pop("eps", 1e-8)), weight_decay=wd)
    if name == "adamax":
        return Adamax(params, lr, betas=betas(), weight_decay=wd)
    if name == "adadelta":
        return Adadelta(params, lr, rho=float(cfg.pop("rho", 0.9)), weight_decay=wd)
    if name == "adagrad":
        return Adagrad(params, lr, weight_decay=wd)
    if name == "rmsprop":
        return RMSprop(params, lr, alpha=float(cfg.pop("alpha", 0.99)),
                       eps=float(cfg.get("eps", 1e-8)),
                       momentum=float(cfg.pop("momentum", 0.0)), weight_decay=wd)
    if name == "asgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=wd)
    if name == "adabound":
        return AdaBound(params, lr, betas=betas(), final_lr=float(cfg.pop("final_lr", 0.1)),
                        gamma=float(cfg.pop("gamma", 1e-3)), weight_decay=wd)
    raise NotImplementedError(f"Optimizer {name} not implemented")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """Reassign the learning rate of every param group (host-side, between
    epochs)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


# ---------------------------------------------------------------------------
# Epoch-indexed LR schedules (a copy of senas_tpu/train/optim.py:209-306)
# ---------------------------------------------------------------------------

def constant_lr(base_lr: float, **_) -> Schedule:
    return lambda epoch: base_lr


def cosine_lr(base_lr: float, T_max: int, eta_min: float = 0.0, **_) -> Schedule:
    def fn(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / T_max)) / 2
    return fn


def cosine_restarts_lr(base_lr: float, T_max: int, eta_min: float = 0.0,
                       T_mult: float = 1, **_) -> Schedule:
    def fn(epoch: int) -> float:
        restart_every = T_max
        restarted_at = 0
        while epoch - restarted_at >= restart_every:
            restarted_at = epoch
            restart_every *= T_mult
        step_n = epoch - restarted_at
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * step_n / restart_every)) / 2
    return fn


def poly_lr(base_lr: float, max_iter: int, decay_iter: int = 1, gamma: float = 0.9, **_) -> Schedule:
    def fn(epoch: int) -> float:
        # reference PolynomialLR semantics (schedulers.py:72-77): only decays
        # on epochs divisible by both decay_iter and max_iter
        if epoch % decay_iter or epoch % max_iter:
            return base_lr
        return base_lr * (1 - epoch / float(max_iter)) ** gamma
    return fn


def multi_step_lr(base_lr: float, milestones, gamma: float = 0.1, **_) -> Schedule:
    milestones = sorted(milestones)

    def fn(epoch: int) -> float:
        k = sum(1 for m in milestones if m <= epoch)
        return base_lr * gamma ** k
    return fn


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1, **_) -> Schedule:
    return lambda epoch: base_lr * gamma ** (epoch // step_size)


def exp_lr(base_lr: float, gamma: float, **_) -> Schedule:
    return lambda epoch: base_lr * gamma ** epoch


def warmup(schedule: Schedule, warmup_iters: int = 100, mode: str = "linear",
           gamma: float = 0.2) -> Schedule:
    def fn(epoch: int) -> float:
        cold = schedule(epoch)
        if epoch < warmup_iters:
            if mode == "linear":
                alpha = epoch / float(warmup_iters)
                factor = gamma * (1 - alpha) + alpha
            elif mode == "constant":
                factor = gamma
            else:
                raise KeyError(f"WarmUp type {mode} not implemented")
            return factor * cold
        return cold
    return fn


_SCHEDULES = {
    "constant_lr": constant_lr,
    "poly_lr": poly_lr,
    "multi_step": multi_step_lr,
    "step_lr": step_lr,
    "cos": cosine_lr,
    "cos_restarts": cosine_restarts_lr,
    "exp_lr": exp_lr,
}


def build_scheduler(base_lr: float, scheduler_dict: Optional[Dict[str, Any]],
                    last_epoch: int = -1) -> Schedule:
    """Scheduler factory mirroring the reference's utils/schedulers/__init__.py.
    The schedule is a pure fn(epoch) -> lr, so resuming only needs the right
    epoch; `last_epoch` is kept for the reference's signature."""
    if scheduler_dict is None:
        return constant_lr(base_lr)
    cfg = dict(scheduler_dict)
    s_type = cfg.pop("name")
    warm = {}
    if "warmup_iters" in cfg:
        warm["warmup_iters"] = cfg.pop("warmup_iters", 100)
        warm["mode"] = cfg.pop("warmup_mode", "linear")
        warm["gamma"] = cfg.pop("warmup_factor", 0.2)
    base = _SCHEDULES[s_type](base_lr, **cfg)
    if warm:
        return warmup(base, **warm)
    return base
