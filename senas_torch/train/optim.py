"""Optimizers and learning-rate schedules.

Port of `senas_tpu/train/optim.py` for what the search path uses:

  * `build_optimizer(params, cfg)` for `sgd` (momentum, no Nesterov, no
    dampening) and `adam` (the `betas` tuple from the YAML, `eps`). The JAX
    package chains optax `add_decayed_weights` before the base transform
    (coupled L2: wd*param added to the gradient before momentum or moment
    estimation); `torch.optim.SGD`/`Adam` with `weight_decay` compute the
    same update, and tests/test_torch_optim.py holds them to optax.
  * `set_learning_rate` / `get_learning_rate` over the param groups, set by
    the host between epochs.
  * The epoch-indexed schedules, `warmup` and `build_scheduler`: plain
    Python, copied.

The other optimizers of the JAX package (adamax, adadelta, adagrad,
rmsprop, asgd, adabound) are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional

import torch

Schedule = Callable[[int], float]

_QUEUED = ("adamax", "adadelta", "adagrad", "rmsprop", "asgd", "adabound")


def build_optimizer(params: Iterable, opt_cfg: Optional[Dict[str, Any]]
                    ) -> torch.optim.Optimizer:
    """A torch optimizer over `params` from a reference-schema config dict
    ({"name", "lr", "weight_decay", "momentum" | "betas", "eps"})."""
    if opt_cfg is None:
        opt_cfg = {"name": "sgd", "lr": 0.01}
    cfg = dict(opt_cfg)
    name = cfg.pop("name", "sgd").lower()
    lr = float(cfg.pop("lr", 1e-3))
    wd = float(cfg.pop("weight_decay", 0.0))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg.pop("momentum", 0.0) or 0.0),
                               weight_decay=wd, nesterov=False)
    if name == "adam":
        betas = tuple(float(b) for b in cfg.pop("betas", (0.9, 0.999)))
        return torch.optim.Adam(params, lr=lr, betas=betas,
                                eps=float(cfg.pop("eps", 1e-8)), weight_decay=wd)
    if name in _QUEUED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md Queue 1, M7: "
            "the other six optimizers)")
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
