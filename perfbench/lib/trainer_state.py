"""What the check reads from senas_torch's training states
(`train/trainer.py`'s `FixedTrainState` and `SearchTrainState`): the first
gradients each optimizer took, and the change of every leaf. Program files
whose step keeps such a state bind these."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _named_optimizer_leaves(st) -> Dict[int, str]:
    names = {id(p): k for k, p in st.model.named_parameters()}
    for k, t in getattr(st, "arch", {}).items():
        names[id(t)] = f"arch.{k}"
    return names


def first_gradients(st, arch0: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The gradients each optimizer took in the first step, worked out from
    its state after that step: SGD's buffer is d = g + wd * p_before with
    p_before = p_after + lr * d; Adam's first moment is (1 - b1) * (g + wd *
    a0), a0 the initial table."""
    names = _named_optimizer_leaves(st)
    w_opt = getattr(st, "w_opt", None) or st.opt
    out = {}
    for group in w_opt.param_groups:
        lr, wd = group["lr"], group["weight_decay"]
        for p in group["params"]:
            d = w_opt.state[p]["momentum_buffer"]
            out[names[id(p)]] = d - wd * (p.detach() + lr * d)
    if arch0 is not None:
        group = st.a_opt.param_groups[0]
        b1, wd = group["betas"][0], group["weight_decay"]
        for p in group["params"]:
            k = names[id(p)].removeprefix("arch.")
            out[f"adam.{k}"] = st.a_opt.state[p]["exp_avg"] / (1 - b1) - wd * arch0[k]
    return {k: v.detach().clone() for k, v in out.items()}


def state_change(st, state0, arch0) -> Dict[str, torch.Tensor]:
    """Every parameter's, buffer's and arch table's change since `state0`
    and `arch0`."""
    after = st.model.state_dict()
    out = {k: (after[k] - state0[k]).detach().clone() for k in after}
    for k, t in getattr(st, "arch", {}).items():
        out[f"arch.{k}"] = (t.detach() - arch0[k]).clone()
    return out
