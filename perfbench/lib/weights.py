"""Weights and architecture tables drawn from the seed, on the device.

The benchmark makes them and hands the same values to the program and to
the reference. Every kernel is drawn from normal(0, std) by the rule its
module states (`perfbench.reference.blocks.init_rules`: the JAX package's
and the reference's kaiming and xavier rules), all kernels in one call of a
generator on the device; batch-norm scales and biases and the running
statistics keep their construction values (1, 0; mean 0, var 1). The arch
tables are 1e-3 * normal, in a second call.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.blocks import init_rules


def draw_state(ref_model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A full state dict (parameters and buffers) for `ref_model`'s layout."""
    rules = init_rules(ref_model)
    state = {k: v.detach().to(device, copy=True) for k, v in ref_model.state_dict().items()}
    names = [k for k in state if k in rules]
    total = sum(state[k].numel() for k in names)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    offset = 0
    for k in names:
        n = state[k].numel()
        state[k] = flat[offset:offset + n].view_as(state[k]) * rules[k]
        offset += n
    return state


def draw_arch(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """The architecture tables, 1e-3 * normal (NAS._init_alphas)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    sizes = {k: torch.Size(s).numel() for k, s in shapes.items()}
    flat = 1e-3 * torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, offset = {}, 0
    for k, s in shapes.items():
        out[k] = flat[offset:offset + sizes[k]].view(s).clone()
        offset += sizes[k]
    return out
