"""The work a step or a request needs, counted on the plain reference.

FLOPs are those of the convolutions and matrix products (`FlopCounterMode`)
of the reference network at batch 1, on the meta device: the same work
whatever kernel the program runs it with. The grouped epilogue's bytes
(K1a-K1d) count each input read once and each output written once, from
the groups' branch shapes and the launches a step makes. The
configuration's file stores these counts; `perfbench/tests` counts them
again.

`expected_launches` and `per_step` are copied from chip_smoke.py, over the
reference's `GroupedMixedOp` (the port's groups, one for one).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

F32 = 4


def _meta_model(ref, cfg):
    with torch.device("meta"):
        return ref.build(cfg)


def _meta_batch(cfg, bs: int = 1):
    hw = cfg["image_size"]
    return (torch.zeros(bs, hw, hw, cfg["in_channels"], device="meta"),
            torch.zeros(bs, hw, hw, dtype=torch.int64, device="meta"))


def _arch(ref, cfg):
    return {k: torch.zeros(s, device="meta", requires_grad=True)
            for k, s in ref.arch_shapes(cfg["meta_node_num"], cfg["depth"],
                                        cfg["sharing_normal"]).items()}


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def flops_per_image(ref, cfg) -> Dict[str, int]:
    """FLOPs an image: `forward` (eval mode) and `train` (a train-mode
    forward and the gradients of every parameter); for a supernet also
    `arch` (a forward on a val image and the gradients of the arch tables
    alone, as the arch step takes them)."""
    model = _meta_model(ref, cfg)
    image, label = _meta_batch(cfg)
    params = list(model.parameters())
    search = hasattr(ref, "arch_shapes")
    arch = _arch(ref, cfg) if search else None

    def loss():
        return ref.loss(ref.forward(model, cfg, arch, image, True), label)

    def forward():
        with torch.no_grad():
            ref.forward(model, cfg, arch, image, False)

    def train():
        torch.autograd.grad(loss(), params + (list(arch.values()) if search else []),
                            allow_unused=True)

    out = {"forward": _flops(forward), "train": _flops(train)}
    if search:
        out["arch"] = _flops(lambda: torch.autograd.grad(loss(), list(arch.values()),
                                                          allow_unused=True))
    return out


def group_shapes(ref, cfg) -> List[tuple]:
    """(branch tensors, [1, C, H, W]) of each grouped epilogue in the order
    a train-mode forward at batch 1 runs them."""
    model = _meta_model(ref, cfg)
    image, label = _meta_batch(cfg)
    arch = _arch(ref, cfg)
    groups = [m for m in model.modules() if type(m).__name__ == "GroupedMixedOp"]
    seen = []
    hooks = [g.register_forward_hook(
        lambda m, args, out: seen.append((sum(op != "none" for op in m.ops), tuple(out.shape))))
        for g in groups]
    try:
        with torch.no_grad():
            ref.forward(model, cfg, arch, image, True)
    finally:
        for h in hooks:
            h.remove()
    return seen


def k1_bytes(n: int, shape: tuple, bs: int) -> Dict[str, int]:
    """Bytes each of K1a-K1d moves for n f32 branch tensors of `shape` at
    batch bs: each input read once, each output written once
    (senas_torch/ops/grouped_epilogue.py's wrappers state what they take)."""
    _, c, h, w = shape
    t = bs * c * h * w * F32          # one branch tensor
    p = bs * c * F32                  # one [B, C] f32 array
    return {"branch_stats": n * t + 2 * n * p,
            "apply_mix": n * t + (n + 1) * p + t,
            "bwd_reduce": (n + 1) * t + (n + 1) * p,
            "bwd_dx": (n + 1) * t + 3 * n * p + n * t}


def expected_launches(groups: List[tuple]) -> Dict[str, Dict[str, int]]:
    """Launches per forward and per backward (chip_smoke.py): every group
    applies its mix and, in train mode, sweeps its stats; a backward runs
    bwd_reduce and bwd_dx for every group."""
    g = len(groups)
    return {"train": {"branch_stats": g, "apply_mix": g},
            "backward": {"bwd_reduce": g, "bwd_dx": g}}


def per_step(expect: Dict[str, Dict[str, int]], do_arch: bool) -> Dict[str, int]:
    """A search step: one train-mode forward and backward, two with do_arch."""
    k = 2 if do_arch else 1
    return {name: k * n for part in expect.values() for name, n in part.items()}


def k1_bytes_per_step(groups: List[tuple], bs: int, do_arch: bool = True) -> int:
    """The bytes K1a-K1d move in a search step at batch bs."""
    passes = per_step(expected_launches(groups), do_arch)["apply_mix"] // len(groups)
    return passes * sum(sum(k1_bytes(n, shape, bs).values()) for n, shape in groups)


def counts(ref, cfg) -> dict:
    """What a configuration's file stores under `counts`."""
    out = {"flops_per_image": flops_per_image(ref, cfg)}
    if hasattr(ref, "arch_shapes"):
        groups = group_shapes(ref, cfg)
        out["k1_groups_per_pass"] = len(groups)
        out["k1_bytes_per_step"] = k1_bytes_per_step(groups, cfg["batch_size"])
    return out
