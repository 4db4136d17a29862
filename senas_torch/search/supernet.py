"""SENAS supernet: macro network + architecture parameters + discretization.

Port of `senas_tpu/search/supernet.py`. Architecture parameters (alpha,
beta, gamma) are not module parameters: they are a dict of tensors that the
caller keeps and passes, softmaxed by `normalize_arch`, to `forward`.
`derive_genotype` is host-side numpy, copied from the JAX package.

`SenasSearch.forward` keeps the JAX package's NHWC boundary (image
[B,H,W,C_in] -> list of logits [B,H,W,nclass]); inside it runs NCHW.
`remat` recomputes every cell (the head's included) in the backward
(`primitives.remat`); `fused=False` builds the per-edge `SearchCell`s the
JAX package's `fused=False` builds, the grouped `FusedSearchCell`s
otherwise. `beta_mode` picks the beta softmax groups: "reference"
(overlapping, as the reference computes them) or "grouped" (disjoint).

`dtype` is the compute dtype of every module (None: the image's, f32);
with `torch.bfloat16` the logits are bf16, and the weights, the BN running
stats and the arch tables stay f32. The decoder's gamma mix follows the
JAX package's promotion: gamma is cast to the image's dtype, so bf16
activations are mixed in f32 and rounded once by the next cell's cast.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from senas_torch.core.device import resolve_device
from senas_torch.core.genotype import DownOps, Genotype, GenoParser, NormOps, UpOps
from senas_torch.ops.primitives import (BasicBlock, ConvBn, ReLUConv,
                                        init_params_, max_pool_3x3, relu, remat)
from senas_torch.search.cell import SearchCell
from senas_torch.search.fused_cell import FusedSearchCell


def _num_edges(meta_node_num: int) -> int:
    return sum(2 + i for i in range(meta_node_num))


def arch_param_count(meta_node_num: int, depth: int) -> Dict[str, tuple]:
    k = _num_edges(meta_node_num)
    return {
        "alphas_dn": (k, len(DownOps)),
        "alphas_up": (k, len(UpOps)),
        "alphas_dn_nm": (k, len(NormOps)),
        "alphas_up_nm": (k, len(NormOps)),
        "betas_dn": (k,),
        "betas_up": (k,),
        "gamma": (sum(range(depth - 1)), 2),
    }


def init_arch_params(meta_node_num: int, depth: int, use_sharing: bool = True, *,
                     generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """1e-3 * randn init (NAS._init_alphas). With use_sharing=True the
    up-normal table is omitted and aliased to the down-normal table at
    normalization time (the reference shares the tensor)."""
    dev = resolve_device(device)
    shapes = arch_param_count(meta_node_num, depth)
    if use_sharing:
        shapes = {k: v for k, v in shapes.items() if k != "alphas_up_nm"}
    return {name: (1e-3 * torch.randn(shape, generator=generator)).to(dev)
            for name, shape in shapes.items()}


def beta_group_start(i: int, mode: str) -> int:
    """Start index of node i's beta softmax group.

    "reference" replicates the reference: its offset is the loop index, so
    the groups are [0:2], [1:4], [2:6], ... -- overlapping, and the last
    raw betas are never read. "grouped" gives the disjoint groups [0:2],
    [2:5], [5:9], ... Any other mode raises ValueError."""
    if mode == "reference":
        return i
    if mode == "grouped":
        return sum(2 + j for j in range(i))
    raise ValueError(f"unknown beta_mode {mode!r}")


def _group_softmax(beta: torch.Tensor, meta_node_num: int,
                   beta_mode: str = "reference") -> torch.Tensor:
    """Per-node-group softmax over edge betas (groups of size 2, 3, 4, ...)."""
    parts = []
    for i in range(meta_node_num):
        start = beta_group_start(i, beta_mode)
        parts.append(torch.softmax(beta[start:start + 2 + i], dim=0))
    return torch.cat(parts, dim=0)


def normalize_arch(arch: Dict[str, torch.Tensor], meta_node_num: int,
                   beta_mode: str = "reference") -> Dict[str, torch.Tensor]:
    """Softmax all architecture parameters (NAS.forward)."""
    alphas_dn_nm = torch.softmax(arch["alphas_dn_nm"], dim=-1)
    alphas_up_nm = (torch.softmax(arch["alphas_up_nm"], dim=-1)
                    if "alphas_up_nm" in arch else alphas_dn_nm)
    return {
        "alphas_dn_nm": alphas_dn_nm,
        "alphas_up_nm": alphas_up_nm,
        "alphas_dn": torch.softmax(arch["alphas_dn"], dim=-1),
        "alphas_up": torch.softmax(arch["alphas_up"], dim=-1),
        "betas_dn": _group_softmax(arch["betas_dn"], meta_node_num, beta_mode),
        "betas_up": _group_softmax(arch["betas_up"], meta_node_num, beta_mode),
        "gamma": torch.softmax(arch["gamma"], dim=-1),
    }


class SearchHead(nn.Module):
    """Up cell + segmentation conv; with `remat` the up cell is recomputed
    in the backward, as every other cell."""

    def __init__(self, meta_node_num: int, double_down: int, c_in0: int,
                 c_in1: int, nclass: int, dtype=None, fused: bool = True,
                 remat: bool = False):
        super().__init__()
        cell = FusedSearchCell if fused else SearchCell
        self.remat = remat
        self.up_cell = cell(meta_node_num, double_down, c_in0, c_in1, c_in1, "up",
                            dtype=dtype)
        self.segmentation_head = ReLUConv(c_in1, nclass, kernel_size=3, dtype=dtype)

    def forward(self, s0, ot, w_up_nm, w_up, betas_up, train: bool = False):
        out = remat(self.up_cell, s0, ot, w_up_nm, w_up, betas_up, train,
                    enabled=self.remat)
        return self.segmentation_head(out, train)


class SenasSearch(nn.Module):
    """Weight-sharing supernet macro-net (the reference's senas_search.py:16-112).

    forward(x, arch_weights, train): x NHWC; arch_weights is the output of
    `normalize_arch`. Returns a list of NHWC logits (one per head), in
    `dtype` (None: f32). Built on `device` (None means the card) with
    kernels drawn from `generator` (a fixed seed when None)."""

    def __init__(self, in_channels: int, c: int, nclass: int, depth: int,
                 meta_node_num: int = 3, double_down_channel: bool = False,
                 supervision: bool = False, dtype=None, fused: bool = True,
                 remat: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if depth < 2:
            raise ValueError(f"depth must be >= 2, got {depth}")
        dev = resolve_device(device)
        self.depth, self.meta_node_num = depth, meta_node_num
        self.supervision, self.remat = supervision, remat
        cell = FusedSearchCell if fused else SearchCell
        double_down = 2 if double_down_channel else 1
        c_in0 = c_in1 = c_curr = c

        self.stem0 = ConvBn(in_channels, c_in0, kernel_size=7, dtype=dtype)
        self.stem1_block = BasicBlock(c_in0, c_in1, stride=1, dtype=dtype)

        num_filters: List[List[List]] = []
        down_f = []
        for i in range(depth):
            if i == 0:
                down_f.append([1, 1, int(c_in1), "stem1"])
            else:
                c_curr = int(double_down * c_curr)
                down_f.append([c_in0, c_in1, c_curr, "down"])
                setattr(self, f"down_{i}", cell(
                    meta_node_num, double_down, c_in0, c_in1, c_curr, "down", dtype=dtype))
                c_in0, c_in1 = c_in1, c_curr
        num_filters.append(down_f)

        for i in range(1, depth):
            up_f = []
            for j in range(depth - i):
                head_curr = num_filters[0][j][2]
                head_down = num_filters[i - 1][j + 1][2]
                head_in0 = sum(num_filters[k][j][2] for k in range(i))
                up_f.append([head_in0, head_down, head_curr, "up"])
                setattr(self, f"up_{i}_{j}", cell(
                    meta_node_num, double_down, head_in0, head_down, head_curr, "up",
                    dtype=dtype))
            num_filters.append(up_f)

        self.head = SearchHead(meta_node_num, double_down, c, num_filters[-1][0][2], nclass,
                               dtype=dtype, fused=fused, remat=remat)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params_(self, generator)
        self.to(dev)

    def forward(self, x, aw: Dict[str, torch.Tensor], train: bool = False):
        a_dn_nm, a_up_nm = aw["alphas_dn_nm"], aw["alphas_up_nm"]
        a_dn, a_up = aw["alphas_dn"], aw["alphas_up"]
        b_dn, b_up, gamma = aw["betas_dn"], aw["betas_up"], aw["gamma"]
        # NHWC -> NCHW with canonical strides. `.contiguous()` is not enough:
        # with C_in=1 the permuted view already counts as contiguous while
        # its strides read as channels_last, and the convolutions would then
        # carry channels_last through the whole network.
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)

        s0 = self.stem0(x, train)
        ot = self.stem1_block(max_pool_3x3(relu(s0), stride=2), train)
        cell_out = [ot]
        for i in range(1, self.depth):
            in0 = s0 if len(cell_out) == 1 else cell_out[-2]
            cell_out.append(remat(getattr(self, f"down_{i}"), in0, cell_out[-1], a_dn_nm,
                                  a_dn, b_dn, train, enabled=self.remat))

        # decoder grid sweep with gamma-mixed dense skips, in the dtype that
        # jnp's promotion of the activations by gamma.astype(image dtype)
        # gives (senas_tpu/search/supernet.py:231-239); torch.cat promotes
        # as jnp.concatenate does
        mix, g = torch.promote_types(ot.dtype, x.dtype), gamma.to(x.dtype)
        for j in reversed(range(self.depth - 1)):
            for i in range(1, self.depth - j):
                ides = list(range(j, i + j))
                gamma_ides = [sum(range(k + j)) + j for k in range(1, i)]
                in0 = torch.cat(
                    [cell_out[ides[0]]]
                    + [cell_out[ides[k]].to(mix) * g[idx][0]
                       + cell_out[ides[k + 1]].to(mix) * g[idx][1]
                       for k, idx in enumerate(gamma_ides)],
                    dim=1)
                cell_out[i + j] = remat(getattr(self, f"up_{i}_{j}"), in0, cell_out[i + j],
                                        a_up_nm, a_up, b_up, train, enabled=self.remat)

        heads = cell_out if self.supervision else cell_out[-1:]
        return [self.head(s0, ot, a_up_nm, a_up, b_up, train).permute(0, 2, 3, 1)
                for ot in heads]


# ---------------------------------------------------------------------------
# Discretization (NAS.genotype), host-side numpy
# ---------------------------------------------------------------------------

def _np_softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def derive_genotype(arch: Dict[str, Any], meta_node_num: int, depth: int,
                    beta_mode: str = "reference") -> Genotype:
    """Discretize continuous arch params into a Genotype (host-side numpy)."""
    arch = {k: _to_numpy(v) for k, v in arch.items()}
    alphas_dn_nm = _np_softmax(arch["alphas_dn_nm"])
    alphas_up_nm = (
        _np_softmax(arch["alphas_up_nm"]) if "alphas_up_nm" in arch else alphas_dn_nm.copy()
    )
    alphas_dn = _np_softmax(arch["alphas_dn"])
    alphas_up = _np_softmax(arch["alphas_up"])

    betas_dn, betas_up = [], []
    for i in range(meta_node_num):   # the groups of _group_softmax
        start = beta_group_start(i, beta_mode)
        betas_dn.append(_np_softmax(arch["betas_dn"][start:start + 2 + i], axis=0))
        betas_up.append(_np_softmax(arch["betas_up"][start:start + 2 + i], axis=0))
    betas_dn = np.concatenate(betas_dn)
    betas_up = np.concatenate(betas_up)

    alphas_dn_nm = alphas_dn_nm * betas_dn[:, None]
    alphas_dn = alphas_dn * betas_dn[:, None]
    alphas_up_nm = alphas_up_nm * betas_up[:, None]
    alphas_up = alphas_up * betas_up[:, None]

    parser = GenoParser(meta_node_num)
    gene_down = parser.parse(alphas_dn_nm, alphas_dn, cell_type="down")
    gene_up = parser.parse(alphas_up_nm, alphas_up, cell_type="up")
    concat = range(2, meta_node_num + 2)

    gamma = _np_softmax(arch["gamma"])
    # zero the len//2 weakest gamma[:,1] entries, then argmax each row
    order = np.argsort(gamma[:, 1], kind="stable")
    drop = set(order[: len(gamma) // 2].tolist())
    gamma_bits = gamma.argmax(1).tolist()
    gamma_bits = [g if i not in drop else 0 for i, g in enumerate(gamma_bits)]
    # path-contiguity fix: within each row of the triangular grid, once a 1
    # appears every later entry becomes 1
    rows = [gamma_bits[sum(range(i)): sum(range(i)) + i] for i in range(1, depth - 1)]
    gamma_path: List[int] = []
    for g in rows:
        if 1 in g:
            first = g.index(1)
            g = g[:first] + [1] * (len(g) - first)
        gamma_path.extend(g)

    return Genotype(down=gene_down, down_concat=concat,
                    up=gene_up, up_concat=concat, gamma=gamma_path)
