"""Fused supernet cell: grouped MixedOps whose epilogue runs as two kernels.

Port of `senas_tpu/search/fused_cell.py`. All edges of a cell that read the
SAME input (the 2*M "input edges" read only preprocess0(in0) / relu(in1))
become ONE conv per candidate branch with E*c_part output channels; the
post-conv epilogue of every branch (BN, the SE block of `se_conv_3`, the
alpha-weighted mix, the closed-form `none` branch) runs through
`fused_group_epilogue`: on the card two hand-written CUDA kernels
(senas_torch/csrc/grouped_epilogue.cu), on the CPU their plain versions.
Inner edges (a different input per edge) are a ModuleList of naive
MixedOps, the slices of flax's stacked vmap axis.

The JAX package's unfused branch path computes the same math as the plain
epilogue, so only the epilogue path is ported. Its default-off MERGE_*
branch-merging paths are not ported. NCHW inside; a group returns
[B, E*P, H', W'] with channel e*P + p for edge e.

`dtype` follows the JAX package: a group computes in its input's dtype
(every kernel cast to it at use, the f32 masters kept) and its epilogue
writes that dtype; the cell's resampling and expand blocks cast to
`dtype`; the betas are cast to the activations' dtype before they scale
them. The alphas stay f32 and enter the epilogue's f32 coefficients.
"""

from __future__ import annotations

import torch
from torch import nn

from senas_torch.ops.grouped_epilogue import fused_group_epilogue
from senas_torch.parallel.collectives import global_count
from senas_torch.ops.primitives import (
    EPS,
    BatchNorm,
    OpType,
    RectifyBlock,
    RectifyResample,
    ShrinkBlock,
    add_kernel,
    avg_pool_3x3,
    conv2d,
    conv_transpose2d,
    kaiming_std,
    max_pool_3x3,
    relu,
    upsample2x,
    xavier_std,
)
from senas_torch.search.cell import MixedOp

_ADAPTERS = ("avg_pool", "max_pool", "up_sample", "identity")
_CONVS = {"conv_3": (3, 1), "se_conv_3": (3, 1),
          "dil_3_conv_5": (5, 3), "dil_2_conv_5": (5, 2)}
_DEPSEP = {"dep_sep_conv_3": 3, "dep_sep_conv_5": 5}


class _EpilogueBN(BatchNorm):
    """BatchNorm's exact variables (scale, bias; mean, var) for a branch
    whose BN runs inside the fused epilogue. `advance` (BatchNorm's) moves
    the running stats from the epilogue's biased batch stats with torch
    momentum-0.1 / unbiased-variance semantics (senas_tpu
    fused_cell.py:90-114), over the global batch's count under a mesh."""

    def forward(self, x, train: bool = False):
        raise RuntimeError("_EpilogueBN holds variables; the fused epilogue "
                           "computes its BN")


class GroupedMixedOp(nn.Module):
    """E same-op-type edges over ONE shared input -> [B, E*P, H', W'].

    alphas: [E, n_ops] mixing weights (already softmaxed). Variables carry
    the flax names (`{op}_kernel`, `{op}_bn`, `{op}_dkernel`, `{op}_dbn`,
    `{op}_pkernel`, `{op}_pbn`, `se_conv_3_se1/2`, `none_bn`). Each kernel
    is drawn with the PER-EDGE torch fan of the E separate ops it stands
    for (the JAX package's explicit fans, senas_tpu fused_cell.py:150-220),
    not the fan of its grouped layout."""

    def __init__(self, c_in: int, c_part: int, num_edges: int, op_type: OpType,
                 dtype=None):
        super().__init__()
        E, P, C = num_edges, c_part, c_in
        self.E, self.P, self.C = E, P, C
        self.op_type = op_type
        self.stride = 1 if op_type == OpType.NORM else 2
        self.transpose = op_type == OpType.UP
        self.ops = list(op_type.value["ops"])
        self.flax_layout = {}

        def kernel(name, shape, std, layout=None):
            add_kernel(self, name, shape, std)
            if layout:
                self.flax_layout[name] = layout

        for name in self.ops:
            if name == "none":
                self.none_bn = _EpilogueBN(E * P)
            elif name in _ADAPTERS:
                if C != P:   # per-edge Conv2d(C, P, 1): fan_out P
                    kernel(f"{name}_kernel", (E * P, C, 1, 1), kaiming_std(P))
                setattr(self, f"{name}_bn", _EpilogueBN(E * P))
            elif name in _CONVS:
                k = _CONVS[name][0]
                if self.transpose:   # per-edge ConvTranspose2d(C, P, k): fan C*k*k
                    kernel(f"{name}_kernel", (C, E * P, k, k), kaiming_std(C * k * k),
                           "hwio_t")
                else:                # per-edge Conv2d(C, P, k): fan_out P*k*k
                    kernel(f"{name}_kernel", (E * P, C, k, k), kaiming_std(P * k * k))
                setattr(self, f"{name}_bn", _EpilogueBN(E * P))
                if name == "se_conv_3":
                    mid = P // 16 if P > 16 else 1   # per-edge Linear(P, mid), (mid, P)
                    kernel("se_conv_3_se1", (E, P, mid), xavier_std(P, mid))
                    kernel("se_conv_3_se2", (E, mid, P), xavier_std(mid, P))
            elif name in _DEPSEP:
                k = _DEPSEP[name]
                # depthwise with channel multiplier E: output channel c*E+e;
                # per-edge (Transpose)Conv2d(C, C, k, groups=C): fan C*k*k
                if self.transpose:
                    kernel(f"{name}_dkernel", (C, E, k, k), kaiming_std(C * k * k), "dw_t")
                else:
                    kernel(f"{name}_dkernel", (C * E, 1, k, k), kaiming_std(C * k * k))
                setattr(self, f"{name}_dbn", BatchNorm(C * E, dtype=dtype))
                # per-edge pointwise Conv2d(C, P, 1): fan_out P
                kernel(f"{name}_pkernel", (E, C, P), kaiming_std(P))
                setattr(self, f"{name}_pbn", _EpilogueBN(E * P))
            else:
                raise NotImplementedError(name)

    def _adapter_pre(self, name, x):
        if name == "avg_pool":
            base = avg_pool_3x3(x, stride=self.stride)
        elif name == "max_pool":
            base = max_pool_3x3(x, stride=self.stride)
        elif name == "up_sample":
            base = upsample2x(x)
        else:
            base = x
        if self.C != self.P:
            return conv2d(base, getattr(self, f"{name}_kernel").to(x.dtype))
        return base.repeat(1, self.E, 1, 1)  # jnp.tile over channels

    def _conv_pre(self, name, x):
        k, dilation = _CONVS[name]
        kern = getattr(self, f"{name}_kernel").to(x.dtype)
        if self.transpose:
            return conv_transpose2d(x, kern, stride=2, dilation=dilation,
                                    output_padding=1)
        return conv2d(x, kern, stride=self.stride, dilation=dilation)

    def _depsep_pre(self, name, x, train):
        """depthwise (multiplier E) -> dbn -> relu -> grouped pointwise:
        everything up to the final pbn, which the epilogue absorbs."""
        dkern = getattr(self, f"{name}_dkernel").to(x.dtype)
        if self.transpose:
            out = conv_transpose2d(x, dkern, stride=2, output_padding=1,
                                   groups=self.C)
        else:
            out = conv2d(x, dkern, stride=self.stride, groups=self.C)
        out = relu(getattr(self, f"{name}_dbn")(out, train))
        b, _, oh, ow = out.shape
        out = out.reshape(b, self.C, self.E, oh, ow)
        # promoted as jnp.einsum promotes: the dbn output is in `dtype`, the
        # pointwise kernel in x's
        pkern = getattr(self, f"{name}_pkernel").to(x.dtype)
        dt = torch.promote_types(out.dtype, pkern.dtype)
        out = torch.einsum("bcehw,ecp->bephw", out.to(dt), pkern.to(dt))
        return out.reshape(b, self.E * self.P, oh, ow).contiguous()

    def forward(self, x, alphas, train: bool = False):
        E, P = self.E, self.P
        specs = []          # (op index, op name, its BN, pre-BN tensor)
        none_idx = None
        for o, name in enumerate(self.ops):
            if name == "none":
                none_idx = o
            elif name in _ADAPTERS:
                specs.append((o, name, getattr(self, f"{name}_bn"),
                              self._adapter_pre(name, x)))
            elif name in _CONVS:
                specs.append((o, name, getattr(self, f"{name}_bn"),
                              self._conv_pre(name, x)))
            else:
                specs.append((o, name, getattr(self, f"{name}_pbn"),
                              self._depsep_pre(name, x, train)))

        bns = [bn for _, _, bn, _ in specs]
        alphas_cols = [alphas[:, o].repeat_interleave(P) for o, *_ in specs]
        se_pos = next((i for i, (_, name, _, _) in enumerate(specs)
                       if name == "se_conv_3"), None)
        se_w1 = se_w2 = None
        if se_pos is not None:
            se_w1, se_w2 = self.se_conv_3_se1, self.se_conv_3_se2
        none_col = none_y = None
        if none_idx is not None:
            nbn = self.none_bn
            none_col = alphas[:, none_idx].repeat_interleave(P)
            if train:
                none_y = nbn.bias  # BN(zeros) in train mode: mu=0, var=0 -> bias
            else:
                none_y = nbn.bias - nbn.mean * torch.rsqrt(nbn.var + EPS) * nbn.scale

        branches = [t for *_, t in specs]
        mixed, (mu, var) = fused_group_epilogue(
            branches, [bn.scale for bn in bns],
            [bn.bias for bn in bns], alphas_cols,
            train=train, run_means=[bn.mean for bn in bns],
            run_vars=[bn.var for bn in bns],
            se_index=se_pos, se_w1=se_w1, se_w2=se_w2, E=E, P=P,
            none_alpha_col=none_col, none_bias=none_y, out_dtype=branches[0].dtype)
        if train:
            count = global_count(mixed)   # the global batch's, under a mesh
            for i, bn in enumerate(bns):
                bn.advance(mu[i], var[i], count)
            if none_idx is not None:
                zero = torch.zeros_like(mu[0])
                self.none_bn.advance(zero, zero, count)
        return mixed


class FusedSearchCell(nn.Module):
    """Drop-in for SearchCell with grouped edge evaluation; the same call
    signature and edge/alpha/beta indexing: edge e = offset(n)+j with
    offset(n) = sum_{i<n}(2+i); edges j<2 are DOWN (down cell) or NORM/UP
    (up cell, j=0/1); inner edges NORM."""

    k = 4

    def __init__(self, meta_node_num: int, double_down: int, c_in0: int,
                 c_in1: int, c_out: int, cell_type: str, dtype=None):
        super().__init__()
        M = self.meta_node_num = meta_node_num
        if cell_type == "down":
            self.preprocess0 = RectifyResample(c_in0, c_in1, "down", dtype=dtype)
            c_part = (c_out // double_down) // self.k
            t0, t1 = OpType.DOWN, OpType.DOWN
        else:
            self.preprocess0 = ShrinkBlock(c_in0, c_in1, dtype=dtype)
            c_part = c_out // self.k
            t0, t1 = OpType.NORM, OpType.UP
        self.c_part = c_part
        self.t0, self.t1 = t0, t1
        self.group0 = GroupedMixedOp(c_in1, c_part, M, t0, dtype=dtype)
        self.group1 = GroupedMixedOp(c_in1, c_part, M, t1, dtype=dtype)
        for n in range(1, M):
            setattr(self, f"inner_{n}", nn.ModuleList(
                [MixedOp(c_part, c_part, OpType.NORM, dtype=dtype) for _ in range(n)]))
        self.post_process = RectifyBlock(M * c_part, c_out, dtype=dtype)

    def forward(self, in0, in1, weights_norm, weights_chg, betas, train: bool = False):
        M, P = self.meta_node_num, self.c_part
        in0p = self.preprocess0(in0, train)
        in1p = relu(in1)

        offsets = [sum(2 + i for i in range(n)) for n in range(M)]
        a0 = (weights_norm if self.t0 == OpType.NORM else weights_chg)[offsets]
        a1 = (weights_norm if self.t1 == OpType.NORM else weights_chg)[
            [o + 1 for o in offsets]]
        m0 = self.group0(in0p, a0, train)   # [B, M*P, H', W']
        m1 = self.group1(in1p, a1, train)

        nodes = []
        for n in range(M):
            off = offsets[n]
            acc = (betas[off].to(m0.dtype) * m0[:, n * P:(n + 1) * P]
                   + betas[off + 1].to(m1.dtype) * m1[:, n * P:(n + 1) * P])
            if n >= 1:
                inner = getattr(self, f"inner_{n}")
                for j in range(n):
                    y = inner[j](nodes[j], weights_norm[off + 2 + j],
                                 weights_chg[off + 2 + j], train)
                    acc = acc + betas[off + 2 + j].to(y.dtype) * y
            nodes.append(relu(acc))
        return self.post_process(torch.cat(nodes[-M:], dim=1), train)
