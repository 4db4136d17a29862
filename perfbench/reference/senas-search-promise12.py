"""Plain reference of `senas-search-promise12`: the SENAS supernet
(`SenasSearch`, grouped cells) with the unfused epilogue, its architecture
tables and their softmax, in float32.

A frozen copy of senas_torch/search/{supernet,fused_cell,cell}.py's CPU
path with `group_epilogue_reference` (senas_torch/ops/grouped_epilogue.py)
in place of the kernels K1a-K1d: per branch a two-pass batch norm, the SE
scale, then the alpha-weighted sum. Module and parameter names are the
port's. Loaded by file path (`perfbench.lib.cells.load_reference`).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from perfbench.reference.blocks import (EPS, BasicBlock, BatchNorm, ConvBn, OpType, ReLUConv,
                                        RectifyBlock, RectifyResample, ShrinkBlock, add_kernel,
                                        avg_pool_3x3, conv2d, conv_transpose2d, dice_ce,
                                        kaiming_std, make_op, max_pool_3x3, relu, upsample2x,
                                        xavier_std)

_ADAPTERS = ("avg_pool", "max_pool", "up_sample", "identity")
_CONVS = {"conv_3": (3, 1), "se_conv_3": (3, 1), "dil_3_conv_5": (5, 3),
          "dil_2_conv_5": (5, 2)}
_DEPSEP = {"dep_sep_conv_3": 3, "dep_sep_conv_5": 5}

loss = dice_ce


def arch_shapes(meta: int, depth: int, sharing: bool) -> Dict[str, tuple]:
    k = sum(2 + i for i in range(meta))
    shapes = {"alphas_dn": (k, len(OpType.DOWN.value)), "alphas_up": (k, len(OpType.UP.value)),
              "alphas_dn_nm": (k, len(OpType.NORM.value)),
              "alphas_up_nm": (k, len(OpType.NORM.value)),
              "betas_dn": (k,), "betas_up": (k,), "gamma": (sum(range(depth - 1)), 2)}
    if sharing:
        del shapes["alphas_up_nm"]
    return shapes


def _group_softmax(beta, meta: int, beta_mode: str):
    parts = []
    for i in range(meta):
        start = i if beta_mode == "reference" else sum(2 + j for j in range(i))
        parts.append(torch.softmax(beta[start:start + 2 + i], dim=0))
    return torch.cat(parts)


def normalize_arch(arch, meta: int, beta_mode: str = "reference"):
    dn_nm = torch.softmax(arch["alphas_dn_nm"], dim=-1)
    up_nm = torch.softmax(arch["alphas_up_nm"], dim=-1) if "alphas_up_nm" in arch else dn_nm
    return {"alphas_dn_nm": dn_nm, "alphas_up_nm": up_nm,
            "alphas_dn": torch.softmax(arch["alphas_dn"], dim=-1),
            "alphas_up": torch.softmax(arch["alphas_up"], dim=-1),
            "betas_dn": _group_softmax(arch["betas_dn"], meta, beta_mode),
            "betas_up": _group_softmax(arch["betas_up"], meta, beta_mode),
            "gamma": torch.softmax(arch["gamma"], dim=-1)}


class MixedOp(nn.Module):
    """sum_i w[i] * branch_i(x) over the op set of one inner edge."""

    def __init__(self, c_in, c_part, op_type):
        super().__init__()
        self.op_type = op_type
        self.branch_names = []
        for i, name in enumerate(op_type.value):
            key = f"branch_{i}_{name}"
            setattr(self, key, make_op(name, c_in, c_part, op_type))
            self.branch_names.append(key)

    def forward(self, x, alpha_normal, alpha_up_dn, train=False):
        w = alpha_normal if self.op_type == OpType.NORM else alpha_up_dn
        out = None
        for i, key in enumerate(self.branch_names):
            y = w[i] * getattr(self, key)(x, train)
            out = y if out is None else out + y
        return out


class GroupedMixedOp(nn.Module):
    """E same-type edges over one input: one conv per candidate branch with
    E*P output channels, then the unfused epilogue."""

    def __init__(self, c_in, c_part, num_edges, op_type):
        super().__init__()
        E, P, C = num_edges, c_part, c_in
        self.E, self.P, self.C = E, P, C
        self.stride = 1 if op_type == OpType.NORM else 2
        self.transpose = op_type == OpType.UP
        self.ops = list(op_type.value)
        for name in self.ops:
            if name == "none":
                self.none_bn = BatchNorm(E * P)
            elif name in _ADAPTERS:
                if C != P:
                    add_kernel(self, f"{name}_kernel", (E * P, C, 1, 1), kaiming_std(P))
                setattr(self, f"{name}_bn", BatchNorm(E * P))
            elif name in _CONVS:
                k = _CONVS[name][0]
                if self.transpose:
                    add_kernel(self, f"{name}_kernel", (C, E * P, k, k), kaiming_std(C * k * k))
                else:
                    add_kernel(self, f"{name}_kernel", (E * P, C, k, k), kaiming_std(P * k * k))
                setattr(self, f"{name}_bn", BatchNorm(E * P))
                if name == "se_conv_3":
                    mid = P // 16 if P > 16 else 1
                    add_kernel(self, "se_conv_3_se1", (E, P, mid), xavier_std(P, mid))
                    add_kernel(self, "se_conv_3_se2", (E, mid, P), xavier_std(mid, P))
            else:
                k = _DEPSEP[name]
                shape = (C, E, k, k) if self.transpose else (C * E, 1, k, k)
                add_kernel(self, f"{name}_dkernel", shape, kaiming_std(C * k * k))
                setattr(self, f"{name}_dbn", BatchNorm(C * E))
                add_kernel(self, f"{name}_pkernel", (E, C, P), kaiming_std(P))
                setattr(self, f"{name}_pbn", BatchNorm(E * P))

    def _branch(self, name, x, train):
        """The branch's tensor before its last batch norm, and that norm."""
        if name in _ADAPTERS:
            if name == "avg_pool":
                base = avg_pool_3x3(x, self.stride)
            elif name == "max_pool":
                base = max_pool_3x3(x, self.stride)
            elif name == "up_sample":
                base = upsample2x(x)
            else:
                base = x
            pre = (conv2d(base, getattr(self, f"{name}_kernel")) if self.C != self.P
                   else base.repeat(1, self.E, 1, 1))
            return pre, getattr(self, f"{name}_bn")
        if name in _CONVS:
            k, dil = _CONVS[name]
            w = getattr(self, f"{name}_kernel")
            pre = (conv_transpose2d(x, w, 2, dil, 1) if self.transpose
                   else conv2d(x, w, self.stride, dil))
            return pre, getattr(self, f"{name}_bn")
        dk = getattr(self, f"{name}_dkernel")
        out = (conv_transpose2d(x, dk, 2, 1, 1, groups=self.C) if self.transpose
               else conv2d(x, dk, self.stride, groups=self.C))
        out = relu(getattr(self, f"{name}_dbn")(out, train))
        b, _, oh, ow = out.shape
        out = torch.einsum("bcehw,ecp->bephw", out.reshape(b, self.C, self.E, oh, ow),
                           getattr(self, f"{name}_pkernel"))
        return out.reshape(b, self.E * self.P, oh, ow).contiguous(), getattr(self, f"{name}_pbn")

    def forward(self, x, alphas, train=False):
        E, P = self.E, self.P
        acc = None
        count = None
        for o, name in enumerate(self.ops):
            if name == "none":
                continue
            pre, bn = self._branch(name, x, train)
            b, c, h, w = pre.shape
            if train:
                mu = pre.mean(dim=(0, 2, 3))
                var = ((pre - mu[:, None, None]) ** 2).mean(dim=(0, 2, 3))
                count = b * h * w
                bn.advance(mu.detach(), var.detach(), count)
            else:
                mu, var = bn.mean, bn.var
            y = ((pre - mu[:, None, None]) * torch.rsqrt(var + EPS)[:, None, None]
                 * bn.scale[:, None, None] + bn.bias[:, None, None])
            if name == "se_conv_3":
                m = y.mean(dim=(2, 3)).reshape(b, E, P)
                hid = torch.relu(torch.einsum("bep,epm->bem", m, self.se_conv_3_se1))
                sig = torch.sigmoid(torch.einsum("bem,emp->bep", hid, self.se_conv_3_se2))
                y = (y.reshape(b, E, P, h, w) * sig[..., None, None]).reshape(b, c, h, w)
            term = alphas[:, o].repeat_interleave(P)[:, None, None] * y
            acc = term if acc is None else acc + term
        if "none" in self.ops:
            nbn, o = self.none_bn, self.ops.index("none")
            if train:
                none_y = nbn.bias
                zero = torch.zeros_like(nbn.mean)
                nbn.advance(zero, zero, count)
            else:
                none_y = nbn.bias - nbn.mean * torch.rsqrt(nbn.var + EPS) * nbn.scale
            acc = acc + (alphas[:, o].repeat_interleave(P) * none_y)[:, None, None]
        return acc


class FusedSearchCell(nn.Module):
    k = 4

    def __init__(self, meta, double_down, c_in0, c_in1, c_out, cell_type):
        super().__init__()
        self.meta_node_num = meta
        if cell_type == "down":
            self.preprocess0 = RectifyResample(c_in0, c_in1, "down")
            c_part = (c_out // double_down) // self.k
            t0 = t1 = OpType.DOWN
        else:
            self.preprocess0 = ShrinkBlock(c_in0, c_in1)
            c_part = c_out // self.k
            t0, t1 = OpType.NORM, OpType.UP
        self.c_part, self.t0, self.t1 = c_part, t0, t1
        self.group0 = GroupedMixedOp(c_in1, c_part, meta, t0)
        self.group1 = GroupedMixedOp(c_in1, c_part, meta, t1)
        for n in range(1, meta):
            setattr(self, f"inner_{n}", nn.ModuleList(
                [MixedOp(c_part, c_part, OpType.NORM) for _ in range(n)]))
        self.post_process = RectifyBlock(meta * c_part, c_out)

    def forward(self, in0, in1, w_norm, w_chg, betas, train=False):
        M, P = self.meta_node_num, self.c_part
        in0p = self.preprocess0(in0, train)
        in1p = relu(in1)
        offsets = [sum(2 + i for i in range(n)) for n in range(M)]
        a0 = (w_norm if self.t0 == OpType.NORM else w_chg)[offsets]
        a1 = (w_norm if self.t1 == OpType.NORM else w_chg)[[o + 1 for o in offsets]]
        m0 = self.group0(in0p, a0, train)
        m1 = self.group1(in1p, a1, train)
        nodes = []
        for n in range(M):
            off = offsets[n]
            acc = betas[off] * m0[:, n * P:(n + 1) * P] + betas[off + 1] * m1[:, n * P:(n + 1) * P]
            if n >= 1:
                inner = getattr(self, f"inner_{n}")
                for j in range(n):
                    y = inner[j](nodes[j], w_norm[off + 2 + j], w_chg[off + 2 + j], train)
                    acc = acc + betas[off + 2 + j] * y
            nodes.append(relu(acc))
        return self.post_process(torch.cat(nodes, dim=1), train)


class SearchHead(nn.Module):
    def __init__(self, meta, double_down, c_in0, c_in1, nclass):
        super().__init__()
        self.up_cell = FusedSearchCell(meta, double_down, c_in0, c_in1, c_in1, "up")
        self.segmentation_head = ReLUConv(c_in1, nclass, 3)

    def forward(self, s0, ot, w_up_nm, w_up, betas_up, train=False):
        return self.segmentation_head(self.up_cell(s0, ot, w_up_nm, w_up, betas_up, train))


class SenasSearch(nn.Module):
    """forward(x NHWC, normalised arch, train) -> [NHWC logits]."""

    def __init__(self, in_channels, c, nclass, depth, meta=3, double_down_channel=False):
        super().__init__()
        self.depth = depth
        double_down = 2 if double_down_channel else 1
        c_in0 = c_in1 = c_curr = c
        self.stem0 = ConvBn(in_channels, c_in0, kernel_size=7)
        self.stem1_block = BasicBlock(c_in0, c_in1)
        num_filters, down_f = [], []
        for i in range(depth):
            if i == 0:
                down_f.append([1, 1, int(c_in1)])
            else:
                c_curr = int(double_down * c_curr)
                down_f.append([c_in0, c_in1, c_curr])
                setattr(self, f"down_{i}", FusedSearchCell(meta, double_down, c_in0, c_in1,
                                                           c_curr, "down"))
                c_in0, c_in1 = c_in1, c_curr
        num_filters.append(down_f)
        for i in range(1, depth):
            up_f = []
            for j in range(depth - i):
                head_curr = num_filters[0][j][2]
                head_down = num_filters[i - 1][j + 1][2]
                head_in0 = sum(num_filters[k][j][2] for k in range(i))
                up_f.append([head_in0, head_down, head_curr])
                setattr(self, f"up_{i}_{j}", FusedSearchCell(meta, double_down, head_in0,
                                                             head_down, head_curr, "up"))
            num_filters.append(up_f)
        self.head = SearchHead(meta, double_down, c, num_filters[-1][0][2], nclass)

    def forward(self, x, aw, train=False):
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        s0 = self.stem0(x, train)
        ot = self.stem1_block(max_pool_3x3(relu(s0), 2), train)
        cell_out = [ot]
        for i in range(1, self.depth):
            in0 = s0 if len(cell_out) == 1 else cell_out[-2]
            cell_out.append(getattr(self, f"down_{i}")(in0, cell_out[-1], aw["alphas_dn_nm"],
                                                       aw["alphas_dn"], aw["betas_dn"], train))
        g = aw["gamma"]
        for j in reversed(range(self.depth - 1)):
            for i in range(1, self.depth - j):
                ides = list(range(j, i + j))
                gamma_ides = [sum(range(k + j)) + j for k in range(1, i)]
                in0 = torch.cat([cell_out[ides[0]]]
                                + [cell_out[ides[k]] * g[idx][0] + cell_out[ides[k + 1]] * g[idx][1]
                                   for k, idx in enumerate(gamma_ides)], dim=1)
                cell_out[i + j] = getattr(self, f"up_{i}_{j}")(
                    in0, cell_out[i + j], aw["alphas_up_nm"], aw["alphas_up"], aw["betas_up"],
                    train)
        return [self.head(s0, cell_out[-1], aw["alphas_up_nm"], aw["alphas_up"],
                          aw["betas_up"], train).permute(0, 2, 3, 1)]


def build(cfg: dict, device=None) -> SenasSearch:
    """The supernet of `cfg` (a configuration file's dict), its parameters
    at their construction values (`blocks.init_rules` says how to draw
    them)."""
    if cfg["deep_supervision"]:
        raise NotImplementedError("deep supervision: the PROMISE12 configurations have none")
    model = SenasSearch(cfg["in_channels"], cfg["init_channels"], cfg["nclass"], cfg["depth"],
                        cfg["meta_node_num"], cfg["double_down_channel"])
    return model.to(device) if device is not None else model


def forward(model, cfg, arch, image, train):
    return model(image, normalize_arch(arch, cfg["meta_node_num"], cfg["beta_mode"]), train)
