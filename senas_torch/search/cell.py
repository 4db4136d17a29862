"""Supernet search cell: MixedOp + shrink/expand cell DAG (naive layout).

Port of `senas_tpu/search/cell.py`. Each MixedOp is a softmax-weighted sum
over the candidate-op set; the cell shrinks its internal width to
c_part = c_out/4, runs a meta-node DAG with beta-scaled edges, then expands
back with a 3x3 RectifyBlock over the concatenated nodes. This per-edge
layout is what the grouped `FusedSearchCell` is held against in the tests;
the supernet runs the fused one. NCHW inside.
"""

from __future__ import annotations

import torch
from torch import nn

from senas_torch.ops.primitives import (
    OpType,
    RectifyBlock,
    RectifyResample,
    ShrinkBlock,
    make_op,
    relu,
)


class MixedOp(nn.Module):
    """Weighted mixture over the candidate-op set for one edge (the
    reference's search/cell.py:5-43; its dead partial-channel path is not
    reproduced). Branches are named `branch_{i}_{op}` as in flax."""

    def __init__(self, c_in: int, c_part: int, op_type: OpType, dtype=None):
        super().__init__()
        self.op_type = op_type
        self.branch_names = []
        for i, name in enumerate(op_type.value["ops"]):
            key = f"branch_{i}_{name}"
            setattr(self, key, make_op(name, c_in, c_part, op_type, dtype=dtype))
            self.branch_names.append(key)

    def forward(self, x, alpha_normal, alpha_up_dn, train: bool = False):
        """sum_i w[i] * branch_i(x). In bf16 the sum is taken in f32 and
        rounded once, as the JAX package's tensordot of the bf16-cast
        weights with the stacked branches is; in f32 (and f64) it is the
        plain sum."""
        w = alpha_normal if self.op_type == OpType.NORM else alpha_up_dn
        out = None
        for i, key in enumerate(self.branch_names):
            b = getattr(self, key)(x, train)
            acc = torch.promote_types(b.dtype, torch.float32)
            y = w[i].to(b.dtype).to(acc) * b.to(acc)
            out = y if out is None else out + y
        return out.to(b.dtype)


class SearchCell(nn.Module):
    """Shrink-and-expand supernet cell (the reference's search/cell.py:46-110)."""

    k = 4  # internal-channel shrink factor (reference Cell.k)

    def __init__(self, meta_node_num: int, double_down: int, c_in0: int,
                 c_in1: int, c_out: int, cell_type: str, dtype=None):
        super().__init__()
        self.meta_node_num = meta_node_num
        if cell_type == "down":
            self.preprocess0 = RectifyResample(c_in0, c_in1, "down", dtype=dtype)
            c_part = (c_out // double_down) // self.k
        else:
            self.preprocess0 = ShrinkBlock(c_in0, c_in1, dtype=dtype)
            c_part = c_out // self.k
        n_edges = 0
        for i in range(meta_node_num):
            for j in range(2 + i):
                if j < 2:
                    t = (OpType.DOWN if cell_type == "down"
                         else OpType.UP if j > 0 else OpType.NORM)
                    op = MixedOp(c_in1, c_part, t, dtype=dtype)
                else:
                    op = MixedOp(c_part, c_part, OpType.NORM, dtype=dtype)
                setattr(self, f"edge_{n_edges}", op)
                n_edges += 1
        self.post_process = RectifyBlock(meta_node_num * c_part, c_out, dtype=dtype)

    def forward(self, in0, in1, weights_norm, weights_chg, betas, train: bool = False):
        """weights_norm/weights_chg: [k_edges, n_ops]; betas: [k_edges]."""
        states = [self.preprocess0(in0, train), relu(in1)]
        offset = 0
        for _ in range(self.meta_node_num):
            node = None
            for j, h in enumerate(states):
                e = offset + j
                y = getattr(self, f"edge_{e}")(h, weights_norm[e], weights_chg[e], train)
                y = betas[e].to(y.dtype) * y
                node = y if node is None else node + y
            offset += len(states)
            states.append(relu(node))
        out = torch.cat(states[-self.meta_node_num:], dim=1)
        return self.post_process(out, train)
