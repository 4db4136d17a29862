"""Fixed (discrete-genotype) SENAS model in PyTorch.

Port of `senas_tpu/models/senas_model.py` (the reference's
models/senas_model.py): stem0 (7x7 ConvBn) + stem1 (max pool + ResNet
BasicBlock), a `depth`-long encoder column of down cells, a triangular
UNet++-style decoder grid of up cells with gamma-pruned dense skips, and a
Head (up cell + 3x3 segmentation conv) shared by every supervised output.

Gamma-pruned up cells are never built, and the skip concatenation of a
later cell takes only the cells that were. Submodules carry the flax names
(`stem0`, `stem1_block`, `down_{i}`, `up_{i}_{j}`, `head.up_cell`,
`head.segmentation_head`, each cell's `op_{i}`), so `senas_torch.convert`
carries the weights leaf by leaf. `SenasModel.forward` keeps the JAX
package's NHWC boundary and runs NCHW inside. `remat` recomputes every
cell (the head's included) in the backward (`primitives.remat`); a
`dropout_prob` above 0 is not ported and raises. `dtype` is every
module's compute dtype, as in the JAX package (None: f32; with
`torch.bfloat16` the logits are bf16 and the weights and running stats
stay f32).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from senas_torch.core.device import resolve_device
from senas_torch.core.genotype import Genotype
from senas_torch.ops.primitives import (BasicBlock, ConvBn, OpType, RectifyBlock,
                                        RectifyResample, ReLUConv, ShrinkBlock,
                                        init_params_, make_op, max_pool_3x3, relu, remat)


class BuildCell(nn.Module):
    """Discrete cell compiled from a genotype (senas_model.py:4-64)."""

    def __init__(self, genotype: Genotype, double_down: int, c_in0: int, c_in1: int,
                 c_out: int, cell_type: str, dropout_prob: float = 0.0, dtype=None):
        super().__init__()
        if cell_type == "down":
            self.preprocess0 = RectifyResample(c_in0, c_in1, "down", dtype=dtype)
            c_part = c_out // double_down
            op_names, idx = zip(*genotype.down)
            concat = genotype.down_concat
        else:
            self.preprocess0 = ShrinkBlock(c_in0, c_in1, dtype=dtype)
            c_part = c_out
            op_names, idx = zip(*genotype.up)
            concat = genotype.up_concat
        self._num_meta_node = len(op_names) // 2
        self._concat = list(concat)
        self._indices = list(idx)

        for i, (name, index) in enumerate(zip(op_names, idx)):
            if index < 2:   # an op on one of the cell's two inputs
                if cell_type == "down":
                    op_type = OpType.DOWN
                elif index > 0:
                    op_type = OpType.UP
                else:
                    op_type = OpType.NORM
                c_in = c_in1
            else:
                op_type, c_in = OpType.NORM, c_part
            setattr(self, f"op_{i}", make_op(name, c_in, c_part, op_type, dp=dropout_prob,
                                             dtype=dtype))
        self.post_process = RectifyBlock(len(self._concat) * c_part, c_out, dtype=dtype)

    def forward(self, in0, in1, train: bool = False):
        states = [self.preprocess0(in0, train), relu(in1)]
        for i in range(self._num_meta_node):
            h1 = getattr(self, f"op_{2 * i}")(states[self._indices[2 * i]], train)
            h2 = getattr(self, f"op_{2 * i + 1}")(states[self._indices[2 * i + 1]], train)
            states.append(relu(h1 + h2))
        out = torch.cat([states[i] for i in self._concat], dim=1)
        return self.post_process(out, train)


class Head(nn.Module):
    """Final up cell + 3x3 segmentation conv (senas_model.py:67-75); with
    `remat` the up cell is recomputed in the backward, as every other
    cell."""

    def __init__(self, genotype: Genotype, double_down: int, c_in0: int, c_in1: int,
                 nclass: int, dtype=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.up_cell = BuildCell(genotype, double_down, c_in0, c_in1, c_in1, "up",
                                 dtype=dtype)
        self.segmentation_head = ReLUConv(c_in1, nclass, kernel_size=3, dtype=dtype)

    def forward(self, s0, ot, train: bool = False):
        return self.segmentation_head(remat(self.up_cell, s0, ot, train, enabled=self.remat),
                                      train)


def _pruned(gamma, depth: int, i: int, j: int) -> bool:
    """Up cell (i, j) is left out: gamma switches its skip off and it is not
    on the last diagonal (senas_model.py:123-127)."""
    return i + j < depth - 1 and gamma[sum(range(i + j)) + j] == 0


class SenasModel(nn.Module):
    """Fixed SENAS network (senas_model.py:78-179).

    forward(x, train): x [B,H,W,in_channels] -> list of [B,H,W,nclass]
    logits (one head per surviving decoder output with supervision, else
    one), in `dtype` (None: f32). Built on `device` (None means the card)
    with kernels drawn from `generator` (a fixed seed when None) by the JAX
    package's init rules."""

    def __init__(self, nclass: int, in_channels: int, c: int = 32, depth: int = 5,
                 dropout_prob: float = 0.0, supervision: bool = False,
                 genotype: Optional[Genotype] = None, double_down_channel: bool = False,
                 dtype=None, remat: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if depth < 2:
            raise ValueError(f"depth must be >= 2, got {depth}")
        if genotype is None:
            raise ValueError("SenasModel needs a genotype")
        dev = resolve_device(device)
        self.depth, self.supervision, self.remat = depth, supervision, remat
        self.gamma = list(genotype.gamma)
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
                setattr(self, f"down_{i}", BuildCell(genotype, double_down, c_in0, c_in1,
                                                     c_curr, "down", dropout_prob, dtype))
                c_in0, c_in1 = c_in1, c_curr
        num_filters.append(down_f)

        for i in range(1, depth):
            up_f = []
            for j in range(depth - i):
                if _pruned(self.gamma, depth, i, j):
                    up_f.append([0, 0, 0, "None"])
                    continue
                head_curr = num_filters[0][j][2]
                head_in1 = num_filters[i - 1][j + 1][2]
                head_in0 = sum(num_filters[k][j][2] for k in range(i))
                up_f.append([head_in0, head_in1, head_curr, "up"])
                setattr(self, f"up_{i}_{j}", BuildCell(genotype, double_down, head_in0,
                                                       head_in1, head_curr, "up",
                                                       dropout_prob, dtype))
            num_filters.append(up_f)

        self.head = Head(genotype, double_down, c, num_filters[-1][0][2], nclass, dtype, remat)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params_(self, generator)
        self.to(dev)

    def forward(self, x, train: bool = False, rng: Optional[torch.Generator] = None):
        # `rng` is the train step's dropout generator; no ported op of this
        # model draws from it (dropout_prob > 0 raises).
        # NHWC -> NCHW with canonical strides (a 1-channel permuted view
        # counts as contiguous with channels_last strides; see SenasSearch)
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        s0 = self.stem0(x, train)
        ot = self.stem1_block(max_pool_3x3(relu(s0), stride=2), train)
        cell_out = [ot]
        for i in range(1, self.depth):
            in0 = s0 if len(cell_out) == 1 else cell_out[-2]
            cell_out.append(remat(getattr(self, f"down_{i}"), in0, cell_out[-1], train,
                                  enabled=self.remat))

        for j in reversed(range(self.depth - 1)):
            for i in range(1, self.depth - j):
                if _pruned(self.gamma, self.depth, i, j):
                    cell_out[i + j] = None
                    continue
                in0 = torch.cat([cell_out[k] for k in range(j, i + j)
                                 if cell_out[k] is not None], dim=1)
                cell_out[i + j] = remat(getattr(self, f"up_{i}_{j}"), in0, cell_out[i + j],
                                        train, enabled=self.remat)

        heads = [o for o in cell_out if o is not None] if self.supervision else cell_out[-1:]
        return [self.head(s0, o, train).permute(0, 2, 3, 1) for o in heads]
