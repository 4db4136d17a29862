"""Plain reference of `senas-fixed-promise12`: the fixed SENAS network
(`SenasModel`) of the searched genotype `senas`, in float32.

A frozen copy of senas_torch/models/senas_model.py's CPU path without
dropout or recomputation: two stems, a column of down cells, the
gamma-pruned grid of up cells with dense skips, and the head. Module and
parameter names are the port's. Loaded by file path
(`perfbench.lib.cells.load_reference`).
"""

from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.blocks import (SENAS_GENOTYPE, BasicBlock, ConvBn, OpType, ReLUConv,
                                        RectifyBlock, RectifyResample, ShrinkBlock, dice_ce,
                                        make_op, max_pool_3x3, relu)

GENOTYPES = {"senas": SENAS_GENOTYPE}
loss = dice_ce


class BuildCell(nn.Module):
    def __init__(self, genotype, double_down, c_in0, c_in1, c_out, cell_type):
        super().__init__()
        if cell_type == "down":
            self.preprocess0 = RectifyResample(c_in0, c_in1, "down")
            c_part = c_out // double_down
            op_names, idx = zip(*genotype.down)
            concat = genotype.down_concat
        else:
            self.preprocess0 = ShrinkBlock(c_in0, c_in1)
            c_part = c_out
            op_names, idx = zip(*genotype.up)
            concat = genotype.up_concat
        self._num_meta_node = len(op_names) // 2
        self._concat = list(concat)
        self._indices = list(idx)
        for i, (name, index) in enumerate(zip(op_names, idx)):
            if index < 2:
                op_type = (OpType.DOWN if cell_type == "down"
                           else OpType.UP if index > 0 else OpType.NORM)
                c_in = c_in1
            else:
                op_type, c_in = OpType.NORM, c_part
            setattr(self, f"op_{i}", make_op(name, c_in, c_part, op_type))
        self.post_process = RectifyBlock(len(self._concat) * c_part, c_out)

    def forward(self, in0, in1, train=False):
        states = [self.preprocess0(in0, train), relu(in1)]
        for i in range(self._num_meta_node):
            h1 = getattr(self, f"op_{2 * i}")(states[self._indices[2 * i]], train)
            h2 = getattr(self, f"op_{2 * i + 1}")(states[self._indices[2 * i + 1]], train)
            states.append(relu(h1 + h2))
        return self.post_process(torch.cat([states[i] for i in self._concat], dim=1), train)


class Head(nn.Module):
    def __init__(self, genotype, double_down, c_in0, c_in1, nclass):
        super().__init__()
        self.up_cell = BuildCell(genotype, double_down, c_in0, c_in1, c_in1, "up")
        self.segmentation_head = ReLUConv(c_in1, nclass, 3)

    def forward(self, s0, ot, train=False):
        return self.segmentation_head(self.up_cell(s0, ot, train))


def _pruned(gamma, depth, i, j):
    return i + j < depth - 1 and gamma[sum(range(i + j)) + j] == 0


class SenasModel(nn.Module):
    """forward(x NHWC, train) -> [NHWC logits]."""

    def __init__(self, nclass, in_channels, c, depth, genotype, double_down_channel=False):
        super().__init__()
        self.depth, self.gamma = depth, list(genotype.gamma)
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
                setattr(self, f"down_{i}", BuildCell(genotype, double_down, c_in0, c_in1,
                                                     c_curr, "down"))
                c_in0, c_in1 = c_in1, c_curr
        num_filters.append(down_f)
        for i in range(1, depth):
            up_f = []
            for j in range(depth - i):
                if _pruned(self.gamma, depth, i, j):
                    up_f.append([0, 0, 0])
                    continue
                head_curr = num_filters[0][j][2]
                head_in1 = num_filters[i - 1][j + 1][2]
                head_in0 = sum(num_filters[k][j][2] for k in range(i))
                up_f.append([head_in0, head_in1, head_curr])
                setattr(self, f"up_{i}_{j}", BuildCell(genotype, double_down, head_in0,
                                                       head_in1, head_curr, "up"))
            num_filters.append(up_f)
        self.head = Head(genotype, double_down, c, num_filters[-1][0][2], nclass)

    def forward(self, x, train=False):
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        s0 = self.stem0(x, train)
        ot = self.stem1_block(max_pool_3x3(relu(s0), 2), train)
        cell_out = [ot]
        for i in range(1, self.depth):
            in0 = s0 if len(cell_out) == 1 else cell_out[-2]
            cell_out.append(getattr(self, f"down_{i}")(in0, cell_out[-1], train))
        for j in reversed(range(self.depth - 1)):
            for i in range(1, self.depth - j):
                if _pruned(self.gamma, self.depth, i, j):
                    cell_out[i + j] = None
                    continue
                in0 = torch.cat([cell_out[k] for k in range(j, i + j)
                                 if cell_out[k] is not None], dim=1)
                cell_out[i + j] = getattr(self, f"up_{i}_{j}")(in0, cell_out[i + j], train)
        return [self.head(s0, cell_out[-1], train).permute(0, 2, 3, 1)]


def build(cfg: dict, device=None) -> SenasModel:
    """The network of `cfg` (a configuration file's dict), its parameters
    at their construction values (`blocks.init_rules` says how to draw
    them)."""
    if cfg["deep_supervision"] or cfg.get("dropout_prob", 0.0):
        raise NotImplementedError("the PROMISE12 configuration has no deep supervision "
                                  "and no dropout")
    model = SenasModel(cfg["nclass"], cfg["in_channels"], cfg["init_channels"], cfg["depth"],
                       GENOTYPES[cfg["geno_type"]], cfg["double_down_channel"])
    return model.to(device) if device is not None else model


def forward(model, cfg, arch, image, train):
    return model(image, train)
