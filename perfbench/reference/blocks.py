"""Plain PyTorch building blocks of the SENAS networks, in float32.

The yardstick the benchmark holds `senas_torch` to. It is a frozen copy of
the port's CPU path (senas_torch/ops/primitives.py, search/cell.py,
search/fused_cell.py, search/supernet.py, models/senas_model.py,
train/loss.py), cut to what the PROMISE12 configurations run: float32 only,
one device, no dropout, no recomputation. The grouped epilogue of a
supernet group is the unfused two-pass form (per-branch batch norm, the SE
scale, the alpha mix) in place of the port's kernels K1a-K1d. Modules and
parameters carry the port's names and layouts, so one state dict loads
into either.

It imports torch and numpy only: nothing of `senas_torch`, `senas_tpu` or
JAX.
"""

from __future__ import annotations

import enum
import math
from collections import namedtuple
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5

Genotype = namedtuple("Genotype", ["down", "down_concat", "up", "up_concat", "gamma"])

# the candidate-op vocabularies; alpha columns index into them
DownOps = ["avg_pool", "se_conv_3", "dil_3_conv_5", "dil_2_conv_5", "dep_sep_conv_3",
           "dep_sep_conv_5"]
UpOps = ["up_sample", "se_conv_3", "dil_3_conv_5", "dil_2_conv_5", "dep_sep_conv_3",
         "dep_sep_conv_5"]
NormOps = ["identity", "none", "dil_3_conv_5", "dil_2_conv_5", "dep_sep_conv_3",
           "dep_sep_conv_5"]

# the searched genotype `senas` (senas_node_4 of the reference's models/geno_searched.py)
SENAS_GENOTYPE = Genotype(
    down=[("se_conv_3", 1), ("avg_pool", 0), ("dil_3_conv_5", 2), ("dep_sep_conv_5", 1),
          ("dil_3_conv_5", 2), ("avg_pool", 0), ("avg_pool", 1), ("dil_3_conv_5", 3)],
    down_concat=range(2, 6),
    up=[("up_sample", 1), ("dil_3_conv_5", 0), ("dil_3_conv_5", 0), ("dil_2_conv_5", 2),
        ("dil_3_conv_5", 1), ("dil_2_conv_5", 2), ("dep_sep_conv_3", 0), ("dil_2_conv_5", 4)],
    up_concat=range(2, 6),
    gamma=[0, 0, 0, 1, 1, 1],
)


class OpType(enum.Enum):
    UP = UpOps
    DOWN = DownOps
    NORM = NormOps


# ---------------------------------------------------------------------------
# Parameters and their init rules
# ---------------------------------------------------------------------------

def kaiming_std(fan: int) -> float:
    return math.sqrt(2.0 / fan)


def xavier_std(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0 / (fan_in + fan_out))


def add_kernel(module: nn.Module, name: str, shape, std: float) -> nn.Parameter:
    """Parameter `name` of `shape`, drawn from normal(0, std) (`init_rules`)."""
    p = nn.Parameter(torch.zeros(shape))
    setattr(module, name, p)
    module.__dict__.setdefault("init_std", {})[name] = std
    return p


def add_conv_kernel(module: nn.Module, name: str, shape) -> nn.Parameter:
    """A kernel [O, I/g, k, k] (or [I, O/g, k, k] transposed), kaiming
    normal with the fan shape[0]*k*k."""
    return add_kernel(module, name, shape, kaiming_std(shape[0] * shape[2] * shape[3]))


def init_rules(model: nn.Module) -> Dict[str, float]:
    """{parameter name: std} of every parameter drawn from normal(0, std);
    the others (batch-norm scales and biases) keep their values, 1 and 0."""
    rules = {}
    for prefix, m in model.named_modules():
        for name, std in m.__dict__.get("init_std", {}).items():
            rules[f"{prefix}.{name}" if prefix else name] = std
    return rules


# ---------------------------------------------------------------------------
# Functional primitives (NCHW)
# ---------------------------------------------------------------------------

def relu(x):
    return F.relu(x)


def conv2d(x, w, stride: int = 1, dilation: int = 1, groups: int = 1):
    k = w.shape[-1]
    p = (k // 2) * dilation if k > 1 else 0
    return F.conv2d(x, w, stride=stride, padding=p, dilation=dilation, groups=groups)


def conv_transpose2d(x, w, stride: int = 2, dilation: int = 1, output_padding: int = 1,
                     groups: int = 1, padding=None):
    p = (w.shape[-1] // 2) * dilation if padding is None else padding
    return F.conv_transpose2d(x, w, stride=stride, padding=p, output_padding=output_padding,
                              groups=groups, dilation=dilation)


def avg_pool_3x3(x, stride: int = 1):
    return F.avg_pool2d(x, 3, stride=stride, padding=1, count_include_pad=False)


def max_pool_3x3(x, stride: int = 2):
    return F.max_pool2d(x, 3, stride=stride, padding=1)


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class BatchNorm(nn.Module):
    """nn.BatchNorm2d semantics with the variables scale, bias (parameters)
    and mean, var (buffers): train mode normalises by the biased batch
    variance and moves the running stats with momentum 0.1 and the
    unbiased variance."""

    def __init__(self, c: int, momentum: float = 0.1):
        super().__init__()
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool = False):
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=train,
                            momentum=self.momentum, eps=EPS)

    @torch.no_grad()
    def advance(self, mu, var, count: int):
        m = self.momentum
        self.mean.mul_(1 - m).add_(m * mu)
        self.var.mul_(1 - m).add_(m * var * (count / max(count - 1, 1)))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class _ConvWeight(nn.Module):
    def __init__(self, c_in, c_out, kernel_size=3, stride=1, dilation=1, transpose=False,
                 output_padding=0, groups=1):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.transpose, self.output_padding = transpose, output_padding
        k = kernel_size
        shape = (c_in, c_out // groups, k, k) if transpose else (c_out, c_in // groups, k, k)
        add_conv_kernel(self, "kernel", shape)

    def forward(self, x, train=False):
        if self.transpose:
            return conv_transpose2d(x, self.kernel, self.stride, self.dilation,
                                    self.output_padding, self.groups)
        return conv2d(x, self.kernel, self.stride, self.dilation, self.groups)


class ReLUConv(nn.Module):
    def __init__(self, c_in, c_out, kernel_size=3):
        super().__init__()
        self._ConvWeight_0 = _ConvWeight(c_in, c_out, kernel_size)

    def forward(self, x, train=False):
        return self._ConvWeight_0(relu(x), train)


class ConvBn(nn.Module):
    def __init__(self, c_in, c_out, kernel_size=3, stride=1, dilation=1, transpose=False,
                 output_padding=0):
        super().__init__()
        self._ConvWeight_0 = _ConvWeight(c_in, c_out, kernel_size, stride, dilation,
                                         transpose, output_padding)
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train=False):
        return self.BatchNorm_0(self._ConvWeight_0(x, train), train)


class Dense(nn.Module):
    """A bias-free dense layer with the kernel [in, out], xavier normal."""

    def __init__(self, c_in, c_out):
        super().__init__()
        add_kernel(self, "kernel", (c_in, c_out), xavier_std(c_in, c_out))

    def forward(self, x):
        return x @ self.kernel


class SEBlock(nn.Module):
    def __init__(self, c, r=16):
        super().__init__()
        mid = c // r if c > r else 1
        self.Dense_0 = Dense(c, mid)
        self.Dense_1 = Dense(mid, c)

    def forward(self, x):
        y = torch.sigmoid(self.Dense_1(relu(self.Dense_0(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class ConvBnSe(nn.Module):
    def __init__(self, c_in, c_out, kernel_size=3, stride=1, dilation=1, transpose=False,
                 output_padding=0):
        super().__init__()
        self.ConvBn_0 = ConvBn(c_in, c_out, kernel_size, stride, dilation, transpose,
                               output_padding)
        self.SEBlock_0 = SEBlock(c_out)

    def forward(self, x, train=False):
        return self.SEBlock_0(self.ConvBn_0(x, train))


class DepSepConv(nn.Module):
    def __init__(self, c_in, c_out, kernel_size=3, stride=1, dilation=1, transpose=False,
                 output_padding=0):
        super().__init__()
        self.depth = _ConvWeight(c_in, c_in, kernel_size, stride, dilation, transpose,
                                 output_padding, groups=c_in)
        self.depth_norm = BatchNorm(c_in)
        self.point = _ConvWeight(c_in, c_out, 1)
        self.point_norm = BatchNorm(c_out)

    def forward(self, x, train=False):
        x = relu(self.depth_norm(self.depth(x, train), train))
        return self.point_norm(self.point(x, train), train)


class AdapterBlock(nn.Module):
    def __init__(self, c_in, c_out, mode, stride=1):
        super().__init__()
        self.mode, self.stride = mode, stride
        if c_in != c_out:
            add_conv_kernel(self, "kernel", (c_out, c_in, 1, 1))
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train=False):
        if self.mode == "none":
            out = torch.zeros_like(x)
        elif self.mode == "identity":
            out = x
        elif self.mode == "avg_pool":
            out = avg_pool_3x3(x, self.stride)
        elif self.mode == "max_pool":
            out = max_pool_3x3(x, self.stride)
        else:
            out = upsample2x(x)
        if hasattr(self, "kernel"):
            out = conv2d(out, self.kernel)
        return self.BatchNorm_0(out, train)


class RectifyResample(nn.Module):
    def __init__(self, c_in, c_out, cell_type):
        super().__init__()
        self.cell_type = cell_type
        if c_in != c_out:
            shape = (c_in, c_out, 1, 1) if cell_type == "up" else (c_out, c_in, 1, 1)
            add_conv_kernel(self, "kernel", shape)
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train=False):
        out = relu(x)
        conv = hasattr(self, "kernel")
        if self.cell_type == "up":
            out = (conv_transpose2d(out, self.kernel, 2, 1, 1, padding=0) if conv
                   else upsample2x(out))
        else:
            out = conv2d(out, self.kernel, stride=2) if conv else avg_pool_3x3(out, 2)
        return self.BatchNorm_0(out, train)


class ShrinkBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        add_conv_kernel(self, "kernel", (c_out, c_in, 3, 3))
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train=False):
        return self.BatchNorm_0(conv2d(relu(x), self.kernel), train)


class RectifyBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        add_conv_kernel(self, "kernel", (c_out, c_in, 3, 3))
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train=False):
        return self.BatchNorm_0(conv2d(x, self.kernel), train)


class BasicBlock(nn.Module):
    """ResNet basic block without a downsample and without an activation
    after the residual sum."""

    def __init__(self, c_in, planes):
        super().__init__()
        add_conv_kernel(self, "conv1", (planes, c_in, 3, 3))
        self.bn1 = BatchNorm(planes)
        add_conv_kernel(self, "conv2", (planes, planes, 3, 3))
        self.bn2 = BatchNorm(planes)

    def forward(self, x, train=False):
        out = relu(self.bn1(conv2d(x, self.conv1), train))
        return self.bn2(conv2d(out, self.conv2), train) + x


def make_op(name, c_in, c_out, op_type):
    """Candidate op `name`: NORM at stride 1; DOWN a stride-2 conv or pool;
    UP a stride-2 transposed conv with output padding 1 (or an upsample)."""
    stride = 1 if op_type == OpType.NORM else 2
    transpose = op_type == OpType.UP
    op = 1 if transpose else 0
    if name in ("none", "identity", "up_sample"):
        return AdapterBlock(c_in, c_out, name, 1)
    if name in ("avg_pool", "max_pool"):
        return AdapterBlock(c_in, c_out, name, stride)
    if name == "conv_3":
        return ConvBn(c_in, c_out, 3, stride, 1, transpose, op)
    if name == "se_conv_3":
        return ConvBnSe(c_in, c_out, 3, stride, 1, transpose, op)
    if name == "dil_3_conv_5":
        return ConvBn(c_in, c_out, 5, stride, 3, transpose, op)
    if name == "dil_2_conv_5":
        return ConvBn(c_in, c_out, 5, stride, 2, transpose, op)
    if name == "dep_sep_conv_3":
        return DepSepConv(c_in, c_out, 3, stride, 1, transpose, op)
    if name == "dep_sep_conv_5":
        return DepSepConv(c_in, c_out, 5, stride, 1, transpose, op)
    raise NotImplementedError(name)


# ---------------------------------------------------------------------------
# Loss: dice_ce on the last head
# ---------------------------------------------------------------------------

def dice_ce(outputs: List[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
    """Cross-entropy (mean over pixels) plus the batch soft dice (softmax,
    background left out, smooth 1e-5, 1e-8 more in the denominator) of the
    last head's NHWC logits."""
    logits = outputs[-1]
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, target[..., None].long()).mean()
    x = torch.softmax(logits, dim=-1)
    y = (target[..., None] == torch.arange(logits.shape[-1], device=target.device)).to(x.dtype)
    tp = (x * y).sum(dim=(0, 1, 2))
    fp = (x * (1 - y)).sum(dim=(0, 1, 2))
    fn = ((1 - x) * y).sum(dim=(0, 1, 2))
    dc = (2 * tp + 1e-5) / (2 * tp + fp + fn + 1e-5 + 1e-8)
    return ce + 1 - dc[1:].mean()
