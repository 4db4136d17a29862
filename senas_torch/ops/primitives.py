"""NAS op vocabulary and shared conv blocks in PyTorch (NCHW inside).

Port of `senas_tpu/ops/primitives.py`. Same candidate-op names, the same
stride/dilation/padding arithmetic and the same BN-everywhere structure,
in PyTorch idiom:

  * NCHW contiguous tensors, the natural layout of `F.conv2d`; the JAX
    package is NHWC, and the model's public boundary converts.
  * Parameters carry the flax variable names (`kernel`, `scale`, `bias`;
    buffers `mean`, `var`) and submodules the flax auto-names
    (`BatchNorm_0`, `_ConvWeight_0`, ...), so `senas_torch.convert` maps
    the two trees leaf by leaf. Conv kernels are stored in PyTorch's own
    layout: OIHW for a conv, [I, O/groups, k, k] for a transposed conv.
    A module whose kernel is not a plain conv says so in `flax_layout`.
  * Transposed convs are `F.conv_transpose2d`: PyTorch correlates the
    spatially flipped kernel, the JAX package an unflipped lhs-dilated one;
    the bridge flips. Output size (H-1)*s - 2p + d*(k-1) + op + 1 in both.
  * Depthwise convs are plain `groups=C` convs. The JAX package's dense
    block-diagonal rewrite is a TPU workaround and is not ported.
  * `forward(x, train)` takes the mode explicitly, as the flax modules do.
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from senas_torch.core.genotype import DownOps, NormOps, UpOps

EPS = 1e-5


def kaiming_std(fan: int) -> float:
    """Std of kaiming_normal_(nonlinearity='relu') for the torch fan `fan`."""
    return math.sqrt(2.0 / fan)


def xavier_std(fan_in: int, fan_out: int) -> float:
    """Std of xavier_normal_ for the torch fans."""
    return math.sqrt(2.0 / (fan_in + fan_out))


def add_kernel(module: nn.Module, name: str, shape, std: float) -> nn.Parameter:
    """Register parameter `name` of `shape` on `module`, to be drawn from
    normal(0, std) by `init_params_`."""
    p = nn.Parameter(torch.zeros(shape))
    setattr(module, name, p)
    if "init_std" not in module.__dict__:
        module.init_std = {}
    module.init_std[name] = std
    return p


def add_conv_kernel(module: nn.Module, name: str, shape) -> nn.Parameter:
    """A conv kernel in PyTorch's layout ([O, I/g, k, k], or [I, O/g, k, k]
    for a transposed conv) with kaiming_normal_(mode='fan_out') on that
    layout: fan = shape[0]*k*k, which is the JAX package's rule for every
    ungrouped block (`kaiming_normal` for a conv, the input-side fan for a
    transposed one, senas_tpu/ops/primitives.py:43-93, 371-374)."""
    return add_kernel(module, name, shape, kaiming_std(shape[0] * shape[2] * shape[3]))


def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init with the JAX package's (= the reference's
    weights_init) rules: every kernel from normal(0, std), with the std its
    module stated when it made it (`add_kernel`); BN scale/bias keep their
    construction values (1, 0). The numbers differ from the JAX package's
    (another generator); the distribution of each leaf is the same."""
    with torch.no_grad():
        for m in module.modules():
            stds = m.__dict__.get("init_std", {})
            for name, p in m.named_parameters(recurse=False):
                if name in stds:
                    p.copy_(torch.randn(p.shape, generator=generator) * stds[name])
                elif p.ndim > 1:
                    raise ValueError(f"{type(m).__name__}.{name} states no init")
    return module


def get_same_padding(kernel_size: int) -> int:
    assert kernel_size % 2 > 0, "kernel size should be odd number"
    return kernel_size // 2


def relu(x):
    return F.relu(x)


# ---------------------------------------------------------------------------
# Functional conv / pool / resize primitives (NCHW)
# ---------------------------------------------------------------------------

def conv2d(x, w, stride: int = 1, dilation: int = 1, groups: int = 1):
    """2D conv, NCHW/OIHW, symmetric padding (k//2)*dilation."""
    k = w.shape[-1]
    p = get_same_padding(k) * dilation if k > 1 else 0
    return F.conv2d(x, w, stride=stride, padding=p, dilation=dilation,
                    groups=groups)


def conv_transpose2d(x, w, stride: int = 2, dilation: int = 1,
                     output_padding: int = 1, groups: int = 1,
                     torch_padding: Optional[int] = None):
    """Transposed conv; w is [I, O/groups, k, k]. Output size
    (H-1)*stride - 2p + dilation*(k-1) + output_padding + 1."""
    k = w.shape[-1]
    p = get_same_padding(k) * dilation if torch_padding is None else torch_padding
    return F.conv_transpose2d(x, w, stride=stride, padding=p,
                              output_padding=output_padding, groups=groups,
                              dilation=dilation)


def avg_pool_3x3(x, stride: int = 1):
    """AvgPool2d(3, stride, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride=stride, padding=1, count_include_pad=False)


def max_pool_3x3(x, stride: int = 2):
    """MaxPool2d(3, stride, padding=1)."""
    return F.max_pool2d(x, 3, stride=stride, padding=1)


def upsample2x(x):
    """Bilinear 2x upsample with half-pixel centres (align_corners=False),
    which is what `jax.image.resize(..., "bilinear")` does when enlarging."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """BatchNorm with torch nn.BatchNorm2d semantics and the flax layout.

    Train mode normalises by the biased batch variance (stats in f32) and
    advances the running stats with momentum 0.1 and the UNBIASED variance;
    eval mode normalises by the running stats. Variables: parameters
    `scale`, `bias`; buffers `mean`, `var` (all f32, [C])."""

    def __init__(self, c: int, momentum: float = 0.1, eps: float = EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool = False):
        # F.batch_norm updates `mean`/`var` in place in train mode.
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            training=train, momentum=self.momentum,
                            eps=self.eps)


# ---------------------------------------------------------------------------
# Op-type vocabulary
# ---------------------------------------------------------------------------

class OpType(enum.Enum):
    UP = {"id": 1, "ops": UpOps}
    DOWN = {"id": 2, "ops": DownOps}
    NORM = {"id": 3, "ops": NormOps}


# ---------------------------------------------------------------------------
# Parametric blocks
# ---------------------------------------------------------------------------

class _ConvWeight(nn.Module):
    """(Conv | ConvTranspose), bias-free (build_weight parity)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0, groups: int = 1):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.transpose, self.output_padding = transpose, output_padding
        k = kernel_size
        if transpose:
            add_conv_kernel(self, "kernel", (c_in, c_out // groups, k, k))
            self.flax_layout = {"kernel": "dw_t" if groups > 1 else "hwio_t"}
        else:
            add_conv_kernel(self, "kernel", (c_out, c_in // groups, k, k))

    def forward(self, x, train: bool = False):
        if self.transpose:
            return conv_transpose2d(x, self.kernel, stride=self.stride,
                                    dilation=self.dilation,
                                    output_padding=self.output_padding,
                                    groups=self.groups)
        return conv2d(x, self.kernel, stride=self.stride,
                      dilation=self.dilation, groups=self.groups)


class ReLUConv(nn.Module):
    """act -> conv (segmentation head building block)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0):
        super().__init__()
        self._ConvWeight_0 = _ConvWeight(c_in, c_out, kernel_size, stride,
                                         dilation, transpose, output_padding)

    def forward(self, x, train: bool = False):
        return self._ConvWeight_0(relu(x), train)


class ConvBn(nn.Module):
    """conv -> BN."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0):
        super().__init__()
        self._ConvWeight_0 = _ConvWeight(c_in, c_out, kernel_size, stride,
                                         dilation, transpose, output_padding)
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(self._ConvWeight_0(x, train), train)


class Dense(nn.Module):
    """Bias-free dense layer with the flax kernel layout [in, out]."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        add_kernel(self, "kernel", (c_in, c_out), xavier_std(c_in, c_out))

    def forward(self, x):
        return x @ self.kernel


class SEBlock(nn.Module):
    """Squeeze-and-Excitation, r=16 (the reference's operations.py:186-203)."""

    def __init__(self, c: int, r: int = 16):
        super().__init__()
        mid = c // r if c > r else 1
        self.Dense_0 = Dense(c, mid)
        self.Dense_1 = Dense(mid, c)

    def forward(self, x):
        y = x.mean(dim=(2, 3))  # [B, C]
        y = torch.sigmoid(self.Dense_1(relu(self.Dense_0(y))))
        return x * y[:, :, None, None]


class ConvBnSe(nn.Module):
    """conv -> BN -> SE."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0):
        super().__init__()
        self.ConvBn_0 = ConvBn(c_in, c_out, kernel_size, stride, dilation,
                               transpose, output_padding)
        self.SEBlock_0 = SEBlock(c_out)

    def forward(self, x, train: bool = False):
        return self.SEBlock_0(self.ConvBn_0(x, train))


class DepSepConv(nn.Module):
    """depthwise conv -> BN -> ReLU -> pointwise conv -> BN."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0):
        super().__init__()
        self.depth = _ConvWeight(c_in, c_in, kernel_size, stride, dilation,
                                 transpose, output_padding, groups=c_in)
        self.depth_norm = BatchNorm(c_in)
        self.point = _ConvWeight(c_in, c_out, 1)
        self.point_norm = BatchNorm(c_out)

    def forward(self, x, train: bool = False):
        x = relu(self.depth_norm(self.depth(x, train), train))
        return self.point_norm(self.point(x, train), train)


class AdapterBlock(nn.Module):
    """Parameterless inner op (zero/identity/pool/upsample) + channel adapter:
    inner -> optional 1x1 conv (if c_in != c_out) -> BN."""

    def __init__(self, c_in: int, c_out: int, mode: str, stride: int = 1):
        super().__init__()
        if mode not in ("none", "identity", "avg_pool", "max_pool", "up_sample"):
            raise ValueError(f"unknown adapter mode {mode!r}")
        self.mode, self.stride = mode, stride
        if c_in != c_out:
            add_conv_kernel(self, "kernel", (c_out, c_in, 1, 1))
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train: bool = False):
        if self.mode == "none":
            out = torch.zeros_like(x)
        elif self.mode == "identity":
            out = x
        elif self.mode == "avg_pool":
            out = avg_pool_3x3(x, stride=self.stride)
        elif self.mode == "max_pool":
            out = max_pool_3x3(x, stride=self.stride)
        else:
            out = upsample2x(x)
        if hasattr(self, "kernel"):
            out = conv2d(out, self.kernel)
        return self.BatchNorm_0(out, train)


class RectifyResample(nn.Module):
    """Cell-input resampling: act -> {2x up (bilinear | 1x1 transpose) |
    2x down (avgpool | 1x1 conv)} -> BN. Conv-free when c_in == c_out."""

    def __init__(self, c_in: int, c_out: int, cell_type: str):
        super().__init__()
        self.cell_type = cell_type
        if c_in != c_out:
            if cell_type == "up":
                add_conv_kernel(self, "kernel", (c_in, c_out, 1, 1))
                self.flax_layout = {"kernel": "hwio_t"}
            else:
                add_conv_kernel(self, "kernel", (c_out, c_in, 1, 1))
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train: bool = False):
        out = relu(x)
        conv = hasattr(self, "kernel")
        if self.cell_type == "up":
            out = (conv_transpose2d(out, self.kernel, stride=2, output_padding=1,
                                    torch_padding=0) if conv else upsample2x(out))
        else:
            out = conv2d(out, self.kernel, stride=2) if conv else avg_pool_3x3(out, stride=2)
        return self.BatchNorm_0(out, train)


class ShrinkBlock(nn.Module):
    """act -> 3x3 conv -> BN: maps grown skip-concat width back down."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        add_conv_kernel(self, "kernel", (c_out, c_in, 3, 3))
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(conv2d(relu(x), self.kernel), train)


class RectifyBlock(nn.Module):
    """3x3 conv -> BN: cell expand/post-process."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        add_conv_kernel(self, "kernel", (c_out, c_in, 3, 3))
        self.BatchNorm_0 = BatchNorm(c_out)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(conv2d(x, self.kernel), train)


class BasicBlock(nn.Module):
    """ResNet BasicBlock (stem1 building block); no activation after the
    residual sum, as in the JAX package."""

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_downsample: bool = False):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        add_conv_kernel(self, "conv1", (planes, c_in, 3, 3))
        self.bn1 = BatchNorm(planes)
        add_conv_kernel(self, "conv2", (planes, planes, 3, 3))
        self.bn2 = BatchNorm(planes)
        self.use_downsample = use_downsample
        if use_downsample:
            add_conv_kernel(self, "down_conv", (planes, c_in, 1, 1))
            self.down_bn = BatchNorm(planes)

    def forward(self, x, train: bool = False):
        out = conv2d(x, self.conv1, stride=self.stride, dilation=self.dilation)
        out = relu(self.bn1(out, train))
        out = conv2d(out, self.conv2, stride=1, dilation=self.dilation)
        out = self.bn2(out, train)
        residual = x
        if self.use_downsample:
            residual = self.down_bn(conv2d(x, self.down_conv, stride=self.stride), train)
        return out + residual


# ---------------------------------------------------------------------------
# Candidate-op registry (OPS, the reference's operations.py:8-21)
# ---------------------------------------------------------------------------

def make_op(name: str, c_in: int, c_out: int, op_type: OpType,
            dp: float = 0.0) -> nn.Module:
    """Instantiate candidate op `name` with the reference's stride rules:
    NORM -> stride 1; DOWN -> stride-2 conv/pool; UP -> stride-2 transpose
    conv with output_padding 1 (pool ops become bilinear 2x upsample).
    `dp` is the conv ops' spatial-dropout rate; only 0 is ported."""
    if dp > 0:
        raise NotImplementedError(
            "dropout_prob > 0 (spatial_dropout) is not ported yet (ROADMAP.md "
            "Queue 1, M11 deferred: dropout)")
    stride = 1 if op_type == OpType.NORM else 2
    transpose = op_type == OpType.UP
    op = 1 if op_type == OpType.UP else 0
    if name in ("none", "identity", "up_sample"):
        return AdapterBlock(c_in, c_out, mode=name, stride=1)
    if name in ("avg_pool", "max_pool"):
        return AdapterBlock(c_in, c_out, mode=name, stride=stride)
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
