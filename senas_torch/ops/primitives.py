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
  * `dtype` is the compute dtype, as in the flax modules: None computes in
    the input's dtype (f32 from an f32 image), `torch.bfloat16` in bf16.
    A module casts its input to `dtype` on entry where the flax one does,
    and its weights at use, so the parameters stay f32 masters. BatchNorm
    takes its statistics and running-stat update in f32 and rounds its
    output once to `dtype`.
  * `SENAS_PALLAS_BN=1` in the environment (read at each call, default
    off, as in the JAX package) routes every 4-D BatchNorm through the
    fused epilogue's kernels at n=1 (`BatchNorm`).
  * `remat(fn, *args)` is the JAX package's `nn.remat` of a cell.
  * Under an active row split (`senas_torch.parallel`, the mesh's spatial
    axis) every map is this rank's block of image rows: the convolutions,
    poolings and the resize go through `senas_torch.parallel.spatial`
    (halo exchanges), the SE block's mean, every BatchNorm's and
    GroupNorm's statistics and Dropout's mask span the global image. A map
    computed inside `collectives.whole_maps()` (a global pool's 1x1 map,
    `on_whole_level`) is whole on every rank of a data index, and its
    BatchNorm reduces over the data subgroup alone.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import math
import os
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from senas_torch.core.genotype import DownOps, NormOps, UpOps
from senas_torch.ops.grouped_epilogue import fused_group_epilogue
from senas_torch.parallel import spatial
from senas_torch.parallel.collectives import (active_mesh, active_split, all_reduce_sum,
                                              global_count, global_height, global_rows,
                                              plane_size, spatial_sum, whole_maps)

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


def add_bias(module: nn.Module, name: str, c: int, fan_in: Optional[int] = None) -> nn.Parameter:
    """Register bias `name` of [c]. With `fan_in` it is drawn from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) by `init_params_`: torch's own
    Conv2d bias init, which the reference's weights_init leaves alone
    (`torch_conv_bias`, senas_tpu/ops/primitives.py:80-90). Without, it
    stays 0 (a flax Dense's or a zero-initialised conv bias)."""
    p = nn.Parameter(torch.zeros(c))
    setattr(module, name, p)
    if fan_in is not None:
        if "init_bound" not in module.__dict__:
            module.init_bound = {}
        module.init_bound[name] = 1.0 / math.sqrt(fan_in)
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
    module stated when it made it (`add_kernel`), and a torch-default conv
    bias from U(-bound, bound) (`add_bias`); BN and GroupNorm scale/bias
    and the other biases keep their construction values (1, 0). The
    numbers differ from the JAX package's (another generator); the
    distribution of each leaf is the same."""
    with torch.no_grad():
        for m in module.modules():
            stds = m.__dict__.get("init_std", {})
            bounds = m.__dict__.get("init_bound", {})
            for name, p in m.named_parameters(recurse=False):
                if name in stds:
                    p.copy_(torch.randn(p.shape, generator=generator) * stds[name])
                elif name in bounds:
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bounds[name])
                elif p.ndim > 1:
                    raise ValueError(f"{type(m).__name__}.{name} states no init")
    return module


def get_same_padding(kernel_size: int) -> int:
    assert kernel_size % 2 > 0, "kernel size should be odd number"
    return kernel_size // 2


def relu(x):
    return F.relu(x)


def sigmoid(x):
    """jax.nn.sigmoid, which is 1 / (1 + exp(-x)) op by op: in bf16 each op
    rounds, and that is computed here; in f32 and f64 it is PyTorch's
    sigmoid (the same function to within an ulp)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def softmax(x, dim: int = -1):
    """jax.nn.softmax over `dim`. In bf16 as XLA computes the JAX package's
    ops: the exps rounded to bf16 in the numerator, the denominator the f32
    sum of the unrounded exps rounded once, then the bf16 quotient. In f32
    and f64 PyTorch's softmax."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    shifted = x - x.amax(dim=dim, keepdim=True)
    total = torch.exp(shifted.float()).sum(dim=dim, keepdim=True)
    return torch.exp(shifted) / total.to(x.dtype)


def log_softmax(x, dim: int = -1):
    """jax.nn.log_softmax over `dim`. In bf16 as XLA computes it: the shift
    in bf16, the f32 sum of the unrounded exps rounded once, its bf16 log
    subtracted. In f32 and f64 PyTorch's."""
    if x.dtype != torch.bfloat16:
        return torch.log_softmax(x, dim=dim)
    shifted = x - x.amax(dim=dim, keepdim=True)
    total = torch.exp(shifted.float()).sum(dim=dim, keepdim=True)
    return shifted - torch.log(total.to(x.dtype))


def mean_all(x):
    """jnp.mean of all elements: in bf16 an f32 sum divided by the count,
    rounded once; in f32 and f64 PyTorch's mean."""
    if x.dtype != torch.bfloat16:
        return x.mean()
    return (x.sum(dtype=torch.float32) / x.numel()).to(x.dtype)


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as JAX's weak typing applies it to `like`: in its
    dtype (bf16(0.9) against a bf16 tensor, where PyTorch would multiply by
    the f32 0.9), on its device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def cast(x, dtype):
    """x in `dtype`; None leaves it as it is (a module's compute dtype)."""
    return x if dtype is None else x.to(dtype)


# ---------------------------------------------------------------------------
# Functional conv / pool / resize primitives (NCHW)
# ---------------------------------------------------------------------------

def is_split(x) -> bool:
    """Whether x is this rank's block of image rows under an active row
    split (`senas_torch.parallel.spatial`): every map of a model then is,
    but those computed inside `collectives.whole_maps()`."""
    return active_split() is not None and not x.is_meta


def conv2d(x, w, stride: int = 1, dilation: int = 1, groups: int = 1):
    """2D conv, NCHW/OIHW, symmetric padding (k//2)*dilation."""
    k = w.shape[-1]
    p = get_same_padding(k) * dilation if k > 1 else 0
    if is_split(x):
        return spatial.conv2d(x, w, stride, dilation, groups, p)
    return F.conv2d(x, w, stride=stride, padding=p, dilation=dilation,
                    groups=groups)


def conv2d_padded(x, w, padding, stride: int = 1, dilation: int = 1, groups: int = 1):
    """2D conv, NCHW/OIHW, of any kernel (kh, kw) with explicit zero
    padding: (ph, pw) per axis as torch's `padding=`, or ((top, bottom),
    (left, right)) for an asymmetric one (TF 'SAME' at stride 2), which is
    padded with F.pad first."""
    if is_split(x):
        return spatial.conv2d(x, w, stride, dilation, groups, padding)
    (top, bottom), (left, right) = spatial.pads(padding)
    if top != bottom or left != right:
        x, top, left = F.pad(x, (left, right, top, bottom)), 0, 0
    return F.conv2d(x, w, stride=stride, padding=(top, left), dilation=dilation, groups=groups)


def _transposed(x, w, **kw):
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        # PyTorch's CPU bf16 transposed convolution (oneDNN) returns NaN
        # weight gradients now and then (seen for a 1x1 input at stride 2);
        # the f32 one of the same bf16 values, rounded once, is the same
        # forward value (f32 sums, one rounding)
        return F.conv_transpose2d(x.float(), w.float(), **kw).to(x.dtype)
    return F.conv_transpose2d(x, w, **kw)


def conv_transpose2d(x, w, stride: int = 2, dilation: int = 1,
                     output_padding: int = 1, groups: int = 1,
                     torch_padding: Optional[int] = None):
    """Transposed conv; w is [I, O/groups, k, k]. Output size
    (H-1)*stride - 2p + dilation*(k-1) + output_padding + 1."""
    k = w.shape[-1]
    p = get_same_padding(k) * dilation if torch_padding is None else torch_padding
    if is_split(x):
        return spatial.conv_transpose2d(x, w, stride, p, output_padding, dilation, groups,
                                        op=_transposed)
    return _transposed(x, w, stride=stride, padding=p, output_padding=output_padding,
                       groups=groups, dilation=dilation)


def avg_pool_3x3(x, stride: int = 1):
    """AvgPool2d(3, stride, padding=1, count_include_pad=False)."""
    if is_split(x):
        return spatial.avg_pool(x, 3, stride, 1, count_include_pad=False)
    return F.avg_pool2d(x, 3, stride=stride, padding=1, count_include_pad=False)


def avg_pool(x, k: int, stride: int, padding: int = 0, count_include_pad: bool = True):
    """AvgPool2d(k, stride, padding, count_include_pad)."""
    if is_split(x):
        return spatial.avg_pool(x, k, stride, padding, count_include_pad)
    return F.avg_pool2d(x, k, stride=stride, padding=padding,
                        count_include_pad=count_include_pad)


def max_pool_3x3(x, stride: int = 2):
    """MaxPool2d(3, stride, padding=1)."""
    if is_split(x):
        return spatial.max_pool(x, 3, stride, 1)
    return F.max_pool2d(x, 3, stride=stride, padding=1)


def max_pool(x, k: int, stride: int, padding=0):
    """MaxPool2d(k, stride) with -inf padding: an int (every side), or a
    (lo, hi) pair on both axes (torch's ceil_mode=True alignment is (0, 1)
    on a map its windows do not tile), padded with F.pad first."""
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    if is_split(x):
        return spatial.max_pool(x, k, stride, ((lo, hi), (lo, hi)))
    if lo == hi:
        return F.max_pool2d(x, k, stride=stride, padding=lo)
    return F.max_pool2d(F.pad(x, (lo, hi, lo, hi), value=float("-inf")), k, stride=stride)


def max_pool_2x2(x):
    """MaxPool2d(2, stride=2)."""
    if is_split(x):
        return spatial.max_pool(x, 2, 2)
    return F.max_pool2d(x, 2, stride=2)


def avg_pool_2x2(x):
    """AvgPool2d(2, stride=2)."""
    if is_split(x):
        return spatial.avg_pool(x, 2, 2)
    return F.avg_pool2d(x, 2, stride=2)


def upsample2x(x):
    """Bilinear 2x upsample with half-pixel centres (align_corners=False),
    which is what `jax.image.resize(..., "bilinear")` does when enlarging."""
    if is_split(x):
        return spatial.upsample2x(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def image_mean(x):
    """x [B, C, H, W] averaged over H, W: x.mean(dim=(2, 3)), of the global
    image under a row split (a sum over the ranks of the data index, divided
    by the global H*W; a bf16 x summed in f32 and rounded once, as its mean
    is)."""
    if not is_split(x):
        return x.mean(dim=(2, 3))
    total = x.sum(dim=(2, 3), dtype=torch.promote_types(x.dtype, torch.float32))
    return (spatial_sum(total) / plane_size(x)).to(x.dtype)


def whole_level(x):
    """x's whole level on every rank: a gather over the spatial subgroup
    (`spatial.gather_level`) under a row split, x itself otherwise."""
    return spatial.gather_level(x) if is_split(x) else x


def on_whole_level(fn, x):
    """fn of x's whole level, every rank computing it alike inside
    `whole_maps()`, cut back to this rank's rows: for an op that reads
    every row of its input (MAnet's position attention). fn(x) without a
    row split."""
    if not is_split(x):
        return fn(x)
    full = spatial.gather_level(x)
    with whole_maps():
        y = fn(full)
    return spatial.own_rows(y)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

def use_pallas_bn() -> bool:
    """The JAX package's gate `SENAS_PALLAS_BN=1`: every 4-D BatchNorm
    normalises through the fused epilogue's kernels at n=1 (K1a's sums and
    K1b's affine forward, K1c and K1d backward). Off by default there, as
    the JAX package measured it slower on its own chip; off here too."""
    return os.environ.get("SENAS_PALLAS_BN", "0") == "1"


# True while `remat` recomputes a forward in the backward: the running
# stats then stay where the first forward left them. A process-wide flag,
# since autograd may run the recompute on a device thread of its own.
_RECOMPUTING = False


@contextlib.contextmanager
def _recomputing():
    global _RECOMPUTING
    before, _RECOMPUTING = _RECOMPUTING, True
    try:
        yield
    finally:
        _RECOMPUTING = before


def remat(fn, *args, enabled: bool = True):
    """fn(*args) with its activations recomputed in the backward instead of
    kept (`torch.utils.checkpoint`, non-reentrant): the JAX package's
    `nn.remat` of a cell. A plain call when not `enabled` or when autograd
    records nothing. The same values and gradients, less live memory,
    one more forward. The recompute leaves the running stats alone
    (BatchNorm and the epilogue's BNs advance them once a step, as flax's
    lifted remat updates batch_stats once). `checkpoint` replays only the
    global RNG states: an op that draws from an explicit `torch.Generator`
    needs its masks drawn outside the recomputed function or its generator
    rebuilt inside it from what the call was given (the SENAS cells'
    dropout streams, `dropout_stream`)."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


class BatchNorm(nn.Module):
    """BatchNorm with torch nn.BatchNorm2d semantics and the flax layout.

    Train mode normalises by the biased batch variance (stats in f32) and
    advances the running stats with momentum 0.1 and the UNBIASED variance;
    eval mode normalises by the running stats. Variables: parameters
    `scale`, `bias`; buffers `mean`, `var` (all f32, [C]). The output is in
    `dtype`, else in x's dtype: a bf16 x is normalised in f32 (PyTorch's
    mixed batch norm) and rounded once, as the flax module's
    `y.astype(self.dtype or x.dtype)` does.

    With `use_pallas_bn()` a 4-D x goes through `fused_group_epilogue([x],
    [scale], [bias], [ones])`, as the JAX module's `_pallas_path` does: in
    train mode its one-sweep batch variance max(E[x^2] - mu^2, 0) (the
    default path's is two-pass), in eval mode an affine of the running
    stats with no stats sweep. The kernels write their input's dtype, so
    where `dtype` differs from x's the path runs in f32 (a bf16 x widened,
    exactly) and rounds once to `dtype`. A non-contiguous x is copied to
    NCHW; `pallas_copies` counts the copies the path makes. Other ranks
    keep `F.batch_norm`, as in the JAX module, and so does a tensor on the
    meta device (a shape-only forward).

    Under an active mesh (`senas_torch.parallel`) train mode normalises by
    the statistics of the GLOBAL batch (every rank's batch rows and, under
    a row split, image rows), as the JAX module does under GSPMD:
    the default path by a two-pass synced BN (the global mean, then the
    global sum of squared deviations, each summed over the ranks), the
    gated path through the epilogue's global sums; the running stats
    advance with the global count."""

    pallas_copies = 0

    def __init__(self, c: int, momentum: float = 0.1, eps: float = EPS, dtype=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool = False):
        if x.dim() == 4 and use_pallas_bn() and not x.is_meta:
            return self._kernel_path(x, train)
        if train and active_mesh() is not None and not x.is_meta:
            return self._synced(x)
        # F.batch_norm updates the running stats it is given in place in
        # train mode; a remat recompute gives it copies.
        mean, var = ((self.mean.clone(), self.var.clone()) if train and _RECOMPUTING
                     else (self.mean, self.var))
        y = F.batch_norm(x, mean, var, self.scale, self.bias,
                         training=train, momentum=self.momentum, eps=self.eps)
        return y if self.dtype is None else y.to(self.dtype)

    def _synced(self, x):
        """Train mode over every rank's rows: the biased two-pass variance
        of the global batch, in at least f32."""
        ct = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(ct)
        dims = [0] + list(range(2, x.dim()))
        col = [1, x.shape[1]] + [1] * (x.dim() - 2)
        count = global_count(x)
        mu = all_reduce_sum(xs.sum(dim=dims)) / count
        d = xs - mu.view(col)
        var = all_reduce_sum((d * d).sum(dim=dims)) / count
        y = (d * (torch.rsqrt(var + self.eps) * self.scale.to(ct)).view(col)
             + self.bias.to(ct).view(col))
        self.advance(mu.detach(), var.detach(), count)
        return y.to(self.dtype or x.dtype)

    def _kernel_path(self, x, train: bool):
        out_dtype = self.dtype or x.dtype
        xk = x if x.dtype == out_dtype else x.float()
        if not xk.is_contiguous():
            xk = xk.contiguous()
        BatchNorm.pallas_copies += (xk is not x)
        ones = torch.ones_like(self.scale)
        if not train:
            y, _ = fused_group_epilogue([xk], [self.scale], [self.bias], [ones], train=False,
                                        run_means=[self.mean], run_vars=[self.var],
                                        out_dtype=xk.dtype)
        else:
            y, (mu, var) = fused_group_epilogue([xk], [self.scale], [self.bias], [ones],
                                                train=True, out_dtype=xk.dtype)
            self.advance(mu[0], var[0], global_count(x))
        return y.to(out_dtype)

    @torch.no_grad()
    def advance(self, mu, var, count: int):
        """Move the running stats from biased batch stats (mu, var) over
        `count` values: momentum 0.1, the unbiased variance. In place (on
        the CPU and on the card), as nn.BatchNorm2d does; the JAX package
        returns new arrays instead. Not while `remat` recomputes."""
        if _RECOMPUTING:
            return
        unbiased = var * (count / max(count - 1, 1))
        m = self.momentum
        self.mean.mul_(1 - m).add_(m * mu)
        self.var.mul_(1 - m).add_(m * unbiased)


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
    """[spatial dropout] + (Conv | ConvTranspose), bias-free (build_weight
    parity); x cast to `dtype` on entry (after the dropout, as in the JAX
    package), the kernel to x's dtype at use. A `dropout` above 0 draws
    from the generator of the enclosing `dropout_stream` in train mode."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0, groups: int = 1, dtype=None,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.dtype = dtype
        self.transpose, self.output_padding = transpose, output_padding
        k = kernel_size
        if transpose:
            add_conv_kernel(self, "kernel", (c_in, c_out // groups, k, k))
            self.flax_layout = {"kernel": "dw_t" if groups > 1 else "hwio_t"}
        else:
            add_conv_kernel(self, "kernel", (c_out, c_in // groups, k, k))

    def forward(self, x, train: bool = False):
        if self.dropout > 0:
            x = spatial_dropout(x, self.dropout, train, _DROPOUT_RNG.get())
        x = cast(x, self.dtype)
        w = self.kernel.to(x.dtype)
        if self.transpose:
            return conv_transpose2d(x, w, stride=self.stride,
                                    dilation=self.dilation,
                                    output_padding=self.output_padding,
                                    groups=self.groups)
        return conv2d(x, w, stride=self.stride,
                      dilation=self.dilation, groups=self.groups)


class ReLUConv(nn.Module):
    """act -> conv (segmentation head building block)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0, dtype=None):
        super().__init__()
        self._ConvWeight_0 = _ConvWeight(c_in, c_out, kernel_size, stride,
                                         dilation, transpose, output_padding,
                                         dtype=dtype)

    def forward(self, x, train: bool = False):
        return self._ConvWeight_0(relu(x), train)


class ConvBn(nn.Module):
    """[spatial dropout] -> conv -> BN."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0, dtype=None, dropout: float = 0.0):
        super().__init__()
        self._ConvWeight_0 = _ConvWeight(c_in, c_out, kernel_size, stride,
                                         dilation, transpose, output_padding,
                                         dtype=dtype, dropout=dropout)
        self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(self._ConvWeight_0(x, train), train)


class Dense(nn.Module):
    """flax Dense with the flax kernel layout [in, out]. The kernel is
    xavier_normal (an nn.Linear under weights_init) unless `std` is given;
    `bias` adds a bias, 0 or, with `bias_fan_in`, torch's conv default.
    It computes in `dtype`, else in the promoted dtype of x and the f32
    kernel, as flax's promote_dtype does."""

    def __init__(self, c_in: int, c_out: int, bias: bool = False,
                 std: Optional[float] = None, bias_fan_in: Optional[int] = None,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        add_kernel(self, "kernel", (c_in, c_out),
                   xavier_std(c_in, c_out) if std is None else std)
        if bias:
            add_bias(self, "bias", c_out, bias_fan_in)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        return y + self.bias.to(dt) if hasattr(self, "bias") else y


class GroupNorm(nn.Module):
    """flax nn.GroupNorm (eps 1e-5, torch's default) with its variables
    `scale` and `bias`. With `dtype` (bf16) it is flax's GroupNorm(dtype=):
    x promoted to f32, normalised, scaled and biased in f32, and rounded
    once to `dtype`, whatever x's dtype (F.group_norm in f32: flax's
    one-sweep E[x^2] - E[x]^2 variance differs from it by f32 rounding,
    under the bf16 rounding). Without, F.group_norm in x's dtype.

    Under a row split each group's statistics span the global image: the
    two-pass form of F.group_norm, each pass a sum over this rank's rows
    summed over the spatial subgroup (the group's mean, then its summed
    squared deviations), divided by the global count (C/G channels times
    the level's global H*W)."""

    def __init__(self, c: int, num_groups: int, eps: float = EPS, dtype=None):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        if is_split(x):
            return self._split_rows(x)
        if self.dtype is None:
            return F.group_norm(x, self.num_groups, self.scale, self.bias, self.eps)
        return F.group_norm(x.float(), self.num_groups, self.scale, self.bias,
                            self.eps).to(self.dtype)

    def _split_rows(self, x):
        ct = torch.float32 if self.dtype is not None else x.dtype
        b, c = x.shape[:2]
        g = x.to(ct).reshape(b, self.num_groups, -1)
        count = (c // self.num_groups) * plane_size(x)
        mu = spatial_sum(g.sum(dim=2)) / count
        d = g - mu[:, :, None]
        var = spatial_sum((d * d).sum(dim=2)) / count
        y = (d * torch.rsqrt(var + self.eps)[:, :, None]).reshape(x.shape)
        y = y * self.scale.to(ct)[:, None, None] + self.bias.to(ct)[:, None, None]
        return y.to(self.dtype or x.dtype)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NCHW channel shuffle: the JAX package's NHWC `channel_shuffle`
    (channel g * (C / groups) + i moves to i * groups + g)."""
    if groups == 1:
        return x
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


# The generator the SENAS cells' spatial dropout draws from, set by the
# enclosing `dropout_stream`.
_DROPOUT_RNG: "contextvars.ContextVar[Optional[torch.Generator]]" = contextvars.ContextVar(
    "senas_dropout_rng", default=None)


@contextlib.contextmanager
def dropout_stream(stream):
    """The spatial dropout of the ops inside draws from a generator on
    `stream`'s device seeded with its seed (`stream` = (seed, device), or
    None: no generator). The generator is built here, from the call's
    arguments alone, so that a cell recomputed under `remat` draws the masks
    its first forward drew."""
    gen = None
    if stream is not None:
        seed, device = stream
        gen = torch.Generator(device=device).manual_seed(seed)
    token = _DROPOUT_RNG.set(gen)
    try:
        yield
    finally:
        _DROPOUT_RNG.reset(token)


def dropout_streams(rng: torch.Generator, n: int) -> list:
    """`n` cells' dropout streams, drawn from the step's generator `rng` in
    one call (one host read a forward, not one a cell)."""
    seeds = torch.randint(0, 2**62, (n,), generator=rng, device=rng.device).tolist()
    return [(seed, rng.device) for seed in seeds]


def channel_dropout_mask(rng: torch.Generator, shape, keep: float) -> torch.Tensor:
    """The kept channels: bool `shape`, each True with probability `keep`,
    drawn from `rng` on its device."""
    return torch.rand(shape, generator=rng, device=rng.device) < keep


def spatial_dropout(x: torch.Tensor, rate: float, train: bool,
                    rng: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX package's `spatial_dropout` (Dropout2d) of NCHW `x`: in train
    mode each channel of each sample is kept with probability 1 - rate and
    scaled by 1 / (1 - rate) in x's dtype, else zero. The [B, C, 1, 1] mask
    comes from `rng` and moves to x's device, so one generator gives every
    device the same masks. Under a mesh every rank draws the global batch's
    mask and keeps its rows; a spatial rank holds whole channels, so every
    spatial rank of a data index keeps the same mask. Train mode without a
    generator raises, as flax does without a 'dropout' key."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("spatial dropout in train mode needs a generator (the forward's rng=)")
    keep = 1.0 - rate
    mesh = active_mesh()
    b = x.shape[0] if mesh is None else global_rows(x.shape[0])
    mask = channel_dropout_mask(rng, (b, x.shape[1], 1, 1), keep)
    if mesh is not None:
        mask = mask[mesh.rows(b)]
    return torch.where(mask.to(x.device), x / scalar(keep, x),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """flax nn.Dropout: in train mode each element is kept with probability
    1 - rate and scaled by 1 / (1 - rate). The mask is drawn from `rng`, a
    torch.Generator, on the generator's device and moved to x's, so one
    generator gives one mask on every device. It scales in x's dtype, as
    flax does. Train mode without a generator raises, as flax does without
    a 'dropout' key."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False, rng: Optional[torch.Generator] = None):
        if not train or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("Dropout in train mode needs a torch.Generator (rng=)")
        keep = 1.0 - self.rate
        # under a mesh every rank draws the global batch's mask and keeps
        # its own rows and, under a row split, its own image rows: the
        # masks of the single-device step
        mesh, split = active_mesh(), active_split()
        shape = x.shape if mesh is None else (global_rows(x.shape[0]),) + tuple(x.shape[1:])
        rows = split is not None and x.dim() == 4
        if rows:
            shape = shape[:2] + (global_height(x),) + shape[3:]
        mask = torch.rand(shape, generator=rng, device=rng.device) < keep
        if mesh is not None:
            mask = mask[mesh.rows(shape[0])]
        if rows:
            mask = mask[:, :, slice(*split.bounds(shape[2]))]
        # x / keep in x's dtype: bf16(0.8) against a bf16 x, as flax divides
        return torch.where(mask.to(x.device), x / scalar(keep, x),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class SEBlock(nn.Module):
    """Squeeze-and-Excitation, r=16 (the reference's operations.py:186-203)."""

    def __init__(self, c: int, r: int = 16, dtype=None):
        super().__init__()
        mid = c // r if c > r else 1
        self.Dense_0 = Dense(c, mid, dtype=dtype)
        self.Dense_1 = Dense(mid, c, dtype=dtype)

    def forward(self, x):
        y = image_mean(x)  # [B, C]
        y = sigmoid(self.Dense_1(relu(self.Dense_0(y))))
        return x * y[:, :, None, None]


class ConvBnSe(nn.Module):
    """conv -> BN -> SE."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0, dtype=None, dropout: float = 0.0):
        super().__init__()
        self.ConvBn_0 = ConvBn(c_in, c_out, kernel_size, stride, dilation,
                               transpose, output_padding, dtype=dtype, dropout=dropout)
        self.SEBlock_0 = SEBlock(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.SEBlock_0(self.ConvBn_0(x, train))


class DepSepConv(nn.Module):
    """depthwise conv -> BN -> ReLU -> pointwise conv -> BN (each conv
    after its own spatial dropout when `dropout` > 0)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, transpose: bool = False,
                 output_padding: int = 0, dtype=None, dropout: float = 0.0):
        super().__init__()
        self.depth = _ConvWeight(c_in, c_in, kernel_size, stride, dilation,
                                 transpose, output_padding, groups=c_in, dtype=dtype,
                                 dropout=dropout)
        self.depth_norm = BatchNorm(c_in, dtype=dtype)
        self.point = _ConvWeight(c_in, c_out, 1, dtype=dtype, dropout=dropout)
        self.point_norm = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = relu(self.depth_norm(self.depth(x, train), train))
        return self.point_norm(self.point(x, train), train)


class AdapterBlock(nn.Module):
    """Parameterless inner op (zero/identity/pool/upsample) + channel adapter:
    inner -> optional 1x1 conv (if c_in != c_out) -> BN."""

    def __init__(self, c_in: int, c_out: int, mode: str, stride: int = 1, dtype=None):
        super().__init__()
        if mode not in ("none", "identity", "avg_pool", "max_pool", "up_sample"):
            raise ValueError(f"unknown adapter mode {mode!r}")
        self.mode, self.stride, self.dtype = mode, stride, dtype
        if c_in != c_out:
            add_conv_kernel(self, "kernel", (c_out, c_in, 1, 1))
        self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = cast(x, self.dtype)
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
            out = conv2d(out, self.kernel.to(out.dtype))
        return self.BatchNorm_0(out, train)


class RectifyResample(nn.Module):
    """Cell-input resampling: act -> {2x up (bilinear | 1x1 transpose) |
    2x down (avgpool | 1x1 conv)} -> BN. Conv-free when c_in == c_out."""

    def __init__(self, c_in: int, c_out: int, cell_type: str, dtype=None):
        super().__init__()
        self.cell_type, self.dtype = cell_type, dtype
        if c_in != c_out:
            if cell_type == "up":
                add_conv_kernel(self, "kernel", (c_in, c_out, 1, 1))
                self.flax_layout = {"kernel": "hwio_t"}
            else:
                add_conv_kernel(self, "kernel", (c_out, c_in, 1, 1))
        self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = relu(cast(x, self.dtype))
        conv = hasattr(self, "kernel")
        if self.cell_type == "up":
            out = (conv_transpose2d(out, self.kernel.to(out.dtype), stride=2,
                                    output_padding=1, torch_padding=0)
                   if conv else upsample2x(out))
        else:
            out = (conv2d(out, self.kernel.to(out.dtype), stride=2) if conv
                   else avg_pool_3x3(out, stride=2))
        return self.BatchNorm_0(out, train)


class ShrinkBlock(nn.Module):
    """act -> 3x3 conv -> BN: maps grown skip-concat width back down."""

    def __init__(self, c_in: int, c_out: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        add_conv_kernel(self, "kernel", (c_out, c_in, 3, 3))
        self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = relu(cast(x, self.dtype))
        return self.BatchNorm_0(conv2d(x, self.kernel.to(x.dtype)), train)


class RectifyBlock(nn.Module):
    """3x3 conv -> BN: cell expand/post-process."""

    def __init__(self, c_in: int, c_out: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        add_conv_kernel(self, "kernel", (c_out, c_in, 3, 3))
        self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = cast(x, self.dtype)
        return self.BatchNorm_0(conv2d(x, self.kernel.to(x.dtype)), train)


class BasicBlock(nn.Module):
    """ResNet BasicBlock (stem1 building block); no activation after the
    residual sum, as in the JAX package."""

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_downsample: bool = False, dtype=None):
        super().__init__()
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        add_conv_kernel(self, "conv1", (planes, c_in, 3, 3))
        self.bn1 = BatchNorm(planes, dtype=dtype)
        add_conv_kernel(self, "conv2", (planes, planes, 3, 3))
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.use_downsample = use_downsample
        if use_downsample:
            add_conv_kernel(self, "down_conv", (planes, c_in, 1, 1))
            self.down_bn = BatchNorm(planes, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = cast(x, self.dtype)
        out = conv2d(x, self.conv1.to(x.dtype), stride=self.stride, dilation=self.dilation)
        out = relu(self.bn1(out, train))
        out = conv2d(out, self.conv2.to(out.dtype), stride=1, dilation=self.dilation)
        out = self.bn2(out, train)
        residual = x
        if self.use_downsample:
            residual = self.down_bn(conv2d(x, self.down_conv.to(x.dtype), stride=self.stride),
                                    train)
        return out + residual


# ---------------------------------------------------------------------------
# Candidate-op registry (OPS, the reference's operations.py:8-21)
# ---------------------------------------------------------------------------

def make_op(name: str, c_in: int, c_out: int, op_type: OpType,
            dp: float = 0.0, dtype=None) -> nn.Module:
    """Instantiate candidate op `name` with the reference's stride rules:
    NORM -> stride 1; DOWN -> stride-2 conv/pool; UP -> stride-2 transpose
    conv with output_padding 1 (pool ops become bilinear 2x upsample).
    `dp` is the conv ops' spatial-dropout rate (`spatial_dropout` before
    each convolution). `dtype` is the op's compute dtype."""
    stride = 1 if op_type == OpType.NORM else 2
    transpose = op_type == OpType.UP
    op = 1 if op_type == OpType.UP else 0
    kw = dict(dtype=dtype, dropout=dp)
    if name in ("none", "identity", "up_sample"):
        return AdapterBlock(c_in, c_out, mode=name, stride=1, dtype=dtype)
    if name in ("avg_pool", "max_pool"):
        return AdapterBlock(c_in, c_out, mode=name, stride=stride, dtype=dtype)
    if name == "conv_3":
        return ConvBn(c_in, c_out, 3, stride, 1, transpose, op, **kw)
    if name == "se_conv_3":
        return ConvBnSe(c_in, c_out, 3, stride, 1, transpose, op, **kw)
    if name == "dil_3_conv_5":
        return ConvBn(c_in, c_out, 5, stride, 3, transpose, op, **kw)
    if name == "dil_2_conv_5":
        return ConvBn(c_in, c_out, 5, stride, 2, transpose, op, **kw)
    if name == "dep_sep_conv_3":
        return DepSepConv(c_in, c_out, 3, stride, 1, transpose, op, **kw)
    if name == "dep_sep_conv_5":
        return DepSepConv(c_in, c_out, 5, stride, 1, transpose, op, **kw)
    raise NotImplementedError(name)


OPS = {name: partial(make_op, name)
       for name in ("none", "identity", "avg_pool", "max_pool", "up_sample", "conv_3",
                    "se_conv_3", "dil_3_conv_5", "dil_2_conv_5", "dep_sep_conv_3",
                    "dep_sep_conv_5")}
