"""The legacy semantic-segmentation block library, NCHW.

Port of `senas_tpu/utils/legacy_blocks.py` (the reference's
utils/functional.py: the pytorch-semseg blocks carried along from the
NasUnet skeleton). Nothing of the framework calls them; they are ported
with the JAX package's observable semantics, quirks included:

  * `UnetConv2`, `ResidualConvUnit`, `MultiResolutionFusion` and
    `ChainedResidualPooling` use UNPADDED 3x3 convolutions, so each one
    shrinks a map by 2; `LinknetUp`'s 1x1 convolutions have padding 1
    (each grows a map by 2) and its deconvolution (k 3, s 2, p 0) gives
    2H + 1.
  * `ConvNorm`'s bias exists only when `bias` and `norm is None`.
    `norm="batch"` is the port's `BatchNorm` (through K1a-K1d under
    `SENAS_PALLAS_BN=1`), `norm="group"` flax's `nn.GroupNorm` at its
    defaults: epsilon 1e-6, the output in `dtype`, else in x's dtype
    promoted with f32.
  * A transposed `ConvNorm` is PyTorch's ConvTranspose2d(k, stride,
    padding): the JAX package correlates an unflipped HWIO kernel over
    the lhs-dilated input, the port stores the kernel in ConvTranspose2d's
    layout [I, O, k, k] (spatially flipped; `senas_torch.convert` maps the
    two, layout "hwio_t").
  * SegNet's 2x2 max pool returns the index of each maximum inside its
    window (0..3, row-major, the first one of a tie); the maximum spreads
    a tied window's gradient evenly over its maxima (`torch.amax`, as
    `jnp.max` does). The unpool is a one-hot scatter. An odd H or W raises.
  * Resizes are `jax.image.resize`'s rule (`ops.resize.jax_resize`).

Every module takes the input channels first (flax infers them), then the
JAX module's fields in their order; `forward(..., train)` takes the mode.
The convolutions compute in the input's dtype, as in the JAX package
(`dtype` is the norms' output dtype). Parameters keep the flax names
(`kernel`, `bias`, submodules `bn`, `gn`, `conv1`, ...).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from senas_torch.ops.primitives import (BatchNorm, GroupNorm, add_bias, add_kernel,
                                        conv2d_padded, conv_transpose2d, kaiming_std,
                                        max_pool, relu)
from senas_torch.ops.resize import jax_resize

GROUP_NORM_EPS = 1e-6   # flax nn.GroupNorm's default


class ConvNorm(nn.Module):
    """conv2DBatchNorm / conv2DGroupNorm / their ReLU variants and the
    norm-free case, by flags (the reference's functional.py:6-154)."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 norm: Optional[str] = "batch", n_groups: int = 16, act: bool = False,
                 transpose: bool = False, dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.norm, self.act, self.transpose, self.dtype = norm, act, transpose, dtype
        k = kernel
        # kaiming_normal(fan_out) of flax's (k, k, I, O) kernel: fan O*k*k
        if transpose:
            add_kernel(self, "kernel", (in_channels, filters, k, k), kaiming_std(filters * k * k))
            self.flax_layout = {"kernel": "hwio_t"}
        else:
            add_kernel(self, "kernel", (filters, in_channels, k, k), kaiming_std(filters * k * k))
        if bias and norm is None:
            add_bias(self, "bias", filters)
        if norm == "batch":
            self.bn = BatchNorm(filters, dtype=dtype)
        elif norm == "group":
            self.gn = GroupNorm(filters, n_groups, eps=GROUP_NORM_EPS, dtype=dtype)

    def forward(self, x, train: bool = False):
        w = self.kernel.to(x.dtype)
        if self.transpose:
            x = conv_transpose2d(x, w, stride=self.stride, output_padding=0,
                                 torch_padding=self.padding)
        else:
            x = conv2d_padded(x, w, (self.padding, self.padding), stride=self.stride,
                              dilation=self.dilation)
        if hasattr(self, "bias"):
            x = x + self.bias.to(x.dtype)[:, None, None]
        if self.norm == "batch":
            x = self.bn(x, train)
        elif self.norm == "group":
            x = self.gn(x if self.dtype is not None
                        else x.to(torch.promote_types(x.dtype, torch.float32)))
        return relu(x) if self.act else x


class UnetConv2(nn.Module):
    """unetConv2 (functional.py:177-203): two UNPADDED 3x3 convs."""

    def __init__(self, in_channels: int, filters: int, is_batchnorm: bool = True, dtype=None):
        super().__init__()
        norm = "batch" if is_batchnorm else None
        self.conv1 = ConvNorm(in_channels, filters, 3, norm=norm, act=True, dtype=dtype)
        self.conv2 = ConvNorm(filters, filters, 3, norm=norm, act=True, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.conv2(self.conv1(x, train), train)


def _bilinear_resize(x, hw: Tuple[int, int]):
    return jax_resize(x, hw, "bilinear")


class UnetUp(nn.Module):
    """unetUp (functional.py:204-218): upsample the low-res input, pad the
    skip by the height difference on both axes, concat [skip, x],
    UnetConv2 without norm. `skip_channels` is the skip's channels (flax
    infers them)."""

    def __init__(self, in_channels: int, skip_channels: int, filters: int,
                 is_deconv: bool = True, dtype=None):
        super().__init__()
        self.is_deconv = is_deconv
        if is_deconv:
            self.up = ConvNorm(in_channels, filters, 2, stride=2, norm=None, bias=True,
                               transpose=True, dtype=dtype)
        up_c = filters if is_deconv else in_channels
        self.conv = UnetConv2(skip_channels + up_c, filters, is_batchnorm=False, dtype=dtype)

    def forward(self, skip, x, train: bool = False):
        if self.is_deconv:
            x = self.up(x, train)
        else:
            x = _bilinear_resize(x, (x.shape[2] * 2, x.shape[3] * 2))
        off = x.shape[2] - skip.shape[2]
        pad = off // 2
        skip = F.pad(skip, (pad, off - pad, pad, off - pad))
        return self.conv(torch.cat([skip, x], dim=1), train)


# ---------------------------------------------------------------------------
# SegNet: argmax pooling + unpooling
# ---------------------------------------------------------------------------

def max_pool_argmax_2x2(x):
    """MaxPool2d(2, 2, return_indices=True) of x [B, C, H, W]: (pooled, the
    window-local index 0..3 of each maximum, int64)."""
    b, c, h, w = x.shape
    wnd = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    wnd = wnd.reshape(b, c, h // 2, w // 2, 4)
    return torch.amax(wnd, dim=4), torch.argmax(wnd, dim=4)


def max_unpool_2x2(x, idx, out_hw: Tuple[int, int]):
    """Inverse of max_pool_argmax_2x2: one-hot scatter into 2x2 windows,
    cut to `out_hw`."""
    b, c, h, w = x.shape
    wnd = F.one_hot(idx, 4).to(x.dtype) * x[..., None]          # [B, C, h, w, 4]
    wnd = wnd.reshape(b, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5)
    full = wnd.reshape(b, c, h * 2, w * 2)
    return full[:, :, : out_hw[0], : out_hw[1]]


class SegnetDown(nn.Module):
    """segnetDown2/3 (functional.py:221-251): n padded conv-bn-relu, then
    the argmax pool. Returns (pooled, indices, the unpooled (H, W))."""

    def __init__(self, in_channels: int, filters: int, n_convs: int = 2, dtype=None):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            setattr(self, f"conv{i + 1}", ConvNorm(in_channels if i == 0 else filters, filters,
                                                   3, padding=1, norm="batch", act=True,
                                                   dtype=dtype))

    def forward(self, x, train: bool = False):
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i + 1}")(x, train)
        shape = (x.shape[2], x.shape[3])
        pooled, idx = max_pool_argmax_2x2(x)
        return pooled, idx, shape


class SegnetUp(nn.Module):
    """segnetUp2/3 (functional.py:253-281): unpool, then n conv-bn-relu."""

    def __init__(self, in_channels: int, filters: int, n_convs: int = 2, dtype=None):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            setattr(self, f"conv{i + 1}", ConvNorm(in_channels if i == 0 else filters, filters,
                                                   3, padding=1, norm="batch", act=True,
                                                   dtype=dtype))

    def forward(self, x, idx, out_hw, train: bool = False):
        x = max_unpool_2x2(x, idx, out_hw)
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i + 1}")(x, train)
        return x


# ---------------------------------------------------------------------------
# Residual / LinkNet / FRRN / RefineNet / PSP families
# ---------------------------------------------------------------------------

class ResidualBlock(nn.Module):
    """residualBlock (functional.py:283-309): 3x3(s)+3x3 with a 1x1
    shortcut."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1, dtype=None):
        super().__init__()
        self.convbnrelu1 = ConvNorm(in_channels, filters, 3, stride=stride, padding=1,
                                    bias=False, act=True, dtype=dtype)
        self.convbn2 = ConvNorm(filters, filters, 3, padding=1, bias=False, dtype=dtype)
        self.shortcut = ConvNorm(in_channels, filters, 1, stride=stride, bias=False,
                                 dtype=dtype)

    def forward(self, x, train: bool = False):
        y = self.convbn2(self.convbnrelu1(x, train), train)
        return relu(y + self.shortcut(x, train))


class ResidualBottleneck(nn.Module):
    """residualBottleneck (functional.py:311-341): 1x1 -> 3x3 -> 1x1*4."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1, dtype=None):
        super().__init__()
        self.convbn1 = ConvNorm(in_channels, filters, 1, bias=False, act=True, dtype=dtype)
        self.convbn2 = ConvNorm(filters, filters, 3, stride=stride, padding=1, bias=False,
                                act=True, dtype=dtype)
        self.convbn3 = ConvNorm(filters, filters * 4, 1, bias=False, dtype=dtype)
        self.shortcut = ConvNorm(in_channels, filters * 4, 1, stride=stride, bias=False,
                                 dtype=dtype)

    def forward(self, x, train: bool = False):
        y = self.convbn3(self.convbn2(self.convbn1(x, train), train), train)
        return relu(y + self.shortcut(x, train))


class LinknetUp(nn.Module):
    """linknetUp (functional.py:343-367): 1x1 C/2 (padding 1) -> deconv
    3x3 s2 -> 1x1 C (padding 1)."""

    def __init__(self, in_channels: int, filters: int, dtype=None):
        super().__init__()
        half = filters // 2
        self.convbnrelu1 = ConvNorm(in_channels, half, 1, padding=1, act=True, dtype=dtype)
        self.deconvbnrelu2 = ConvNorm(half, half, 3, stride=2, act=True, transpose=True,
                                      dtype=dtype)
        self.convbnrelu3 = ConvNorm(half, filters, 1, padding=1, act=True, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = self.deconvbnrelu2(self.convbnrelu1(x, train), train)
        return self.convbnrelu3(x, train)


FRRN_RESIDUAL_CHANNELS = 32   # the full-resolution stream z


class FRRU(nn.Module):
    """Full-Resolution Residual Unit (functional.py:369-419): y the pooled
    stream (`in_channels`), z the full-resolution residual stream (32
    channels)."""

    def __init__(self, in_channels: int, filters: int, scale: int, group_norm: bool = False,
                 n_groups: int = 16, dtype=None):
        super().__init__()
        self.scale = scale
        norm = "group" if group_norm else "batch"
        kw = dict(padding=1, bias=False, norm=norm, n_groups=n_groups, act=True, dtype=dtype)
        self.conv1 = ConvNorm(in_channels + FRRN_RESIDUAL_CHANNELS, filters, 3, **kw)
        self.conv2 = ConvNorm(filters, filters, 3, **kw)
        self.conv_res = ConvNorm(filters, FRRN_RESIDUAL_CHANNELS, 1, norm=None, bias=True,
                                 dtype=dtype)

    def forward(self, y, z, train: bool = False):
        s = self.scale
        zp = max_pool(z, s, s)                                   # 'VALID' windows
        x = self.conv1(torch.cat([y, zp], dim=1), train)
        y_prime = self.conv2(x, train)
        r = self.conv_res(y_prime, train)
        r = r.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)   # nearest
        return y_prime, z + r


class RU(nn.Module):
    """Residual Unit for FRRN (functional.py:421-455)."""

    def __init__(self, in_channels: int, filters: int, group_norm: bool = False,
                 n_groups: int = 16, dtype=None):
        super().__init__()
        norm = "group" if group_norm else "batch"
        kw = dict(padding=1, bias=False, norm=norm, n_groups=n_groups, dtype=dtype)
        self.conv1 = ConvNorm(in_channels, filters, 3, act=True, **kw)
        self.conv2 = ConvNorm(filters, filters, 3, **kw)

    def forward(self, x, train: bool = False):
        return x + self.conv2(self.conv1(x, train), train)


def _crop_add(y, x):
    crop = (x.shape[2] - y.shape[2]) // 2
    return y + x[:, :, crop: crop + y.shape[2], crop: crop + y.shape[3]]


class ResidualConvUnit(nn.Module):
    """residualConvUnit (functional.py:457-472): relu-conv-relu-conv
    (UNPADDED) + the centre crop of the input."""

    def __init__(self, channels: int, kernel: int = 3, dtype=None):
        super().__init__()
        self.conv1 = ConvNorm(channels, channels, kernel, norm=None, bias=True, dtype=dtype)
        self.conv2 = ConvNorm(channels, channels, kernel, norm=None, bias=True, dtype=dtype)

    def forward(self, x, train: bool = False):
        y = self.conv2(relu(self.conv1(relu(x), train)), train)
        return _crop_add(y, x)


class MultiResolutionFusion(nn.Module):
    """multiResolutionFusion (functional.py:474-499): an unpadded 3x3 conv
    of each input, bilinear-upsampled by its scale, summed. `conv_low`
    exists with `low_channels` (flax makes it when the low input is
    given)."""

    def __init__(self, high_channels: int, filters: int, up_scale_high: int,
                 up_scale_low: int, low_channels: Optional[int] = None, dtype=None):
        super().__init__()
        self.up_scale_high, self.up_scale_low = up_scale_high, up_scale_low
        self.conv_high = ConvNorm(high_channels, filters, 3, norm=None, bias=True, dtype=dtype)
        if low_channels is not None:
            self.conv_low = ConvNorm(low_channels, filters, 3, norm=None, bias=True,
                                     dtype=dtype)

    def forward(self, x_high, x_low=None, train: bool = False):
        h = self.conv_high(x_high, train)
        h = _bilinear_resize(h, (h.shape[2] * self.up_scale_high,
                                 h.shape[3] * self.up_scale_high))
        if x_low is None:
            return h
        low = self.conv_low(x_low, train)
        low = _bilinear_resize(low, (low.shape[2] * self.up_scale_low,
                                     low.shape[3] * self.up_scale_low))
        return h + low


class ChainedResidualPooling(nn.Module):
    """chainedResidualPooling (functional.py:501-515): relu -> max pool (5,
    stride 1, pad 2 of -inf) -> unpadded 3x3 conv, + the cropped input."""

    def __init__(self, in_channels: int, filters: int, dtype=None):
        super().__init__()
        self.conv = ConvNorm(in_channels, filters, 3, norm=None, bias=True, dtype=dtype)

    def forward(self, x, train: bool = False):
        y = self.conv(max_pool(relu(x), 5, 1, 2), train)
        return _crop_add(y, x)


class BottleNeckPSP(nn.Module):
    """bottleNeckPSP (functional.py:592-654): a dilated bottleneck with a
    projected shortcut; dilation > 1 replaces the stride of cbr2."""

    def __init__(self, in_channels: int, mid: int, filters: int, stride: int = 1,
                 dilation: int = 1, dtype=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype)
        self.cbr1 = ConvNorm(in_channels, mid, 1, act=True, **kw)
        if dilation > 1:
            self.cbr2 = ConvNorm(mid, mid, 3, padding=dilation, dilation=dilation, act=True,
                                 **kw)
        else:
            self.cbr2 = ConvNorm(mid, mid, 3, stride=stride, padding=1, act=True, **kw)
        self.cb3 = ConvNorm(mid, filters, 1, **kw)
        self.cb4 = ConvNorm(in_channels, filters, 1, stride=stride if dilation == 1 else 1,
                            **kw)

    def forward(self, x, train: bool = False):
        y = self.cb3(self.cbr2(self.cbr1(x, train), train), train)
        return relu(y + self.cb4(x, train))


class BottleNeckIdentifyPSP(nn.Module):
    """bottleNeckIdentifyPSP (functional.py:656-707): identity residual."""

    def __init__(self, channels: int, mid: int, dilation: int = 1, dtype=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype)
        self.cbr1 = ConvNorm(channels, mid, 1, act=True, **kw)
        self.cbr2 = ConvNorm(mid, mid, 3, padding=dilation, dilation=dilation, act=True, **kw)
        self.cb3 = ConvNorm(mid, channels, 1, **kw)

    def forward(self, x, train: bool = False):
        y = self.cb3(self.cbr2(self.cbr1(x, train), train), train)
        return relu(x + y)


class ResidualBlockPSP(nn.Module):
    """residualBlockPSP (functional.py:709-751): one BottleNeckPSP, then
    n_blocks - 1 identity bottlenecks."""

    def __init__(self, in_channels: int, n_blocks: int, mid: int, filters: int,
                 stride: int = 1, dilation: int = 1, dtype=None):
        super().__init__()
        self.n_blocks = n_blocks
        self.block1 = BottleNeckPSP(in_channels, mid, filters, stride, dilation, dtype=dtype)
        for i in range(n_blocks - 1):
            setattr(self, f"block{i + 2}", BottleNeckIdentifyPSP(filters, mid, dilation,
                                                                 dtype=dtype))

    def forward(self, x, train: bool = False):
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i + 1}")(x, train)
        return x


class CascadeFeatureFusion(nn.Module):
    """cascadeFeatureFusion (functional.py:753-802, ICNet): the low input
    upsampled 2x, a dilated 3x3 on it + a 1x1 on the high one, summed and
    rectified; also the low-res class logits of the auxiliary loss."""

    def __init__(self, n_classes: int, low_channels: int, high_channels: int, filters: int,
                 dtype=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype)
        self.low_dilated = ConvNorm(low_channels, filters, 3, padding=2, dilation=2, **kw)
        self.high_proj = ConvNorm(high_channels, filters, 1, **kw)
        self.low_cls = ConvNorm(low_channels, n_classes, 1, norm=None, bias=True, dtype=dtype)

    def forward(self, x_low, x_high, train: bool = False):
        x_low = _bilinear_resize(x_low, (x_low.shape[2] * 2, x_low.shape[3] * 2))
        low = self.low_dilated(x_low, train)
        high = self.high_proj(x_high, train)
        return relu(low + high), self.low_cls(x_low, train)


# ---------------------------------------------------------------------------
# interp helpers (functional.py:804-848)
# ---------------------------------------------------------------------------

def get_interp_size(x, s_factor: int = 1, z_factor: int = 1) -> Tuple[int, int]:
    """Caffe-style interp size arithmetic (functional.py:804-817) of an
    NCHW map."""
    h, w = x.shape[2], x.shape[3]
    h = (h - 1) // s_factor + 1
    w = (w - 1) // s_factor + 1
    h = h + (h - 1) * (z_factor - 1)
    w = w + (w - 1) * (z_factor - 1)
    return h, w


def interp(x, size: Tuple[int, int], mode: str = "bilinear"):
    """x resized to `size` by `jax.image.resize`'s rule for `mode`."""
    return jax_resize(x, size, mode)


def get_upsampling_weight(in_channels: int, out_channels: int,
                          kernel_size: int) -> torch.Tensor:
    """Bilinear deconv initializer (functional.py:835-848) in the layout of
    a transposed `ConvNorm`'s kernel, [in, out, k, k] (the JAX package
    returns flax's HWIO; the filter is symmetric, so the flip between the
    two layouts leaves it as it is)."""
    factor = (kernel_size + 1) // 2
    center = factor - 1 if kernel_size % 2 == 1 else factor - 0.5
    og = torch.arange(kernel_size, dtype=torch.float32)
    line = 1 - (og - center).abs() / factor
    filt = line[:, None] * line[None, :]
    w = torch.zeros(in_channels, out_channels, kernel_size, kernel_size)
    n = min(in_channels, out_channels)
    w[torch.arange(n), torch.arange(n)] = filt
    return w
