"""Segmentation losses on NHWC logits, in PyTorch.

Port of `senas_tpu/train/loss.py` (numerics of the reference's
utils/loss/loss.py):
  * soft dice: softmax over classes, tp/fp/fn reduced over batch+spatial
    (batch dice), background excluded, smooth 1e-5, extra 1e-8 in the
    denominator; the squared-denominator variant;
  * cross-entropy: mean over all pixels;
  * dice_ce = ce + dice; deep-supervision mean over heads.
  * the smp family (`train/smp_losses.py`) under the names smp_dice,
    smp_jaccard, smp_tversky, smp_focal, smp_lovasz and smp_soft_ce,
    multiclass on the logits, with senas_tpu's hyperparameters.
All functions take `logits` [B,H,W,C] (or a list of such) and an integer
`target` [B,H,W].

bf16 logits are taken as they are, and the loss is bf16, as in the JAX
package. There its softmax, log-softmax and mean are jnp ops that round to
bf16 one by one (the exps and a mean's terms summed in f32); PyTorch's
fused softmax and log-softmax round once, so in bf16 the softmax,
log-softmax and mean of `ops/primitives.py` repeat the JAX package's ops.
In f32 and f64 they are PyTorch's own.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from senas_torch.ops.primitives import log_softmax, mean_all, softmax
from senas_torch.train import smp_losses


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood; a label outside [0, C) follows
    `jnp.take_along_axis` (`smp_losses.take_class`): -1 is the last class,
    others give NaN."""
    logp = log_softmax(logits)
    return -mean_all(smp_losses.take_class(logp, target)[..., None])


def _one_hot(target: torch.Tensor, nclass: int, dtype) -> torch.Tensor:
    # jax.nn.one_hot: zeros for a label outside [0, nclass)
    return smp_losses.one_hot(target, nclass, dtype)


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                   do_bg: bool = False, smooth: float = 1e-5) -> torch.Tensor:
    x = softmax(logits)
    y = _one_hot(target, logits.shape[-1], x.dtype)
    axes = (0, 1, 2)  # batch + spatial => per-class counts
    tp = (x * y).sum(dim=axes)
    fp = (x * (1 - y)).sum(dim=axes)
    fn = ((1 - x) * y).sum(dim=axes)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth + 1e-8)
    if not do_bg:
        dc = dc[1:]
    return 1 - mean_all(dc)


def soft_dice_loss_squared(logits: torch.Tensor, target: torch.Tensor,
                           do_bg: bool = False, smooth: float = 1e-5) -> torch.Tensor:
    x = softmax(logits)
    y = _one_hot(target, logits.shape[-1], x.dtype)
    axes = (0, 1, 2)
    intersect = (x * y).sum(dim=axes) + smooth
    denominator = (x ** 2 + y ** 2).sum(dim=axes) + smooth
    dc = 2 * intersect / denominator
    if not do_bg:
        dc = dc[1:]
    return 1 - mean_all(dc)


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                 square_dice: bool = False) -> torch.Tensor:
    dice = (soft_dice_loss_squared(logits, target) if square_dice
            else soft_dice_loss(logits, target))
    return cross_entropy(logits, target) + dice


def _smp(cls, with_mode: bool = True, **kw):
    """An smp loss on multiclass NHWC logits and an int label map."""
    return cls(mode="multiclass", **kw) if with_mode else cls(**kw)


_LOSSES = {
    "cross_entropy": cross_entropy,
    "dice_ce": lambda lg, tg: dice_ce_loss(lg, tg, square_dice=False),
    "dice_sq_ce": lambda lg, tg: dice_ce_loss(lg, tg, square_dice=True),
    "dice_loss": soft_dice_loss,
    "dice_square": soft_dice_loss_squared,
    # smp family (segmentation_models_pytorch/losses; senas_tpu/train/loss.py:91-96)
    "smp_dice": _smp(smp_losses.DiceLoss),
    "smp_jaccard": _smp(smp_losses.JaccardLoss),
    "smp_tversky": _smp(smp_losses.TverskyLoss, alpha=0.3, beta=0.7),
    "smp_focal": _smp(smp_losses.FocalLoss, alpha=0.25),
    "smp_lovasz": _smp(smp_losses.LovaszLoss),
    "smp_soft_ce": _smp(smp_losses.SoftCrossEntropyLoss, with_mode=False, smooth_factor=0.1),
}


def segmentation_loss(name: str, outputs, target: torch.Tensor) -> torch.Tensor:
    """Applies the loss to the LAST head."""
    if isinstance(outputs, (list, tuple)):
        outputs = outputs[-1]
    return _LOSSES[name](outputs, target)


def multi_segmentation_loss(name: str, outputs: Sequence[torch.Tensor],
                            target: torch.Tensor) -> torch.Tensor:
    """Deep-supervision mean over heads."""
    fn = _LOSSES[name]
    return sum(fn(ot, target) for ot in outputs) / len(outputs)


def build_loss(name: str, supervision: bool = False) -> Callable:
    """Loss factory for the names the search configs use."""
    if name not in _LOSSES:
        raise NotImplementedError(f"loss {name!r}")
    if supervision:
        return lambda outputs, target: multi_segmentation_loss(name, outputs, target)
    return lambda outputs, target: segmentation_loss(name, outputs, target)
