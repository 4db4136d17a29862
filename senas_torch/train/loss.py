"""Segmentation losses on NHWC logits, in PyTorch.

Port of `senas_tpu/train/loss.py` (numerics of the reference's
utils/loss/loss.py):
  * soft dice: softmax over classes, tp/fp/fn reduced over batch+spatial
    (batch dice), background excluded, smooth 1e-5, extra 1e-8 in the
    denominator; the squared-denominator variant;
  * cross-entropy: mean over all pixels;
  * dice_ce = ce + dice; deep-supervision mean over heads.
All functions take `logits` [B,H,W,C] (or a list of such) and an integer
`target` [B,H,W]. The smp loss family is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, target[..., None].long()).mean()


def _one_hot(target: torch.Tensor, nclass: int, dtype) -> torch.Tensor:
    return F.one_hot(target.long(), nclass).to(dtype)


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                   do_bg: bool = False, smooth: float = 1e-5) -> torch.Tensor:
    x = torch.softmax(logits, dim=-1)
    y = _one_hot(target, logits.shape[-1], x.dtype)
    axes = (0, 1, 2)  # batch + spatial => per-class counts
    tp = (x * y).sum(dim=axes)
    fp = (x * (1 - y)).sum(dim=axes)
    fn = ((1 - x) * y).sum(dim=axes)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth + 1e-8)
    if not do_bg:
        dc = dc[1:]
    return 1 - dc.mean()


def soft_dice_loss_squared(logits: torch.Tensor, target: torch.Tensor,
                           do_bg: bool = False, smooth: float = 1e-5) -> torch.Tensor:
    x = torch.softmax(logits, dim=-1)
    y = _one_hot(target, logits.shape[-1], x.dtype)
    axes = (0, 1, 2)
    intersect = (x * y).sum(dim=axes) + smooth
    denominator = (x ** 2 + y ** 2).sum(dim=axes) + smooth
    dc = 2 * intersect / denominator
    if not do_bg:
        dc = dc[1:]
    return 1 - dc.mean()


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                 square_dice: bool = False) -> torch.Tensor:
    dice = (soft_dice_loss_squared(logits, target) if square_dice
            else soft_dice_loss(logits, target))
    return cross_entropy(logits, target) + dice


_LOSSES = {
    "cross_entropy": cross_entropy,
    "dice_ce": lambda lg, tg: dice_ce_loss(lg, tg, square_dice=False),
    "dice_sq_ce": lambda lg, tg: dice_ce_loss(lg, tg, square_dice=True),
    "dice_loss": soft_dice_loss,
    "dice_square": soft_dice_loss_squared,
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
