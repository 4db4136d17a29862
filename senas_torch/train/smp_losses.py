"""The smp segmentation loss family in PyTorch, on NHWC inputs.

Port of `senas_tpu/train/smp_losses.py` (the reference's vendored
segmentation_models_pytorch/losses: dice, jaccard, tversky, focal, lovasz,
soft_bce, soft_ce and the _functional score helpers). Same math, the same
defaults and non-empty-class masking, and senas_tpu's layout and masks:
y_pred is NHWC ([B,H,W,C]), and ignore_index is applied with masks rather
than by boolean indexing, so each loss keeps static shapes.

Modes: "binary" (y_pred [B,H,W] or [B,H,W,1]), "multiclass" (y_pred
[B,H,W,C], y_true int [B,H,W]) and "multilabel" (y_pred and y_true
[B,H,W,C]).

On bf16 inputs the log-softmax and the means round op by op, as jax.nn's
and jnp's do (`ops/primitives.py`), so a bf16 loss equals the JAX
package's.

The Lovasz losses sort their errors (stable, descending, as jnp.argsort of
the negated errors). Their value does not depend on the order within ties;
their gradient does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from senas_torch.ops.primitives import log_softmax, mean_all, scalar, softmax

BINARY_MODE = "binary"
MULTICLASS_MODE = "multiclass"
MULTILABEL_MODE = "multilabel"
_MODES = (BINARY_MODE, MULTICLASS_MODE, MULTILABEL_MODE)


# ---------------------------------------------------------------------------
# Score helpers (_functional.py:153-194)
# ---------------------------------------------------------------------------

def _sum(x, axis):
    return x.sum() if axis is None else x.sum(dim=axis)


def soft_dice_score(output, target, smooth=0.0, eps=1e-7, axis=None):
    intersection = _sum(output * target, axis)
    cardinality = _sum(output + target, axis)
    return (2.0 * intersection + smooth) / (cardinality + smooth).clamp_min(eps)


def soft_jaccard_score(output, target, smooth=0.0, eps=1e-7, axis=None):
    intersection = _sum(output * target, axis)
    cardinality = _sum(output + target, axis)
    union = cardinality - intersection
    return (intersection + smooth) / (union + smooth).clamp_min(eps)


def soft_tversky_score(output, target, alpha, beta, smooth=0.0, eps=1e-7, axis=None):
    tp = _sum(output * target, axis)
    fp = _sum(output * (1.0 - target), axis)
    fn = _sum((1.0 - output) * target, axis)
    # alpha and beta in the scores' dtype, as JAX's weak-typed floats are
    return (tp + smooth) / (tp + scalar(alpha, fp) * fp + scalar(beta, fn) * fn
                            + smooth).clamp_min(eps)


# ---------------------------------------------------------------------------
# Layout: (y_pred, y_true) to [B, C, P] each (dice.py:73-105), from NHWC.
# ---------------------------------------------------------------------------

def one_hot(labels: torch.Tensor, c: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: a row of zeros for a label outside [0, c), such as
    the void label -1 of ADE20K (F.one_hot raises on it)."""
    return (labels[..., None] == torch.arange(c, device=labels.device)).to(dtype)


def take_class(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """`jnp.take_along_axis(values, labels[..., None], -1)[..., 0]` with
    JAX's index rule: a label in [-C, -1] counts as label + C, any other
    label outside [0, C) gives NaN (and no gradient). `gather` would raise
    on the CPU and assert on the card."""
    c = values.shape[-1]
    labels = labels.long()
    idx = torch.where(labels < 0, labels + c, labels)
    valid = (idx >= 0) & (idx < c)
    got = values.gather(-1, torch.where(valid, idx, torch.zeros_like(idx))[..., None])[..., 0]
    return torch.where(valid, got, torch.full((), float("nan"), dtype=got.dtype,
                                               device=got.device))


def _flatten(mode: str, y_pred, y_true, from_logits: bool, ignore_index: Optional[int]):
    if mode == BINARY_MODE:
        if y_pred.ndim == 4 and y_pred.shape[-1] == 1:
            y_pred = y_pred[..., 0]
        if y_true.ndim == 4 and y_true.shape[-1] == 1:
            y_true = y_true[..., 0]
        if from_logits:
            y_pred = torch.exp(F.logsigmoid(y_pred))
        b = y_pred.shape[0]
        y_pred = y_pred.reshape(b, 1, -1)
        y_true = y_true.reshape(b, 1, -1).to(y_pred.dtype)
        if ignore_index is not None:
            mask = (y_true != ignore_index).to(y_pred.dtype)
            y_pred, y_true = y_pred * mask, y_true * mask
        return y_pred, y_true

    if mode == MULTICLASS_MODE:
        if from_logits:
            y_pred = torch.exp(log_softmax(y_pred))
        b, c = y_pred.shape[0], y_pred.shape[-1]
        y_pred = y_pred.reshape(b, -1, c).transpose(1, 2)           # [B, C, P]
        y_true = y_true.reshape(b, -1).long()
        if ignore_index is not None:
            mask = (y_true != ignore_index)
            y_pred = y_pred * mask[:, None].to(y_pred.dtype)
            oh = one_hot(torch.where(mask, y_true, 0), c, y_pred.dtype)
            y_true = oh.transpose(1, 2) * mask[:, None].to(y_pred.dtype)
        else:
            y_true = one_hot(y_true, c, y_pred.dtype).transpose(1, 2)
        return y_pred, y_true

    if mode == MULTILABEL_MODE:
        if from_logits:
            y_pred = torch.exp(F.logsigmoid(y_pred))
        b, c = y_pred.shape[0], y_pred.shape[-1]
        y_pred = y_pred.reshape(b, -1, c).transpose(1, 2)
        y_true = y_true.reshape(b, -1, c).transpose(1, 2).to(y_pred.dtype)
        if ignore_index is not None:
            mask = (y_true != ignore_index).to(y_pred.dtype)
            y_pred, y_true = y_pred * mask, y_true * mask
        return y_pred, y_true

    raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")


# ---------------------------------------------------------------------------
# Dice / Jaccard / Tversky (dice.py:12-131, jaccard.py, tversky.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiceLoss:
    mode: str = MULTICLASS_MODE
    classes: Optional[Tuple[int, ...]] = None
    log_loss: bool = False
    from_logits: bool = True
    smooth: float = 0.0
    ignore_index: Optional[int] = None
    eps: float = 1e-7

    def _score(self, y_pred, y_true, axis):
        return soft_dice_score(y_pred, y_true, self.smooth, self.eps, axis)

    def _aggregate(self, loss):
        return loss.mean()

    def __call__(self, y_pred, y_true):
        y_pred, y_true = _flatten(self.mode, y_pred, y_true, self.from_logits,
                                  self.ignore_index)
        axis = (0, 2)
        scores = self._score(y_pred, y_true, axis)
        if self.log_loss:
            loss = -torch.log(scores.clamp_min(self.eps))
        else:
            loss = 1.0 - scores
        # zero the channels without any true pixel (dice.py:117-121)
        loss = loss * (y_true.sum(dim=axis) > 0).to(loss.dtype)
        if self.classes is not None:
            loss = loss[torch.as_tensor(self.classes, device=loss.device)]
        return self._aggregate(loss)


@dataclasses.dataclass(frozen=True)
class JaccardLoss(DiceLoss):
    def _score(self, y_pred, y_true, axis):
        return soft_jaccard_score(y_pred, y_true, self.smooth, self.eps, axis)


@dataclasses.dataclass(frozen=True)
class TverskyLoss(DiceLoss):
    alpha: float = 0.5
    beta: float = 0.5
    gamma: float = 1.0

    def _score(self, y_pred, y_true, axis):
        return soft_tversky_score(y_pred, y_true, self.alpha, self.beta,
                                  self.smooth, self.eps, axis)

    def _aggregate(self, loss):
        return loss.mean() ** self.gamma


# ---------------------------------------------------------------------------
# Focal (focal.py, _functional.py:36-97)
# ---------------------------------------------------------------------------

def focal_loss_with_logits(output, target, gamma=2.0, alpha=0.25, reduction="mean",
                           normalized=False, reduced_threshold=None, eps=1e-6, valid=None):
    """Binary focal loss; `valid` masks ignored pixels (the reference drops
    them by boolean indexing)."""
    target = target.to(output.dtype)
    # BCE with logits, elementwise
    logpt = output.clamp_min(0) - output * target + torch.log1p(torch.exp(-output.abs()))
    pt = torch.exp(-logpt)
    if reduced_threshold is None:
        focal_term = (1.0 - pt) ** gamma
    else:
        focal_term = torch.where(pt < reduced_threshold, torch.ones_like(pt),
                                 ((1.0 - pt) / reduced_threshold) ** gamma)
    loss = focal_term * logpt
    if alpha is not None:
        loss = loss * (alpha * target + (1 - alpha) * (1 - target))
    if valid is not None:
        loss = loss * valid
        focal_term = focal_term * valid
    if normalized:
        loss = loss / focal_term.sum().clamp_min(eps)
    if reduction == "mean":
        if valid is not None:
            return loss.sum() / valid.sum().clamp_min(1.0)
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "batchwise_mean":
        return loss.sum(0)
    return loss


@dataclasses.dataclass(frozen=True)
class FocalLoss:
    mode: str = MULTICLASS_MODE
    alpha: Optional[float] = None
    gamma: float = 2.0
    ignore_index: Optional[int] = None
    reduction: str = "mean"
    normalized: bool = False
    reduced_threshold: Optional[float] = None

    def __call__(self, y_pred, y_true):
        kw = dict(gamma=self.gamma, alpha=self.alpha, reduction=self.reduction,
                  normalized=self.normalized, reduced_threshold=self.reduced_threshold)
        if self.mode in (BINARY_MODE, MULTILABEL_MODE):
            yp, yt = y_pred.reshape(-1), y_true.reshape(-1)
            valid = None
            if self.ignore_index is not None:
                valid = (yt != self.ignore_index).to(yp.dtype)
                yt = torch.where(yt == self.ignore_index, torch.zeros_like(yt), yt)
            return focal_loss_with_logits(yp, yt, valid=valid, **kw)
        # multiclass: a binary focal loss per class, summed (focal.py:72-89)
        valid = None
        if self.ignore_index is not None:
            valid = (y_true != self.ignore_index).to(y_pred.dtype).reshape(-1)
        total = 0.0
        for cls in range(y_pred.shape[-1]):
            cls_true = (y_true == cls).to(y_pred.dtype).reshape(-1)
            total = total + focal_loss_with_logits(y_pred[..., cls].reshape(-1), cls_true,
                                                   valid=valid, **kw)
        return total


# ---------------------------------------------------------------------------
# SoftBCE / SoftCE (soft_bce.py, soft_ce.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SoftBCEWithLogitsLoss:
    ignore_index: Optional[int] = -100
    reduction: str = "mean"
    smooth_factor: Optional[float] = None
    pos_weight: Optional[float] = None

    def __call__(self, y_pred, y_true):
        y_true = y_true.to(y_pred.dtype)
        if self.smooth_factor is not None:
            soft = (1 - y_true) * self.smooth_factor + y_true * (1 - self.smooth_factor)
        else:
            soft = y_true
        logpt = (y_pred.clamp_min(0) - y_pred * soft
                 + torch.log1p(torch.exp(-y_pred.abs())))
        if self.pos_weight is not None:
            # BCEWithLogits pos_weight: a weight on the positive term
            logpt = -(self.pos_weight * soft * F.logsigmoid(y_pred)
                      + (1 - soft) * F.logsigmoid(-y_pred))
        if self.ignore_index is not None:
            logpt = logpt * (y_true != self.ignore_index).to(logpt.dtype)
        if self.reduction == "mean":
            return logpt.mean()
        if self.reduction == "sum":
            return logpt.sum()
        return logpt


@dataclasses.dataclass(frozen=True)
class SoftCrossEntropyLoss:
    reduction: str = "mean"
    smooth_factor: Optional[float] = None
    ignore_index: Optional[int] = -100

    def __call__(self, y_pred, y_true):
        """y_pred [B,H,W,C] logits; y_true [B,H,W] int."""
        lprobs = log_softmax(y_pred)
        y_true = y_true.long()
        pad = None
        tgt = y_true
        if self.ignore_index is not None:
            pad = y_true == self.ignore_index
            tgt = torch.where(pad, torch.zeros_like(y_true), y_true)
        nll = -take_class(lprobs, tgt)
        smooth = -lprobs.sum(dim=-1)
        if pad is not None:
            nll = torch.where(pad, torch.zeros_like(nll), nll)
            smooth = torch.where(pad, torch.zeros_like(smooth), smooth)
        if self.reduction == "mean":
            nll, smooth = mean_all(nll), mean_all(smooth)
        elif self.reduction == "sum":
            nll, smooth = nll.sum(), smooth.sum()
        eps = self.smooth_factor or 0.0
        # the weights in the loss's dtype, as JAX's weak-typed floats are
        return (scalar(1.0 - eps, nll) * nll
                + scalar(eps / y_pred.shape[-1], smooth) * smooth)


# ---------------------------------------------------------------------------
# Lovasz (lovasz.py:22-139)
# ---------------------------------------------------------------------------

def _descending(errors):
    """The order that sorts `errors` descending, stable (jnp.argsort(-e))."""
    return torch.sort(-errors, stable=True).indices


def _jaccard_steps(jaccard):
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def _lovasz_grad(gt_sorted):
    """Gradient of the Lovasz extension w.r.t. sorted errors (Alg. 1)."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    return _jaccard_steps(1.0 - intersection / union)


def _lovasz_hinge_flat(logits, labels, valid=None):
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits * signs
    if valid is not None:
        # ignored pixels sort last and contribute zero
        errors = torch.where(valid > 0, errors, torch.full_like(errors, -torch.inf))
    order = _descending(errors)
    errors_sorted, gt_sorted = errors[order], labels[order]
    if valid is not None:
        v_sorted = valid[order]
        gts = (gt_sorted * v_sorted).sum()
        intersection = gts - torch.cumsum(gt_sorted * v_sorted, 0)
        union = gts + torch.cumsum((1.0 - gt_sorted) * v_sorted, 0)
        grad = _jaccard_steps(1.0 - intersection / union.clamp_min(1e-12))
        return torch.dot(F.relu(errors_sorted) * v_sorted, grad)
    return torch.dot(F.relu(errors_sorted), _lovasz_grad(gt_sorted))


def _lovasz_softmax_flat(probas, labels, valid=None):
    """probas [P, C], labels [P] int; the mean over the present classes."""
    losses, present = [], []
    for cls in range(probas.shape[1]):
        fg = (labels == cls).to(probas.dtype)
        if valid is not None:
            fg = fg * valid
        errors = (fg - probas[:, cls]).abs()
        if valid is not None:
            errors = torch.where(valid > 0, errors, torch.full_like(errors, -torch.inf))
        order = _descending(errors)
        errors_sorted, fg_sorted = errors[order], fg[order]
        if valid is not None:
            v_sorted = valid[order]
            gts = fg_sorted.sum()
            inter = gts - torch.cumsum(fg_sorted, 0)
            union = gts + torch.cumsum((1.0 - fg_sorted) * v_sorted, 0)
            grad = _jaccard_steps(1.0 - inter / union.clamp_min(1e-12))
            losses.append(torch.dot(torch.where(v_sorted > 0, errors_sorted,
                                                torch.zeros_like(errors_sorted)), grad))
        else:
            losses.append(torch.dot(errors_sorted, _lovasz_grad(fg_sorted)))
        present.append((fg.sum() > 0).to(probas.dtype))
    losses, present = torch.stack(losses), torch.stack(present)
    return (losses * present).sum() / present.sum().clamp_min(1.0)


@dataclasses.dataclass(frozen=True)
class LovaszLoss:
    mode: str = MULTICLASS_MODE
    per_image: bool = False
    ignore_index: Optional[int] = None
    from_logits: bool = True

    def __call__(self, y_pred, y_true):
        if self.mode in (BINARY_MODE, MULTILABEL_MODE):
            if y_pred.ndim == 4 and y_pred.shape[-1] == 1:
                y_pred = y_pred[..., 0]
            labels = y_true.reshape(y_true.shape[0], -1).to(y_pred.dtype)
            logits = y_pred.reshape(y_pred.shape[0], -1)
            valid = None
            if self.ignore_index is not None:
                valid = (labels != self.ignore_index).to(y_pred.dtype)
                labels = torch.where(valid > 0, labels, torch.zeros_like(labels))
            if self.per_image:
                return torch.stack([
                    _lovasz_hinge_flat(logits[i], labels[i],
                                       None if valid is None else valid[i])
                    for i in range(logits.shape[0])]).mean()
            return _lovasz_hinge_flat(logits.reshape(-1), labels.reshape(-1),
                                      None if valid is None else valid.reshape(-1))

        # multiclass
        probas = softmax(y_pred) if self.from_logits else y_pred
        b, c = probas.shape[0], probas.shape[-1]
        flat_p = probas.reshape(b, -1, c)
        flat_l = y_true.reshape(b, -1).long()
        valid = None
        if self.ignore_index is not None:
            valid = (flat_l != self.ignore_index).to(probas.dtype)
            flat_l = torch.where(valid > 0, flat_l, torch.zeros_like(flat_l))
        if self.per_image:
            return torch.stack([
                _lovasz_softmax_flat(flat_p[i], flat_l[i], None if valid is None else valid[i])
                for i in range(b)]).mean()
        return _lovasz_softmax_flat(flat_p.reshape(-1, c), flat_l.reshape(-1),
                                    None if valid is None else valid.reshape(-1))


__all__ = [
    "BINARY_MODE", "MULTICLASS_MODE", "MULTILABEL_MODE",
    "soft_dice_score", "soft_jaccard_score", "soft_tversky_score",
    "DiceLoss", "JaccardLoss", "TverskyLoss", "FocalLoss", "LovaszLoss",
    "SoftBCEWithLogitsLoss", "SoftCrossEntropyLoss",
    "focal_loss_with_logits",
]
