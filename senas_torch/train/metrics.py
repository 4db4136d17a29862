"""Segmentation metrics: pixAcc / mIoU / Dice (percent, background excluded).

Port of `senas_tpu/train/metrics.py` (numerics of the reference's
utils/metrics.py): per-batch confusion counts per foreground class from the
argmax prediction, the reference's bitwise-AND pixel accuracy, and a host
accumulator that reports (2tp+eps)/(2tp+fp+fn+eps)-style percentages.
`confusion_counts` and `mean_pix_accuracy` run on the logits' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SMOOTH = float(np.spacing(1))


def confusion_counts(logits: torch.Tensor, label: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-foreground-class (tp, fp, fn) as f32, summed over batch+spatial.
    logits: [B,H,W,C]; label: [B,H,W] int. Returns three [C-1] tensors."""
    nclass = logits.shape[-1]
    pred = logits.argmax(dim=-1)
    classes = torch.arange(1, nclass, device=logits.device)[:, None, None, None]
    pred_is = pred[None] == classes
    label_is = label[None] == classes
    tp = (pred_is & label_is).sum(dim=(1, 2, 3)).float()
    fp = (pred_is & ~label_is).sum(dim=(1, 2, 3)).float()
    fn = (~pred_is & label_is).sum(dim=(1, 2, 3)).float()
    return tp, fp, fn


def mean_pix_accuracy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-image (bitwise_and(pred, label>0).sum + eps) / ((label>0).sum + eps),
    averaged over the batch."""
    pred = logits.argmax(dim=-1).int()
    labeled = (label > 0).int()
    correct = torch.bitwise_and(pred, labeled).float().sum(dim=(1, 2))
    total = labeled.float().sum(dim=(1, 2))
    return ((correct + SMOOTH) / (total + SMOOTH)).mean()


def percentage(value, dec: int = 3) -> float:
    value = np.mean(np.asarray(value, dtype=np.float64))
    return round(100.0 * float(value), dec)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def mloss(self):
        return self.avg

    def mperc(self):
        return percentage(self.avg)


class SegmentationMetric:
    """Accumulates pixAcc / mIoU / Dice across batches."""

    def __init__(self, nclass: int):
        self.nclass = nclass
        self.reset()

    def reset(self):
        self.acc = AverageMeter()
        self.tp_total = np.zeros(self.nclass - 1, dtype=np.float64)
        self.fp_total = np.zeros(self.nclass - 1, dtype=np.float64)
        self.fn_total = np.zeros(self.nclass - 1, dtype=np.float64)

    def update(self, label, logits):
        """label: [B,H,W] int; logits: [B,H,W,C] tensors."""
        tp, fp, fn = confusion_counts(logits, label)
        self.update_counts(tp.cpu().numpy(), fp.cpu().numpy(), fn.cpu().numpy(),
                           float(mean_pix_accuracy(logits, label)))

    def update_counts(self, tp: np.ndarray, fp: np.ndarray, fn: np.ndarray, acc: float):
        """For eval loops that already computed the counts."""
        self.tp_total += tp
        self.fp_total += fp
        self.fn_total += fn
        self.acc.update(acc)

    def miou(self):
        return (self.tp_total + SMOOTH) / (self.tp_total + self.fp_total + self.fn_total + SMOOTH)

    def dice(self):
        return (2 * self.tp_total + SMOOTH) / (
            2 * self.tp_total + self.fp_total + self.fn_total + SMOOTH)

    def get(self):
        return self.acc.mperc(), percentage(self.miou()), percentage(self.dice())
