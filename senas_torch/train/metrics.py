"""Segmentation metrics: pixAcc / mIoU / Dice (percent, background excluded).

Port of `senas_tpu/train/metrics.py` (numerics of the reference's
utils/metrics.py): per-batch confusion counts per foreground class from the
argmax prediction, the reference's bitwise-AND pixel accuracy, and a host
accumulator that reports (2tp+eps)/(2tp+fp+fn+eps)-style percentages.
`confusion_counts` and `mean_pix_accuracy` run on the logits' device.
`RunScore` is the reference's confusion-matrix scorer.
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


class RunScore:
    """Confusion-matrix scorer (utils/utils.py:43-90): accumulates an
    n_classes^2 histogram over (true, pred) label maps and reports overall
    accuracy, per-class mean accuracy, mean IoU, frequency-weighted
    accuracy and the per-class IoU table, in float64, under the JAX
    package's keys ("Mean IoU " ends with a space).

    The label maps are numpy arrays or tensors. Pixels whose true label
    lies outside [0, n_classes) are left out. The histogram is
    `torch.bincount` in int64 on the maps' own device (a CUDA map's on the
    card), added to the float64 matrix once an `update`."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def _hist(self, label_true, label_pred) -> torch.Tensor:
        n = self.n_classes
        t = torch.as_tensor(label_true).reshape(-1).long()
        p = torch.as_tensor(label_pred, device=t.device).reshape(-1).long()
        valid = (t >= 0) & (t < n)
        return torch.bincount(n * t[valid] + p[valid], minlength=n * n).reshape(n, n)

    def update(self, label_trues, label_preds):
        total = None
        for lt, lp in zip(label_trues, label_preds):
            h = self._hist(lt, lp)
            total = h if total is None else total + h.to(total.device)
        if total is not None:
            self.confusion_matrix += total.cpu().numpy()

    def get_scores(self):
        hist = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            per_class_acc = np.diag(hist) / hist.sum(axis=1)
            iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                                  - np.diag(hist))
            freq = hist.sum(axis=1) / hist.sum()
        summary = {
            "Overall Acc": acc,
            "Mean Acc": np.nanmean(per_class_acc),
            "FreqW Acc": (freq[freq > 0] * iu[freq > 0]).sum(),
            "Mean IoU ": np.nanmean(iu),
        }
        return summary, dict(enumerate(iu))

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))
