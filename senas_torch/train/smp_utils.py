"""smp's training utilities in PyTorch: score functions, metric objects,
meters and the Train/Valid epoch runners.

Port of `senas_tpu/train/smp_utils.py` (the reference's vendored
segmentation_models_pytorch/utils/{functional,metrics,meter,epoch}.py):
the same formulas (global soft scores with eps smoothing, an optional
binarising threshold, channel exclusion) and the same epoch contract,
runner(dataloader) -> {"loss": mean, "<metric name>": mean}. NHWC:
y_pred and y_true are [B,H,W,C] probability and one-hot tensors. The
epochs take a torch model (a callable x -> prediction) and, to train, a
torch optimizer over its parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _threshold(x, threshold: Optional[float]):
    if threshold is None:
        return x
    return (x > threshold).to(x.dtype)


def _take_channels(*xs, ignore_channels: Optional[Sequence[int]] = None):
    if ignore_channels is None:
        return xs
    keep = [c for c in range(xs[0].shape[-1]) if c not in ignore_channels]
    idx = torch.as_tensor(keep, device=xs[0].device)
    return tuple(torch.index_select(x, -1, idx) for x in xs)


def iou(pr, gt, eps=1e-7, threshold=None, ignore_channels=None):
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, gt, ignore_channels=ignore_channels)
    intersection = (gt * pr).sum()
    union = gt.sum() + pr.sum() - intersection + eps
    return (intersection + eps) / union


jaccard = iou


def f_score(pr, gt, beta=1.0, eps=1e-7, threshold=None, ignore_channels=None):
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, gt, ignore_channels=ignore_channels)
    tp = (gt * pr).sum()
    fp = pr.sum() - tp
    fn = gt.sum() - tp
    return (((1 + beta ** 2) * tp + eps)
            / ((1 + beta ** 2) * tp + beta ** 2 * fn + fp + eps))


def accuracy(pr, gt, threshold=0.5, ignore_channels=None):
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, gt, ignore_channels=ignore_channels)
    tp = (gt == pr).to(pr.dtype).sum()
    return tp / gt.numel()


def precision(pr, gt, eps=1e-7, threshold=None, ignore_channels=None):
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, gt, ignore_channels=ignore_channels)
    tp = (gt * pr).sum()
    fp = pr.sum() - tp
    return (tp + eps) / (tp + fp + eps)


def recall(pr, gt, eps=1e-7, threshold=None, ignore_channels=None):
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, gt, ignore_channels=ignore_channels)
    tp = (gt * pr).sum()
    fn = gt.sum() - tp
    return (tp + eps) / (tp + fn + eps)


@dataclasses.dataclass(frozen=True)
class Metric:
    """A named metric callable; `name` keys the epoch logs."""

    fn: Callable
    name: str
    kwargs: Tuple[Tuple[str, object], ...] = ()

    def __call__(self, y_pr, y_gt):
        return self.fn(y_pr, y_gt, **dict(self.kwargs))


def IoU(eps=1e-7, threshold=0.5, ignore_channels=None):
    return Metric(iou, "iou_score",
                  (("eps", eps), ("threshold", threshold), ("ignore_channels", ignore_channels)))


def Fscore(beta=1.0, eps=1e-7, threshold=0.5, ignore_channels=None):
    return Metric(f_score, "fscore",
                  (("beta", beta), ("eps", eps), ("threshold", threshold),
                   ("ignore_channels", ignore_channels)))


def Accuracy(threshold=0.5, ignore_channels=None):
    return Metric(accuracy, "accuracy",
                  (("threshold", threshold), ("ignore_channels", ignore_channels)))


def Precision(eps=1e-7, threshold=0.5, ignore_channels=None):
    return Metric(precision, "precision",
                  (("eps", eps), ("threshold", threshold), ("ignore_channels", ignore_channels)))


def Recall(eps=1e-7, threshold=0.5, ignore_channels=None):
    return Metric(recall, "recall",
                  (("eps", eps), ("threshold", threshold), ("ignore_channels", ignore_channels)))


class AverageValueMeter:
    """meter.py: running mean and std of scalar updates."""

    def __init__(self):
        self.reset()

    def add(self, value, n: int = 1):
        self.n += n
        self.sum += value * n
        self.sum_sq += (value ** 2) * n

    @property
    def mean(self):
        return self.sum / max(self.n, 1)

    @property
    def std(self):
        if self.n < 2:
            return float("nan")
        var = (self.sum_sq - self.n * self.mean ** 2) / (self.n - 1)
        return float(np.sqrt(max(var, 0.0)))

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.sum_sq = 0.0


class _Epoch:
    """The epoch contract (epoch.py:69-120): iterate a loader of (x
    [B,H,W,C] float, y [B,H,W,C] one-hot) numpy pairs and return
    {"loss": mean, metric.name: mean, ...}."""

    def __init__(self, model: Callable, loss, metrics: Sequence[Metric], device=None,
                 verbose: bool = True):
        from senas_torch.core.device import resolve_device
        self.model = model
        self.loss = loss
        self.metrics = list(metrics)
        self.device = resolve_device(device)
        self.verbose = verbose

    def _batch(self, x, y):
        raise NotImplementedError

    def run(self, dataloader) -> Dict[str, float]:
        loss_meter = AverageValueMeter()
        metric_meters = {m.name: AverageValueMeter() for m in self.metrics}
        for x, y in dataloader:
            x = torch.as_tensor(np.asarray(x), device=self.device)
            y = torch.as_tensor(np.asarray(y), device=self.device)
            loss_v, y_pred = self._batch(x, y)
            loss_meter.add(float(loss_v))
            with torch.no_grad():
                for m in self.metrics:
                    metric_meters[m.name].add(float(m(y_pred, y)))
        logs = {"loss": loss_meter.mean}
        logs.update({k: v.mean for k, v in metric_meters.items()})
        return logs


class ValidEpoch(_Epoch):
    """A no-grad forward per batch (epoch.py:94-120)."""

    def _batch(self, x, y):
        with torch.no_grad():
            pred = self.model(x)
            return self.loss(pred, y), pred


class TrainEpoch(_Epoch):
    """Forward, backward and an optimizer step per batch (epoch.py:69-91)."""

    def __init__(self, model: Callable, loss, metrics: Sequence[Metric],
                 optimizer: torch.optim.Optimizer, device=None, verbose: bool = True):
        super().__init__(model, loss, metrics, device, verbose)
        self.optimizer = optimizer

    def _batch(self, x, y):
        self.optimizer.zero_grad(set_to_none=True)
        pred = self.model(x)
        loss_v = self.loss(pred, y)
        loss_v.backward()
        self.optimizer.step()
        return loss_v.detach(), pred.detach()
