"""Losses, metrics and optimizers (the JAX package's `train/__init__.py`
exports, imported at first use)."""

from senas_torch._exports import lazy_exports

_EXPORTS = {
    "build_loss": "senas_torch.train.loss",
    "segmentation_loss": "senas_torch.train.loss",
    "SegmentationMetric": "senas_torch.train.metrics",
    "AverageMeter": "senas_torch.train.metrics",
    "confusion_counts": "senas_torch.train.metrics",
    "build_optimizer": "senas_torch.train.optim",
    "build_scheduler": "senas_torch.train.optim",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
