"""The search, train and test runners (the JAX package's
`runner/__init__.py` exports, imported at first use)."""

from senas_torch._exports import lazy_exports

_EXPORTS = {
    "SearchRunner": "senas_torch.runner.search",
    "TrainRunner": "senas_torch.runner.train",
    "TestRunner": "senas_torch.runner.test",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
