"""The port's models: the fixed SENAS model, the searched genotypes and
the factory of the baseline zoo. The JAX package's `models/__init__.py`
exports, imported at first use."""

from senas_torch._exports import lazy_exports

_EXPORTS = {
    "BuildCell": "senas_torch.models.senas_model",
    "Head": "senas_torch.models.senas_model",
    "SenasModel": "senas_torch.models.senas_model",
    "geno_searched": "senas_torch.models.geno_searched",
    "get_segmentation_model": "senas_torch.models.factory",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
