"""The genotype, the config loader and the device rule. The first two are
the JAX package's `core/__init__.py` exports, imported at first use."""

from senas_torch._exports import lazy_exports

from senas_torch.core.device import resolve_device  # noqa: F401

_EXPORTS = {
    "Genotype": "senas_torch.core.genotype",
    "GenoParser": "senas_torch.core.genotype",
    "parse_genotype": "senas_torch.core.genotype",
    "load_config": "senas_torch.core.config",
}
__all__ = sorted([*_EXPORTS, "resolve_device"])
__getattr__ = lazy_exports(__name__, _EXPORTS)
