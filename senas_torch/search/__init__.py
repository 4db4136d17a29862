"""The supernet and its cells (the JAX package's `search/__init__.py`
exports, imported at first use)."""

from senas_torch._exports import lazy_exports

_EXPORTS = {
    "MixedOp": "senas_torch.search.cell",
    "SearchCell": "senas_torch.search.cell",
    "SenasSearch": "senas_torch.search.supernet",
    "init_arch_params": "senas_torch.search.supernet",
    "normalize_arch": "senas_torch.search.supernet",
    "derive_genotype": "senas_torch.search.supernet",
    "arch_param_count": "senas_torch.search.supernet",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
