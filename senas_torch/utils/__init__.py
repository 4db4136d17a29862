"""Logging, seeding, counting and device utilities (the JAX package's
`utils/__init__.py` exports, imported at first use)."""

from senas_torch._exports import lazy_exports

_EXPORTS = {
    "get_logger": "senas_torch.utils.logging",
    "create_exp_dir": "senas_torch.utils.logging",
    "calc_time": "senas_torch.utils.logging",
    "store_images": "senas_torch.utils.logging",
    "calc_parameters_count": "senas_torch.utils.misc",
    "create_class_weight": "senas_torch.utils.misc",
    "get_gpus_memory_info": "senas_torch.utils.misc",
    "one_hot_encoding": "senas_torch.utils.misc",
    "set_seed": "senas_torch.utils.misc",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
