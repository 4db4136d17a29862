from senas_torch.core.device import resolve_device  # noqa: F401
