"""The port's op vocabulary (the JAX package's `ops/__init__.py`
exports, imported at first use, so that loading a submodule such as
`ops._build` does not load the ops)."""

from senas_torch._exports import lazy_exports

_EXPORTS = {
    "OPS": "senas_torch.ops.primitives",
    "DownOps": "senas_torch.ops.primitives",
    "NormOps": "senas_torch.ops.primitives",
    "UpOps": "senas_torch.ops.primitives",
    "OpType": "senas_torch.ops.primitives",
    "AdapterBlock": "senas_torch.ops.primitives",
    "BasicBlock": "senas_torch.ops.primitives",
    "ConvBn": "senas_torch.ops.primitives",
    "ConvBnSe": "senas_torch.ops.primitives",
    "DepSepConv": "senas_torch.ops.primitives",
    "ReLUConv": "senas_torch.ops.primitives",
    "RectifyBlock": "senas_torch.ops.primitives",
    "RectifyResample": "senas_torch.ops.primitives",
    "SEBlock": "senas_torch.ops.primitives",
    "ShrinkBlock": "senas_torch.ops.primitives",
    "avg_pool_3x3": "senas_torch.ops.primitives",
    "channel_shuffle": "senas_torch.ops.primitives",
    "max_pool_3x3": "senas_torch.ops.primitives",
    "upsample2x": "senas_torch.ops.primitives",
    "make_op": "senas_torch.ops.primitives",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
