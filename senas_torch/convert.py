"""Weight bridge between the JAX package's flax variables and the port.

The port's modules carry the flax variable names, so a flax leaf at
`params/down_1/group0/se_conv_3_kernel` is the port's parameter
`down_1.group0.se_conv_3_kernel` and a `batch_stats` leaf is a buffer. The
bridge is a per-leaf layout transform, never a name table:

  * "hwio"   conv kernel (k,k,I,O) <-> OIHW (O,I,k,k); also a depthwise
             (k,k,1,C*E) <-> (C*E,1,k,k). The default for a 4-D leaf.
  * "hwio_t" transposed conv: flax correlates an unflipped kernel over the
             lhs-dilated input, PyTorch's ConvTranspose2d the spatially
             flipped one with in/out swapped: (k,k,I,O) <-> flip(I,O,k,k).
  * "dw_t"   depthwise transposed conv with channel multiplier E:
             (k,k,1,C*E) (channel c*E+e) <-> flip(C,E,k,k) for groups=C.
  * "copy"   everything else (BN and GroupNorm scale/bias, biases, dense
             (I,O) kernels, which the port keeps in flax's layout,
             pointwise (E,C,P), SE (E,P,mid)/(E,mid,P)).

The baseline zoo adds no layout of its own: a grouped (ResNeXt) kernel
(k,k,I/g,O) and a depthwise one (k,k,1,C) are "hwio" to (O,I/g,k,k) and
(C,1,k,k); Linknet's and nasunet's transposed kernels are "hwio_t", a
depthwise transposed one "dw_t"; nasunet's CWeightOp is two Dense layers
and a (transposed) conv.

A module whose kernel is not a plain conv names its layout in its
`flax_layout` dict. The vmapped inner edges of a fused cell (flax
`inner_n`, every leaf stacked on a leading axis of n) are the port's
`inner_n.0` ... `inner_n.{n-1}`.

Input and output trees are nested dicts of numpy arrays,
{"params": ..., "batch_stats": ...}; arch dicts map names to arrays.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from senas_torch.core.device import resolve_device

_INNER = re.compile(r"^inner_\d+$")


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _layout(model: nn.Module, key: str, ndim: int) -> str:
    owner, _, leaf = key.rpartition(".")
    module = model.get_submodule(owner) if owner else model
    kind = getattr(module, "flax_layout", {}).get(leaf)
    return kind or ("hwio" if ndim == 4 else "copy")


def _to_torch_layout(a: np.ndarray, kind: str, shape) -> np.ndarray:
    if kind == "hwio":
        return a.transpose(3, 2, 0, 1)
    if kind == "hwio_t":
        return np.flip(a, axis=(0, 1)).transpose(2, 3, 0, 1)
    if kind == "dw_t":
        k = a.shape[0]
        return np.flip(a.reshape(k, k, shape[0], shape[1]), axis=(0, 1)).transpose(2, 3, 0, 1)
    return a


def _to_flax_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "hwio":
        return a.transpose(2, 3, 1, 0)
    if kind == "hwio_t":
        return np.flip(a, axis=(2, 3)).transpose(2, 3, 0, 1)
    if kind == "dw_t":
        c, e, k, _ = a.shape
        return np.flip(a, axis=(2, 3)).transpose(2, 3, 0, 1).reshape(k, k, 1, c * e)
    return a


def _torch_leaves(path: Tuple[str, ...], leaf: np.ndarray):
    """Split a stacked `inner_n` axis: yields (torch key, array)."""
    for i, part in enumerate(path):
        if _INNER.match(part):
            for j in range(leaf.shape[0]):
                yield ".".join(path[:i + 1] + (str(j),) + path[i + 1:]), leaf[j]
            return
    yield ".".join(path), leaf


def variables_to_state_dict(model: nn.Module, variables: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} -> the model's state_dict (CPU f32)."""
    target = model.state_dict()
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            for key, a in _torch_leaves(path, np.asarray(leaf)):
                if key not in target:
                    raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has no "
                                   f"counterpart {key!r} in the port")
                shape = tuple(target[key].shape)
                a = _to_torch_layout(a, _layout(model, key, a.ndim), shape)
                if a.shape != shape:
                    raise ValueError(f"{key}: flax leaf maps to {a.shape}, port has {shape}")
                out[key] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return out


def load_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Copy flax variables into the model (strict: every leaf on both sides)."""
    model.load_state_dict(variables_to_state_dict(model, variables), strict=True)
    return model


def state_dict_to_variables(model: nn.Module) -> Dict[str, Any]:
    """The model's weights and BN stats -> flax {"params", "batch_stats"}."""
    buffers = {k for k, _ in model.named_buffers()}
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    stacked: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for key, t in model.state_dict().items():
        a = _to_flax_layout(t.detach().cpu().numpy(), _layout(model, key, t.ndim))
        parts = key.split(".")
        path = ("batch_stats" if key in buffers else "params",)
        # fold `inner_n.j.` back into flax's stacked leading axis
        i = next((i for i, p in enumerate(parts) if _INNER.match(p)), None)
        if i is not None:
            flax_path = path + tuple(parts[:i + 1] + parts[i + 2:])
            stacked.setdefault(flax_path, {})[int(parts[i + 1])] = a
            continue
        _put(tree, path + tuple(parts), np.ascontiguousarray(a))
    for flax_path, by_index in stacked.items():
        _put(tree, flax_path, np.stack([by_index[j] for j in range(len(by_index))]))
    return tree


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def arch_to_torch(arch: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """Arch dict of arrays -> f32 tensors on `device` (None means the card),
    copies: a search step updates its tables in place."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in arch.items()}


def arch_to_numpy(arch: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in arch.items()}
