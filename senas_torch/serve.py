"""Serving export: package a trained model as a `torch.export` artifact.

Port of `senas_tpu/serve.py`, which serialises the jitted eval-mode forward
as StableHLO. Here `torch.export` captures the eval-mode forward as an
`ExportedProgram`: an ATen graph with the weights and BN running stats
inside and a symbolic batch dimension, which a serving process loads
without the model code, the genotype or the checkpoint (plain
`torch.export.load`, no import of this package, runs it).

Artifact layout (a directory):
    model.pt2   — `torch.export.save` of the program, its tensors on the CPU
    meta.json   — input spec (hw, channels), classes, matmul precision, notes

The file holds the program's CPU form, so it loads on any machine; the
`Predictor` moves it to the device it serves on (`move_to_device_pass`,
which also rewrites device arguments baked into the graph). One artifact
serves on the card or the CPU: JAX's `platforms` argument has no
counterpart.

Precision. `torch.export` does not capture TF32: cuDNN and cuBLAS read
their TF32 flags when each kernel is launched. The artifact records the
precision it was exported for in meta.json; a "float32" artifact's
`Predictor` turns TF32 off for cuDNN and cuBLAS around each call and
restores the process's flags after, a "backend-default" one leaves them
as they are (torch's default for cuDNN is TF32 on).

Surface:
- ``export_predict_fn(model, in_shape, matmul_precision=None)`` -> ``ExportedProgram``
- ``save_artifact(exported, meta, out_dir)`` / ``load_artifact(out_dir)``
- ``Predictor`` — the loaded artifact on a device (or one replica per
  device, `data_parallel`) and the argmax mask helper; any batch size.

CLI: ``python -m senas_torch.export_model`` (checkpoint -> artifact, with a
round-trip check).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from senas_torch.core.device import resolve_device
from senas_torch.utils.spans import span

FORMAT = "torch.export/pt2"
PROGRAM_FILE = "model.pt2"
PRECISIONS = ("float32", "backend-default")


class _LastLogits(nn.Module):
    """The eval-mode forward that returns only the last logits (the
    testing_model.py serving output)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        out = self.model(x, train=False)
        if isinstance(out, tuple):  # aux_params models: (masks, labels)
            out = out[0]
        return out[-1] if isinstance(out, (list, tuple)) else out


def _precision_name(matmul_precision: Optional[str]) -> str:
    name = matmul_precision or "backend-default"
    if name not in PRECISIONS:
        raise ValueError(f"matmul_precision {matmul_precision!r}: use None, "
                         f"{' or '.join(repr(p) for p in PRECISIONS)}")
    return name


@contextlib.contextmanager
def serving_precision(matmul_precision: Optional[str]):
    """Within it, "float32" turns TF32 off for cuDNN and cuBLAS (restored
    after); "backend-default" (or None) leaves the process's flags alone."""
    if _precision_name(matmul_precision) != "float32":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def export_predict_fn(model: nn.Module, in_shape: Tuple[int, int, int],
                      matmul_precision: Optional[str] = None
                      ) -> torch.export.ExportedProgram:
    """Export the eval-mode logits of `model` with a symbolic batch dimension.

    `model(x, train)` takes NHWC f32 x and returns the deep-supervision list;
    the program returns only the final logits [B,H,W,nclass]. It is traced
    on the model's device with an example batch of 2 (torch.export would
    specialise a batch of 1) and holds the weights. The batch is
    `Dim.DYNAMIC`: the trace sets its range (`batch_range`). A batch of at
    least 1 cannot be asked for: the trace assumes a symbolic size is not 1,
    and on the card it also guards b <= 65535, so `Dim("b", min=1)` fails
    there. `matmul_precision` (None,
    "backend-default" or "float32") is the precision it is served at;
    `save_artifact` records it."""
    h, w, c = in_shape
    precision = _precision_name(matmul_precision)
    device = next(model.parameters()).device
    example = torch.zeros(2, h, w, c, device=device)
    with torch.no_grad():
        exported = torch.export.export(_LastLogits(model).eval(), (example,),
                                       dynamic_shapes={"x": {0: torch.export.Dim.DYNAMIC}})
    exported.serving_precision = precision
    return exported


def batch_range(exported: torch.export.ExportedProgram) -> Tuple[int, Optional[int]]:
    """The batch sizes the program was traced valid for: (least, most, or
    None for no bound)."""
    name = exported.graph_signature.user_inputs[0]
    node = next(n for n in exported.graph.nodes if n.op == "placeholder" and n.name == name)
    size = node.meta["val"].shape[0]
    if isinstance(size, int):
        return size, size
    bounds = exported.range_constraints[size.node.expr]
    return int(bounds.lower), (int(bounds.upper) if bounds.upper.is_Integer else None)


def save_artifact(exported: torch.export.ExportedProgram, meta: Dict[str, Any],
                  out_dir: str) -> str:
    """Write `out_dir`/model.pt2 (the program, moved to the CPU) and
    meta.json (`meta` plus the format, the precision and torch's version)."""
    from torch.export.passes import move_to_device_pass

    os.makedirs(out_dir, exist_ok=True)
    precision = getattr(exported, "serving_precision", "backend-default")
    if meta.get("matmul_precision", precision) != precision:
        raise ValueError(f"meta says matmul_precision {meta['matmul_precision']!r}, the "
                         f"program was exported for {precision!r}")
    with warnings.catch_warnings():
        # torch's own pytree specs warn when deep-copied (a deprecation inside torch)
        warnings.simplefilter("ignore", FutureWarning)
        on_cpu = move_to_device_pass(copy.deepcopy(exported), "cpu")
    torch.export.save(on_cpu, os.path.join(out_dir, PROGRAM_FILE))
    meta = dict(meta)
    meta.setdefault("format", FORMAT)
    meta["matmul_precision"] = precision
    meta["batch_range"] = list(batch_range(exported))
    meta.setdefault("torch_version", torch.__version__)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return out_dir


def load_artifact(out_dir: str) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """(the program on the CPU, its meta)."""
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(out_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if meta.get("format", FORMAT) != FORMAT:
        raise ValueError(f"{out_dir}: artifact format {meta['format']!r}, expected {FORMAT!r}")
    exported = torch.export.load(os.path.join(out_dir, PROGRAM_FILE))
    exported.serving_precision = meta.get("matmul_precision", "backend-default")
    return exported, meta


def _on_device(out_dir: str, device: torch.device) -> nn.Module:
    """A callable copy of the artifact's program with its tensors on `device`."""
    from torch.export.passes import move_to_device_pass

    exported, _ = load_artifact(out_dir)
    return move_to_device_pass(exported, str(device)).module()


class Predictor:
    """A loaded serving artifact. Any leading batch size runs without
    re-export.

    `device=None` means the card (a missing card raises). With
    `data_parallel=True` there is one replica of the program per entry of
    `devices` (default: every visible CUDA device). A request is
    zero-padded to a multiple of the replica count, and each replica's part
    to at least the least batch the program was traced for (2: a batch of
    1 runs as 2), split evenly, run on the replicas, and the logits are
    concatenated on the first device and sliced back, so callers see the
    same results either way (eval-mode BN is per sample). The replicas are
    called in turn; on CUDA devices the launches are asynchronous, so the
    devices work at once.

    A request is the span `serve_request` (`utils/spans.py`), which holds
    `stage_in` (the host tensor, its padding and, as `h2d`, the first
    replica's copy), `program` (the replicas' calls, with each later
    replica's copy an `h2d` after the call before it, so that a card runs
    while the next part is copied) and, for `predict_masks`, `readback`
    (argmax, uint8 and the copy to the host)."""

    def __init__(self, out_dir: str, data_parallel: bool = False,
                 devices: Optional[Sequence] = None, device=None):
        program, self.meta = load_artifact(out_dir)
        self.batch_range = batch_range(program)
        if data_parallel:
            if devices is None:
                devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
            self.devices = [resolve_device(d) for d in devices]
            if not self.devices:
                raise ValueError("Predictor(data_parallel=True): no CUDA device visible "
                                 "(pass devices=...)")
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        self.matmul_precision = self.meta.get("matmul_precision", "backend-default")
        self._replicas = [_on_device(out_dir, d) for d in self.devices]

    def logits(self, x: np.ndarray) -> torch.Tensor:
        """[B,H,W,C_in] float input -> [B,H,W,nclass] f32 logits on `self.device`."""
        with span("serve_request", unit=True):
            return self._logits(x)

    def _logits(self, x: np.ndarray) -> torch.Tensor:
        n = len(self._replicas)
        with span("stage_in"):
            x = torch.as_tensor(np.asarray(x, np.float32))
            least, most = self.batch_range
            part = max(-(-x.shape[0] // n), least)
            if most is not None and part > most:
                raise ValueError(f"a batch of {x.shape[0]} needs {part} per replica; the "
                                 f"program was traced for at most {most}")
            pad = part * n - x.shape[0]
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            chunks = x.chunk(n)
            with span("h2d"):
                placed = chunks[0].to(self.device, non_blocking=True)
        with span("program"), torch.inference_mode(), serving_precision(self.matmul_precision):
            outs = []
            for i, replica in enumerate(self._replicas):
                outs.append(replica(placed))
                if i + 1 < n:
                    with span("h2d"):
                        placed = chunks[i + 1].to(self.devices[i + 1], non_blocking=True)
            out = outs[0] if n == 1 else torch.cat([o.to(self.device) for o in outs])
            return out[:out.shape[0] - pad] if pad else out

    def predict_masks(self, x: np.ndarray) -> np.ndarray:
        """[B,H,W,C_in] float input -> [B,H,W] uint8 class masks (the
        testing_model.py mask payload; uint8 for a small readback)."""
        with span("serve_request", unit=True):
            logits = self._logits(x)
            with span("readback"):
                return logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()
