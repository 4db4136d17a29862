"""Checkpoint / resume with `torch.save`.

Port of `senas_tpu/train/checkpoint.py` (Orbax there): a rolling "last"
checkpoint each epoch plus a "best" copy when the tracked metric improves.
One file `<directory>/<name>.pt` holds the state's `state_dict()` (a
`FixedTrainState`: the model's weights and BN running stats, the
optimizer's state and the step; a `SearchTrainState` also the arch tables
and both optimizers) and the meta fields the runner keeps (epoch,
dur_time, patience, genotype, best metrics). It is written to a temporary
file and renamed, so a run cut while saving leaves the previous checkpoint
whole. It holds only tensors, numbers, strings and containers, so it loads
with `weights_only=True`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def exists(self, name: str = "last") -> bool:
        return os.path.exists(self._path(name))

    def _write(self, payload: Dict[str, Any], name: str) -> None:
        tmp = self._path(name) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(name))

    def save(self, state, meta: Dict[str, Any], is_best: bool = False, name: str = "last"):
        """Write `state.state_dict()` and `meta` as `name`, and as "best"
        too when `is_best`."""
        payload = {**state.state_dict(), "meta": dict(meta)}
        self._write(payload, name)
        if is_best:
            self._write(payload, "best")

    def restore(self, state, name: str = "last") -> Optional[Dict[str, Any]]:
        """Load checkpoint `name` into `state` in place; returns its meta
        fields, or None when there is no such checkpoint."""
        payload = self.restore_raw(name)
        if payload is None:
            return None
        state.load_state_dict(payload)
        return payload["meta"]

    def restore_raw(self, name: str = "last") -> Optional[Dict[str, Any]]:
        """The checkpoint as saved (on the CPU), with no target state: for a
        reader that needs only a part of it, as evaluation needs only the
        model and not the training run's optimizer. None when absent."""
        if not self.exists(name):
            return None
        return torch.load(self._path(name), map_location="cpu", weights_only=True)
