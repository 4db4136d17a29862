"""Checkpoint / resume of a search with `torch.save`.

Port of `senas_tpu/train/checkpoint.py` (Orbax there): a rolling "last"
checkpoint each epoch. One file `<directory>/<name>.pt` holds the model's
state_dict (weights and BN running stats), the arch tables, both
optimizers' state_dicts, the step count and the meta fields the runner
keeps (epoch, dur_time, cur_patience, geno_type). It is written to a
temporary file and renamed, so a run cut while saving leaves the previous
checkpoint whole. It holds only tensors, numbers, strings and containers,
so `restore` loads it with `weights_only=True`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from senas_torch.train.trainer import SearchTrainState


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def exists(self, name: str = "last") -> bool:
        return os.path.exists(self._path(name))

    def save(self, state: SearchTrainState, meta: Dict[str, Any], name: str = "last"):
        payload = {
            "model": state.model.state_dict(),
            "arch": {k: v.detach() for k, v in state.arch.items()},
            "w_opt": state.w_opt.state_dict(),
            "a_opt": state.a_opt.state_dict(),
            "step": state.step,
            "meta": dict(meta),
        }
        tmp = self._path(name) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(name))

    def restore(self, state: SearchTrainState, name: str = "last") -> Optional[Dict[str, Any]]:
        """Load checkpoint `name` into `state` in place (the arch tables are
        copied into the tensors the optimizers hold); returns its meta
        fields, or None when there is no such checkpoint."""
        if not self.exists(name):
            return None
        payload = torch.load(self._path(name), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        if payload["arch"].keys() != state.arch.keys():
            raise ValueError(f"checkpoint arch tables {sorted(payload['arch'])} do not "
                             f"match the run's {sorted(state.arch)}")
        with torch.no_grad():
            for k, t in state.arch.items():
                t.copy_(payload["arch"][k])
        state.w_opt.load_state_dict(payload["w_opt"])
        state.a_opt.load_state_dict(payload["a_opt"])
        state.step = int(payload["step"])
        return payload["meta"]
