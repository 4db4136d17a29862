"""Synthetic segmentation dataset for tests and benchmarking (a copy of
`senas_tpu/data/synthetic.py`: the same seed gives the same samples).

Random blob masks with correlated intensities: enough structure that a
segmentation model can overfit a few batches (used by integration tests to
check end-to-end learning), with zero external data dependencies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from senas_torch.data.base import SegmentationDataset, SPECS, register_dataset


class Synthetic(SegmentationDataset):
    def __init__(self, root: Optional[str] = None, split: str = "train", mode: str = "train",
                 size: int = 32, hw: int = 64, num_class: int = 2,
                 in_channels: int = 1, seed: int = 0):
        self.spec = SPECS["synthetic"]
        self._n = size
        self._hw = hw
        self._nc = num_class
        self._ic = in_channels
        rs = np.random.RandomState(seed + (0 if mode == "train" else 1))
        self.images = np.zeros((size, hw, hw, in_channels), np.float32)
        self.labels = np.zeros((size, hw, hw), np.int32)
        yy, xx = np.mgrid[0:hw, 0:hw]
        for i in range(size):
            lab = np.zeros((hw, hw), np.int32)
            for c in range(1, num_class):
                cx, cy = rs.randint(hw // 4, 3 * hw // 4, 2)
                r = rs.randint(hw // 8, hw // 4)
                lab[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
            img = lab.astype(np.float32)[..., None] * np.ones(in_channels)
            img = img + 0.25 * rs.randn(hw, hw, in_channels)
            self.images[i] = img
            self.labels[i] = lab

    def __len__(self):
        return self._n

    def __getitem__(self, index):
        return self.images[index], self.labels[index]


@register_dataset("synthetic")
def _make(root=None, split="train", mode="train", **kw):
    return Synthetic(root=root, split=split, mode=mode, **kw)
