"""Host batches drawn from the seed, as the runners' loaders hand them over.

Copied from chip_smoke.py `_batches`: an image of standard normal values
[B, H, W, C_in] (f32) and a label map [B, H, W] (int64) with foreground at
a density of 0.3. It draws from numpy's PCG64 generator (`default_rng`),
which takes seeds of any size, and hands numpy arrays on the host, which
the runners' `make_batch_placer` moves to the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def batches(rng: np.random.Generator, n: int, bs: int, hw: int,
            in_channels: int) -> List[Dict[str, np.ndarray]]:
    out = []
    for _ in range(n):
        image = rng.standard_normal((bs, hw, hw, in_channels), dtype=np.float32)
        label = (rng.random((bs, hw, hw), dtype=np.float32) > 0.7).astype(np.int64)
        out.append({"image": image, "label": label})
    return out
