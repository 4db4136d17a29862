"""Per-dataset normalisation constants (mean and std per channel).

    python -m senas_torch.calc_mean_std --dataset promise12 --data-root <root> \
        [--split train] [--limit N] [--device cuda|cpu]

The flags of tools/calc_mean_std.py (the reference's
utils/datasets/calc_mean_std.py), plus --device (default cuda). It walks
the port's `get_dataset(<name>, split=..., mode="val")` (the deterministic
centre crop, no augmentation) and takes the per-channel float64 sums of
the pixels and their squares on that device; a dataset whose spec
normalises its samples has that undone, so the numbers are those of the
raw [0, 1] pixels, as the reference reports them.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np
import torch

from senas_torch.core.device import resolve_device
from senas_torch.data import get_dataset


def mean_std(ds, n: int, device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and std of the first n samples of `ds` (float64
    sums on `device`), in raw pixel units."""
    count = 0
    s1 = s2 = None
    for i in range(n):
        img, _ = ds[i]
        img = torch.as_tensor(np.asarray(img)).to(device, torch.float64)
        c = img.shape[-1] if img.dim() == 3 else 1
        flat = img.reshape(-1, c)
        if s1 is None:
            s1 = torch.zeros(c, dtype=torch.float64, device=device)
            s2 = torch.zeros(c, dtype=torch.float64, device=device)
        s1 += flat.sum(0)
        s2 += (flat ** 2).sum(0)
        count += flat.shape[0]
    mean = (s1 / count).cpu().numpy()
    std = np.sqrt(np.maximum((s2 / count).cpu().numpy() - mean ** 2, 0))
    spec = ds.spec
    if spec.mean is not None:
        prior_m = np.asarray(spec.mean, np.float64)
        prior_s = np.asarray(spec.std, np.float64)
        mean = prior_m + prior_s * mean
        std = prior_s * std
    return mean, std


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-channel mean and std of a dataset")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--data-root", default=os.environ.get("SENAS_DATA_ROOT", "../data/imgseg/"))
    ap.add_argument("--split", default="train")
    ap.add_argument("--limit", type=int, default=0,
                    help="optional cap on number of samples")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ds = get_dataset(args.dataset, path=args.data_root, split=args.split, mode="val")
    n = len(ds) if not args.limit else min(args.limit, len(ds))
    mean, std = mean_std(ds, n, device)
    print(f"dataset={args.dataset} n={n}")
    print(f"mean = {[round(v, 7) for v in mean.tolist()]}")
    print(f"std  = {[round(v, 7) for v in std.tolist()]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
