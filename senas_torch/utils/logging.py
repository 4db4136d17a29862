"""Run-dir logging, scalar logging and image grids for the runners.

`senas_tpu/utils/logging.py`, copied: stdout + run.log file logger,
`create_exp_dir`, the run-dir layout
<log_root>/<model>/<phase>/<dataset>/<phase>-<timestamp>/ with the config
YAML copied in, a JSONL scalar log (scalars.jsonl), and the
input | prediction | ground-truth grids (`store_images`). Images are
written as PNG by `write_png` (zlib + struct: the port does not depend on
Pillow). TensorBoard output is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import sys
import time
import zlib
from typing import Optional

import numpy as np


def get_logger(log_dir: str, name: str = "senas_torch") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"{name}:{log_dir}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def create_exp_dir(path: str, desc: str = "Experiment dir: {}") -> str:
    os.makedirs(path, exist_ok=True)
    print(desc.format(path))
    return path


def close_logger(logger: logging.Logger) -> None:
    """Close and detach the logger's handlers (its run.log file)."""
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def make_run_dir(log_root: str, model: str, phase: str, dataset: str,
                 config_path: Optional[str] = None) -> str:
    """<log_root>/<model>/<phase>/<dataset>/<phase>-<timestamp>/ with the
    config copied in (search_arc.py:51-59 convention)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(log_root, model, phase, dataset, f"{phase}-{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    if config_path and os.path.exists(config_path):
        shutil.copy(config_path, run_dir)
    return run_dir


def calc_time(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    d, h = divmod(h, 24)
    return f"{d}d {h}h {m}m {s}s"


class ScalarWriter:
    """Scalar logging to <log_dir>/scalars.jsonl, one JSON object a line."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step), "t": time.time()}) + "\n")
        self._jsonl.flush()

    def add_image_grid(self, tag: str, grid: np.ndarray, step: int):
        """grid: [H, W, 3] uint8, written as <log_dir>/<tag>_<step>.png."""
        write_png(os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png"), grid)

    def export_scalars_to_json(self, path: str):
        # the JSONL is already on disk; the reference's export hook copies it
        shutil.copy(os.path.join(self.log_dir, "scalars.jsonl"), path)

    def close(self):
        self._jsonl.close()


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit PNG of `image`: [H, W] grayscale or [H, W, 3] RGB uint8.
    Each row is stored with filter type 0 (none) in one zlib stream."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"write_png takes [H,W] or [H,W,3] uint8, got {image.shape}")
    h, w = image.shape[:2]
    color = 0 if image.ndim == 2 else 2
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


_PALETTE = None


def get_mask_palette(nclass: int) -> np.ndarray:
    """VOC-style color palette (the reference's utils/encoder_colors.py:3-33)."""
    global _PALETTE
    if _PALETTE is None:
        pal = np.zeros((256, 3), np.uint8)
        for j in range(256):
            lab = j
            for i in range(8):
                pal[j, 0] |= ((lab >> 0) & 1) << (7 - i)
                pal[j, 1] |= ((lab >> 1) & 1) << (7 - i)
                pal[j, 2] |= ((lab >> 2) & 1) << (7 - i)
                lab >>= 3
        _PALETTE = pal
    return _PALETTE


def store_images(images: np.ndarray, preds: np.ndarray, labels: np.ndarray,
                 nclass: int) -> np.ndarray:
    """input | prediction | ground-truth grid (the reference's
    utils/utils.py:253-282).

    images: [B,H,W,C] float; preds/labels: [B,H,W] int. Returns [H*B, W*3, 3]
    uint8 (rows = samples, cols = input/pred/gt)."""
    pal = get_mask_palette(nclass)
    rows = []
    for img, pred, lab in zip(images, preds, labels):
        x = img[..., 0] if img.ndim == 3 else img
        lo, hi = float(x.min()), float(x.max())
        gray = ((x - lo) / (hi - lo if hi > lo else 1) * 255).astype(np.uint8)
        gray3 = np.stack([gray] * 3, axis=-1)
        if nclass <= 2:
            p = np.stack([(pred * 255).astype(np.uint8)] * 3, -1)
            g = np.stack([(lab * 255).astype(np.uint8)] * 3, -1)
        else:
            p = pal[pred.astype(np.int32) % 256]
            g = pal[lab.astype(np.int32) % 256]
        rows.append(np.concatenate([gray3, p, g], axis=1))
    return np.concatenate(rows, axis=0)
