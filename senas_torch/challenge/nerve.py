"""Ultrasound-nerve challenge utilities: run-length encoding submission and
the incoherent-image filter.

A numpy copy of `senas_tpu/challenge/nerve.py`, kept here so that the port
imports nothing of the JAX package; tests/test_torch_challenge.py holds it
to the JAX package's on identical inputs. Parity targets of both: the
reference's utils/challenge/nerve/run_length_encoding.py (column-major RLE
with the <5-pixel empty-mask rule) and filter_incoherent_images.py
(per-patient similarity clustering that drops contradictory annotations).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


def rle_encoding(mask: np.ndarray, min_pixels: int = 5) -> str:
    """Column-major run-length encoding, 1-indexed "start length ..." pairs.

    Masks with fewer than `min_pixels` positives encode as empty — the
    challenge's empty-mask convention (run_length_encoding.py:10-22).
    """
    flat = np.asarray(mask).T.ravel()
    on = np.flatnonzero(flat > 0)
    if on.size < min_pixels:
        return ""
    breaks = np.flatnonzero(np.diff(on) > 1)
    starts = np.concatenate([[on[0]], on[breaks + 1]])
    ends = np.concatenate([on[breaks], [on[-1]]])
    lengths = ends - starts
    pairs = np.stack([starts + 1, lengths + 1], axis=1).ravel()
    return " ".join(str(int(v)) for v in pairs)


def rle_decoding(rle: str, shape: Tuple[int, int]) -> np.ndarray:
    """Inverse of rle_encoding (for round-trip testing)."""
    out = np.zeros(shape[0] * shape[1], np.uint8)
    if rle:
        nums = [int(v) for v in rle.split()]
        for start, length in zip(nums[::2], nums[1::2]):
            out[start - 1:start - 1 + length] = 1
    return out.reshape(shape[::-1]).T


def write_rle_submission(masks: Iterable[np.ndarray], out_path: str,
                         ids: Optional[Sequence] = None) -> str:
    """Write the challenge CSV: header "img,pixels", one RLE row per mask
    (run_length_encoding.py:24-52)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("img,pixels\n")
        for i, mask in enumerate(masks):
            row_id = ids[i] if ids is not None else i + 1
            f.write(f"{row_id},{rle_encoding(mask)}\n")
    return out_path


def hard_dice(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    """Hard Dice with the challenge's both-empty := 1 rule
    (filter_incoherent_images.py:21-31)."""
    denom = int((y_pred == 1).sum() + (y_true == 1).sum())
    if denom == 0:
        return 1.0
    return float(2 * y_true[y_pred == 1].sum() / denom)


def _downsample_mean(img: np.ndarray, factor: int) -> np.ndarray:
    h, w = img.shape[0] // factor * factor, img.shape[1] // factor * factor
    v = img[:h, :w].reshape(h // factor, factor, w // factor, factor)
    return v.mean(axis=(1, 3))


def filter_incoherent_images(
        images: Sequence[np.ndarray], masks: Sequence[np.ndarray],
        similarity_threshold: float = 0.005,
        downsample: int = 8) -> Tuple[List[int], List[Tuple[int, int]]]:
    """Find near-duplicate images whose masks disagree.

    The reference notebook-derived filter clusters visually similar images
    per patient (cosine distance on downsampled intensities) and flags pairs
    where one annotation is empty and the other is not — contradictory
    labels that cap achievable accuracy. Returns (keep_indices,
    incoherent_pairs).
    """
    feats = np.stack([
        _downsample_mean(np.asarray(img, np.float32), downsample).ravel()
        for img in images])
    feats -= feats.mean(axis=1, keepdims=True)
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    feats /= norms
    sim = feats @ feats.T  # cosine similarity
    has_mask = np.asarray([int(np.asarray(m).sum() > 0) for m in masks])

    incoherent_pairs: List[Tuple[int, int]] = []
    drop = set()
    n = len(images)
    for i in range(n):
        for j in range(i + 1, n):
            if 1.0 - sim[i, j] < similarity_threshold and has_mask[i] != has_mask[j]:
                incoherent_pairs.append((i, j))
                # drop the empty-mask twin (keep the positive annotation)
                drop.add(j if has_mask[i] else i)
    keep = [i for i in range(n) if i not in drop]
    return keep, incoherent_pairs
