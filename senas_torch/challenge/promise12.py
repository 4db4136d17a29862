"""PROMISE12 challenge evaluation + submission writer.

A numpy copy of `senas_tpu/challenge/promise12.py`, kept here so that the
port imports nothing of the JAX package; tests/test_torch_challenge.py
holds each function to the JAX package's on identical inputs, exactly.
Volumetric metrics with the reference's definitions (its
utils/challenge/promise12/metrics.py:10-54, 137-167): per-case soft Dice,
relative absolute volume difference, and symmetric surface distances ->
max (Hausdorff) and mean surface distance; plus the submission writer that
stitches per-slice predictions back into case volumes and restores
origin/direction/spacing (store_test_seg.py:8-38). SimpleITK and skimage
are replaced by the port's own MHD reader and writer (`data/io.py`) and
scipy.ndimage.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from senas_torch.data.io import MetaImage, read_mhd, write_mhd


def numpy_dice(y_true: np.ndarray, y_pred: np.ndarray, axis=None,
               smooth: float = 1.0) -> np.ndarray:
    """Soft Dice over the given axes (metrics.py:137-139)."""
    intersection = (y_true * y_pred).sum(axis=axis)
    return (2.0 * intersection + smooth) / (
        y_true.sum(axis=axis) + y_pred.sum(axis=axis) + smooth)


def rel_abs_vol_diff(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Relative absolute volume difference in percent (metrics.py:141-142)."""
    return float(np.abs((y_pred.sum() / y_true.sum() - 1) * 100))


def surface_distances(a: np.ndarray, b: np.ndarray,
                      sampling=1, connectivity: int = 1) -> np.ndarray:
    """Symmetric surface distances between two binary volumes.

    Boundary voxels are extracted by xor with a binary erosion; distances
    come from the Euclidean distance transform with physical `sampling`
    (voxel spacing). max() of the result is the Hausdorff distance, mean()
    the mean surface distance (metrics.py:148-167).
    """
    a = np.atleast_1d(np.squeeze(a).astype(bool))
    b = np.atleast_1d(np.squeeze(b).astype(bool))
    conn = ndimage.generate_binary_structure(a.ndim, connectivity)
    surf_a = a ^ ndimage.binary_erosion(a, conn)
    # NOTE: the reference computes input2's "surface" with logical_or
    # instead of xor (metrics.py:160) — i.e. the full foreground of b plus
    # its eroded interior. That is reproduced here for metric parity.
    surf_b = b | ndimage.binary_erosion(b, conn)
    dist_to_a = ndimage.distance_transform_edt(~surf_a, sampling)
    dist_to_b = ndimage.distance_transform_edt(~surf_b, sampling)
    return np.concatenate([dist_to_a[surf_b], dist_to_b[surf_a]])


def resize_slices_nearest(pred: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Nearest-neighbor resize of [N, h, w] masks to [N, H, W]
    (utils/utils.py:285-296 semantics, cv2-free)."""
    rows, cols = shape[1], shape[2]
    src_h, src_w = pred.shape[1], pred.shape[2]
    ri = np.minimum((np.arange(rows) * src_h / rows).astype(np.int64), src_h - 1)
    ci = np.minimum((np.arange(cols) * src_w / cols).astype(np.int64), src_w - 1)
    return pred[:, ri[:, None], ci[None, :]].astype(int)


def iter_case_volumes(folder: str, case_ids: Optional[Sequence[int]] = None,
                      masks: bool = True) -> Iterator[Tuple[str, MetaImage]]:
    """Yield (filename, MetaImage) for the case .mhd files in `folder`,
    sorted by name; `masks` selects the *_segmentation files
    (metrics.py:56-76)."""
    names = sorted(f for f in os.listdir(folder) if f.endswith(".mhd"))
    if masks:
        names = [f for f in names if "segm" in f.lower()]
    else:
        names = [f for f in names if "segm" not in f.lower()]
    if case_ids is not None:
        wanted = {str(c).zfill(2) for c in case_ids}
        names = [f for f in names
                 if any(w in f for w in wanted)]
    for name in names:
        yield name, read_mhd(os.path.join(folder, name))


def volumetric_metrics(pred_slices: Iterable[np.ndarray], folder: str,
                       case_ids: Optional[Sequence[int]] = None,
                       logger=None) -> Dict[str, float]:
    """Per-case volumetric evaluation (biomedical_image_metric,
    metrics.py:10-54).

    pred_slices: iterable of [h, w] (or [h, w, 1]) binary mask slices in
    case order. Ground truth comes from the *_segmentation.mhd volumes in
    `folder`; predictions are nearest-resized up to each case's native
    resolution before scoring. Returns summary statistics instead of
    printing.
    """
    preds = [np.asarray(p).reshape(p.shape[0], p.shape[1]) for p in pred_slices]
    stacked = np.stack(preds)  # [N, h, w]

    vol_scores, ravds, hauss, mean_surf, slice_scores = [], [], [], [], []
    start = 0
    for _, case in iter_case_volumes(folder, case_ids, masks=True):
        y_true = (case.array > 0).astype(np.int64)
        n = len(y_true)
        y_pred = resize_slices_nearest(stacked[start:start + n], y_true.shape)
        start += n

        ravds.append(rel_abs_vol_diff(y_true, y_pred))
        vol_scores.append(float(numpy_dice(y_true, y_pred, axis=None)))
        spacing = tuple(reversed(case.spacing))  # (x,y,z) header -> (z,y,x)
        sd = surface_distances(y_true, y_pred, sampling=spacing)
        hauss.append(float(sd.max()) if sd.size else 0.0)
        mean_surf.append(float(sd.mean()) if sd.size else 0.0)
        per_slice_axes = tuple(range(1, y_true.ndim))
        slice_scores.append(numpy_dice(y_true, y_pred, axis=per_slice_axes))

    vol_scores = np.asarray(vol_scores)
    slice_scores = np.concatenate(slice_scores) if slice_scores else np.zeros(0)
    summary = {
        "mean_volumetric_dsc": float(vol_scores.mean()),
        "median_volumetric_dsc": float(np.median(vol_scores)),
        "std_volumetric_dsc": float(vol_scores.std()),
        "mean_hausdorff": float(np.mean(hauss)),
        "mean_mean_surface_dist": float(np.mean(mean_surf)),
        "mean_rel_abs_vol_diff": float(np.mean(ravds)),
        "mean_slice_dsc": float(slice_scores.mean()) if slice_scores.size else 0.0,
        "n_cases": len(vol_scores),
    }
    if logger is not None:
        for k, v in summary.items():
            logger.info("%s: %s", k, v)
    return summary


def predict_test(pred_slices: Iterable[np.ndarray], case_paths: Sequence[str],
                 dest: str = "../data/predictions") -> List[str]:
    """Stitch per-slice predictions back into case volumes and write
    <case>_segmentation.mhd with the source origin/direction/spacing
    restored (store_test_seg.py:8-38). Returns the written paths."""
    os.makedirs(dest, exist_ok=True)
    preds = [np.asarray(p).reshape(p.shape[0], p.shape[1]) for p in pred_slices]
    stacked = np.stack(preds)

    written = []
    start = 0
    for path in case_paths:
        case = read_mhd(path)
        n = len(case.array)
        vol = resize_slices_nearest(stacked[start:start + n], case.array.shape)
        start += n
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(dest, f"{name}_segmentation.mhd")
        write_mhd(out_path, MetaImage(
            array=vol.astype(np.uint8), spacing=case.spacing,
            origin=case.origin, direction=case.direction))
        written.append(out_path)
    return written


def best_worst_contour_grid(images: np.ndarray, y_true: np.ndarray,
                            y_pred: np.ndarray, out_path: str,
                            n_best: int = 20, n_worst: int = 20) -> str:
    """Contour grid of the best/worst predictions among non-empty slices
    (make_plots, metrics.py:76-134). GT contours red, prediction blue.
    Draws with matplotlib, imported here: the rest of the port does not
    need it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    axes = tuple(range(1, y_true.ndim))
    scores = numpy_dice(y_true.astype(float), y_pred.astype(float), axis=axes)
    nonempty = set(np.nonzero(y_true.sum(axis=axes))[0].tolist())
    order = np.argsort(scores)[::-1]
    picks = [i for i in order if i in nonempty][:n_best]
    picks += [i for i in order[::-1] if i in nonempty][:n_worst]

    n_cols = 4
    n_rows = max(1, int(np.ceil(len(picks) / n_cols)))
    fig, ax_grid = plt.subplots(n_rows, n_cols,
                                figsize=(4 * n_cols, 4 * n_rows), squeeze=False)
    for slot, idx in enumerate(picks):
        ax = ax_grid[slot // n_cols][slot % n_cols]
        ax.imshow(images[idx], cmap="gray")
        ax.contour(y_true[idx], levels=[0.5], colors="r", linewidths=1)
        ax.contour(y_pred[idx], levels=[0.5], colors="b", linewidths=1)
        ax.set_xticks([]), ax.set_yticks([])
    for slot in range(len(picks), n_rows * n_cols):
        ax_grid[slot // n_cols][slot % n_cols].axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return out_path
