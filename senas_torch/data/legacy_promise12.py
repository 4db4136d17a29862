"""Legacy PROMISE12 3-D volume pipeline (V-Net style).

A numpy and scipy copy of `senas_tpu/data/legacy_promise12.py`, kept here
so that the port imports nothing of the JAX package. The reference carries
a SimpleITK `DataManager` + torch `customDataset` pair (reference
utils/datasets/promise12.py:16-236 and :424-490) that nothing imports at
run time: the V-Net-era path that isotropically resamples each MRI volume
to a target spacing, center-crops a fixed 3-D block, trains on whole
volumes, and back-registers the predicted block onto the original image
grid with connected-component cleanup. The live loader is the 2-D slice
path (data/promise12.py).

No SimpleITK: the port's MetaImage reader (data/io.py) supplies array +
spacing/direction/origin, and the resampling is an explicit output-grid ->
input-grid affine index map evaluated with scipy.ndimage.map_coordinates
(SimpleITK's ResampleImageFilter semantics: output voxel i at physical
O + D·diag(dst_res)·i, pulled from the input grid, zero-padded outside).
Arrays are returned in the reference's [x, y, z] layout (its
`np.transpose(..., [2, 1, 0])` of the sitk [z, y, x] buffer) so downstream
indexing matches line for line.

Reference quirks preserved:
  * per-volume min-max rescale to [0, 1] at load (RescaleIntensityImageFilter),
  * normalization by mean/std of the >0 voxels only (promise12.py:89-94),
  * GT resampled LINEARLY then thresholded at 0.5 (:99-105),
  * `newSize = max(spacing/dst_res * size, vol_size)` crop-window arithmetic
    (:121-148),
  * largest-connected-component cleanup where the background bin counts as
    size 0 (:222-229),
  * the `normDir` direction-normalization transform centered at the
    physical ORIGIN (sitk AffineTransform default center), not the volume
    center (:125-134).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .io import MetaImage, read_mhd, write_mhd

from scipy import ndimage as _ndi


DEFAULT_PARAMS = {
    # reference defaults: isotropic 1x1x1.5 mm, 128x128x64 block
    # (promise12.py:17 comment)
    "dstRes": np.asarray([1.0, 1.0, 1.5], dtype=float),
    "VolSize": np.asarray([128, 128, 64], dtype=int),
    "normDir": False,
}


def _direction_matrix(meta: MetaImage) -> np.ndarray:
    d = np.asarray(meta.direction, dtype=float)
    return d.reshape(3, 3) if d.size == 9 else np.eye(3)


def _xyz_array(meta: MetaImage) -> np.ndarray:
    """[z, y, x] buffer -> [x, y, z] (the reference's transpose [2,1,0])."""
    return np.transpose(np.asarray(meta.array, dtype=np.float32), (2, 1, 0))


def _map_grid(out_size: Sequence[int], out_res: Sequence[float],
              in_res: Sequence[float], direction: np.ndarray,
              origin: Sequence[float], norm_dir: bool,
              inverse: bool) -> np.ndarray:
    """Continuous input indices (3, X, Y, Z) for each output voxel.

    Physical model (both grids share the reference image's origin O and
    direction D — SetReferenceImage semantics):
        x_phys = O + D · diag(out_res) · i
        p      = T(x_phys)              T = D^{-1} (normDir resample),
                                        T = D      (normDir back-register),
                                        identity otherwise
        j      = diag(1/in_res) · D^{-1} · (p − O)
    Without normDir everything collapses to per-axis index scaling; with it
    the sitk AffineTransform is centered at PHYSICAL ZERO (its default), so
    the origin contributes the constant diag(1/in_res)·D^{-1}·(T·O − O).
    """
    ix, iy, iz = [np.arange(s, dtype=float) for s in out_size]
    grid = np.stack(np.meshgrid(ix, iy, iz, indexing="ij"))  # (3, X, Y, Z)
    scale_out = np.asarray(out_res, dtype=float)
    scale_in = np.asarray(in_res, dtype=float)
    if norm_dir:
        d_inv = np.linalg.inv(direction)
        t = d_inv if inverse else direction
        m = d_inv @ t @ direction * scale_out  # columns scaled = ·diag(r)
        m = m / scale_in[:, None]              # rows scaled = diag(1/s)·
        o = np.asarray(origin, dtype=float)[:3]
        off = (d_inv @ (t @ o - o)) / scale_in
        return (np.einsum("ab,bxyz->axyz", m, grid)
                + off[:, None, None, None])
    # identity transform: D^{-1}·D = I, pure per-axis scaling
    s = (scale_out / scale_in)[:, None, None, None]
    return grid * s


def resample_to_grid(meta: MetaImage, dst_res: Sequence[float],
                     new_size: Sequence[int], order: int,
                     norm_dir: bool = False) -> np.ndarray:
    """SimpleITK ResampleImageFilter equivalent -> [x, y, z] float array.

    order=1 is sitkLinear, order=0 sitkNearestNeighbor; outside-of-volume
    reads are 0 (sitk default pixel value)."""
    vol = _xyz_array(meta)
    coords = _map_grid(new_size, dst_res, meta.spacing,
                       _direction_matrix(meta), meta.origin, norm_dir,
                       inverse=True)
    return _ndi.map_coordinates(vol, coords, order=order, mode="constant",
                                cval=0.0, prefilter=False)


class DataManager:
    """Volume-level PROMISE12 manager (reference promise12.py:16-236).

    Same public surface: createImageFileList / createGTFileList /
    loadImages / loadGT / loadTrainingData / loadTestingData /
    loadInferData / getNumpyImages / getNumpyGT / getNumpyData /
    writeResultsFromNumpyLabel. Operates on .mhd volumes via the repo's
    native reader instead of SimpleITK.
    """

    def __init__(self, image_folder: str, gt_folder: Optional[str],
                 results_dir: str, parameters: Optional[dict] = None):
        p = dict(DEFAULT_PARAMS)
        if parameters:
            p.update(parameters)
        p["dstRes"] = np.asarray(p["dstRes"], dtype=float)
        p["VolSize"] = np.asarray(p["VolSize"], dtype=int)
        self.params = p
        self.imageFolder = image_folder
        self.GTFolder = gt_folder
        self.resultsDir = results_dir
        self.sitkImages: Dict[str, MetaImage] = {}
        self.sitkGT: Dict[str, MetaImage] = {}
        self.meanIntensityTrain: Optional[float] = None

    # --- file discovery (reference :36-43) ---
    def createImageFileList(self):
        self.imageFileList = [
            f for f in sorted(os.listdir(self.imageFolder))
            if os.path.isfile(os.path.join(self.imageFolder, f))
            and "_seg" not in f and ".raw" not in f]

    def createGTFileList(self):
        self.GTFileList = [
            f for f in sorted(os.listdir(self.GTFolder))
            if os.path.isfile(os.path.join(self.GTFolder, f))
            and "_seg" in f and ".raw" not in f]

    # --- loading (reference :45-84) ---
    def loadImages(self):
        self.sitkImages = {}
        m = 0.0
        for f in self.imageFileList:
            key = f.split(".")[0]
            meta = read_mhd(os.path.join(self.imageFolder, f))
            arr = np.asarray(meta.array, dtype=np.float32)
            lo, hi = float(arr.min()), float(arr.max())
            arr = (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)
            self.sitkImages[key] = MetaImage(
                array=arr, spacing=meta.spacing, origin=meta.origin,
                direction=meta.direction, header=meta.header)
            m += float(arr.mean())
        self.meanIntensityTrain = m / max(len(self.sitkImages), 1)

    def loadGT(self):
        self.sitkGT = {}
        for f in self.GTFileList:
            key = f.split(".")[0]
            meta = read_mhd(os.path.join(self.GTFolder, f))
            arr = (np.asarray(meta.array, dtype=np.float32) > 0.5
                   ).astype(np.float32)
            self.sitkGT[key] = MetaImage(
                array=arr, spacing=meta.spacing, origin=meta.origin,
                direction=meta.direction, header=meta.header)

    def loadTrainingData(self):
        self.createImageFileList()
        self.createGTFileList()
        self.loadImages()
        self.loadGT()

    loadTestingData = loadTrainingData

    def loadInferData(self):
        self.createImageFileList()
        self.loadImages()

    # --- resample + crop (reference :86-152) ---
    def _grid_for(self, meta: MetaImage) -> Tuple[np.ndarray, np.ndarray]:
        """(new_size, start_px) of the dst-res grid + centered crop window."""
        size_xyz = np.asarray(meta.array.shape[::-1], dtype=float)  # x,y,z
        factor = np.asarray(meta.spacing, dtype=float)[:3] / self.params["dstRes"]
        factor_size = size_xyz * factor
        new_size = np.max([factor_size, self.params["VolSize"].astype(float)],
                          axis=0).astype(int)
        centroid = new_size.astype(float) / 2.0
        start = (centroid - self.params["VolSize"] / 2.0).astype(int)
        return new_size, start

    def getNumpyData(self, dat: Dict[str, MetaImage], order: int
                     ) -> Dict[str, np.ndarray]:
        out = {}
        vs = self.params["VolSize"]
        for key, meta in dat.items():
            new_size, start = self._grid_for(meta)
            res = resample_to_grid(meta, self.params["dstRes"], new_size,
                                   order, norm_dir=self.params["normDir"])
            out[key] = res[start[0]:start[0] + vs[0],
                           start[1]:start[1] + vs[1],
                           start[2]:start[2] + vs[2]].astype(np.float64)
        return out

    def getNumpyImages(self) -> Dict[str, np.ndarray]:
        dat = self.getNumpyData(self.sitkImages, order=1)
        for key in dat:  # V-Net standardization over the >0 voxels only
            pos = dat[key][dat[key] > 0]
            mean = float(np.mean(pos)) if pos.size else 0.0
            std = float(np.std(pos)) if pos.size else 1.0
            dat[key] -= mean
            dat[key] /= std if std else 1.0
        return dat

    def getNumpyGT(self) -> Dict[str, np.ndarray]:
        dat = self.getNumpyData(self.sitkGT, order=1)  # LINEAR, then 0.5
        return {k: (v > 0.5).astype(np.float32) for k, v in dat.items()}

    # --- back-registration (reference :155-236) ---
    def numpy_label_to_original_grid(self, result: np.ndarray, key: str
                                     ) -> np.ndarray:
        """Place a VolSize [x,y,z] mask back onto the ORIGINAL image grid
        (inverse of getNumpyData's resample+crop), threshold, and keep the
        largest connected component. Returns uint8 [x,y,z]."""
        meta = self.sitkImages[key]
        new_size, start = self._grid_for(meta)
        # paste the cropped block into the full dst-res grid
        vs = self.params["VolSize"]
        full = np.zeros(tuple(new_size), dtype=np.float32)
        full[start[0]:start[0] + vs[0], start[1]:start[1] + vs[1],
             start[2]:start[2] + vs[2]] = result.astype(np.float32)
        # resample the dst grid back to the original grid (NN, like the
        # reference's second resampler.Execute with sitkNearestNeighbor)
        orig_size = tuple(int(s) for s in meta.array.shape[::-1])
        coords = _map_grid(orig_size, meta.spacing, self.params["dstRes"],
                           _direction_matrix(meta), meta.origin,
                           self.params["normDir"], inverse=False)
        back = _ndi.map_coordinates(full, coords, order=0, mode="constant",
                                    cval=0.0, prefilter=False)
        binary = (back >= 0.5).astype(np.uint8)
        # largest-connected-component cleanup; reference counts background
        # as size 0 so an all-empty mask stays empty (:222-229). scipy's
        # default structure is face connectivity == sitk ConnectedComponent.
        labels, n = _ndi.label(binary)
        if n == 0:
            return np.zeros_like(binary)
        sizes = np.concatenate([[0], _ndi.sum_labels(
            np.ones_like(binary), labels, index=np.arange(1, n + 1))])
        active = int(np.argmax(sizes))
        return (labels == active).astype(np.uint8)

    def writeResultsFromNumpyLabel(self, result: np.ndarray, key: str,
                                   result_tag: str = "_segmentation",
                                   ext: str = ".mhd",
                                   result_dir: Optional[str] = None) -> str:
        mask_xyz = self.numpy_label_to_original_grid(result, key)
        meta = self.sitkImages[key]
        out = MetaImage(array=np.transpose(mask_xyz, (2, 1, 0)),
                        spacing=meta.spacing, origin=meta.origin,
                        direction=meta.direction)
        result_dir = result_dir or self.resultsDir
        os.makedirs(result_dir, exist_ok=True)
        path = os.path.join(result_dir, key + result_tag + ext)
        write_mhd(path, out)
        return path


class LegacyVolumeDataset:
    """Whole-volume dataset (reference customDataset, promise12.py:424-490).

    mode="train":  images/GT are index-aligned arrays; item =
                   (image [1, z, y, x] float32, gt [z, y, x]) — the
                   reference's transpose([2,1,0]) + expand_dims(0).
    mode="test":   images/GT are the DataManager dicts; item =
                   (image, gt, key) with gt looked up at key+"_segmentation".
    mode="infer":  (image, key).
    """

    def __init__(self, mode: str, images, gt=None):
        if images is None:
            raise RuntimeError("images must be set")
        if mode not in ("train", "test", "infer"):
            raise ValueError(f"mode must be train, test or infer, not {mode!r}")
        self.mode = mode
        self.images = images
        self.GT = gt

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        if self.mode == "train":
            img = np.transpose(self.images[index], (2, 1, 0))
            img = np.expand_dims(img, 0).astype(np.float32)
            gt = np.transpose(self.GT[index], (2, 1, 0))
            return img, gt
        key = list(self.images.keys())[index]
        img = np.transpose(self.images[key], (2, 1, 0))
        img = np.expand_dims(img, 0).astype(np.float32)
        if self.mode == "infer":
            return img, key
        gt = np.transpose(self.GT[key + "_segmentation"], (2, 1, 0))
        return img, gt, key
