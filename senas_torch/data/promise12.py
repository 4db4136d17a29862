"""PROMISE12 prostate MR dataset.

A port of `senas_tpu/data/promise12.py` (the reference's
utils/datasets/promise12.py) without cv2:
  * a one-time build of per-slice .npy caches under npy_image_<rows> from
    the TrainingData/*.mhd volumes: per-slice CLAHE (clip 0.05), nearest
    resize to crop², the fixed val cases [5, 15, 25, 35, 45], curvature-flow
    smoothing, and the train set's mean and std applied to val and test
    (promise12.py:250-319);
  * the train split's joint augmentation: RandomTranslate(0.2, 0.1),
    vertical and horizontal flips, Elastic(alpha 1.5, sigma 0.07)
    (promise12.py:361-366).

Volumes are read with the port's MetaImage reader (data/io.py).
"""

from __future__ import annotations

import os

import numpy as np

from senas_torch.data import augment as A
from senas_torch.data import imgproc
from senas_torch.data.base import SPECS, SegmentationDataset, register_dataset, require_root
from senas_torch.data.io import read_mhd

VAL_CASES = [5, 15, 25, 35, 45]


def _img_resize(imgs: np.ndarray, rows: int, cols: int, equalize: bool) -> np.ndarray:
    out = np.zeros((len(imgs), rows, cols))
    for i, img in enumerate(imgs):
        if equalize:
            img = A.equalize_adapthist(img, clip_limit=0.05)
        out[i] = imgproc.resize_nearest(img, rows, cols)
    return out


def build_cache(base_path: str, store_path: str, rows: int, cols: int):
    """Volumes -> slice .npy cache (the reference's data_to_array). A case
    belongs to a split when its file name holds the case number as two
    digits, as in the reference."""
    os.makedirs(store_path, exist_ok=True)
    train_dir = os.path.join(base_path, "TrainingData")
    file_list = sorted(x for x in os.listdir(train_dir) if x.endswith(".mhd"))
    train_list = sorted(set(range(50)) - set(VAL_CASES))

    mu = sigma = None
    for count, case_list in enumerate([train_list, VAL_CASES]):
        images, masks = [], []
        wanted = [f for f in file_list if any(str(c).zfill(2) in f for c in case_list)]
        for filename in wanted:
            vol = read_mhd(os.path.join(train_dir, filename)).array
            if "segm" in filename.lower():
                masks.append(_img_resize(vol, rows, cols, equalize=False))
            else:
                images.append(_img_resize(vol, rows, cols, equalize=True))
        images = np.concatenate(images, 0).reshape(-1, rows, cols)
        masks = np.concatenate(masks, 0).reshape(-1, rows, cols).astype(np.uint8)
        images = A.smooth_images(images).astype(np.float32)
        if count == 0:
            mu, sigma = float(np.mean(images)), float(np.std(images))
        tag = ("train", "val")[count]
        np.save(os.path.join(store_path, f"X_{tag}.npy"), (images - mu) / sigma)
        np.save(os.path.join(store_path, f"y_{tag}.npy"), masks)

    test_dir = os.path.join(base_path, "TestData")
    if os.path.isdir(test_dir):
        file_list = sorted(x for x in os.listdir(test_dir) if x.endswith(".mhd"))
        images, n_imgs = [], []
        for filename in file_list:
            imgs = _img_resize(read_mhd(os.path.join(test_dir, filename)).array,
                               rows, cols, equalize=True)
            images.append(imgs)
            n_imgs.append(len(imgs))
        if images:
            images = np.concatenate(images, 0).reshape(-1, rows, cols)
            images = A.smooth_images(images).astype(np.float32)
            np.save(os.path.join(store_path, "X_test.npy"), (images - mu) / sigma)
            np.save(os.path.join(store_path, "test_n_imgs.npy"), np.array(n_imgs))


MODES = ("train", "val", "test")


class Promise12(SegmentationDataset):
    """Slices of the cache (built on first use) in mode train, val or test.
    The test mode's labels are zeros; `n_imgs` holds each test case's
    slice count and `test_file_list` its volumes, in case order."""

    def __init__(self, root: str, mode: str = "train"):
        root = require_root("promise12", root)
        if mode not in MODES:
            raise ValueError(f"promise12 mode {mode!r}; one of {MODES}")
        self.spec = SPECS["promise12"]
        self.mode = mode
        rows, cols = self.spec.crop_size
        base = os.path.join(root, self.spec.base_dir)
        store = os.path.join(base, f"npy_image_{rows}")
        if not os.path.exists(store):
            build_cache(base, store, rows, cols)

        self.X = np.load(os.path.join(store, f"X_{mode}.npy"))
        if mode != "test":
            self.y = np.load(os.path.join(store, f"y_{mode}.npy"))
        else:
            self.y = np.zeros_like(self.X, dtype=np.uint8)
            self.n_imgs = np.load(os.path.join(store, "test_n_imgs.npy"))
            test_dir = os.path.join(base, "TestData")
            self.test_file_list = sorted(
                os.path.join(test_dir, x) for x in os.listdir(test_dir) if x.endswith(".mhd"))

        self.joint_transform = A.Compose([
            A.RandomTranslate(offset=(0.2, 0.1)),
            A.RandomVerticallyFlip(),
            A.RandomHorizontallyFlip(),
            A.RandomElasticTransform(alpha=1.5, sigma=0.07),
        ]) if mode == "train" else None

    def __len__(self):
        return len(self.X)

    def __getitem__(self, index):
        img = self.X[index].astype(np.float32)
        lab = self.y[index].astype(np.int32)
        if self.joint_transform is not None:
            img, lab = self.joint_transform(img, lab.astype(np.uint8))
            lab = lab.astype(np.int32)
        return img[..., None], lab


@register_dataset("promise12")
def _make(root, mode="train", split=None):
    """`split` is the runners' name of the split (train_split / split in
    the config), which they pass to every dataset; PROMISE12's split is its
    mode, as in the JAX package."""
    return Promise12(root=root, mode=mode)
