"""Medical Segmentation Decathlon tasks: Heart / Spleen / Pancreas / Hippo.

A port of `senas_tpu/data/msd.py` without Pillow or cv2. One template covers
all four (the reference's heart.py / spleen.py / pancreas.py / hippo.py are
per-task copies of the same walker): per-slice PNGs under
<root>/<Task..>/imagesTr/<case>/<i>.png with matching labelsTr, which
`extract_task` writes once from the task's .nii.gz volumes; train:
RandomSizedCrop(crop, presize) -> translate/vflip/hflip/elastic; val:
CenterCrop; image scaled to [0,1] then mean/std-normalised; labels
255 -> 1 (heart.py:63-92).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from senas_torch.data import augment as A
from senas_torch.data.base import SPECS, SegmentationDataset, register_dataset, require_root
from senas_torch.data.imfile import read_image, write_png_l
from senas_torch.data.io import read_nifti
from senas_torch.data.png_datasets import joint_transform

TASKS = ("heart", "spleen", "pancreas", "hippo")


def nii_to_png_slices(nii_path: str, out_dir: str, is_label: bool):
    """Extract the axial slices of a NIfTI volume to 8-bit PNGs
    (heart.py:127-134): labels as 255 * label clipped to [0, 255], every
    value through Pillow's float-to-8-bit conversion (`write_png_l`:
    truncated toward zero, clipped, so intensities above 255 saturate)."""
    os.makedirs(out_dir, exist_ok=True)
    vol = read_nifti(nii_path)
    for i in range(vol.shape[-1]):
        arr = np.asarray(vol[..., i])
        if is_label:
            arr = (255 * arr.astype(np.int64)).clip(0, 255)
        write_png_l(os.path.join(out_dir, f"{i}.png"), arr.astype(np.float64))


def extract_task(base_path: str):
    """Walk imagesTr/labelsTr .nii.gz volumes and extract per-slice PNGs
    (each volume once: an existing slice folder is kept)."""
    for sub, is_label in [("imagesTr", False), ("labelsTr", True)]:
        folder = os.path.join(base_path, sub)
        if not os.path.isdir(folder):
            continue
        for f in sorted(os.listdir(folder)):
            if ".nii" not in f:
                continue
            out = os.path.join(folder, f.split(".")[0])
            if not os.path.exists(out):
                nii_to_png_slices(os.path.join(folder, f), out, is_label)


class MSDTask(SegmentationDataset):
    def __init__(self, spec_name: str, root: str, mode: str = "train"):
        self.spec = SPECS[spec_name]
        self.mode = mode
        base = os.path.join(require_root(spec_name, root), self.spec.base_dir)
        image_path = os.path.join(base, "imagesTr")
        mask_path = os.path.join(base, "labelsTr")

        self.data_info: List[Tuple[str, str]] = []
        if mode in ("train", "val"):
            for walk_root, _dirs, files in os.walk(image_path):
                case = walk_root.split(os.sep)[-1]
                for f in files:
                    if ".nii" in f or not f.endswith(".png"):
                        continue
                    self.data_info.append((os.path.join(image_path, case, f),
                                           os.path.join(mask_path, case, f)))
            if not self.data_info:
                raise RuntimeError(f"Found 0 images under {base}")
            self.data_info.sort()

        h, w = self.spec.crop_size
        # augment sizes are (W, H), the reference's PIL convention
        self.random_crop = A.RandomSizedCrop((w, h), presize=self.spec.presize)
        self.center_crop = A.CenterCrop((w, h), presize=self.spec.presize)
        self.joint_transform = joint_transform((0.2, 0.1))

    def __len__(self):
        return len(self.data_info)

    def __getitem__(self, index):
        img_path, mask_path = self.data_info[index]
        img = read_image(img_path, "L").astype(np.float32)
        lab = read_image(mask_path, "L")
        if self.mode == "train":
            img, lab = self.random_crop(img, lab)
            img, lab = self.joint_transform(img, lab)
        else:
            img, lab = self.center_crop(img, lab)
        img = img / 255.0
        mean, std = self.spec.mean[0], self.spec.std[0]
        img = (img - mean) / std
        lab = lab.astype(np.int32)
        lab[lab == 255] = 1
        return img[..., None].astype(np.float32), lab


for _name in TASKS:
    def _factory(root, split="train", mode="train", _n=_name):
        return MSDTask(_n, root=root, mode=mode)
    register_dataset(_name)(_factory)
