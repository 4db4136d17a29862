"""MoNuSAC nuclei dataset: pre-cleaned PNG pairs under
MoNuSAC/MoNuSAC_cleaned/{images,masks} (the reference's
utils/datasets/monusac.py: binary labels in this config, 255 -> 1; the
crop / augment / normalise template of the MSD tasks). A port of
`senas_tpu/data/monusac.py` without Pillow or cv2: the RGB images are read
as gray ("L", Pillow's luma), as there."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from senas_torch.data import augment as A
from senas_torch.data.base import SPECS, SegmentationDataset, register_dataset, require_root
from senas_torch.data.imfile import read_image
from senas_torch.data.png_datasets import joint_transform


class MoNuSAC(SegmentationDataset):
    def __init__(self, root: str, mode: str = "train"):
        self.spec = SPECS["monusac"]
        self.mode = mode
        base = os.path.join(require_root("monusac", root), self.spec.base_dir)
        image_path = os.path.join(base, "MoNuSAC_cleaned", "images")
        mask_path = os.path.join(base, "MoNuSAC_cleaned", "masks")
        self.data_info: List[Tuple[str, str]] = []
        if mode in ("train", "val"):
            for _root, _dirs, files in os.walk(mask_path):
                for f in files:
                    self.data_info.append((os.path.join(image_path, f),
                                           os.path.join(mask_path, f)))
            if not self.data_info:
                raise RuntimeError(f"Found 0 images under {base}")
            self.data_info.sort()

        h, w = self.spec.crop_size
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
        img = (img - self.spec.mean[0]) / self.spec.std[0]
        lab = lab.astype(np.int32)
        lab[lab == 255] = 1
        return img[..., None].astype(np.float32), lab


@register_dataset("monusac")
def _make(root, split="train", mode="train"):
    return MoNuSAC(root=root, mode=mode)
