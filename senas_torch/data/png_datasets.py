"""Image-pair segmentation loaders: ultrasound-nerve, bladder, CamVid, and
CHAOS from its DICOM series.

A port of `senas_tpu/data/png_datasets.py` that reads its files with
`senas_torch.data.imfile` (no Pillow) and `senas_torch.data.dicom`, and
augments with `senas_torch.data.augment` (no cv2). Under the same
`random.seed` and `np.random.seed` each sample equals the JAX package's bit
for bit.

Reference counterparts: utils/datasets/ultrasound_nerve.py (Kaggle nerve,
*_mask.tif pairs), bladder.py, camvid.py, chaos.py.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from senas_torch.data import augment as A
from senas_torch.data.base import SPECS, SegmentationDataset, register_dataset, require_root
from senas_torch.data.dicom import read_dicom_pixels
from senas_torch.data.imfile import read_image
from senas_torch.utils.misc import create_class_weight


def joint_transform(translate: Tuple[float, float]) -> A.Compose:
    """The train split's joint augmentation of every loader here and in
    data/msd.py and data/monusac.py (heart.py:63-92)."""
    return A.Compose([
        A.RandomTranslate(offset=translate),
        A.RandomVerticallyFlip(),
        A.RandomHorizontallyFlip(),
        A.RandomElasticTransform(alpha=1.5, sigma=0.07),
    ])


class _PairDataset(SegmentationDataset):
    """Shared crop / augment / normalise template (heart.py:63-92)."""

    def __init__(self, spec_name: str, mode: str,
                 pairs: List[Tuple[str, Optional[str]]],
                 translate=(0.2, 0.1), convert: str = "L", label_remap_255=True):
        self.spec = SPECS[spec_name]
        self.mode = mode
        self.data_info = pairs
        self.label_remap_255 = label_remap_255
        self.convert = convert
        h, w = self.spec.crop_size
        self.random_crop = A.RandomSizedCrop((w, h), presize=self.spec.presize)
        self.center_crop = A.CenterCrop((w, h), presize=self.spec.presize)
        self.joint_transform = joint_transform(translate)

    def __len__(self):
        return len(self.data_info)

    def __getitem__(self, index):
        img_path, mask_path = self.data_info[index]
        img = read_image(img_path, self.convert).astype(np.float32)
        if mask_path is not None:
            lab = read_image(mask_path, "L")
        else:
            lab = np.zeros(img.shape[:2], np.uint8)
        if self.mode == "train":
            img, lab = self.random_crop(img, lab)
            img, lab = self.joint_transform(img, lab)
        else:
            img, lab = self.center_crop(img, lab)
        img = img / 255.0
        if self.spec.mean is not None:
            mean = np.asarray(self.spec.mean, np.float32)
            std = np.asarray(self.spec.std, np.float32)
            img = (img - mean) / std if img.ndim == 3 else (img - mean[0]) / std[0]
        lab = lab.astype(np.int32)
        if self.label_remap_255:
            lab[lab == 255] = 1
        if img.ndim == 2:
            img = img[..., None]
        return img.astype(np.float32), lab


class UltraNerve(_PairDataset):
    """Kaggle ultrasound-nerve: <i>.tif + <i>_mask.tif pairs under
    data_clean/ (train/val) or test/ (ultrasound_nerve.py:29-60)."""

    def __init__(self, root, mode="train"):
        base = os.path.join(require_root("ultrasound_nerve", root), "ultrasound-nerve")
        sub = "data_clean" if mode in ("train", "val") else "test"
        folder = os.path.join(base, sub)
        pairs = []
        if os.path.isdir(folder):
            for f in sorted(os.listdir(folder)):
                if f.endswith(".tif") and "_mask" not in f:
                    mask = os.path.join(folder, f.replace(".tif", "_mask.tif"))
                    pairs.append((os.path.join(folder, f),
                                  mask if os.path.exists(mask) else None))
        if not pairs:
            raise RuntimeError(f"Found 0 images under {folder}")
        super().__init__("ultrasound_nerve", mode, pairs, translate=(0.2, 0.2))


class Bladder(_PairDataset):
    """bladder/{Images,Labels} PNG pairs (bladder.py:19-60); 3 classes with
    labels stored as 0/128/255 -> 0/1/2."""

    def __init__(self, root, mode="train"):
        base = os.path.join(require_root("bladder", root), "bladder")
        img_dir = os.path.join(base, "Images")
        lab_dir = os.path.join(base, "Labels")
        pairs = []
        if os.path.isdir(img_dir):
            for f in sorted(os.listdir(img_dir)):
                pairs.append((os.path.join(img_dir, f), os.path.join(lab_dir, f)))
        if not pairs:
            raise RuntimeError(f"Found 0 images under {base}")
        super().__init__("bladder", mode, pairs, label_remap_255=False)

    def __getitem__(self, index):
        img, lab = super().__getitem__(index)
        lab = np.where(lab >= 255, 2, np.where(lab >= 128, 1, 0)).astype(np.int32)
        return img, lab


class CamVid(_PairDataset):
    """CamVid street scenes, 12 classes, RGB (camvid.py:68-120)."""

    def __init__(self, root, mode="train"):
        base = os.path.join(require_root("camvid", root), "CamVid")
        sub = {"train": "train", "val": "val", "test": "test"}.get(mode, "train")
        img_dir = os.path.join(base, sub)
        lab_dir = os.path.join(base, sub + "annot")
        pairs = []
        if os.path.isdir(img_dir):
            for f in sorted(os.listdir(img_dir)):
                pairs.append((os.path.join(img_dir, f), os.path.join(lab_dir, f)))
        if not pairs:
            raise RuntimeError(f"Found 0 images under {base}")
        super().__init__("camvid", mode, pairs, convert="RGB", label_remap_255=False)


def _chaos_mask_name(image_name: str, chaos_type: str, is_dup: bool) -> str:
    """Ground-truth filename for a DICOM slice (chaos.py:8-30 rules).

    CT has two filename batches (IMG-...-i.dcm and i0xxx,0000b.dcm); MR
    T1DUAL in/out-phase pairs share one mask (is_dup halves the index)."""
    stem = image_name[:-4]
    if chaos_type == "CT":
        if "IMG" in image_name:
            id_num = int(stem.split("-")[-1][2:]) - 1
            return f"liver_GT_{id_num:03}.png"
        return "liver_GT_" + stem.split(",")[0][2:] + ".png"
    m = stem.split("-")[-1]
    ident = "%03d" % ((int(m) + 1) // 2) if is_dup else m[2:]
    return "liver_" + ident + ".png"


def auto_contrast_params(image: np.ndarray, lo_pct=0.01, hi_pct=0.99):
    """Percentile-stretch (a, b) such that a*img + b maps the lo/hi shades
    to 0/255. The reference's auto_contrast (chaos.py:54-66) computes this
    and then returns its input unchanged, so the MR path below does not
    apply it either; the parameters are here for callers who want the
    intended stretch."""
    hist = np.bincount(image.astype(np.uint8).ravel(), minlength=256)
    cum = np.cumsum(hist) / hist.sum()
    p_lo = int(np.searchsorted(cum, lo_pct))
    p_hi = int(np.searchsorted(cum, hi_pct))
    a = 255.0 / max(p_hi + p_lo, 1)
    return a, -a * p_lo


class CHAOS(_PairDataset):
    """CHAOS liver segmentation from DICOM series (chaos.py:85-191).

    chaos_type="CT": HU rescale (slope/intercept, values >= 4000 set to the
    intercept), binary liver labels (255 -> 1). chaos_type="MR": T1DUAL
    (in/out-phase, shared masks) + T2SPIR series, grayscale max-scaling,
    4 organ classes (80/160/240/255 -> 1..4). A slice without its mask gets
    an all-background label.
    """

    def __init__(self, root, mode="train", chaos_type="CT"):
        self.chaos_type = chaos_type
        spec_name = "chaos" if chaos_type == "CT" else "chaos_mr"
        base = os.path.join(require_root(spec_name, root), SPECS[spec_name].base_dir)
        pairs = []
        if os.path.isdir(base):
            for case in sorted(os.listdir(base)):
                if case == "notes.txt":
                    continue
                if chaos_type == "MR":
                    series = [(os.path.join(case, "T1DUAL"), True),
                              (os.path.join(case, "T2SPIR"), False)]
                else:
                    series = [(case, False)]
                for rel, is_dup in series:
                    dicom_dir = os.path.join(base, rel, "DICOM_anon")
                    ground_dir = os.path.join(base, rel, "Ground")
                    if not os.path.isdir(dicom_dir):
                        continue
                    for f in sorted(os.listdir(dicom_dir)):
                        if not f.lower().endswith((".dcm", ".ima")):
                            continue
                        mask = os.path.join(
                            ground_dir, _chaos_mask_name(f, chaos_type, is_dup))
                        pairs.append((os.path.join(dicom_dir, f),
                                      mask if os.path.exists(mask) else None))
        if not pairs:
            raise RuntimeError(f"Found 0 DICOM slices under {base}")
        # MR is harder: wider translate range (chaos.py:96-103)
        translate = (0.3, 0.3) if chaos_type == "MR" else (0.2, 0.1)
        super().__init__(spec_name, mode, pairs, translate=translate)

    def class_weights_from_masks(self):
        """Log-scaled class weights over mask shade counts
        (chaos.py:129-142 + create_class_weight)."""
        shades = [0, 80, 160, 240, 255] if self.chaos_type == "MR" else [0, 255]
        counts = {s: 0.0 for s in shades}
        for _, mask_path in self.data_info:
            if mask_path is None:
                continue
            lab = read_image(mask_path, "L")
            for s in shades:
                counts[s] += float((lab == s).sum())
        counts = {s: max(c, 1.0) for s, c in counts.items()}
        return create_class_weight(counts)

    def __getitem__(self, index):
        img_path, mask_path = self.data_info[index]
        arr, slope, intercept = read_dicom_pixels(img_path)
        if self.chaos_type == "CT":
            arr = arr.astype(np.float32) * slope + intercept
            arr[arr >= 4000] = intercept  # remove abnormal pixels (chaos.py:156)
            lo, hi = arr.min(), arr.max()
            img = (arr - lo) / (hi - lo if hi > lo else 1.0) * 255.0
        else:
            # MR grayscale extraction (chaos.py:69-82): scale max to 255
            arr = arr.astype(np.float32)
            img = np.maximum(arr, 0) / max(arr.max(), 1e-6) * 255.0
            img = np.uint8(img).astype(np.float32)
        if mask_path is not None:
            lab = read_image(mask_path, "L")
        else:
            lab = np.zeros(img.shape, np.uint8)
        if self.mode == "train":
            img, lab = self.random_crop(img, lab)
            img, lab = self.joint_transform(img, lab)
        else:
            img, lab = self.center_crop(img, lab)
        img = img / 255.0
        img = (img - self.spec.mean[0]) / self.spec.std[0]
        lab = lab.astype(np.int32)
        if self.chaos_type == "CT":
            lab[lab == 255] = 1
        else:  # MR organ shades -> class ids (chaos.py:179-186)
            out = np.zeros_like(lab)
            for cls, shade in enumerate((80, 160, 240, 255), start=1):
                out[lab == shade] = cls
            lab = out
        return img[..., None].astype(np.float32), lab


register_dataset("ultrasound_nerve")(lambda root, split="train", mode="train":
                                     UltraNerve(root, mode))
register_dataset("bladder")(lambda root, split="train", mode="train": Bladder(root, mode))
register_dataset("camvid")(lambda root, split="train", mode="train": CamVid(root, mode))
register_dataset("chaos")(lambda root, split="train", mode="train":
                          CHAOS(root, mode, chaos_type="CT"))
register_dataset("chaos_mr")(lambda root, split="train", mode="train":
                             CHAOS(root, mode, chaos_type="MR"))
