"""Generic semantic-segmentation / classification loaders, without Pillow.

A port of `senas_tpu/data/generic.py` (the reference's NasUnet-inherited
ade20k, pascal_voc, pascal_aug, pcontext, coco, minc and imagenet loaders)
with its class names and structure. The JAX package opens its files with
Pillow and transforms Pillow images; here the images are uint8 arrays,
decoded by `data/imfile.py` (JPEG in the native library) and transformed
by `data/pilresample.py`, both bit-equal to Pillow. The transforms draw
from Python's `random` in the same order, and the normalisation does the
same float arithmetic (float32 / 255, then float64 against the ImageNet
mean and std, cast once), so a sample equals the JAX package's bit for
bit under one `random.seed` (`tests/test_torch_generic.py`).

Pascal-Context and COCO need the `detail` API and pycocotools: they raise
the JAX package's ImportError at the same boundary.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from senas_torch.data import pilresample as P
from senas_torch.data.base import (SPECS, DatasetSpec, SegmentationDataset, register_dataset,
                                   require_root)
from senas_torch.data.imfile import read_image

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _size(arr: np.ndarray) -> Tuple[int, int]:
    """Pillow's `Image.size`: (width, height)."""
    return arr.shape[1], arr.shape[0]


def _normalise(img: np.ndarray) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - np.asarray(_IMAGENET_MEAN)) / np.asarray(_IMAGENET_STD)
    return arr.astype(np.float32)


class _SyncTransformDataset(SegmentationDataset):
    """Scale-jitter -> pad -> random crop (train) / center fit (val), the
    shared pipeline of the generic loaders (ade20k.py:62-94)."""

    def __init__(self, spec: DatasetSpec, mode: str, base_size: int = 520):
        self.spec = spec
        self.mode = mode
        self.base_size = base_size
        self.images: List[str] = []
        self.masks: List[str] = []

    def __len__(self):
        return len(self.images)

    # -- mask value -> training id; dataset-specific ----------------------
    def _mask_transform(self, mask: np.ndarray) -> np.ndarray:
        return mask.astype(np.int32)

    def _sync_transform(self, img: np.ndarray, mask: np.ndarray):
        crop = self.spec.crop_size[0]
        if random.random() < 0.5:
            img = P.flip_left_right(img)
            mask = P.flip_left_right(mask)
        w, h = _size(img)
        long_size = random.randint(int(self.base_size * 0.5),
                                   int(self.base_size * 2.5))
        if h > w:
            oh, ow = long_size, int(1.0 * w * long_size / h + 0.5)
            short = ow
        else:
            ow, oh = long_size, int(1.0 * h * long_size / w + 0.5)
            short = oh
        img = P.resize_bilinear(img, (ow, oh))
        mask = P.resize_nearest(mask, (ow, oh))
        if short < crop:
            padh = crop - oh if oh < crop else 0
            padw = crop - ow if ow < crop else 0
            img = P.expand(img, padw, padh)
            mask = P.expand(mask, padw, padh)
        w, h = _size(img)
        x1 = random.randint(0, w - crop)
        y1 = random.randint(0, h - crop)
        box = (x1, y1, x1 + crop, y1 + crop)
        return P.crop(img, box), P.crop(mask, box)

    def _val_sync_transform(self, img: np.ndarray, mask: np.ndarray):
        crop = self.spec.crop_size[0]
        w, h = _size(img)
        if h > w:
            ow, oh = crop, int(1.0 * h * crop / w)
        else:
            oh, ow = crop, int(1.0 * w * crop / h)
        img = P.resize_bilinear(img, (ow, oh))
        mask = P.resize_nearest(mask, (ow, oh))
        w, h = _size(img)
        x1 = int(round((w - crop) / 2.0))
        y1 = int(round((h - crop) / 2.0))
        box = (x1, y1, x1 + crop, y1 + crop)
        return P.crop(img, box), P.crop(mask, box)

    def _load_pair(self, index: int):
        # the mask as stored: a palette PNG's indices, a gray PNG's values
        return read_image(self.images[index], "RGB"), read_image(self.masks[index], None)

    def __getitem__(self, index: int):
        img, mask = self._load_pair(index)
        if self.mode == "train":
            img, mask = self._sync_transform(img, mask)
        else:
            img, mask = self._val_sync_transform(img, mask)
        lab = self._mask_transform(np.asarray(mask))
        return _normalise(img), lab.astype(np.int32)


# ---------------------------------------------------------------------------
# ADE20K (ade20k.py:20-135)
# ---------------------------------------------------------------------------

ADE20K_SPEC = DatasetSpec("ade20k", "ADEChallengeData2016", 150, 3,
                          (480, 480), False)


class ADE20KSegmentation(_SyncTransformDataset):
    def __init__(self, root, split="train", mode="train"):
        super().__init__(ADE20K_SPEC, mode)
        base = os.path.join(require_root("ade20k", root), self.spec.base_dir)
        sub = "training" if mode == "train" else "validation"
        img_dir = os.path.join(base, "images", sub)
        ann_dir = os.path.join(base, "annotations", sub)
        if os.path.isdir(img_dir):
            for f in sorted(os.listdir(img_dir)):
                if f.endswith(".jpg"):
                    m = os.path.join(ann_dir, f[:-4] + ".png")
                    if os.path.isfile(m):
                        self.images.append(os.path.join(img_dir, f))
                        self.masks.append(m)
        if not self.images:
            raise RuntimeError(f"Found 0 images under {base}")

    def _mask_transform(self, mask):
        # labels are 1..150, 0=void; shift so void becomes -1 (ade20k.py:95)
        return mask.astype(np.int32) - 1


# ---------------------------------------------------------------------------
# Pascal VOC 2012 (pascal_voc.py:10-88)
# ---------------------------------------------------------------------------

VOC_SPEC = DatasetSpec("pascal_voc", "VOCdevkit/VOC2012", 21, 3,
                       (480, 480), False)


class VOCSegmentation(_SyncTransformDataset):
    def __init__(self, root, split="train", mode="train"):
        super().__init__(VOC_SPEC, mode)
        base = os.path.join(require_root("pascal_voc", root), self.spec.base_dir)
        split_f = os.path.join(base, "ImageSets/Segmentation",
                               "trainval.txt" if mode == "train" else "val.txt")
        if os.path.isfile(split_f):
            with open(split_f) as fh:
                for line in fh:
                    name = line.strip()
                    self.images.append(
                        os.path.join(base, "JPEGImages", name + ".jpg"))
                    self.masks.append(
                        os.path.join(base, "SegmentationClass", name + ".png"))
        if not self.images:
            raise RuntimeError(f"Found 0 images under {base}")

    def _mask_transform(self, mask):
        lab = mask.astype(np.int32)
        lab[lab == 255] = 0  # void -> background (pascal_voc.py:80)
        return lab


# ---------------------------------------------------------------------------
# Pascal VOC augmented (SBD .mat masks, pascal_aug.py:7-80)
# ---------------------------------------------------------------------------

VOCAUG_SPEC = DatasetSpec("pascal_aug", "VOCaug/dataset", 21, 3,
                          (480, 480), False)


class VOCAugSegmentation(_SyncTransformDataset):
    def __init__(self, root, split="train", mode="train"):
        super().__init__(VOCAUG_SPEC, mode)
        base = os.path.join(require_root("pascal_aug", root), self.spec.base_dir)
        split_f = os.path.join(base, "trainval.txt" if mode == "train"
                               else "val.txt")
        if os.path.isfile(split_f):
            with open(split_f) as fh:
                for line in fh:
                    name = line.strip()
                    self.images.append(os.path.join(base, "img", name + ".jpg"))
                    self.masks.append(os.path.join(base, "cls", name + ".mat"))
        if not self.images:
            raise RuntimeError(f"Found 0 images under {base}")

    def _load_pair(self, index):
        from scipy.io import loadmat
        img = read_image(self.images[index], "RGB")
        mat = loadmat(self.masks[index], mat_dtype=True, squeeze_me=True,
                      struct_as_record=False)
        # Image.fromarray(uint8) is an "L" image of these values
        mask = np.ascontiguousarray(mat["GTcls"].Segmentation.astype(np.uint8))
        return img, mask


# ---------------------------------------------------------------------------
# Pascal-Context (pcontext.py:17-110) — needs the `detail` API for masks
# ---------------------------------------------------------------------------

PCONTEXT_SPEC = DatasetSpec("pcontext", "VOCdevkit/VOC2010", 59, 3,
                            (480, 480), False)


class ContextSegmentation(_SyncTransformDataset):
    def __init__(self, root, split="train", mode="train"):
        super().__init__(PCONTEXT_SPEC, mode)
        try:
            from detail import Detail  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Pascal-Context requires the `detail` API "
                "(https://github.com/zhanghang1989/detail-api), which is not "
                "baked into this image — mirroring the reference dependency "
                "(pcontext.py:22-25).") from e
        base = os.path.join(require_root("pcontext", root), self.spec.base_dir)
        ann = os.path.join(base, "trainval_merged.json")
        self._detail = Detail(ann, os.path.join(base, "JPEGImages"),
                              "train" if mode == "train" else "val")
        self.images = [img["file_name"] for img in self._detail.getImgs()]


# ---------------------------------------------------------------------------
# COCO-as-VOC-classes (coco.py:9-80) — needs pycocotools
# ---------------------------------------------------------------------------

COCO_SPEC = DatasetSpec("coco", "coco", 21, 3, (480, 480), False)
# the 20 VOC categories expressed as COCO category ids (coco.py:14-16)
COCO_VOC_CAT_IDS = [0, 5, 2, 16, 9, 44, 6, 3, 17, 62, 21, 67, 18, 19, 4,
                    1, 64, 20, 63, 7, 72]


class COCOSegmentation(_SyncTransformDataset):
    def __init__(self, root, split="train", mode="train"):
        super().__init__(COCO_SPEC, mode)
        try:
            from pycocotools.coco import COCO  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "COCOSegmentation requires pycocotools, which is not baked "
                "into this image — mirroring the reference dependency "
                "(coco.py:2-7).") from e
        base = os.path.join(require_root("coco", root), self.spec.base_dir)
        sub = "train2017" if mode == "train" else "val2017"
        self._coco = COCO(os.path.join(
            base, "annotations", f"instances_{sub}.json"))
        self._img_dir = os.path.join(base, sub)
        self.images = list(sorted(self._coco.imgs.keys()))

    def _load_pair(self, index):
        from pycocotools import mask as coco_mask
        coco = self._coco
        img_id = self.images[index]
        meta = coco.loadImgs(img_id)[0]
        img = read_image(os.path.join(self._img_dir, meta["file_name"]), "RGB")
        anns = coco.loadAnns(coco.getAnnIds(imgIds=img_id))
        mask = np.zeros((meta["height"], meta["width"]), np.uint8)
        for ann in anns:
            if ann["category_id"] not in COCO_VOC_CAT_IDS:
                continue
            cls = COCO_VOC_CAT_IDS.index(ann["category_id"])
            rle = coco_mask.frPyObjects(ann["segmentation"],
                                        meta["height"], meta["width"])
            m = coco_mask.decode(rle)
            if m.ndim == 3:
                m = m.any(axis=2)
            mask[m > 0] = cls
        return img, mask


# ---------------------------------------------------------------------------
# MINC-2500 material classification (minc.py:17-60)
# ---------------------------------------------------------------------------

MINC_SPEC = DatasetSpec("minc", "minc-2500", 23, 3, (224, 224), False)


class MINCDataset(SegmentationDataset):
    """23-way material classification from the labels/ split files."""

    def __init__(self, root, split="train", mode="train"):
        self.spec = MINC_SPEC
        self.mode = mode
        base = os.path.join(require_root("minc", root), self.spec.base_dir)
        split_f = os.path.join(
            base, "labels", f"{'train' if mode == 'train' else 'test'}1.txt")
        self.samples: List[Tuple[str, int]] = []
        self._classes: List[str] = sorted(os.listdir(
            os.path.join(base, "images"))) if os.path.isdir(
            os.path.join(base, "images")) else []
        if os.path.isfile(split_f):
            with open(split_f) as fh:
                for line in fh:
                    rel = line.strip()
                    cls_name = rel.split("/")[1]
                    self.samples.append((os.path.join(base, rel),
                                         self._classes.index(cls_name)))
        if not self.samples:
            raise RuntimeError(f"Found 0 samples under {base}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        path, label = self.samples[index]
        img = P.resize_bilinear(read_image(path, "RGB"), self.spec.crop_size[::-1])
        return _normalise(img), np.int32(label)


# ---------------------------------------------------------------------------
# ImageNet classification folders (imagenet.py:14-30)
# ---------------------------------------------------------------------------

IMAGENET_SPEC = DatasetSpec("imagenet", "ILSVRC2012", 1000, 3,
                            (224, 224), False)


class ImageNetDataset(SegmentationDataset):
    def __init__(self, root, split="train", mode="train"):
        self.spec = IMAGENET_SPEC
        self.mode = mode
        base = os.path.join(require_root("imagenet", root), self.spec.base_dir,
                            "train" if mode == "train" else "val")
        self.samples: List[Tuple[str, int]] = []
        if os.path.isdir(base):
            classes = sorted(os.listdir(base))
            for ci, cls in enumerate(classes):
                cdir = os.path.join(base, cls)
                for f in sorted(os.listdir(cdir)):
                    self.samples.append((os.path.join(cdir, f), ci))
        if not self.samples:
            raise RuntimeError(f"Found 0 samples under {base}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        path, label = self.samples[index]
        img = P.resize_bilinear(read_image(path, "RGB"), self.spec.crop_size[::-1])
        return _normalise(img), np.int32(label)


for _name, _spec, _cls in [
        ("ade20k", ADE20K_SPEC, ADE20KSegmentation),
        ("pascal_voc", VOC_SPEC, VOCSegmentation),
        ("pascal_aug", VOCAUG_SPEC, VOCAugSegmentation),
        ("pcontext", PCONTEXT_SPEC, ContextSegmentation),
        ("coco", COCO_SPEC, COCOSegmentation),
        ("minc", MINC_SPEC, MINCDataset),
        ("imagenet", IMAGENET_SPEC, ImageNetDataset)]:
    SPECS.setdefault(_name, _spec)
    register_dataset(_name)(
        lambda root, split="train", mode="train", _c=_cls, **kw:
        _c(root, split, mode))
