"""The port's generic loaders (`senas_torch/data/generic.py`) against
senas_tpu's (`senas_tpu/data/generic.py`, Pillow) on trees written here
in each dataset's layout, with Pillow and scipy:

- `get_dataset(name, root, mode=...)` for ade20k, pascal_voc, pascal_aug,
  minc and imagenet, in train and val mode: the same length and files, and
  every sample equal bit for bit (the float32 image and the int32 label or
  class) under the same `random.seed` (train mode draws the flip, the
  scale jitter and the crop from it). The JPEGs are baseline and
  progressive, 4:2:0, 4:2:2 and 4:4:4; VOC's masks are palette PNGs with a
  255 border, ADE20K's gray PNGs with void 0 (label -1), VOCaug's `.mat`
  files; images portrait and landscape, smaller than the crop (padded) and
  larger;
- coco and pcontext raise senas_tpu's ImportError (pycocotools and the
  `detail` API are on neither machine);
- the registry: the seven specs equal senas_tpu's, and a missing data root
  raises as for every other dataset.
"""

import dataclasses
import os
import random

import numpy as np
import pytest

from senas_tpu.data import base as jbase
from senas_tpu.data import generic as jgeneric
from senas_torch.data import base as tbase
from senas_torch.data import generic as tgeneric

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

Image = pytest.importorskip("PIL.Image")
scipy_io = pytest.importorskip("scipy.io")

NAMES = ("ade20k", "pascal_voc", "pascal_aug", "minc", "imagenet")
# (h, w): landscape, portrait, and one under the 480 crop
SHAPES = ((240, 320), (300, 200), (150, 170))


def _image(rs, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 9.0) * np.cos(y / 7.0) + 1) * 100
    return np.clip(base[..., None] + rs.randint(0, 50, (h, w, 3)), 0, 255).astype(np.uint8)


def _save_jpeg(path, arr, i):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, quality=(85, 60, 95)[i % 3], subsampling=i % 3,
                              progressive=bool(i % 2))


def _labels(rs, h, w, classes, void=None):
    lab = rs.randint(0, classes, (h // 10 + 1, w // 10 + 1)).repeat(10, 0).repeat(10, 1)[:h, :w]
    lab = lab.astype(np.uint8)
    if void is not None:
        lab[::13] = void
    return lab


def _write(root, name, rs, n=3):
    if name == "ade20k":
        for sub in ("training", "validation"):
            for i in range(n):
                h, w = SHAPES[i % 3]
                _save_jpeg(f"{root}/ADEChallengeData2016/images/{sub}/a{i}.jpg", _image(rs, h, w), i)
                os.makedirs(f"{root}/ADEChallengeData2016/annotations/{sub}", exist_ok=True)
                Image.fromarray(_labels(rs, h, w, 151, void=0)).save(
                    f"{root}/ADEChallengeData2016/annotations/{sub}/a{i}.png")
    elif name == "pascal_voc":
        base = f"{root}/VOCdevkit/VOC2012"
        os.makedirs(f"{base}/SegmentationClass", exist_ok=True)
        os.makedirs(f"{base}/ImageSets/Segmentation", exist_ok=True)
        for i in range(n):
            h, w = SHAPES[i % 3]
            _save_jpeg(f"{base}/JPEGImages/v{i}.jpg", _image(rs, h, w), i)
            lab = _labels(rs, h, w, 21, void=255)
            im = Image.frombytes("P", (w, h), lab.tobytes())
            im.putpalette(list(rs.randint(0, 256, 768)))
            im.save(f"{base}/SegmentationClass/v{i}.png")
        for f in ("trainval.txt", "val.txt"):
            with open(f"{base}/ImageSets/Segmentation/{f}", "w") as fh:
                fh.write("\n".join(f"v{i}" for i in range(n)) + "\n")
    elif name == "pascal_aug":
        base = f"{root}/VOCaug/dataset"
        os.makedirs(f"{base}/cls", exist_ok=True)
        for i in range(n):
            h, w = SHAPES[i % 3]
            _save_jpeg(f"{base}/img/s{i}.jpg", _image(rs, h, w), i)
            seg = _labels(rs, h, w, 21).astype(np.float64)
            gt = {"Segmentation": seg, "Boundaries": np.zeros(1), "CategoriesPresent": np.ones(1)}
            scipy_io.savemat(f"{base}/cls/s{i}.mat", {"GTcls": gt})
        for f in ("trainval.txt", "val.txt"):
            with open(f"{base}/{f}", "w") as fh:
                fh.write("\n".join(f"s{i}" for i in range(n)) + "\n")
    elif name == "minc":
        base = f"{root}/minc-2500"
        os.makedirs(f"{base}/labels", exist_ok=True)
        rels = []
        for ci, cls in enumerate(("brick", "wood")):
            for i in range(2):
                rel = f"images/{cls}/{cls}_{i}.jpg"
                h, w = SHAPES[(ci + i) % 3]
                _save_jpeg(f"{base}/{rel}", _image(rs, h, w), ci + i)
                rels.append(rel)
        for f in ("train1.txt", "test1.txt"):
            with open(f"{base}/labels/{f}", "w") as fh:
                fh.write("\n".join(rels) + "\n")
    else:
        for split in ("train", "val"):
            for ci, cls in enumerate(("n01", "n02")):
                for i in range(2):
                    h, w = SHAPES[(ci + i) % 3]
                    _save_jpeg(f"{root}/ILSVRC2012/{split}/{cls}/x{i}.JPEG", _image(rs, h, w), i)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("generic"))
    rs = np.random.RandomState(0)
    for name in NAMES:
        _write(root, name, rs)
    return root


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("name", NAMES)
def test_samples_match_senas_tpu(root, name, mode):
    jd = jbase.get_dataset(name, root, mode=mode)
    td = tbase.get_dataset(name, root, mode=mode)
    assert len(td) == len(jd) > 0
    if hasattr(jd, "images"):
        assert td.images == jd.images and td.masks == jd.masks
    else:
        assert td.samples == jd.samples
    for i in range(len(jd)):
        for rep in range(2 if mode == "train" else 1):
            random.seed(100 * i + rep)
            jx, jy = jd[i]
            random.seed(100 * i + rep)
            tx, ty = td[i]
            assert tx.dtype == jx.dtype == np.float32 and tx.shape == jx.shape
            assert ty.dtype == jy.dtype and np.shape(ty) == np.shape(jy)
            np.testing.assert_array_equal(tx, jx, err_msg=f"{name} {mode} {i}")
            np.testing.assert_array_equal(ty, jy, err_msg=f"{name} {mode} {i}")
    if name == "ade20k":
        assert (np.asarray(ty) == -1).any()


def test_coco_and_pcontext_raise_senas_tpus_import_error(tmp_path):
    for name in ("coco", "pcontext"):
        with pytest.raises(ImportError) as jerr:
            jbase.get_dataset(name, str(tmp_path))
        with pytest.raises(ImportError) as terr:
            tbase.get_dataset(name, str(tmp_path))
        assert str(terr.value) == str(jerr.value)


def test_specs_and_roots():
    for name in NAMES + ("coco", "pcontext"):
        assert (dataclasses.asdict(tbase.get_dataset_spec(name))
                == dataclasses.asdict(jbase.get_dataset_spec(name)))
        if name not in ("coco", "pcontext"):
            with pytest.raises(ValueError, match="data_root"):
                tbase.get_dataset(name, None)
    assert tgeneric.COCO_VOC_CAT_IDS == jgeneric.COCO_VOC_CAT_IDS
