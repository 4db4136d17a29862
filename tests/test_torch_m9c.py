"""M9c: the rotation and colour transforms of `senas_torch.data.augment`
against senas_tpu's (cv2) under one `random.seed`, and their cv2 twins
in `senas_torch.data.imgproc` against cv2 5.0 (x86-64 build):

- `rotation_matrix` equals `cv2.getRotationMatrix2D`, and
  `warp_affine_nearest` equals `cv2.warpAffine(..., INTER_NEAREST,
  borderValue=0)` exactly, on uint8 masks and float32 images with 1 and 3
  channels, at widths on both sides of cv2's blocks of 16 columns;
  `RandomRotate` equals senas_tpu's exactly;
- `AdjustGamma`, `AdjustBrightness`, `AdjustContrast` and
  `AdjustSaturation` equal senas_tpu's exactly (the same numpy ops);
- `hsv_to_rgb` equals `cv2.cvtColor(COLOR_HSV2RGB)` exactly;
  `rgb_to_hsv` equals `COLOR_RGB2HSV` in s and v exactly and in h within
  1 ulp (cv2 computes the last pixel of some of its parallel stripes in a
  scalar tail, unfused, where its h may lie 1 ulp from its SIMD blocks');
- `AdjustHue` lies within 32 ulps of each pixel's largest input magnitude
  of senas_tpu's, on at most 1e-3 of the elements (that 1-ulp h, carried
  through the hue shift and HSV -> RGB, where a hue at 0 or 360 picks a
  sector at the other end), else exactly.
"""

import random

import numpy as np
import pytest

from senas_tpu.data import augment as J
from senas_torch.data import augment as T
from senas_torch.data import imgproc

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

HUE_ULPS = 32
HUE_SHARE = 1e-3


def _ulps(a, b):
    a = a.astype(np.float32).view(np.int32).astype(np.int64)
    b = b.astype(np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _image(rs, h, w, c):
    shape = (h, w) + ((c,) if c else ())
    return (rs.rand(*shape) * 4 - 2).astype(np.float32)


@pytest.mark.parametrize("kind", ["mask", "gray", "rgb"])
def test_warp_affine_nearest_is_cv2s(kind):
    rs = np.random.RandomState(["mask", "gray", "rgb"].index(kind))
    sizes = [(rs.randint(1, 120), w) for w in (1, 7, 15, 16, 17, 31, 32, 33, 47, 64, 95)]
    sizes += [tuple(rs.randint(1, 200, 2)) for _ in range(20)]
    for h, w in sizes:
        for angle in (0.0, 90.0, -45.0, 180.0, rs.uniform(-30, 30), rs.uniform(-180, 180)):
            src = (rs.randint(0, 256, (h, w), dtype=np.uint8) if kind == "mask"
                   else _image(rs, h, w, 3 if kind == "rgb" else 0))
            m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
            np.testing.assert_array_equal(imgproc.rotation_matrix((w / 2, h / 2), angle, 1.0), m)
            want = cv2.warpAffine(src, m, (w, h), flags=cv2.INTER_NEAREST,
                                  borderValue=0).reshape(src.shape)
            np.testing.assert_array_equal(imgproc.warp_affine_nearest(src, m), want,
                                          err_msg=f"{kind} {h}x{w} {angle}")


@pytest.mark.parametrize("channels", [0, 3])
def test_random_rotate_matches(channels):
    rs = np.random.RandomState(channels)
    for seed in range(6):
        img = _image(rs, 45, 61, channels)
        mask = rs.randint(0, 5, (45, 61)).astype(np.uint8)
        random.seed(seed)
        ji, jm = J.RandomRotate(25)(img, mask)
        random.seed(seed)
        ti, tm = T.RandomRotate(25)(img, mask)
        assert ti.dtype == ji.dtype and tm.dtype == jm.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("name,arg", [("AdjustGamma", 0.5), ("AdjustBrightness", 0.3),
                                      ("AdjustContrast", 0.4), ("AdjustSaturation", 0.5)])
@pytest.mark.parametrize("channels", [0, 3])
def test_colour_transforms_match(name, arg, channels):
    rs = np.random.RandomState(7)
    for seed in range(4):
        img = (rs.rand(33, 29, *((channels,) if channels else ())) * 2).astype(np.float32)
        if name == "AdjustGamma":
            img = img - 0.5                       # lo < 0: the shift and scale matter
        mask = np.zeros((33, 29), np.uint8)
        random.seed(seed)
        ji, _ = getattr(J, name)(arg)(img, mask)
        random.seed(seed)
        ti, tm = getattr(T, name)(arg)(img, mask)
        assert ti.dtype == ji.dtype and tm is mask
        np.testing.assert_array_equal(ti, ji, err_msg=f"{name} seed {seed}")


def test_hsv_twins_against_cv2():
    rs = np.random.RandomState(3)
    worst_h = 0
    for t in range(60):
        h, w = rs.randint(1, 130, 2)
        img = _image(rs, h, w, 3) if t % 2 else rs.rand(h, w, 3).astype(np.float32)
        img[: h // 4] = np.round(img[: h // 4] * 4) / 4      # ties between channels
        want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        got = imgproc.rgb_to_hsv(img)
        np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
        worst_h = max(worst_h, int(_ulps(got[..., 0], want[..., 0]).max()))
        hsv = want.copy()
        hsv[..., 0] = (hsv[..., 0] + rs.uniform(-90, 90)) % 360
        np.testing.assert_array_equal(imgproc.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    assert worst_h <= 1, worst_h


def test_adjust_hue_within_its_bound():
    rs = np.random.RandomState(5)
    differing, total = 0, 0
    for seed in range(120):
        h, w = rs.randint(1, 90, 2)
        img = _image(rs, h, w, 3) if seed % 2 else rs.rand(h, w, 3).astype(np.float32)
        mask = np.zeros((h, w), np.uint8)
        random.seed(seed)
        ji, _ = J.AdjustHue(0.3)(img, mask)
        random.seed(seed)
        ti, _ = T.AdjustHue(0.3)(img, mask)
        assert ti.dtype == ji.dtype == np.float32 and ti.shape == ji.shape
        scale = np.spacing(np.abs(img).max(axis=-1, keepdims=True))
        assert (np.abs(ti - ji) <= HUE_ULPS * scale).all(), seed
        differing += int((ti != ji).sum())
        total += ti.size
    assert differing <= HUE_SHARE * total, differing / total
    gray = _image(rs, 8, 9, 0)
    assert T.AdjustHue(0.3)(gray, None)[0] is gray       # not 3 channels: unchanged
