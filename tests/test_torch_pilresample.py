"""`senas_torch.data.pilresample` against Pillow 12.1.0, bit for bit
(tolerance 0), on uint8 arrays:

- `resize_bilinear` equals `Image.resize(size, BILINEAR)` (which
  antialiases when it reduces) on "L" and "RGB", up and down, on either
  axis alone and both, at the generic loaders' sizes (a 500x375 VOC image
  to a long side of 260-1300, 224x224) and at small odd ones, through the
  native passes and through their numpy twins;
- `resize_nearest` equals `resize(size, NEAREST)` on "L", "RGB" and "P"
  (indices kept), over a sweep of widths;
- `flip_left_right`, `expand` (ImageOps.expand with a right and bottom
  border, fill 0, palette index 0 on "P") and `crop` (inside and past the
  image) equal Pillow's.
"""

import numpy as np
import pytest

from senas_torch.data import pilresample as P

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

Image = pytest.importorskip("PIL.Image")
ImageOps = pytest.importorskip("PIL.ImageOps")

CASES = [((375, 500), (1300, 975)), ((375, 500), (260, 195)), ((375, 500), (780, 585)),
         ((512, 683), (1250, 937)), ((375, 500), (224, 224)), ((37, 53), (100, 80)),
         ((5, 7), (3, 2)), ((1, 1), (4, 5)), ((40, 30), (30, 40)), ((64, 64), (64, 17)),
         ((64, 64), (13, 64)), ((10, 10), (1, 1)), ((2, 9), (9, 2))]


def _arr(seed, hw, channels):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, hw + ((channels,) if channels else ()), dtype=np.uint8)


def _palette_image(idx):
    im = Image.frombytes("P", idx.shape[::-1], idx.tobytes())
    im.putpalette(list(np.random.RandomState(0).randint(0, 256, 768)))
    return im


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("channels", [0, 3], ids=["L", "RGB"])
@pytest.mark.parametrize("hw,size", CASES, ids=[f"{h}x{w}-{s[0]}x{s[1]}" for (h, w), s in CASES])
def test_bilinear_is_pillows(hw, size, channels, native):
    a = _arr(hw[0] + size[0], hw, channels)
    want = np.asarray(Image.fromarray(a).resize(size, Image.BILINEAR))
    got = P.resize_bilinear(a, size, native=native)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_bilinear_sweep():
    """Every width 1-40 to every tenth output width 1-120, one row, "L"."""
    for w in range(1, 41):
        a = _arr(w, (2, w), 0)
        for ow in range(1, 121, 10):
            want = np.asarray(Image.fromarray(a).resize((ow, 2), Image.BILINEAR))
            np.testing.assert_array_equal(P.resize_bilinear(a, (ow, 2)), want, err_msg=f"{w}->{ow}")


@pytest.mark.parametrize("mode", ["L", "RGB", "P"])
@pytest.mark.parametrize("hw,size", CASES[:8], ids=[f"{h}x{w}-{s[0]}x{s[1]}" for (h, w), s in CASES[:8]])
def test_nearest_is_pillows(hw, size, mode):
    a = _arr(hw[1] + size[1], hw, 3 if mode == "RGB" else 0)
    im = _palette_image(a) if mode == "P" else Image.fromarray(a)
    out = im.resize(size, Image.NEAREST)
    assert out.mode == mode
    np.testing.assert_array_equal(P.resize_nearest(np.asarray(im), size), np.asarray(out))


def test_nearest_sweep():
    bad = []
    for w in list(range(1, 40)) + [375, 500, 683]:
        a = (np.arange(w) % 251).astype(np.uint8)[None]
        for ow in range(1, 1400, 89 if w > 100 else 5):
            want = np.asarray(Image.fromarray(a).resize((ow, 1), Image.NEAREST))
            if not np.array_equal(P.resize_nearest(a, (ow, 1)), want):
                bad.append((w, ow))
    assert not bad, bad[:10]


@pytest.mark.parametrize("mode", ["L", "RGB", "P"])
def test_flip_expand_crop(mode):
    a = _arr(9, (23, 31), 3 if mode == "RGB" else 0)
    im = _palette_image(a) if mode == "P" else Image.fromarray(a)
    arr = np.asarray(im)
    np.testing.assert_array_equal(P.flip_left_right(arr),
                                  np.asarray(im.transpose(Image.FLIP_LEFT_RIGHT)))
    for padw, padh in ((0, 5), (7, 0), (3, 4)):
        got = P.expand(arr, padw, padh)
        want = ImageOps.expand(im, border=(0, 0, padw, padh), fill=0)
        assert want.mode == mode
        np.testing.assert_array_equal(got, np.asarray(want))
    for box in ((0, 0, 31, 23), (4, 3, 20, 19), (25, 18, 40, 30), (-3, -2, 10, 9)):
        np.testing.assert_array_equal(P.crop(arr, box), np.asarray(im.crop(box)), err_msg=box)
