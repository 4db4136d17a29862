"""The port's JPEG decoder (`senas_torch/data/native/image_native.cpp`
through `senas_torch.data.imfile.read_image`) against Pillow 12.1.0 and
its bundled libjpeg-turbo, bit for bit (tolerance 0):

- `read_image(path, "RGB")` and `read_image(path, "L")` equal
  `np.asarray(Image.open(path).convert(mode))` on files Pillow writes:
  baseline and progressive (successive approximation), chroma subsampling
  0, 1 and 2 (4:4:4, 4:2:2, 4:2:0), quality 50 and 95, at odd sizes (37x53,
  1x1, 17x9, 9x17, 64x48); gray; restart intervals; 4:4:0 (h1v2) from cv2;
- the colour-space rule of libjpeg's default_decompress_parms: no JFIF
  marker with component ids 'R','G','B', an Adobe marker with transform 0
  or 1, unknown ids;
- `read_image(path, None)` gives a gray or palette PNG's values or
  indices as stored (`np.asarray(Image.open(path))`);
- each unsupported variant raises ValueError naming it: arithmetic
  coding, lossless, hierarchical, 12-bit samples, CMYK, sampling 4x1;
- `chip_smoke.encode_jpeg`'s baseline files decode alike in Pillow and
  the port.
"""

import io

import numpy as np
import pytest

from senas_torch.data import imfile

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")

SIZES = [(37, 53), (1, 1), (17, 9), (9, 17), (64, 48)]


def _scene(seed, h, w, c=3):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 7.0) * np.cos(y / 5.0) + 1) * 100
    return np.clip(base[..., None] + rs.randint(0, 60, (h, w, c)), 0, 255).astype(np.uint8)


def _same(path, modes=("RGB", "L")):
    for mode in modes:
        with Image.open(path) as im:
            want = np.asarray(im.convert(mode))
        got = imfile.read_image(str(path), mode)
        assert got.dtype == np.uint8 and got.shape == want.shape, (mode, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{path} as {mode}")


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_pillow_jpeg(tmp_path, size, subsampling, quality, progressive):
    arr = _scene(size[0] * 7 + size[1] + subsampling, *size)
    path = tmp_path / "img.jpg"
    Image.fromarray(arr).save(path, quality=quality, subsampling=subsampling,
                              progressive=progressive)
    _same(path)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_gray_jpeg(tmp_path, size, progressive):
    arr = _scene(size[0] + size[1], *size, c=1)[..., 0]
    path = tmp_path / "gray.jpg"
    Image.fromarray(arr).save(path, quality=90, progressive=progressive)
    with Image.open(path) as im:
        assert im.mode == "L"
    _same(path)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("blocks", [1, 3])
def test_restart_intervals(tmp_path, blocks, subsampling, progressive):
    arr = _scene(blocks + subsampling, 45, 70)
    path = tmp_path / "rst.jpg"
    Image.fromarray(arr).save(path, quality=80, subsampling=subsampling,
                              progressive=progressive, restart_marker_blocks=blocks)
    assert b"\xff\xdd" in path.read_bytes()
    _same(path)


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("size", [(33, 2), (17, 9), (40, 31)])
def test_h1v2_from_cv2(tmp_path, size, progressive):
    """4:4:0 (chroma halved vertically only), which Pillow does not write."""
    arr = _scene(size[0], *size)
    ok, enc = cv2.imencode(".jpg", arr, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
    path = tmp_path / "h1v2.jpg"
    path.write_bytes(enc.tobytes())
    _same(path)


def _pillow_bytes(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _without_jfif(data):
    assert data[2:4] == b"\xff\xe0"
    return data[:2] + data[4 + int.from_bytes(data[4:6], "big"):]


def _with_ids(data, ids):
    b = bytearray(data)
    frame, scan = b.index(b"\xff\xc0"), b.index(b"\xff\xda")
    for k, cid in enumerate(ids):
        b[frame + 10 + 3 * k] = cid
        b[scan + 5 + 2 * k] = cid
    return bytes(b)


def _adobe(data, transform):
    return data[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform]) \
        + data[2:]


@pytest.mark.parametrize("case", ["no_jfif", "rgb_ids", "jfif_rgb_ids", "adobe0", "adobe1",
                                  "adobe0_rgb_ids", "unknown_ids"])
def test_colour_space_rule(tmp_path, case):
    data = _pillow_bytes(_scene(3, 24, 40), quality=90)
    bare = _without_jfif(data)
    made = {"no_jfif": bare, "rgb_ids": _with_ids(bare, b"RGB"),
            "jfif_rgb_ids": _with_ids(data, b"RGB"), "adobe0": _adobe(bare, 0),
            "adobe1": _adobe(bare, 1), "adobe0_rgb_ids": _with_ids(_adobe(bare, 0), b"RGB"),
            "unknown_ids": _with_ids(bare, bytes([4, 5, 6]))}[case]
    path = tmp_path / "cs.jpg"
    path.write_bytes(made)
    _same(path)


def test_pixels_as_stored(tmp_path):
    rs = np.random.RandomState(4)
    idx = rs.randint(0, 21, (23, 31)).astype(np.uint8)
    idx[:2] = 255
    pal = Image.frombytes("P", (31, 23), idx.tobytes())
    pal.putpalette(list(rs.randint(0, 256, 768)))
    pal.save(tmp_path / "p.png")
    Image.fromarray(idx).save(tmp_path / "l.png")
    for name in ("p.png", "l.png"):
        with Image.open(tmp_path / name) as im:
            want = np.asarray(im)
        np.testing.assert_array_equal(imfile.read_image(str(tmp_path / name), None), want)
    # "L" still maps a palette through its colours
    with Image.open(tmp_path / "p.png") as im:
        np.testing.assert_array_equal(imfile.read_image(str(tmp_path / "p.png"), "L"),
                                      np.asarray(im.convert("L")))
    Image.fromarray(_scene(1, 8, 8)).save(tmp_path / "rgb.png")
    with pytest.raises(ValueError, match="as stored"):
        imfile.read_image(str(tmp_path / "rgb.png"), None)


def _patched(data, old, new):
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def test_unsupported_variants_raise(tmp_path):
    base = _pillow_bytes(_scene(5, 16, 16), quality=90)
    cmyk = io.BytesIO()
    Image.fromarray(_scene(6, 16, 16, c=4), "CMYK").save(cmyk, "JPEG")
    ok, s411 = cv2.imencode(".jpg", _scene(7, 16, 32), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    frame = base.index(b"\xff\xc0")
    cases = {"arithmetic": _patched(base, b"\xff\xc0", b"\xff\xc9"),
             "lossless": _patched(base, b"\xff\xc0", b"\xff\xc3"),
             "hierarchical": _patched(base, b"\xff\xc0", b"\xff\xc5"),
             "12-bit": base[:frame + 4] + b"\x0c" + base[frame + 5:],
             "CMYK": cmyk.getvalue(),
             "sampling factor 4x1": s411.tobytes()}
    for what, data in cases.items():
        path = tmp_path / f"{len(what)}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=what):
            imfile.read_image(str(path), "RGB")


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("gray", [False, True])
def test_chip_smoke_encoder_decodes_alike(tmp_path, subsampling, gray):
    import chip_smoke
    rs = np.random.RandomState(8)
    img, _ = chip_smoke._generic_pair(rs, 45, 67, 21, 0, 255, 3)
    data = chip_smoke.encode_jpeg(img[..., 0] if gray else img, 90, subsampling)
    path = tmp_path / "enc.jpg"
    path.write_bytes(data)
    _same(path)
    err = np.abs(imfile.read_image(str(path), "RGB").astype(int)
                 - (np.repeat(img[..., :1], 3, -1) if gray else img)).mean()
    assert err < 12, err
