"""The port's image files without Pillow (`senas_torch.data.imfile`)
against Pillow itself, bit for bit (tolerance 0):

- `read_image(path, mode)` equals `np.asarray(Image.open(path).convert(mode))`
  for mode "L" and "RGB" on PNGs that Pillow writes in every colour type at
  bit depth 8 (gray, gray+alpha, RGB, RGBA, palette; with tRNS), at odd
  sizes, 1-pixel rows and columns, and data in several IDAT chunks; on
  PNGs written here with each of the five row filters and with a mix of them per row (as Pillow decodes
  them); on TIFFs that Pillow writes uncompressed, and TIFFs written here in
  either byte order, in several strips, WhiteIsZero;
- the formats it does not read raise, naming them: interlaced, 16-bit and
  1-bit PNG, compressed and tiled TIFF, CMYK JPEG (tests/test_torch_jpeg.py
  holds the JPEG decoder);
- `write_png_l` stores what Pillow's "F" to "L" conversion gives for
  values below 0, above 255, fractional, NaN and infinite.
"""

import struct
import zlib

import numpy as np
import pytest

from senas_torch.data import imfile

Image = pytest.importorskip("PIL.Image")


def _smooth(rs, shape):
    """Smooth content with noise, so that Pillow's encoder picks different
    filters row by row."""
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 5.0) * np.cos(y / 4.0) + 1) * 100
    extra = shape[2:] or ()
    noise = rs.randint(0, 40, (h, w) + tuple(extra))
    return (base.reshape((h, w) + (1,) * len(extra)) + noise).astype(np.uint8)


def _same(path):
    for mode in ("L", "RGB"):
        with Image.open(path) as im:
            want = np.asarray(im.convert(mode))
        got = imfile.read_image(str(path), mode)
        assert got.dtype == np.uint8 and got.shape == want.shape, (mode, got.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{path} as {mode}")


# the last: RGB(A) data in several IDAT chunks
SIZES = [(1, 1), (1, 9), (9, 1), (13, 29), (64, 65), (257, 300)]


@pytest.mark.parametrize("mode,channels", [("L", 0), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_pillow_png(tmp_path, mode, channels, size):
    rs = np.random.RandomState(size[0] * 100 + size[1] + channels)
    arr = _smooth(rs, size + ((channels,) if channels else ()))
    path = tmp_path / "img.png"
    Image.fromarray(arr, mode).save(path)
    if size == (257, 300) and channels >= 3:
        assert path.read_bytes().count(b"IDAT") > 1
    _same(path)


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_pillow_palette_png(tmp_path, size):
    """256 palette entries (bit depth 8); then 100 entries, so pixels past
    the palette read as Pillow reads them (black); then with tRNS."""
    rs = np.random.RandomState(size[0] + size[1])
    im = Image.fromarray(rs.randint(0, 256, size).astype(np.uint8), "P")
    im.putpalette(rs.randint(0, 256, 768).tolist())
    im.save(tmp_path / "p256.png")
    _same(tmp_path / "p256.png")
    im.putpalette(rs.randint(0, 256, 300).tolist())
    im.save(tmp_path / "p100.png")
    _same(tmp_path / "p100.png")
    im.save(tmp_path / "trns.png", transparency=bytes(range(0, 256, 3)))
    with Image.open(tmp_path / "trns.png") as back:
        assert "transparency" in back.info
    with pytest.warns(UserWarning):
        _same(tmp_path / "trns.png")


def test_pillow_png_with_trns(tmp_path):
    """A tRNS chunk of a gray or RGB PNG changes no pixel of the "L" or
    "RGB" conversion."""
    rs = np.random.RandomState(1)
    gray, rgb = _smooth(rs, (20, 23)), _smooth(rs, (20, 23, 3))
    Image.fromarray(gray, "L").save(tmp_path / "l.png", transparency=int(gray[3, 4]))
    Image.fromarray(rgb, "RGB").save(tmp_path / "rgb.png", transparency=tuple(rgb[5, 6].tolist()))
    for name in ("l.png", "rgb.png"):
        with Image.open(tmp_path / name) as back:
            assert "transparency" in back.info
        _same(tmp_path / name)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, pixels, colour, ftypes, palette=None, depth=8, interlace=0):
    """A PNG of uint8 `pixels` [H, W, C], each row filtered with its type."""
    h, w, c = pixels.shape
    x = pixels.reshape(h, w * c).astype(np.int32)
    rows = []
    for r in range(h):
        cur = x[r]
        up = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][ftypes[r]]
        rows.append(bytes([ftypes[r]]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    body = imfile.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                              0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    body += chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")
    path.write_bytes(body)


@pytest.mark.parametrize("colour,channels", [(0, 1), (4, 2), (2, 3), (6, 4), (3, 1)],
                         ids=["gray", "gray_alpha", "rgb", "rgba", "palette"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_each_row_filter(tmp_path, colour, channels, ftype):
    rs = np.random.RandomState(channels * 10 + (5 if ftype == "mixed" else ftype))
    h, w = 17, 23
    pixels = _smooth(rs, (h, w, channels))
    ftypes = rs.randint(0, 5, h) if ftype == "mixed" else np.full(h, ftype)
    palette = rs.randint(0, 256, (256, 3)).astype(np.uint8) if colour == 3 else None
    _write_png(tmp_path / "f.png", pixels, colour, ftypes, palette)
    _same(tmp_path / "f.png")


def _write_tiff(path, pixels, order="<", rows_per_strip=None, photometric=None,
                compression=1, tiled=False):
    """A baseline TIFF of uint8 `pixels` ([H, W] gray or [H, W, 3] RGB)."""
    h, w = pixels.shape[:2]
    spp = 1 if pixels.ndim == 2 else pixels.shape[2]
    rps = rows_per_strip or h
    stride = w * spp
    strips = [pixels.reshape(h, stride)[r:r + rps].tobytes() for r in range(0, h, rps)]
    if photometric is None:
        photometric = 2 if spp == 3 else 1
    data_at = 8
    offsets, pos = [], data_at
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    pos += pos % 2
    extra_at = pos                       # the strip tables and BitsPerSample
    tables = struct.pack(order + "%dI" % len(strips), *offsets)
    tables += struct.pack(order + "%dI" % len(strips), *map(len, strips))
    bits_at = extra_at + len(tables)
    tables += struct.pack(order + "3H", 8, 8, 8)
    ifd_at = extra_at + len(tables)
    entries = [(256, 4, 1, w), (257, 4, 1, h),
               (258, 3, spp, bits_at if spp > 2 else 8), (259, 3, 1, compression),
               (262, 3, 1, photometric),
               (273, 4, len(strips), extra_at if len(strips) > 1 else offsets[0]),
               (277, 3, 1, spp), (278, 4, 1, rps),
               (279, 4, len(strips), extra_at + 4 * len(strips) if len(strips) > 1
                else len(strips[0]))]
    if tiled:
        entries.append((322, 3, 1, 16))
    ifd = struct.pack(order + "H", len(entries))
    for tag, typ, count, value in entries:
        if typ == 3 and count == 1:          # a SHORT, left-justified
            inline = struct.pack(order + "H", value) + b"\x00\x00"
        else:                                # a LONG, or the offset of the values
            inline = struct.pack(order + "I", value)
        ifd += struct.pack(order + "HHI", tag, typ, count) + inline
    ifd += struct.pack(order + "I", 0)
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd_at)
    body = head + b"".join(strips)
    body += b"\x00" * (extra_at - len(body)) + tables + ifd
    path.write_bytes(body)


@pytest.mark.parametrize("shape", [(20, 31), (20, 31, 3), (1, 5), (7, 1, 3)])
def test_pillow_tiff(tmp_path, shape):
    rs = np.random.RandomState(sum(shape))
    Image.fromarray(_smooth(rs, shape)).save(tmp_path / "p.tif")
    with Image.open(tmp_path / "p.tif") as im:
        assert im.info.get("compression", "raw") == "raw"
    _same(tmp_path / "p.tif")


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("shape,rps,photometric", [((21, 13), None, None),
                                                   ((21, 13), 4, None),
                                                   ((21, 13, 3), 5, None),
                                                   ((21, 13), 6, 0)],
                         ids=["gray", "gray_strips", "rgb_strips", "white_is_zero"])
def test_written_tiff(tmp_path, order, shape, rps, photometric):
    rs = np.random.RandomState(len(shape) * 7 + (rps or 0))
    _write_tiff(tmp_path / "w.tif", _smooth(rs, shape), order, rps, photometric)
    _same(tmp_path / "w.tif")


def test_unsupported_formats_raise(tmp_path):
    rs = np.random.RandomState(2)
    gray = _smooth(rs, (12, 10))
    cases = {}
    _write_png(tmp_path / "interlaced.png", gray[..., None], 0, np.zeros(12, int), interlace=1)
    cases["interlaced.png"] = "interlaced"
    Image.fromarray(gray.astype(np.uint16) * 200).save(tmp_path / "16.png")
    with Image.open(tmp_path / "16.png") as im:
        assert im.mode.startswith("I")
    cases["16.png"] = "16-bit"
    Image.fromarray(gray > 100).save(tmp_path / "1.png")
    cases["1.png"] = "1-bit"
    _write_tiff(tmp_path / "lzw.tif", gray, compression=5)
    cases["lzw.tif"] = "compressed TIFF"
    _write_tiff(tmp_path / "tiled.tif", gray, tiled=True)
    cases["tiled.tif"] = "tiled TIFF"
    Image.fromarray(np.repeat(gray[..., None], 4, axis=-1), "CMYK").save(tmp_path / "j.jpg")
    cases["j.jpg"] = "CMYK"
    (tmp_path / "junk.bin").write_bytes(b"not an image at all")
    cases["junk.bin"] = "unknown image format"
    for name, what in cases.items():
        with pytest.raises(ValueError, match=what):
            imfile.read_image(str(tmp_path / name), "L")
    with pytest.raises(ValueError, match="mode"):
        imfile.read_image(str(tmp_path / "1.png"), "RGBA")


def test_write_png_l_is_pillows_f_to_l(tmp_path):
    rs = np.random.RandomState(4)
    arr = rs.randn(37, 41) * 200 + 100                       # below 0, above 255
    arr[0, :12] = [0.6, -0.6, 1.5, 254.6, 255.9, 256.0, np.nan, np.inf, -np.inf, 1e10,
                   0.99999999999, 254.99999999999]
    arr[1, :4] = np.round(arr[1, :4])                        # whole numbers
    imfile.write_png_l(str(tmp_path / "port.png"), arr)
    Image.fromarray(arr.astype(np.float64)).convert("L").save(tmp_path / "pil.png", format="png")
    with Image.open(tmp_path / "port.png") as got, Image.open(tmp_path / "pil.png") as want:
        assert got.mode == want.mode == "L"
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(imfile.read_image(str(tmp_path / "port.png"), "L"),
                                  np.asarray(Image.fromarray(arr).convert("L")))
    assert imfile.float_to_l(arr)[0, :12].tolist() == [0, 0, 1, 254, 255, 255, 0, 255, 0, 255,
                                                       1, 255]
