"""The image files the loaders read and write, in numpy, without Pillow.

The JAX package reads its PNG and TIFF files with Pillow
(`np.asarray(Image.open(path).convert(mode))`) and writes the MSD slices
with Pillow's float-to-8-bit conversion. This module computes the same
pixels with the standard library's `zlib` and numpy:

- `read_image(path, mode)`: mode "L" or "RGB" of
  - PNG at bit depth 8 in every colour type (gray, gray+alpha, RGB, RGBA,
    palette), with all five row filters; a `tRNS` chunk is read and, as in
    Pillow's conversion to "L" or "RGB", changes no pixel;
  - baseline uncompressed TIFF, 8-bit gray (BlackIsZero or WhiteIsZero)
    or RGB, in strips, in either byte order;
  - JPEG, Huffman-coded (baseline, extended sequential, progressive), 8-bit,
    gray or three components, decoded by the native library
    (`data/native/image_native.cpp`) as Pillow's libjpeg-turbo decodes it.

  Mode None gives the pixels as stored, what `np.asarray(Image.open(path))`
  gives for an "L" or "P" image: a gray image's values, a palette image's
  indices (the masks of Pascal VOC).

  Anything else (interlaced or 16-bit PNG, compressed or tiled TIFF,
  arithmetic-coded, lossless, 12-bit or CMYK JPEG, ...) raises ValueError
  naming the format. Nothing falls back.
- `write_png_l(path, arr)`: what `Image.fromarray(arr.astype(np.float64))
  .convert("L").save(path, format="png")` writes, decoded: the values as
  float32, truncated toward zero and clipped to [0, 255] (NaN is 0).

Pillow's conversions, reproduced exactly (`tests/test_torch_imfile.py`):
RGB to L is the fixed-point ITU-R 601-2 luma (R * 19595 + G * 38470 +
B * 7471 + 0x8000) >> 16; alpha is dropped; a palette entry the file does
not give is black, as Pillow reads it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from senas_torch.utils.logging import write_png

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, Pillow's mode, name)
_PNG_COLOUR = {0: (1, "L", "gray"), 2: (3, "RGB", "RGB"), 3: (1, "P", "palette"),
               4: (2, "LA", "gray+alpha"), 6: (4, "RGBA", "RGBA")}


def read_image(path: str, mode: Optional[str]) -> np.ndarray:
    """The pixels of the image file `path` converted to `mode` ("L": uint8
    [H, W]; "RGB": uint8 [H, W, 3]), as Pillow converts them; mode None:
    an "L" or "P" image's values or palette indices as stored."""
    if mode not in ("L", "RGB", None):
        raise ValueError(f"mode {mode!r}: only 'L', 'RGB' and None are supported")
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        pixels, kind, palette = _decode_png(data, path)
    elif data[:4] in (b"II*\x00", b"MM\x00*"):
        pixels, kind, palette = _decode_tiff(data, path)
    elif data[:3] == b"\xff\xd8\xff":
        pixels, kind, palette = _decode_jpeg(data, path)
    else:
        raise ValueError(f"{path}: {_format_name(data)} is not supported "
                         "(PNG, uncompressed TIFF and JPEG only)")
    if mode is None:
        if kind not in ("L", "P"):
            raise ValueError(f"{path}: a {kind} image read as stored is not supported "
                             "(mode None reads 'L' and 'P' images)")
        return pixels.copy()
    return _convert(pixels, kind, palette, mode)


def _decode_jpeg(data: bytes, path: str):
    from senas_torch.data import native
    try:
        pixels = native.jpeg_decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return pixels, ("L" if pixels.ndim == 2 else "RGB"), None


def _format_name(data: bytes) -> str:
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:2] == b"BM":
        return "BMP"
    return "an unknown image format"


def _convert(pixels: np.ndarray, kind: str, palette, mode: str) -> np.ndarray:
    """Pillow's convert(mode) of an 8-bit image of `kind` (L, LA, RGB,
    RGBA or P)."""
    if kind == "P":
        pixels = palette[pixels]
        kind = "RGB"
    if kind in ("L", "LA"):
        gray = pixels[..., 0] if kind == "LA" else pixels
        return gray.copy() if mode == "L" else np.repeat(gray[..., None], 3, axis=-1)
    rgb = pixels[..., :3]
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _decode_png(data: bytes, path: str):
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _comp, _filt, interlace = ihdr
    if colour not in _PNG_COLOUR:
        raise ValueError(f"{path}: PNG colour type {colour} is not valid")
    channels, kind, name = _PNG_COLOUR[colour]
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit {name} PNG is not supported (bit depth 8 only)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = width * channels
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    pixels = unfilter(rows[:, 0], rows[:, 1:].reshape(height, width, channels))
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        palette = full
    return (pixels[..., 0] if channels == 1 else pixels), kind, palette


def unfilter(ftypes: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo PNG's per-row filters: `filtered` uint8 [H, W, C] (C bytes per
    pixel), `ftypes` the filter byte of each row (0 none, 1 sub, 2 up,
    3 average, 4 Paeth). The rows from the first of type 3-4 to the last
    go through `_unfilter_diagonals` together (one more row there costs one
    step, a second run of them W steps); the others a row at a time."""
    ftypes = np.asarray(ftypes)
    if (ftypes > 4).any():
        raise ValueError(f"PNG filter type {int(ftypes.max())} is not valid")
    h, w, c = filtered.shape
    out = np.empty_like(filtered)
    seq = np.flatnonzero(ftypes >= 3)
    first, last = (seq[0], seq[-1] + 1) if len(seq) else (h, h)
    prev = np.zeros((w, c), np.uint8)
    for r in range(h):
        if r == first:
            out[first:last] = _unfilter_diagonals(ftypes[first:last], filtered[first:last],
                                                  prev)
        if first <= r < last:
            prev = out[r]
            continue
        row = filtered[r]
        if ftypes[r] == 1:
            row = np.cumsum(row, axis=0, dtype=np.uint8)
        elif ftypes[r] == 2:
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_diagonals(ftypes: np.ndarray, filtered: np.ndarray,
                        prev: np.ndarray) -> np.ndarray:
    """Undo average and Paeth filters (types 0-2 may be among them) of
    rows below `prev`. Each byte needs its reconstructed left neighbour,
    so the rows are undone along anti-diagonals: pixel (r, x) needs only
    (r, x-1), (r-1, x) and (r-1, x-1), which lie on the two diagonals
    before its own, so each diagonal is one vector step (H + W steps)."""
    h, w, c = filtered.shape
    # skewed layout: pixel (r, x) at t[x + r + 2, r + 1], `prev` in column
    # 0; the places left of each row stay 0 (PNG's zero neighbours)
    rr, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    skew = (xx + rr + 2, rr + 1)
    raw = np.zeros((w + h + 2, h + 1, c), np.int16)
    raw[skew] = filtered
    t = np.zeros_like(raw)
    t[1:w + 1, 0] = prev
    ft = np.zeros(h + 1, np.int16)
    ft[1:] = ftypes
    ft = ft[:, None]
    for j in range(2, w + h + 1):
        lo, hi = max(1, j - w), min(h, j - 1) + 1          # rows on this diagonal
        a = t[j - 1, lo:hi]                                # left
        b = t[j - 1, lo - 1:hi - 1]                        # up
        cc = t[j - 2, lo - 1:hi - 1]                       # up-left
        f = ft[lo:hi]
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.where(f == 4, paeth, np.where(f == 3, (a + b) >> 1,
                        np.where(f == 2, b, np.where(f == 1, a, 0))))
        t[j, lo:hi] = (raw[j, lo:hi] + pred) & 255
    return t[skew].astype(np.uint8)


def float_to_l(arr: np.ndarray) -> np.ndarray:
    """Pillow's "F" to "L" conversion of float64 `arr`: the values as
    float32 (Pillow's "F" mode), truncated toward zero, clipped to
    [0, 255]; NaN becomes 0."""
    v = np.asarray(arr, np.float64).astype(np.float32)
    with np.errstate(invalid="ignore"):
        out = np.clip(np.trunc(v), 0, 255)
    return np.where(np.isnan(v), 0, out).astype(np.uint8)


def write_png_l(path: str, arr: np.ndarray) -> None:
    """Write 2-D `arr` as an 8-bit gray PNG with Pillow's F-to-L values
    (`float_to_l`): what `Image.fromarray(arr.astype(np.float64))
    .convert("L").save(path, format="png")` stores."""
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f"write_png_l takes a 2-D array, got shape {arr.shape}")
    write_png(path, float_to_l(arr))


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}   # BYTE, SHORT, LONG: the types of the tags read
_TAG_NAMES = {256: "width", 257: "height", 258: "bits", 259: "compression",
              262: "photometric", 273: "strip_offsets", 277: "samples",
              279: "strip_counts", 284: "planar", 317: "predictor", 322: "tile_width",
              338: "extra_samples"}


def _decode_tiff(data: bytes, path: str):
    """The first image of a baseline TIFF: 8-bit, uncompressed, in strips."""
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack(order + "HHI4s",
                                               data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        if tag not in _TAG_NAMES or typ not in _TIFF_TYPES:
            continue
        fmt = _TIFF_TYPES[typ]
        size = struct.calcsize(fmt) * count
        at = struct.unpack(order + "I", value)[0]
        raw = value[:size] if size <= 4 else data[at:at + size]
        tags[_TAG_NAMES[tag]] = struct.unpack(order + fmt * count, raw)
    get = lambda name, default: tags.get(name, (default,))
    width, height = get("width", 0)[0], get("height", 0)[0]
    compression, photometric = get("compression", 1)[0], get("photometric", -1)[0]
    samples, bits = get("samples", 1)[0], get("bits", 1)
    if compression != 1:
        raise ValueError(f"{path}: compressed TIFF (compression {compression}) is not "
                         "supported (uncompressed only)")
    if "tile_width" in tags:
        raise ValueError(f"{path}: tiled TIFF is not supported (strips only)")
    if any(b != 8 for b in bits):
        raise ValueError(f"{path}: {bits[0]}-bit TIFF is not supported (8 bits only)")
    if (photometric, samples) not in ((0, 1), (1, 1), (2, 3)) or "extra_samples" in tags:
        raise ValueError(f"{path}: TIFF with photometric {photometric} and {samples} "
                         "samples per pixel is not supported (8-bit gray or RGB only)")
    if samples > 1 and get("planar", 1)[0] != 1:
        raise ValueError(f"{path}: planar (separate) TIFF is not supported")
    if get("predictor", 1)[0] != 1:
        raise ValueError(f"{path}: TIFF with a predictor is not supported")
    strips = b"".join(data[o:o + c] for o, c in zip(tags["strip_offsets"],
                                                    tags["strip_counts"]))
    size = width * height * samples
    if len(strips) < size:
        raise ValueError(f"{path}: TIFF image data is truncated")
    pixels = np.frombuffer(strips[:size], np.uint8).reshape(height, width, samples)
    if photometric == 2:
        return pixels.copy(), "RGB", None
    gray = pixels[..., 0]
    return (255 - gray if photometric == 0 else gray.copy()), "L", None
