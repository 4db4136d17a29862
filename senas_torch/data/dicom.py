"""Minimal DICOM reader for uncompressed CT/MR slices.

A copy of `senas_tpu/data/dicom.py` (numpy only), kept here so that the
port imports nothing of the JAX package. It replaces the reference's
pydicom dependency (utils/datasets/chaos.py:4) for the subset DICOM
actually used there: single-frame, little-endian, implicit/explicit VR,
native (uncompressed) pixel data; extracts Rows, Columns, BitsAllocated,
PixelRepresentation, RescaleSlope/Intercept and the pixel array.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

# (group, element) tags we care about
_TAG_ROWS = (0x0028, 0x0010)
_TAG_COLS = (0x0028, 0x0011)
_TAG_BITS_ALLOC = (0x0028, 0x0100)
_TAG_PIXEL_REP = (0x0028, 0x0103)
_TAG_SLOPE = (0x0028, 0x1053)
_TAG_INTERCEPT = (0x0028, 0x1052)
_TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
_TAG_PIXEL_DATA = (0x7FE0, 0x0010)
_TAG_TS = (0x0002, 0x0010)

_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}

_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_IMPLICIT_LE = "1.2.840.10008.1.2"


def _read_elements(buf: bytes, offset: int, explicit: bool):
    """Yield (tag, vr, value_bytes, next_offset)."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, offset)
        tag = (group, elem)
        offset += 4
        if explicit or group == 0x0002:
            vr = buf[offset:offset + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from("<H", buf, offset + 2)[0]
                offset += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, offset)[0]
            offset += 4
        if length == 0xFFFFFFFF:
            raise ValueError("undefined-length (encapsulated) DICOM not supported")
        value = buf[offset:offset + length]
        offset += length
        yield tag, vr, value, offset


def read_dicom_pixels(path: str) -> Tuple[np.ndarray, float, float]:
    """Return (pixel_array [rows, cols], rescale_slope, rescale_intercept)."""
    with open(path, "rb") as fp:
        buf = fp.read()

    offset = 0
    transfer_syntax = _EXPLICIT_LE
    if buf[128:132] == b"DICM":
        offset = 132
        # file meta group is always explicit LE; scan it for transfer syntax
        for tag, vr, value, next_off in _read_elements(buf, offset, explicit=True):
            if tag == _TAG_TS:
                transfer_syntax = value.decode("ascii", "ignore").strip("\x00 ")
            if tag[0] != 0x0002:
                offset = next_off - (8 + len(value)) if vr in _LONG_VRS else next_off
                break
            offset = next_off
    # else: raw dataset without preamble (some CHAOS exports); assume implicit

    explicit = transfer_syntax != _IMPLICIT_LE
    if transfer_syntax not in (_EXPLICIT_LE, _IMPLICIT_LE):
        raise ValueError(f"unsupported transfer syntax {transfer_syntax!r} "
                         f"(compressed DICOM not supported)")

    fields: Dict[Tuple[int, int], bytes] = {}
    pixel_data = None
    try:
        for tag, vr, value, next_off in _read_elements(buf, offset, explicit):
            if tag == _TAG_PIXEL_DATA:
                pixel_data = value
                break
            if tag[0] in (0x0028,):
                fields[tag] = value
    except struct.error:
        pass
    if pixel_data is None:
        raise ValueError(f"{path}: no PixelData found")

    def _us(tag, default):
        v = fields.get(tag)
        if not v:
            return default
        return struct.unpack("<H", v[:2])[0]

    def _ds(tag, default):
        v = fields.get(tag)
        if not v:
            return default
        try:
            return float(v.decode("ascii", "ignore").strip("\x00 ").split("\\")[0])
        except ValueError:
            return default

    rows = _us(_TAG_ROWS, 512)
    cols = _us(_TAG_COLS, 512)
    bits = _us(_TAG_BITS_ALLOC, 16)
    signed = _us(_TAG_PIXEL_REP, 0) == 1
    slope = _ds(_TAG_SLOPE, 1.0)
    intercept = _ds(_TAG_INTERCEPT, 0.0)

    if bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 8:
        dtype = np.int8 if signed else np.uint8
    else:
        raise ValueError(f"unsupported BitsAllocated={bits}")
    arr = np.frombuffer(pixel_data, dtype=dtype, count=rows * cols).reshape(rows, cols)
    return np.array(arr), slope, intercept
