"""Minimal medical-image IO: MetaImage (.mhd/.raw) and NIfTI-1 (.nii/.nii.gz).

A numpy copy of `senas_tpu/data/io.py`, kept here so that the port imports
nothing of the JAX package. Both write and read the same bytes: a volume
written by either package reads back equal in the other
(tests/test_torch_challenge.py). The reference reads these formats through
SimpleITK / nibabel; MetaImage is a text header plus a raw binary blob and
NIfTI-1 a fixed 348-byte header, so the framework carries its own readers,
plus the MHD writer of the PROMISE12 submission path.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

_MET_TO_DTYPE = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_TO_DTYPE.items()}


@dataclass
class MetaImage:
    """array is indexed [z, y, x] like sitk.GetArrayFromImage."""

    array: np.ndarray
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)
    origin: Tuple[float, ...] = (0.0, 0.0, 0.0)
    direction: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)
    header: Dict[str, str] = field(default_factory=dict)


def read_mhd(path: str) -> MetaImage:
    header: Dict[str, str] = {}
    with open(path, "r", errors="ignore") as fp:
        for line in fp:
            if "=" not in line:
                continue
            key, val = line.split("=", 1)
            header[key.strip()] = val.strip()

    ndims = int(header.get("NDims", 3))
    dim_size = [int(v) for v in header["DimSize"].split()]
    dtype = _MET_TO_DTYPE[header.get("ElementType", "MET_SHORT")]
    data_file = header.get("ElementDataFile", "LOCAL")
    byte_order_msb = header.get("ElementByteOrderMSB", "False").lower() == "true" or \
        header.get("BinaryDataByteOrderMSB", "False").lower() == "true"
    compressed = header.get("CompressedData", "False").lower() == "true"

    raw_path = os.path.join(os.path.dirname(path), data_file)
    with open(raw_path, "rb") as fp:
        blob = fp.read()
    if compressed:
        blob = zlib.decompress(blob)
    arr = np.frombuffer(blob, dtype=dtype)
    if byte_order_msb:
        arr = arr.byteswap()
    # MetaImage DimSize is (x, y, z); numpy array is [z, y, x]
    arr = arr.reshape(tuple(reversed(dim_size)))

    def _floats(key, default):
        if key in header:
            return tuple(float(v) for v in header[key].split())
        return default

    spacing = _floats("ElementSpacing", _floats("ElementSize", (1.0,) * ndims))
    origin = _floats("Offset", _floats("Position", (0.0,) * ndims))
    direction = _floats("TransformMatrix", tuple(np.eye(ndims).ravel()))
    return MetaImage(array=np.array(arr), spacing=spacing, origin=origin,
                     direction=direction, header=header)


def write_mhd(path: str, image: MetaImage):
    """Write .mhd + .raw pair (challenge submission format)."""
    if not path.endswith(".mhd"):
        raise ValueError(f"write_mhd: {path!r} does not end in .mhd")
    arr = np.ascontiguousarray(image.array)
    met_type = _DTYPE_TO_MET[arr.dtype]
    raw_name = os.path.basename(path)[:-4] + ".raw"
    ndims = arr.ndim
    dims = tuple(reversed(arr.shape))  # numpy [z,y,x] -> header (x,y,z)
    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        "CompressedData = False",
        "TransformMatrix = " + " ".join(str(v) for v in image.direction),
        "Offset = " + " ".join(str(v) for v in image.origin),
        "CenterOfRotation = " + " ".join("0" for _ in range(ndims)),
        "ElementSpacing = " + " ".join(str(v) for v in image.spacing),
        "DimSize = " + " ".join(str(v) for v in dims),
        f"ElementType = {met_type}",
        f"ElementDataFile = {raw_name}",
    ]
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    with open(os.path.join(os.path.dirname(path), raw_name), "wb") as fp:
        fp.write(arr.tobytes())


# ---------------------------------------------------------------------------
# NIfTI-1
# ---------------------------------------------------------------------------

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}


def read_nifti(path: str) -> np.ndarray:
    """Read a NIfTI-1 volume (.nii or .nii.gz), returning the data array in
    file (Fortran, x-fastest) order: shape (X, Y, Z[, T])."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fp:
        hdr = fp.read(348)
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            endian = ">"
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
        dim = struct.unpack(endian + "8h", hdr[40:56])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        vox_offset = int(struct.unpack(endian + "f", hdr[108:112])[0])
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1:1 + ndim])
        dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(endian)
        fp.read(max(0, vox_offset - 348))
        count = int(np.prod(shape))
        data = np.frombuffer(fp.read(count * dtype.itemsize), dtype=dtype, count=count)
    arr = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        arr = arr * slope + scl_inter
    return np.asarray(arr)
