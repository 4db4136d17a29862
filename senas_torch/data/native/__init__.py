"""ctypes bindings of the data path's native libraries.

- `augment_native.cpp`: the curvature flow. `senas_torch.data.augment.
  smooth_images` calls it unless its caller passes `native=False`, which
  runs the numpy version instead.
- `image_native.cpp`: JPEG decoding (`jpeg_decode`, for `data/imfile.py`),
  the integer passes of Pillow's resampling (`resample_h`, `resample_v`,
  for `data/pilresample.py`, which holds their numpy twins), and cv2's
  nearest affine warp and float RGB <-> HSV (`warp_affine_nearest`,
  `rgb_to_hsv`, `hsv_to_rgb`, for `data/imgproc.py`).

Each library is built with g++ at first use (`build.py`); a build that
fails raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
_image_lib = None
_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded library, built first if need be (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            from senas_torch.data.native.build import build
            so = ctypes.CDLL(str(build()))
            so.curvature_flow.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                                          ctypes.c_int, ctypes.c_double, ctypes.c_int]
            so.curvature_flow.restype = None
            _lib = so
    return _lib


def curvature_flow(img: np.ndarray, t_step: float, n_iter: int) -> np.ndarray:
    """`n_iter` steps of curvature flow of a 2-D image, as float64; the
    input is not changed."""
    if np.ndim(img) != 2:
        raise ValueError(f"curvature_flow takes a 2-D image, got shape {np.shape(img)}")
    so = lib()
    # a copy: the kernel works in place and must not alias the caller's array
    u = np.array(img, dtype=np.float64, order="C", copy=True)
    h, w = u.shape
    so.curvature_flow(u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), h, w,
                      float(t_step), int(n_iter))
    return u


_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_intp = ctypes.POINTER(ctypes.c_int)


def image_lib() -> ctypes.CDLL:
    """The loaded image library, built first if need be (once per process)."""
    global _image_lib
    with _lock:
        if _image_lib is None:
            from senas_torch.data.native.build import build
            so = ctypes.CDLL(str(build("image_native")))
            so.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_long, _intp, _intp, _intp,
                                     ctypes.c_char_p, ctypes.c_int]
            so.jpeg_info.restype = ctypes.c_int
            so.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, _u8p, ctypes.c_char_p,
                                       ctypes.c_int]
            so.jpeg_decode.restype = ctypes.c_int
            so.resample_h.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, _u8p, ctypes.c_int, _i32p, _i32p,
                                      ctypes.c_int]
            so.resample_h.restype = None
            so.resample_v.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int,
                                      _i32p, _i32p, ctypes.c_int]
            so.resample_v.restype = None
            so.warp_affine_nearest.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               _u8p, ctypes.POINTER(ctypes.c_float)]
            so.warp_affine_nearest.restype = None
            for fn in (so.rgb_to_hsv, so.hsv_to_rgb):
                fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                               ctypes.c_long]
                fn.restype = None
            _image_lib = so
    return _image_lib


def jpeg_decode(data: bytes) -> np.ndarray:
    """The pixels of JPEG file contents `data`: uint8 [H, W] for a gray
    file, [H, W, 3] RGB for a colour one. Raises ValueError with the
    decoder's message (naming an unsupported variant)."""
    so = image_lib()
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if so.jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                    err, len(err)):
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value) + ((3,) if c.value == 3 else ()), np.uint8)
    if so.jpeg_decode(data, len(data), out.ctypes.data_as(_u8p), err, len(err)):
        raise ValueError(err.value.decode())
    return out


def resample_h(img: np.ndarray, first: int, rows: int, out_w: int, bounds: np.ndarray,
               k: np.ndarray) -> np.ndarray:
    """Pillow's horizontal pass over rows [first, first + rows) of uint8
    `img` [H, W, C]: `bounds` int32 [out_w, 2] (first input, count),
    `k` int32 [out_w, ksize] fixed-point weights."""
    img = np.ascontiguousarray(img, np.uint8)
    bounds = np.ascontiguousarray(bounds, np.int32)
    k = np.ascontiguousarray(k, np.int32)
    h, w, ch = img.shape
    out = np.empty((rows, out_w, ch), np.uint8)
    image_lib().resample_h(img.ctypes.data_as(_u8p), w, ch, first, rows,
                           out.ctypes.data_as(_u8p), out_w, bounds.ctypes.data_as(_i32p),
                           k.ctypes.data_as(_i32p), k.shape[1])
    return out


def resample_v(img: np.ndarray, out_h: int, bounds: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pillow's vertical pass of uint8 `img` [H, W, C] to `out_h` rows."""
    img = np.ascontiguousarray(img, np.uint8)
    bounds = np.ascontiguousarray(bounds, np.int32)
    k = np.ascontiguousarray(k, np.int32)
    h, w, ch = img.shape
    out = np.empty((out_h, w, ch), np.uint8)
    image_lib().resample_v(img.ctypes.data_as(_u8p), w, ch, out.ctypes.data_as(_u8p), out_h,
                           bounds.ctypes.data_as(_i32p), k.ctypes.data_as(_i32p), k.shape[1])
    return out


def warp_affine_nearest(img: np.ndarray, inverse: np.ndarray) -> np.ndarray:
    """Each output pixel of `img` [H, W, ...] (any dtype) read at the
    rounded float32 map `inverse` [2, 3] of its position, 0 outside
    (`imgproc.rotate_nearest`'s kernel)."""
    img = np.ascontiguousarray(img)
    m = np.ascontiguousarray(inverse, np.float32).reshape(6)
    h, w = img.shape[:2]
    pix = img.dtype.itemsize * int(np.prod(img.shape[2:], dtype=np.int64))
    out = np.empty_like(img)
    image_lib().warp_affine_nearest(img.ctypes.data_as(_u8p), h, w, pix,
                                    out.ctypes.data_as(_u8p),
                                    m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def colour_convert(img: np.ndarray, to_hsv: bool) -> np.ndarray:
    """float32 [..., 3] RGB -> HSV (`to_hsv`) or HSV -> RGB."""
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty_like(img)
    fn = image_lib().rgb_to_hsv if to_hsv else image_lib().hsv_to_rgb
    fp = ctypes.POINTER(ctypes.c_float)
    fn(img.ctypes.data_as(fp), out.ctypes.data_as(fp), img.size // 3)
    return out
