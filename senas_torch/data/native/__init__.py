"""ctypes binding of the native curvature flow (`augment_native.cpp`).

The library is built with g++ at first use (`build.py`); a build that fails
raises. `senas_torch.data.augment.smooth_images` calls it unless its
caller passes `native=False`, which runs the numpy version instead.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
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
