"""Joint (image, mask) augmentations and the cache build's preprocessing.

A port of `senas_tpu/data/augment.py`: `Compose`, the two flips,
`RandomTranslate`, `RandomRotate`, `RandomElasticTransform`, the resize
and crop family (`Scale`, `FreeScale`, `RandomZoom`, `RandomCrop`,
`CenterCrop`, `RandomSizedCrop`, `RandomSized`, `Pad`), the colour
transforms (`AdjustGamma`, `AdjustBrightness`, `AdjustContrast`,
`AdjustSaturation`, `AdjustHue`), and the cache build's
`equalize_adapthist` and `smooth_images`. Images are float32 [H,W] or
[H,W,C], masks uint8 [H,W]. Where the JAX package calls cv2, this module
calls `senas_torch.data.imgproc`, which computes the same numbers without
cv2 (the hue's RGB -> HSV within 1 ulp of h, `imgproc.rgb_to_hsv`).

The transforms draw from Python's `random` and numpy's global `np.random`,
in the JAX package's order and shapes, so that under the same
`random.seed` and `np.random.seed` both packages give the same sample.
"""

from __future__ import annotations

import math
import numbers
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from senas_torch.data import imgproc


def _resize(img: np.ndarray, size_wh: Tuple[int, int], nearest: bool) -> np.ndarray:
    """cv2.resize(img, size_wh) with INTER_NEAREST or INTER_LINEAR."""
    w, h = size_wh
    if nearest:
        return imgproc.resize_nearest(img, h, w)
    return imgproc.resize_bilinear(img, h, w)


class Compose:
    def __init__(self, augmentations: Sequence):
        self.augmentations = augmentations

    def __call__(self, img, mask):
        if img.shape[:2] != mask.shape[:2]:
            raise ValueError(f"image {img.shape} and mask {mask.shape} differ in size")
        for a in self.augmentations:
            img, mask = a(img, mask)
        return img, mask


class RandomHorizontallyFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, mask):
        if random.random() < self.p:
            return np.ascontiguousarray(img[:, ::-1]), np.ascontiguousarray(mask[:, ::-1])
        return img, mask


class RandomVerticallyFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, mask):
        if random.random() < self.p:
            return np.ascontiguousarray(img[::-1]), np.ascontiguousarray(mask[::-1])
        return img, mask


class RandomTranslate:
    """Shift by up to offset * size; the image is re-padded by reflection,
    the mask with zeros (the reference's augmentation.py:148-191)."""

    def __init__(self, offset: Tuple[float, float]):
        self.offset = offset

    def __call__(self, img, mask):
        h, w = img.shape[:2]
        x_offset = int(2 * (random.random() - 0.5) * self.offset[0] * w)
        y_offset = int(2 * (random.random() - 0.5) * self.offset[1] * h)
        return (self._translate(img, x_offset, y_offset, reflect=True),
                self._translate(mask, x_offset, y_offset, reflect=False))

    @staticmethod
    def _translate(arr, x_offset, y_offset, reflect):
        h, w = arr.shape[:2]
        y0, x0 = max(y_offset, 0), max(x_offset, 0)
        crop = arr[y0:y0 + h - abs(y_offset), x0:x0 + w - abs(x_offset)]
        pt = ((y_offset, 0) if y_offset >= 0 else (0, -y_offset),
              (x_offset, 0) if x_offset >= 0 else (0, -x_offset))
        if arr.ndim == 3:
            pt = pt + ((0, 0),)
        return np.pad(crop, pt, mode="reflect" if reflect else "constant")


class RandomRotate:
    def __init__(self, degree: float):
        self.degree = degree

    def __call__(self, img, mask):
        angle = random.random() * 2 * self.degree - self.degree
        h, w = img.shape[:2]
        m = imgproc.rotation_matrix((w / 2, h / 2), angle, 1.0)
        img2 = imgproc.warp_affine_nearest(img, m)
        mask2 = imgproc.warp_affine_nearest(mask, m)
        return img2.reshape(img.shape), mask2.reshape(mask.shape)


class RandomElasticTransform:
    """Simard-style elastic deformation with probability p (the
    reference's augmentation.py:376-425). The displacement fields are
    blurred uniform noise; the image (each of its channels alike) is
    resampled bilinearly and the mask
    by nearest neighbour, zero outside. As in the JAX package, the map of
    row coordinates goes where cv2 takes the column map, and the two
    converted maps are handed over in swapped order (which cv2 accepts)."""

    def __init__(self, alpha: float = 3, sigma: float = 0.07, p: float = 0.5):
        self.alpha = alpha
        self.sigma = sigma
        self.p = p

    def __call__(self, img, mask):
        if random.random() >= self.p:
            return img, mask
        h, w = img.shape[:2]
        alpha = self.alpha * h
        sigma = self.sigma * h
        blur_size = int(4 * sigma) | 1
        dx = imgproc.gaussian_blur(np.random.rand(h, w) * 2 - 1, blur_size, sigma) * alpha
        dy = imgproc.gaussian_blur(np.random.rand(h, w) * 2 - 1, blur_size, sigma) * alpha
        x, y = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        maps = imgproc.convert_maps_16sc2((x + dx).astype(np.float32),
                                          (y + dy).astype(np.float32))
        src = img.reshape(h, w) if img.size == h * w else img
        img2 = imgproc.remap_bilinear(src, maps).reshape(img.shape)
        mask2 = imgproc.remap_nearest(mask.reshape(h, w), maps).reshape(mask.shape)
        return img2, mask2


class Scale:
    """Resize the shorter side to `size`, keeping the aspect (the
    reference's augmentation.py:217-242)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, mask):
        h, w = img.shape[:2]
        if (w >= h and w == self.size) or (h >= w and h == self.size):
            return img, mask
        if w > h:
            ow = self.size
            oh = int(self.size * h / w)
        else:
            oh = self.size
            ow = int(self.size * w / h)
        return _resize(img, (ow, oh), False), _resize(mask, (ow, oh), True)


class FreeScale:
    def __init__(self, size: Tuple[int, int]):
        self.size = size  # (h, w)

    def __call__(self, img, mask):
        wh = (self.size[1], self.size[0])
        return _resize(img, wh, False), _resize(mask, wh, True)


class RandomZoom:
    def __init__(self, zoom: Tuple[float, float] = (0.8, 1.2)):
        self.zoom = zoom

    def __call__(self, img, mask):
        h, w = img.shape[:2]
        z = random.uniform(*self.zoom)
        nh, nw = int(h * z), int(w * z)
        img2 = _resize(img, (nw, nh), False)
        mask2 = _resize(mask, (nw, nh), True)
        if z >= 1:  # centre crop back
            y0, x0 = (nh - h) // 2, (nw - w) // 2
            return img2[y0:y0 + h, x0:x0 + w], mask2[y0:y0 + h, x0:x0 + w]
        # pad back
        py, px = h - nh, w - nw
        pt = ((py // 2, py - py // 2), (px // 2, px - px // 2))
        if img.ndim == 3:
            return np.pad(img2, pt + ((0, 0),)), np.pad(mask2, pt)
        return np.pad(img2, pt), np.pad(mask2, pt)


class RandomCrop:
    def __init__(self, size, padding: int = 0):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = size
        self.padding = padding

    def __call__(self, img, mask):
        if self.padding > 0:
            p = self.padding
            pt = ((p, p), (p, p))
            img = np.pad(img, pt + ((0, 0),) if img.ndim == 3 else pt)
            mask = np.pad(mask, pt)
        h, w = img.shape[:2]
        th, tw = self.size
        if w == tw and h == th:
            return img, mask
        if w < tw or h < th:
            return _resize(img, (tw, th), False), _resize(mask, (tw, th), True)
        x1 = random.randint(0, w - tw)
        y1 = random.randint(0, h - th)
        return img[y1:y1 + th, x1:x1 + tw], mask[y1:y1 + th, x1:x1 + tw]


class CenterCrop:
    def __init__(self, size, presize: bool = False):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = size  # (w, h), the reference's convention
        self.presize = presize

    def __call__(self, img, mask):
        h, w = img.shape[:2]
        tw, th = self.size
        if self.presize or w < tw or h < th:
            img = _resize(img, (tw, th), False)
            mask = _resize(mask, (tw, th), True)
            h, w = img.shape[:2]
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return img[y1:y1 + th, x1:x1 + tw], mask[y1:y1 + th, x1:x1 + tw]


class RandomSizedCrop:
    """Area 0.7-1.0, aspect 0.6-1.4, 10 attempts, then the centre crop
    (the reference's augmentation.py:277-317)."""

    def __init__(self, size, presize: bool = False):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = size  # (w, h)
        self.presize = presize
        self.center_crop = CenterCrop(self.size, self.presize)

    def __call__(self, img, mask):
        h, w = img.shape[:2]
        tw, th = self.size
        if self.presize or w < tw or h < th:
            img = _resize(img, (tw, th), False)
            mask = _resize(mask, (tw, th), True)
            h, w = img.shape[:2]
        for _ in range(10):
            area = w * h
            target_area = random.uniform(0.7, 1.0) * area
            aspect = random.uniform(0.6, 1.4)
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if tw > th and cw < ch:
                cw, ch = ch, cw
            elif tw < th and cw > ch:
                cw, ch = ch, cw
            if cw <= w and ch <= h:
                x1 = random.randint(0, w - cw)
                y1 = random.randint(0, h - ch)
                imgc = img[y1:y1 + ch, x1:x1 + cw]
                maskc = mask[y1:y1 + ch, x1:x1 + cw]
                return _resize(imgc, (tw, th), False), _resize(maskc, (tw, th), True)
        return self.center_crop(img, mask)


class RandomSized:
    def __init__(self, size):
        self.size = size
        self.scale = Scale(size)
        self.crop = RandomCrop(size)

    def __call__(self, img, mask):
        h, w = img.shape[:2]
        nw = int(random.uniform(0.5, 2) * w)
        nh = int(random.uniform(0.5, 2) * h)
        img = _resize(img, (nw, nh), False)
        mask = _resize(mask, (nw, nh), True)
        return self.crop(*self.scale(img, mask))


class Pad:
    def __init__(self, padding: int, fill=0):
        self.padding = padding
        self.fill = fill

    def __call__(self, img, mask):
        p = self.padding
        pt = ((p, p), (p, p))
        img = np.pad(img, pt + ((0, 0),) if img.ndim == 3 else pt,
                     constant_values=self.fill)
        mask = np.pad(mask, pt, constant_values=self.fill)
        return img, mask


class AdjustGamma:
    def __init__(self, gamma: float):
        self.gamma = gamma

    def __call__(self, img, mask):
        g = random.uniform(1, 1 + self.gamma)
        lo, hi = img.min(), img.max()
        scale = (hi - lo) if hi > lo else 1.0
        return (np.power((img - lo) / scale, g) * scale + lo).astype(img.dtype), mask


class AdjustBrightness:
    def __init__(self, bf: float):
        self.bf = bf

    def __call__(self, img, mask):
        f = random.uniform(1 - self.bf, 1 + self.bf)
        return (img * f).astype(img.dtype), mask


class AdjustContrast:
    def __init__(self, cf: float):
        self.cf = cf

    def __call__(self, img, mask):
        f = random.uniform(1 - self.cf, 1 + self.cf)
        mean = img.mean()
        return ((img - mean) * f + mean).astype(img.dtype), mask


class AdjustSaturation:
    def __init__(self, saturation: float):
        self.saturation = saturation

    def __call__(self, img, mask):
        if img.ndim != 3 or img.shape[2] != 3:
            return img, mask
        f = random.uniform(1 - self.saturation, 1 + self.saturation)
        gray = img.mean(axis=2, keepdims=True)
        return (gray + (img - gray) * f).astype(img.dtype), mask


class AdjustHue:
    def __init__(self, hue: float):
        self.hue = hue

    def __call__(self, img, mask):
        if img.ndim != 3 or img.shape[2] != 3:
            return img, mask
        shift = random.uniform(-self.hue, self.hue) * 180
        hsv = imgproc.rgb_to_hsv(img.astype(np.float32))
        hsv[..., 0] = (hsv[..., 0] + shift) % 360
        return imgproc.hsv_to_rgb(hsv).astype(img.dtype), mask


# ---------------------------------------------------------------------------
# Preprocessing of the cache build
# ---------------------------------------------------------------------------

def equalize_adapthist(img: np.ndarray, clip_limit: float = 0.05,
                       nbins: int = 256) -> np.ndarray:
    """CLAHE of a 2-D float image, as floats in [0, 1]: the JAX package's
    cv2 CLAHE on a 16-bit quantisation. Its tile grid is (h // 8, w // 8)
    tiles, which at 320 x 320 is 40 x 40 tiles of 8 x 8 pixels and a clip
    limit of 1 per bin; that is the JAX package's semantics, kept as is."""
    img = np.asarray(img, dtype=np.float64)
    lo, hi = img.min(), img.max()
    scale = (hi - lo) if hi > lo else 1.0
    u16 = ((img - lo) / scale * 65535).astype(np.uint16)
    h, w = img.shape
    grid = (max(1, h // 8), max(1, w // 8))
    return imgproc.clahe_u16(u16, clip_limit * nbins, grid).astype(np.float64) / 65535.0


def smooth_images(imgs: np.ndarray, t_step: float = 0.125, n_iter: int = 5,
                  native: bool = True) -> np.ndarray:
    """Curvature-flow denoising of each image of a stack (the reference's
    sitk.CurvatureFlow, augmentation.py:428-442), as float64. `native`
    runs the C++ version (built at first use; a failed build raises),
    else numpy's `_curvature_flow`; the two agree exactly."""
    out = np.array(imgs, dtype=np.float64, copy=True)
    if native:
        from senas_torch.data.native import curvature_flow as flow
    else:
        flow = _curvature_flow
    for idx in range(len(out)):
        out[idx] = flow(out[idx], t_step, n_iter)
    return out


def _curvature_flow(img: np.ndarray, t_step: float, n_iter: int) -> np.ndarray:
    """dI/dt = kappa * |grad I| with central differences, edges replicated."""
    eps = 1e-8
    u = img.astype(np.float64)
    for _ in range(n_iter):
        up = np.pad(u, 1, mode="edge")
        ux = (up[1:-1, 2:] - up[1:-1, :-2]) / 2.0
        uy = (up[2:, 1:-1] - up[:-2, 1:-1]) / 2.0
        uxx = up[1:-1, 2:] - 2 * u + up[1:-1, :-2]
        uyy = up[2:, 1:-1] - 2 * u + up[:-2, 1:-1]
        uxy = (up[2:, 2:] - up[2:, :-2] - up[:-2, 2:] + up[:-2, :-2]) / 4.0
        num = uxx * uy * uy - 2 * ux * uy * uxy + uyy * ux * ux
        den = ux * ux + uy * uy + eps
        u = u + t_step * num / den
    return u


# ---------------------------------------------------------------------------
# Registry (the reference's utils/augmentations/__init__.py:7-32)
# ---------------------------------------------------------------------------

key2aug = {
    "gamma": AdjustGamma,
    "hue": AdjustHue,
    "brightness": AdjustBrightness,
    "saturation": AdjustSaturation,
    "contrast": AdjustContrast,
    "rcrop": RandomCrop,
    "hflip": RandomHorizontallyFlip,
    "vflip": RandomVerticallyFlip,
    "scale": Scale,
    "rsize": RandomSized,
    "rsizecrop": RandomSizedCrop,
    "rotate": RandomRotate,
    "translate": RandomTranslate,
    "ccrop": CenterCrop,
    "elastic": RandomElasticTransform,
    "zoom": RandomZoom,
}


def get_composed_augmentations(aug_dict: Optional[dict]) -> Optional[Compose]:
    if aug_dict is None:
        return None
    return Compose([key2aug[k](v) for k, v in aug_dict.items()])
