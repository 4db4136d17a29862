"""The port's cv2-free image operations (`senas_torch.data.imgproc`) against
cv2 itself on seeded inputs, at square and non-square sizes, sizes that the
CLAHE grid does not divide, and the loaders' own sizes (PROMISE12's 320 x
320 and 320 x 288 volumes and 256 x 256 crops; CHAOS CT's 512 x 512 to
256 x 256 presize, heart's 256 x 320 crops, hippo's 32 x 48, and the crop
sizes RandomSizedCrop draws).

Tolerances: `resize_nearest`, `resize_bilinear` (gray and RGB), `fma32`,
`clahe_u16`, `convert_maps_16sc2`, `remap_bilinear` (gray and RGB) and
`remap_nearest` are exact (each reproduces cv2's integer and float32
arithmetic, and IPP's for the bilinear resize, its unfused border columns
of a 9x or larger upscale in width included); `gaussian_blur` within
1e-12 (cv2 and scipy sum the 71 taps in another order: 1.1e-16 seen), its
kernel within 1e-16."""

import math
import random
from fractions import Fraction

import numpy as np
import pytest

from senas_torch.data import imgproc

cv2 = pytest.importorskip("cv2")

BLUR_ATOL = 1e-12


@pytest.mark.parametrize("src,dst", [
    ((320, 320), (256, 256)), ((320, 288), (256, 256)), ((96, 96), (256, 256)),
    ((100, 70), (33, 47)), ((37, 53), (300, 17)), ((256, 256), (320, 288)),
])
@pytest.mark.parametrize("dtype", [np.uint8, np.float64])
def test_resize_nearest(src, dst, dtype):
    rs = np.random.RandomState(0)
    img = (rs.rand(*src) * 255).astype(dtype)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(imgproc.resize_nearest(img, *dst), want)


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest to the rational q (ties to even)."""
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    picks = [c for c, d in zip(cands, dist) if d == best]
    if len(picks) > 1:
        picks = [c for c in picks if not int(np.array(c).view(np.uint32)) & 1]
    return picks[0]


def test_fma32_rounds_once():
    """x * y + z rounded once to float32, against exact rationals: random
    operands and the cases where rounding the float64 sum first would land
    on a tie (1 + 2^-23 + 2^-24 - 2^-70 must round down)."""
    rs = np.random.RandomState(7)
    x = (rs.randn(3000) * 10.0 ** rs.randint(-3, 4, 3000)).astype(np.float32)
    y = rs.rand(3000).astype(np.float32)
    z = (rs.randn(3000) * 10.0 ** rs.randint(-3, 4, 3000)).astype(np.float32)
    e = np.float32(2.0 ** -23)
    x = np.concatenate([x, [1 + e, 1 + e, -(1 + e)]]).astype(np.float32)
    y = np.concatenate([y, [2.0 ** -24 * (1 - 2.0 ** -23)] * 3]).astype(np.float32)
    z = np.concatenate([z, [1 + e, 1.0, -(1 + e)]]).astype(np.float32)
    want = [_round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
            for a, b, c in zip(x, y, z)]
    got = imgproc.fma32(x, y, z)
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    assert got[-3] == 1 + e and got[-1] == -(1 + e)
    # rounding the float64 sum to float32 is off there
    assert np.float32(np.float64(x[-3]) * np.float64(y[-3]) + np.float64(z[-3])) != got[-3]


def _rsc_sizes(n, w, h, tw, th, seed):
    """Crop sizes RandomSizedCrop((tw, th)) draws from a w x h image."""
    random.seed(seed)
    out = []
    while len(out) < n:
        area = w * h * random.uniform(0.7, 1.0)
        aspect = random.uniform(0.6, 1.4)
        cw, ch = int(round(math.sqrt(area * aspect))), int(round(math.sqrt(area / aspect)))
        if (tw > th and cw < ch) or (tw < th and cw > ch):
            cw, ch = ch, cw
        if cw <= w and ch <= h:
            out.append(((ch, cw), (th, tw)))
    return out


RESIZE_CASES = ([((512, 512), (256, 256)),     # CHAOS CT presize: cv2's 2x area path
                 ((320, 320), (256, 320)),     # heart: crop to 256 x 320
                 ((320, 320), (256, 256)),     # spleen, pancreas presize
                 ((35, 51), (32, 48)),         # hippo presize
                 ((48, 32), (32, 48)),
                 ((256, 320), (217, 301)),     # a ratio cv2's own code computes otherwise
                 ((96, 80), (512, 512)),       # bladder's small images up to 512
                 ((256, 256), (256, 256))]     # the same size: a copy
                + _rsc_sizes(4, 256, 256, 256, 256, 0)
                + _rsc_sizes(4, 320, 320, 320, 256, 1))


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_bilinear_at_the_loaders_ratios(src, dst, channels):
    rs = np.random.RandomState(sum(src) + sum(dst))
    shape = src + ((channels,) if channels else ())
    img = (rs.rand(*shape) * 255).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = imgproc.resize_bilinear(img, *dst)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [0, 3])
def test_resize_bilinear_at_random_ratios(channels):
    """Up to 4x up and down, values of every scale."""
    rs = np.random.RandomState(11 + channels)
    for i in range(60):
        src = tuple(int(v) for v in rs.randint(2, 160, 2))
        dst = tuple(int(np.clip(s * rs.uniform(0.25, 4.0), 1, 400)) for s in src)
        shape = src + ((channels,) if channels else ())
        img = (rs.randn(*shape) * 10.0 ** rs.randint(-3, 5)).astype(np.float32)
        want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(imgproc.resize_bilinear(img, *dst), want,
                                      err_msg=f"{shape} -> {dst}")


def test_resize_bilinear_stated_limit():
    """Where IPP leaves the fused multiply-add: an image upscaled 9x or more
    in width (5 or more border columns a side), whose height pass takes
    those columns with two roundings on channels 0-1 of an RGB image and
    every channel of a 4-channel one. Equal to cv2 there, at 8 x 4 x 3 ->
    9 x 58 and 20 x 4 x 3 -> 61 x 58, at 4-channel images, and on a sweep
    of widths across the 5-column threshold (upscales from 2x to 16x)."""
    rs = np.random.RandomState(3)
    cases = [((8, 4, 3), (9, 58)), ((20, 4, 3), (61, 58)), ((6, 5, 4), (13, 50)),
             ((6, 3, 4), (13, 27))]
    cases += [((5, sw, ch), (11, dw)) for ch in (0, 3) for sw in (3, 4, 7)
              for dw in range(2 * sw, 16 * sw, sw)]
    for shape, (dh, dw) in cases:
        shape = shape if shape[2] else shape[:2]
        img = (rs.rand(*shape) * 255).astype(np.float32)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(imgproc.resize_bilinear(img, dh, dw), want,
                                      err_msg=f"{shape} -> {(dh, dw)}")
    with pytest.raises(ValueError, match="float32"):
        imgproc.resize_bilinear(np.zeros((4, 4), np.uint8), 8, 8)


@pytest.mark.parametrize("shape,clip,grid", [
    ((320, 320), 12.8, (40, 40)),      # the PROMISE12 slices: 8x8 tiles, limit 1
    ((320, 288), 12.8, (40, 36)),      # a grid that divides neither side
    ((96, 96), 12.8, (12, 12)),
    ((100, 70), 12.8, (12, 8)),
    ((77, 131), 2.0, (4, 4)),
    ((64, 48), 40.0, (3, 5)),
    ((80, 80), 0.0, (2, 2)),           # no clipping
    ((96, 80), 1000.0, (8, 8)),        # limit above every bin
])
def test_clahe_u16(shape, clip, grid):
    rs = np.random.RandomState(1)
    u16 = (rs.rand(*shape) * 65535).astype(np.uint16)
    want = cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(u16)
    np.testing.assert_array_equal(imgproc.clahe_u16(u16, clip, grid), want)


def test_clahe_u16_on_a_smooth_image():
    """Few distinct values per tile (large clipped excess, residual steps)."""
    y, x = np.mgrid[0:160, 0:120]
    u16 = ((np.sin(x / 17.0) * np.cos(y / 23.0) + 1) * 3000).astype(np.uint16)
    want = cv2.createCLAHE(clipLimit=12.8, tileGridSize=(20, 15)).apply(u16)
    np.testing.assert_array_equal(imgproc.clahe_u16(u16, 12.8, (20, 15)), want)


@pytest.mark.parametrize("shape", [(256, 256), (96, 96), (100, 70)])
def test_gaussian_blur(shape):
    rs = np.random.RandomState(2)
    sigma = 0.07 * shape[0]
    ksize = int(4 * sigma) | 1
    field = rs.rand(*shape) * 2 - 1
    want = cv2.GaussianBlur(field, ksize=(ksize, ksize), sigmaX=sigma)
    np.testing.assert_allclose(imgproc.gaussian_blur(field, ksize, sigma), want,
                               rtol=0, atol=BLUR_ATOL)


def test_gaussian_kernel():
    """Within 1e-16 of taps near 0.02: the two exp() differ in the last bit
    (2.1e-17 seen)."""
    want = cv2.getGaussianKernel(71, 17.92, cv2.CV_64F)[:, 0]
    np.testing.assert_allclose(imgproc.gaussian_kernel(71, 17.92), want, rtol=0, atol=1e-16)


def _maps(rs, h, w, stretch):
    """Elastic-transform maps as the JAX package makes them, displacements
    scaled by `stretch` to reach well past the borders."""
    sigma = 0.07 * h
    ksize = int(4 * sigma) | 1
    dx = cv2.GaussianBlur(rs.rand(h, w) * 2 - 1, ksize=(ksize, ksize), sigmaX=sigma)
    dy = cv2.GaussianBlur(rs.rand(h, w) * 2 - 1, ksize=(ksize, ksize), sigmaX=sigma)
    x, y = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return ((x + dx * 1.5 * h * stretch).astype(np.float32),
            (y + dy * 1.5 * h * stretch).astype(np.float32))


@pytest.mark.parametrize("shape,stretch", [((256, 256), 1), ((256, 256), 30),
                                           ((96, 80), 30), ((70, 100), 10)])
def test_convert_maps_and_remap(shape, stretch):
    rs = np.random.RandomState(3)
    map_x, map_y = _maps(rs, *shape, stretch)
    xy, frac = cv2.convertMaps(map_x, map_y, cv2.CV_16SC2)
    got_xy, got_frac = imgproc.convert_maps_16sc2(map_x, map_y)
    np.testing.assert_array_equal(got_xy, xy)
    np.testing.assert_array_equal(got_frac, frac)

    img = rs.randn(*shape).astype(np.float32)
    mask = rs.randint(0, 3, shape).astype(np.uint8)
    # the maps in the JAX package's (swapped) order, which cv2 accepts
    want_img = cv2.remap(img, frac, xy, interpolation=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT)
    want_mask = cv2.remap(mask, frac, xy, interpolation=cv2.INTER_NEAREST,
                          borderMode=cv2.BORDER_CONSTANT)
    np.testing.assert_array_equal(imgproc.remap_bilinear(img, (got_xy, got_frac)), want_img)
    np.testing.assert_array_equal(imgproc.remap_nearest(mask, (got_xy, got_frac)), want_mask)
    # an RGB image through the same maps (CamVid's elastic transform)
    rgb = rs.randn(*shape, 3).astype(np.float32)
    want_rgb = cv2.remap(rgb, frac, xy, interpolation=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT)
    np.testing.assert_array_equal(imgproc.remap_bilinear(rgb, (got_xy, got_frac)), want_rgb)


def test_remap_nearest_is_not_plain_rounding():
    """cv2's nearest rule with a fraction table: pixel (y + (fy < 16),
    x + (fx < 16)). Plain rounding of the maps picks other pixels."""
    rs = np.random.RandomState(4)
    map_x, map_y = _maps(rs, 64, 64, 1)
    maps = imgproc.convert_maps_16sc2(map_x, map_y)
    mask = rs.randint(0, 255, (64, 64)).astype(np.uint8)
    rounded = cv2.remap(mask, map_x, map_y, interpolation=cv2.INTER_NEAREST,
                        borderMode=cv2.BORDER_CONSTANT)
    assert (imgproc.remap_nearest(mask, maps) != rounded).mean() > 0.1
