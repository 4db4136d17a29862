"""The port's cv2-free image operations (`senas_torch.data.imgproc`) against
cv2 itself on seeded inputs, at square and non-square sizes, sizes that the
CLAHE grid does not divide, and the PROMISE12 path's own sizes (320 x 320
and 320 x 288 volumes, 256 x 256 crops).

Tolerances: `resize_nearest`, `clahe_u16`, `convert_maps_16sc2`,
`remap_bilinear` and `remap_nearest` are exact (each reproduces cv2's
integer and float32 arithmetic); `gaussian_blur` within 1e-12 (cv2 and
scipy sum the 71 taps in another order: 1.1e-16 seen), its kernel within
1e-16."""

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
