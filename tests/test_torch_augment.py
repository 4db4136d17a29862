"""The port's joint augmentations and cache-build preprocessing
(`senas_torch.data.augment`) against senas_tpu's (which calls cv2), under
the same `random.seed` and `np.random.seed`: each transform (the flips,
translate and elastic of the PROMISE12 path; the resize and crop family of
the other loaders, on gray and RGB images; the elastic transform of an RGB
image), `Compose` of the PROMISE12 train split's four, CLAHE and the
curvature flow in both packages, native and numpy.

Tolerances: images within 2.5e-7 and masks exactly equal (every case here
came out exactly equal: the port reproduces cv2's rounding); the curvature
flow exactly equal in all four pairings."""

import random

import numpy as np
import pytest

from senas_torch.data import augment as T

J = pytest.importorskip("senas_tpu.data.augment")  # needs cv2

IMG_ATOL = 2.5e-7


def _pair(shape, seed):
    """A float32 image of `shape` ([H, W] or [H, W, C]) and a uint8 [H, W]
    mask."""
    rs = np.random.RandomState(seed)
    img = rs.randn(*shape).astype(np.float32)
    mask = (rs.rand(*shape[:2]) > 0.6).astype(np.uint8)
    return img, mask


def _both(make, shape, seed, draws=6):
    """Each package's transform on the same pair, `draws` times from the
    same seeds; returns the pairs of outputs."""
    img, mask = _pair(shape, seed)
    out = []
    for pkg in (J, T):
        random.seed(seed)
        np.random.seed(seed)
        fn = make(pkg)
        out.append([fn(img.copy(), mask.copy()) for _ in range(draws)])
    return zip(*out)


def _assert_same(pairs):
    for (ji, jm), (ti, tm) in pairs:
        assert ti.shape == ji.shape and ti.dtype == ji.dtype
        np.testing.assert_allclose(ti, ji, rtol=0, atol=IMG_ATOL)
        np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("make", [
    lambda A: A.RandomHorizontallyFlip(),
    lambda A: A.RandomVerticallyFlip(),
    lambda A: A.RandomTranslate(offset=(0.2, 0.1)),
    lambda A: A.RandomElasticTransform(alpha=1.5, sigma=0.07),
    lambda A: A.RandomElasticTransform(alpha=3, sigma=0.07, p=1.0),
], ids=["hflip", "vflip", "translate", "elastic", "elastic_always"])
@pytest.mark.parametrize("shape", [(64, 64), (72, 48)])
def test_transform_matches(make, shape):
    _assert_same(_both(make, shape, seed=7))


# the resize and crop family of the other loaders (senas_tpu/data/augment.py
# :140-298), at sizes that take each branch (crop, resize up and down,
# presize, pad, the centre-crop fallback of RandomSizedCrop)
RESIZE_FAMILY = {
    "scale": lambda A: A.Scale(48),
    "scale_noop": lambda A: A.Scale(72),
    "freescale": lambda A: A.FreeScale((40, 56)),
    "zoom": lambda A: A.RandomZoom((0.8, 1.2)),
    "zoom_out": lambda A: A.RandomZoom((0.6, 0.9)),
    "rcrop": lambda A: A.RandomCrop(32),
    "rcrop_pad": lambda A: A.RandomCrop((40, 30), padding=4),
    "rcrop_up": lambda A: A.RandomCrop(96),
    "ccrop": lambda A: A.CenterCrop((48, 40)),
    "ccrop_presize": lambda A: A.CenterCrop((48, 40), presize=True),
    "rsizecrop": lambda A: A.RandomSizedCrop((56, 40)),
    "rsizecrop_tall": lambda A: A.RandomSizedCrop((40, 56)),
    "rsizecrop_presize": lambda A: A.RandomSizedCrop(64, presize=True),
    "rsizecrop_fallback": lambda A: A.RandomSizedCrop((64, 8)),
    "rsized": lambda A: A.RandomSized(48),
    "pad": lambda A: A.Pad(3, fill=2),
}


@pytest.mark.parametrize("name", sorted(RESIZE_FAMILY))
@pytest.mark.parametrize("shape", [(64, 64), (72, 48), (72, 48, 3)], ids=["square", "tall", "rgb"])
def test_resize_family_matches(name, shape):
    _assert_same(_both(RESIZE_FAMILY[name], shape, seed=9, draws=5))


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_elastic_of_an_rgb_image_matches(p):
    make = lambda A: A.RandomElasticTransform(alpha=1.5, sigma=0.07, p=p)
    _assert_same(_both(make, (64, 48, 3), seed=4, draws=4))


@pytest.mark.parametrize("seed", [0, 1])
def test_promise12_compose_matches(seed):
    def make(A):
        return A.Compose([A.RandomTranslate(offset=(0.2, 0.1)), A.RandomVerticallyFlip(),
                          A.RandomHorizontallyFlip(),
                          A.RandomElasticTransform(alpha=1.5, sigma=0.07)])
    _assert_same(_both(make, (96, 96), seed, draws=8))


def test_translate_keeps_a_channel_axis():
    img, mask = _pair((40, 40), 3)
    img3 = np.repeat(img[..., None], 3, axis=-1)
    random.seed(3)
    ji, jm = J.RandomTranslate(offset=(0.3, 0.3))(img3, mask)
    random.seed(3)
    ti, tm = T.RandomTranslate(offset=(0.3, 0.3))(img3, mask)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


def test_registry_and_the_transforms_of_m9b():
    """M9b brought the resize and crop family, M9c the rotation and the
    colour transforms: the registry is the JAX package's, name for name
    (tests/test_torch_m9c.py holds the M9c transforms to senas_tpu's)."""
    aug = T.get_composed_augmentations({"hflip": 0.5, "translate": (0.1, 0.1),
                                        "rsizecrop": 32, "zoom": (0.9, 1.1)})
    assert [type(a) for a in aug.augmentations] == [T.RandomHorizontallyFlip,
                                                    T.RandomTranslate, T.RandomSizedCrop,
                                                    T.RandomZoom]
    assert T.get_composed_augmentations(None) is None
    assert set(T.key2aug) == set(J.key2aug)
    for k in T.key2aug:
        assert T.key2aug[k].__name__ == J.key2aug[k].__name__, k
    aug = T.get_composed_augmentations({"rotate": 10, "hue": 0.1, "gamma": 0.2})
    assert [type(a) for a in aug.augmentations] == [T.RandomRotate, T.AdjustHue,
                                                    T.AdjustGamma]


@pytest.mark.parametrize("shape", [(96, 96), (120, 100)])
def test_equalize_adapthist_matches(shape):
    rs = np.random.RandomState(5)
    img = (rs.rand(*shape) * 900 + 100 * np.sin(np.arange(shape[1]) / 9.0)).astype(np.int16)
    np.testing.assert_array_equal(T.equalize_adapthist(img, clip_limit=0.05),
                                  J.equalize_adapthist(img, clip_limit=0.05))


def test_smooth_images_native_and_numpy_in_both_packages(monkeypatch):
    rs = np.random.RandomState(6)
    imgs = rs.rand(3, 48, 40)
    port_native = T.smooth_images(imgs)
    port_numpy = T.smooth_images(imgs, native=False)
    jax_side = J.smooth_images(imgs)   # native when its library is there
    from senas_tpu.data import native as jnative
    monkeypatch.setattr(jnative, "available", lambda: False)
    jax_numpy = J.smooth_images(imgs)
    for other in (port_numpy, jax_side, jax_numpy):
        np.testing.assert_array_equal(port_native, other)
    assert not np.array_equal(port_native, imgs)


def test_native_curvature_flow_leaves_its_input():
    from senas_torch.data import native
    img = np.random.RandomState(8).rand(16, 16)
    before = img.copy()
    out = native.curvature_flow(img, 0.125, 3)
    np.testing.assert_array_equal(img, before)
    np.testing.assert_array_equal(out, T._curvature_flow(before, 0.125, 3))
