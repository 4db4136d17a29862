"""The port's MobileNetV3 and ResNeSt encoders
(`senas_torch/models/encoders_{mnv3,resnest}.py`) against senas_tpu's on
the CPU, from the same numpy-made weights (non-trivial BN running stats),
batch 2: the eval-mode pyramids at 32x32x3 of
timm-mobilenetv3_large_100, timm-mobilenetv3_small_minimal_100,
timm-resnest14d and the radix 4 / cardinality 2 and radix 1 ResNeSts;
the train-mode pyramids of the first three at 64x64 with the running
stats they leave (ResNeSt's attention BatchNorm normalises [2, attn, 1, 1]
maps there: 2 values a channel, running-variance factor 2); output stride
16 and 8 for MobileNetV3; TF 'same' padding (asymmetric at stride 2, and
under dilation), hardswish and hardsigmoid; the dilated mode's error of
ResNeSt.

Tolerances (f32 on both sides), the resnet test's: eval-mode maps within
2e-5 of their largest magnitude, train-mode maps within 2e-4, running
stats atol 2e-5 and rtol 1e-4; where the port's own f32 map or stat lies
far from an f64 run of the port, F32_SPREAD (5) times that distance
(`assert_pyramid_close`, `assert_stats_close`; a fault of the port moves
its f32 and f64 maps alike, so it stays within none of these bounds): timm-resnest14d's deepest
train-mode map at 64x64 is 1.8e-4 off the port's f64 run in senas_tpu
(the port's f32 5.5e-5), and timm-resnest50d_4s2x40d's deepest eval-mode
map 2.4e-4 (the port's 1.3e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_torch.models import encoders_mnv3 as tmnv3
from senas_torch.models import encoders_resnest as tresnest
from senas_tpu.models import encoders_mnv3 as jmnv3
from senas_tpu.models import encoders_resnest as jresnest

from torch_port_util import (assert_dilation_error_matches, assert_encoder_eval_matches,
                             assert_encoder_train_matches, nchw)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["timm-mobilenetv3_large_100", "timm-mobilenetv3_small_minimal_100", "timm-resnest14d"]
STRIDES = {32: [1, 2, 4, 8, 16, 32], 16: [1, 2, 4, 8, 16, 16], 8: [1, 2, 4, 8, 8, 8]}


@pytest.mark.parametrize("name", NAMES + ["timm-resnest50d_4s2x40d", "timm-resnest50d_1s4x24d"])
def test_eval_pyramid_matches(name):
    got = assert_encoder_eval_matches(name)
    assert [32 // f.shape[2] for f in got] == STRIDES[32]


@pytest.mark.parametrize("name", NAMES)
def test_train_pyramid_and_running_stats_match(name):
    assert_encoder_train_matches(name)


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("name", NAMES[:2])
def test_dilated_pyramid_matches(name, output_stride):
    got = assert_encoder_eval_matches(name, output_stride)
    assert [32 // f.shape[2] for f in got] == STRIDES[output_stride]


@pytest.mark.parametrize("k,stride,dilation", [(3, 2, 1), (5, 2, 1), (3, 1, 1), (5, 1, 1),
                                               (3, 1, 2), (5, 1, 4)])
@pytest.mark.parametrize("hw", [7, 8])
def test_same_padding_matches(k, stride, dilation, hw):
    rng = np.random.RandomState(k * 10 + stride + hw)
    x = rng.randn(2, hw, hw, 4).astype(np.float32)
    w = rng.randn(k, k, 1, 4).astype(np.float32)
    want = np.asarray(jmnv3._conv_same(jnp.asarray(x), jnp.asarray(w), stride=stride, groups=4,
                                       dilation=dilation))
    got = tmnv3._conv_same(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                           stride=stride, groups=4, dilation=dilation)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hard_activations_match():
    x = np.linspace(-5, 5, 101, dtype=np.float32)
    for jf, tf in ((jmnv3.hardswish, tmnv3.hardswish), (jmnv3.hardsigmoid, tmnv3.hardsigmoid)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(), np.asarray(jf(x)),
                                   rtol=1e-6, atol=1e-7)


def test_every_name_matches():
    for t, j in ((tmnv3.MNV3_ENCODERS, jmnv3.MNV3_ENCODERS),
                 (tresnest.RESNEST_ENCODERS, jresnest.RESNEST_ENCODERS)):
        assert list(t) == list(j)
        for name, entry in j.items():
            assert t[name]["kw"] == entry["kw"] and \
                t[name]["cls"].__name__ == entry["cls"].__name__, name


@pytest.mark.parametrize("output_stride", [16, 8])
def test_resnest_raises_senas_tpus_error(output_stride):
    assert_dilation_error_matches("timm-resnest14d", output_stride)


@pytest.mark.parametrize("depth", [1, 3])
def test_a_shallow_encoder_builds_what_senas_tpu_builds(depth):
    for name in NAMES:
        assert_encoder_eval_matches(name, depth=depth)
