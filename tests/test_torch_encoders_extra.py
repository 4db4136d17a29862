"""The port's VGG, DenseNet, MobileNetV2 and EfficientNet encoders
(`senas_torch/models/encoders_extra.py`) against senas_tpu's on the CPU,
from the same numpy-made weights (non-trivial BN running stats), batch 2:
the eval-mode pyramids at 32x32x3 of vgg11, vgg11_bn, densenet121,
mobilenet_v2, efficientnet-b0, timm-efficientnet-b0 and
timm-tf_efficientnet_lite0; their train-mode pyramids at 64x64 with the
running stats they leave; output stride 16 and 8 for the two dilatable
classes; the pyramid channels of every name of the module; the dilated
mode's error of VGG and DenseNet.

Tolerances (f32 on both sides), the resnet test's: eval-mode maps within
2e-5 of their largest magnitude, train-mode maps within 2e-4, running
stats atol 2e-5 and rtol 1e-4. Where the port's own f32 map or stat lies
far from an f64 run of the port, F32_SPREAD (5) times that distance
(`assert_pyramid_close`, `assert_stats_close`): train-mode BatchNorm over
the few values of the deep maps of batch 2 amplifies f32 rounding along
the stack (mobilenet_v2's deepest map at 64x64: senas_tpu 1.7e-4 off the
port's f64 run, the port's f32 1.0e-4). A fault of the port moves its f32
and f64 maps alike, so it stays within none of these bounds."""

import pytest

from senas_torch.models import encoders as tenc
from senas_torch.models import encoders_extra as textra
from senas_tpu.models import encoders as jenc
from senas_tpu.models import encoders_extra as jextra

from torch_port_util import (assert_dilation_error_matches, assert_encoder_eval_matches,
                             assert_encoder_train_matches)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["vgg11", "vgg11_bn", "densenet121", "mobilenet_v2", "efficientnet-b0",
         "timm-efficientnet-b0", "timm-tf_efficientnet_lite0"]
DILATABLE = ["mobilenet_v2", "efficientnet-b0"]
STRIDES = {32: [1, 2, 4, 8, 16, 32], 16: [1, 2, 4, 8, 16, 16], 8: [1, 2, 4, 8, 8, 8]}


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_matches(name):
    got = assert_encoder_eval_matches(name)
    sizes = [f.shape[2] for f in got]
    if name.startswith("vgg"):    # the first map is the first block's, at stride 1
        assert sizes == [32, 16, 8, 4, 2, 1]
    else:
        assert [32 // s for s in sizes] == STRIDES[32]


@pytest.mark.parametrize("name", NAMES)
def test_train_pyramid_and_running_stats_match(name):
    assert_encoder_train_matches(name)


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("name", DILATABLE)
def test_dilated_pyramid_matches(name, output_stride):
    got = assert_encoder_eval_matches(name, output_stride)
    assert [32 // f.shape[2] for f in got] == STRIDES[output_stride]


@pytest.mark.parametrize("name", sorted(jextra.EXTRA_ENCODERS))
def test_encoder_out_channels_match(name):
    assert tenc.encoder_out_channels(name) == jenc.encoder_out_channels(name)


def test_every_name_and_the_gate_match():
    assert list(textra.EXTRA_ENCODERS) == list(jextra.EXTRA_ENCODERS)
    assert textra.GATED_FAMILIES == jextra.GATED_FAMILIES
    for name, entry in jextra.EXTRA_ENCODERS.items():
        assert textra.EXTRA_ENCODERS[name]["kw"] == entry["kw"], name
        assert textra.EXTRA_ENCODERS[name]["cls"].__name__ == entry["cls"].__name__, name


@pytest.mark.parametrize("name", ["vgg13_bn", "densenet121"])
@pytest.mark.parametrize("output_stride", [16, 8])
def test_undilatable_families_raise_senas_tpus_error(name, output_stride):
    assert_dilation_error_matches(name, output_stride)


@pytest.mark.parametrize("depth", [2, 4])
def test_a_shallow_encoder_builds_what_senas_tpu_builds(depth):
    """The variables of a cut encoder are senas_tpu's leaf for leaf (the
    load is strict), and its pyramid matches."""
    for name in ("vgg11_bn", "densenet121", "mobilenet_v2", "efficientnet-b0"):
        assert_encoder_eval_matches(name, depth=depth)
        assert (tenc.encoder_out_channels(name, depth, 1)
                == jenc.encoder_out_channels(name, depth, 1))
