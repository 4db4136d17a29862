"""The port's resnet-family encoders against senas_tpu's on the CPU: the
feature pyramids of resnet10/18/34/50 and resnext50_32x4d at output stride
32, 16 and 8 (smp's make_dilated) from the same numpy-made weights, batch 2
of 32x32x3, in eval mode, and in train mode (64x64, with the running stats
they leave) for resnet10 and resnext50_32x4d at stride 16;
`encoder_out_channels` and `stage_dilation` against senas_tpu's, and the
error of each name the port does not build.

Tolerances (f32 on both sides): eval-mode maps within 2e-5 of their largest
magnitude; train-mode maps within 2e-4, since train-mode BN over few values
amplifies f32 rounding along the stack: resnext50's deepest map, after 16
Bottlenecks at batch 2, is 8.0e-5 (senas_tpu) and 6.0e-5 (the port) off an
f64 run of the port; the running stats they leave atol 2e-5 and rtol 1e-4
(resnext50's layer4 variances, ~1.5, differ by up to 2.6e-5 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import encoders as jenc
from senas_torch import convert
from senas_torch.models import encoders as tenc
from senas_torch.ops.primitives import init_params_

from torch_port_util import assert_trees_close, nchw, nhwc, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

REL = 2e-5
TRAIN_REL = 2e-4
NAMES = ["resnet10", "resnet18", "resnet34", "resnet50", "resnext50_32x4d"]


def _pair(name, output_stride, seed=0, depth=5, hw=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, hw, hw, 3).astype(np.float32)
    jm = jenc.get_encoder(name, depth=depth, output_stride=output_stride)
    variables = random_variables(jm, rng, jnp.asarray(x), False)
    tm = tenc.get_encoder(name, depth=depth, output_stride=output_stride, in_channels=3)
    init_params_(tm, torch.Generator().manual_seed(0))
    convert.load_variables(tm, variables)
    return x, jm, variables, tm


def _close(got, want, rel=REL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("output_stride", [32, 16, 8])
@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_matches(name, output_stride):
    x, jm, variables, tm = _pair(name, output_stride)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)
    with torch.no_grad():
        got = tm(nchw(x), train=False)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _close(nhwc(g), np.asarray(w))
    strides = [32 // f.shape[2] for f in got[1:]]
    assert strides == {32: [2, 4, 8, 16, 32], 16: [2, 4, 8, 16, 16],
                       8: [2, 4, 8, 8, 8]}[output_stride]


@pytest.mark.parametrize("name", ["resnet10", "resnext50_32x4d"])
def test_train_pyramid_and_running_stats_match(name):
    x, jm, variables, tm = _pair(name, 16, seed=1, hw=64)
    want, mutated = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        variables, x)
    with torch.no_grad():
        got = tm(nchw(x), train=True)
    for g, w in zip(got, want):
        _close(nhwc(g), np.asarray(w), TRAIN_REL)
    assert_trees_close(convert.state_dict_to_variables(tm)["batch_stats"],
                       jax.device_get(mutated["batch_stats"]), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("name", sorted(tenc._ENCODERS))
def test_encoder_out_channels_match(name):
    for depth, in_ch in ((5, 3), (3, 1), (4, 2)):
        assert (tenc.encoder_out_channels(name, depth, in_ch)
                == jenc.encoder_out_channels(name, depth, in_ch))
    assert tenc.get_encoder_names() == list(jenc._ENCODERS)


def test_stage_dilation_matches():
    for os_ in (8, 16, 32):
        assert [tenc.stage_dilation(s, os_) for s in range(1, 6)] == \
               [jenc.stage_dilation(s, os_) for s in range(1, 6)]
    for mod in (tenc, jenc):
        with pytest.raises(ValueError, match="16 or 8, got 4"):
            mod.stage_dilation(5, 4)


def test_errors_match_senas_tpu():
    def message(fn, *args, **kw):
        with pytest.raises(Exception) as info:
            fn(*args, **kw)
        return type(info.value), str(info.value)

    assert message(tenc.get_encoder, "resnet34", weights="imagenet") == \
        message(jenc.get_encoder, "resnet34", weights="imagenet")
    assert message(tenc.get_encoder, "resnet34", output_stride=4) == \
        message(jenc.get_encoder, "resnet34", output_stride=4)
    with pytest.raises(KeyError, match="unknown encoder 'resnet7'"):
        tenc.get_encoder("resnet7")
    with pytest.raises(KeyError):
        jenc.get_encoder("resnet7")


def test_every_other_family_of_senas_tpu_names_the_next_slice():
    others = [n for n in jenc.get_encoder_names() if n not in tenc._ENCODERS]
    assert len(others) > 90
    for name in others + ["tu-resnet34"]:
        with pytest.raises(NotImplementedError, match="M15b"):
            tenc.get_encoder(name)
        with pytest.raises(NotImplementedError, match="M15b"):
            tenc.encoder_out_channels(name)


def test_output_stride_16_dilates_the_last_stage_only():
    enc = tenc.get_encoder("resnet10", output_stride=16, in_channels=1)
    assert enc.layer4_0.dilation == 2 and enc.layer4_0.stride == 1
    assert enc.layer3_0.dilation == 1 and enc.layer3_0.stride == 2
