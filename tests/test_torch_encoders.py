"""The port's resnet-family encoders against senas_tpu's on the CPU: the
feature pyramids of resnet10/18/34/50 and resnext50_32x4d at output stride
32, 16 and 8 (smp's make_dilated) from the same numpy-made weights, batch 2
of 32x32x3, in eval mode, and in train mode (64x64, with the running stats
they leave) for resnet10 and resnext50_32x4d at stride 16; `dilate_last`
(senas_tpu's alias of output stride 16, the fourth parameter of
`get_encoder`), by position and by keyword, on a resnet and on a dilatable
family, and the error of an undilatable one;
`encoder_out_channels` and `stage_dilation` against senas_tpu's, and the
error of each name the port does not build (the other families:
tests/test_torch_encoders_{extra,families,mnv3_resnest}.py,
tests/test_torch_encoder_registry.py).

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

from torch_port_util import (assert_pyramid_close, assert_trees_close, nchw, nhwc, port_f64,
                             random_variables)
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
    assert tenc.get_encoder_names()[:len(jenc._ENCODERS)] == list(jenc._ENCODERS)


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
    """No name of senas_tpu is left unbuilt (its timm residual variants
    named ROADMAP's M15c before this slice): every name, and a tu- alias of
    one, builds the class senas_tpu builds."""
    others = [n for n in jenc.get_encoder_names() if n not in tenc.get_encoder_names()]
    assert others == []
    for name in ("timm-res2net50_26w_4s", "tu-res2net50_26w_4s"):
        assert type(tenc.get_encoder(name)).__name__ == type(jenc.get_encoder(name)).__name__


def test_output_stride_16_dilates_the_last_stage_only():
    enc = tenc.get_encoder("resnet10", output_stride=16, in_channels=1)
    assert enc.layer4_0.dilation == 2 and enc.layer4_0.stride == 1
    assert enc.layer3_0.dilation == 1 and enc.layer3_0.stride == 2


# dilate_last=True, by position (the fourth parameter, as in senas_tpu) and
# by keyword
DILATE_LAST_CALLS = {"positional": lambda mod, name: mod.get_encoder(name, 5, None, True),
                     "keyword": lambda mod, name: mod.get_encoder(name, dilate_last=True)}


@pytest.mark.parametrize("call", sorted(DILATE_LAST_CALLS))
@pytest.mark.parametrize("name", ["resnet10", "mobilenet_v2"])
def test_dilate_last_pyramid_matches(name, call):
    """The eval pyramid of `dilate_last=True` against senas_tpu's, from the
    same weights: output stride 16 on a resnet and on a dilatable family."""
    build = DILATE_LAST_CALLS[call]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = build(jenc, name)
    variables = random_variables(jm, rng, jnp.asarray(x), False)
    tm = build(tenc, name)
    init_params_(tm, torch.Generator().manual_seed(0))
    convert.load_variables(tm, variables)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)
    with torch.no_grad():
        got = tm(nchw(x), train=False)
    assert_pyramid_close(got, want, REL, port_f64(tm, x, False)[0], what=name)
    assert [32 // f.shape[2] for f in got[1:]] == [2, 4, 8, 16, 16]


@pytest.mark.parametrize("name", ["resnet10", "mobilenet_v2"])
def test_dilate_last_by_position_and_keyword_builds_one_module(name):
    """Both calls build output stride 16's module: the same parameters, and
    from the same weights the same pyramid, bit for bit."""
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 32, 32).astype(np.float32))
    built = [DILATE_LAST_CALLS[c](tenc, name) for c in sorted(DILATE_LAST_CALLS)]
    built.append(tenc.get_encoder(name, output_stride=16))
    init_params_(built[0], torch.Generator().manual_seed(1))
    shapes = {k: v.shape for k, v in built[0].state_dict().items()}
    outs = []
    for m in built:
        assert {k: v.shape for k, v in m.state_dict().items()} == shapes
        m.load_state_dict(built[0].state_dict())
        with torch.no_grad():
            outs.append(m(x, train=False))
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.mark.parametrize("call", sorted(DILATE_LAST_CALLS))
def test_dilate_last_on_an_undilatable_family_raises_senas_tpus_error(call):
    build = DILATE_LAST_CALLS[call]
    with pytest.raises(ValueError) as want:
        build(jenc, "densenet121")
    with pytest.raises(ValueError) as got:
        build(tenc, "densenet121")
    assert str(got.value) == str(want.value) and "dilated mode" in str(got.value)


def test_resnet_encoder_takes_dilate_last():
    """ResNetEncoder's own keyword, as senas_tpu's field: stride 16, and
    no change to an explicit output stride 8."""
    enc = tenc.ResNetEncoder(3, (1, 1, 1, 1), dilate_last=True)
    assert enc.layer4_0.dilation == 2 and enc.layer4_0.stride == 1
    assert enc.layer3_0.dilation == 1 and enc.layer3_0.stride == 2
    enc = tenc.ResNetEncoder(3, (1, 1, 1, 1), dilate_last=True, output_stride=8)
    assert enc.layer3_0.dilation == 2 and enc.layer4_0.dilation == 4
