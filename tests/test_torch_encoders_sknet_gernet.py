"""The port's SK-Net and GERNet encoders
(`senas_torch/models/encoders_timm2.py`) against senas_tpu's on the CPU,
from the same numpy-made weights (non-trivial BN running stats), batch 2:
the eval-mode pyramids at 32x32x3 of timm-skresnet18, timm-skresnext50_32x4d
and timm-gernet_s; the train-mode pyramids at 64x64 of timm-skresnet18 and
timm-gernet_s with the running stats they leave (SK-Net's attention
BatchNorm moves its `mean` and `var` by flax's 0.99 / biased-variance
rule); output stride 16 and 8 for both; timm-gernet_s at depth 1-4, where
the final 1x1 conv is built over the last built stage; the flax-rule
BatchNorm itself against `flax.linen.BatchNorm`; one clipped SGD train step
of a `Unet` on timm-skresnet18; timm-skresnet18 with SENAS_PALLAS_BN=1
against senas_tpu's gated encoder (64x64); every SK-Net and GERNet name's
pyramid channels against senas_tpu's forward. Res2Net and RegNet:
tests/test_torch_encoders_timm2.py.

Tolerances (f32 on both sides), the resnet test's: eval-mode maps within
2e-5 of their largest magnitude, train-mode maps within 2e-4, running
stats atol 2e-5 and rtol 1e-4; where the port's own f32 map or stat lies
far from an f64 run of the port, F32_SPREAD (5) times that distance
(`assert_pyramid_close`, `assert_stats_close`): SK-Net's attention
BatchNorm normalises a [B, attn, 1, 1] map, 2 values a channel at batch 2.
The flax-rule BatchNorm: f32 within rtol 1e-6 / atol 1e-6 (outputs and
running stats), bf16 by the module-level bound of tests/torch_port_util.py
(`assert_bf16_bits`: equal but on <= 1e-3 of the elements, by one ulp).
The train step (dice_ce, SGD 6e-3 / 0.9 / 5e-4, clip 5; encoder depth 4,
decoder (64, 32, 16, 8), 32x32x1, every norm scale at 1): the loss and
the gradient norm rtol 1e-5, every weight and running stat after it atol
2e-5 (tests/test_torch_zoo.py's), each widened to F32_SPREAD times the
port's own f32-vs-f64 distance where that is larger (the attention
BatchNorms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from senas_torch import convert
from senas_torch.models import encoders as tenc
from senas_torch.models import encoders_timm2 as ttimm2
from senas_torch.models import zoo as tzoo
from senas_torch.ops import primitives
from senas_torch.ops.primitives import BatchNorm
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_train_step
from senas_tpu.models import encoders as jenc
from senas_tpu.models import encoders_timm2 as jtimm2
from senas_tpu.models import zoo as jzoo
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train

from torch_port_util import (F32_SPREAD, assert_bf16_bits, assert_encoder_eval_matches,
                             assert_encoder_train_matches, assert_pyramid_close,
                             assert_stats_close, encoder_pair, nchw, nhwc,
                             port_f64, random_variables, unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["timm-skresnet18", "timm-skresnext50_32x4d", "timm-gernet_s"]
DILATABLE = ["timm-skresnet18", "timm-gernet_s"]
STRIDES = {32: [1, 2, 4, 8, 16, 32], 16: [1, 2, 4, 8, 16, 16], 8: [1, 2, 4, 8, 8, 8]}
OPT = {"name": "sgd", "lr": 0.006, "weight_decay": 0.0005, "momentum": 0.9}


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_matches(name):
    got = assert_encoder_eval_matches(name)
    assert [32 // f.shape[2] for f in got] == STRIDES[32]


@pytest.mark.parametrize("name", ["timm-skresnet18", "timm-gernet_s"])
def test_train_pyramid_and_running_stats_match(name):
    assert_encoder_train_matches(name)


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("name", DILATABLE)
def test_dilated_pyramid_matches(name, output_stride):
    got = assert_encoder_eval_matches(name, output_stride)
    assert [32 // f.shape[2] for f in got] == STRIDES[output_stride]


def test_dilated_sknet_sets_both_paths_to_the_stage_rate():
    """The reference's quirk: in a dilated stage both SK paths take the
    stage's dilation (4 at output stride 8's stage 5), at stride 1."""
    sk = tenc.get_encoder("timm-skresnet18", output_stride=8, in_channels=3).layer4_0.conv1
    assert (sk.path0.dilation, sk.path1.dilation) == (4, 4)
    assert sk.path0.stride == sk.path1.stride == 1
    sk = tenc.get_encoder("timm-skresnet18", in_channels=3).layer4_0.conv1
    assert (sk.path0.dilation, sk.path1.dilation, sk.path0.stride) == (1, 2, 2)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_a_shallow_gernet_builds_what_senas_tpu_builds(depth):
    """The final 1x1 conv over the last built stage, whose output the
    pyramid drops below depth 5: the same variables (`load_variables` is
    strict) and maps as senas_tpu's."""
    assert_encoder_eval_matches("timm-gernet_s", depth=depth)
    assert (tenc.encoder_out_channels("timm-gernet_s", depth, 1)
            == jenc.encoder_out_channels("timm-gernet_s", depth, 1))


def _flax_bn_case(shape, seed):
    """(x NHWC, flax variables of a BatchNorm over its last axis)."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * rng.uniform(0.5, 2.0, c) + rng.randn(c)).astype(np.float32)
    variables = {"params": {"scale": rng.uniform(0.7, 1.3, c).astype(np.float32),
                            "bias": (0.2 * rng.randn(c)).astype(np.float32)},
                 "batch_stats": {"mean": (0.2 * rng.randn(c)).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    return x, variables


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(2, 1, 1, 16), (3, 5, 4, 8)])
def test_flax_rule_batch_norm_matches_flax(shape, train):
    """`FlaxBatchNorm` against flax.linen.BatchNorm (unjitted) in f32 and
    bf16: the output, and in train mode the running stats it leaves
    (momentum 0.99, the biased one-sweep variance)."""
    x, variables = _flax_bn_case(shape, seed=sum(shape) + train)
    f32_stats = None
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x) if jdt is None else jnp.asarray(x).astype(jdt)
        want, mutated = nn.BatchNorm(use_running_average=not train, dtype=jdt).apply(
            variables, xj, mutable=["batch_stats"])
        bn = convert.load_variables(ttimm2.FlaxBatchNorm(shape[-1], dtype=tdt), variables)
        xt = nchw(x) if tdt is None else nchw(x).to(tdt)
        with torch.no_grad():
            got = bn(xt, train=train)
        assert got.dtype == (tdt or torch.float32)
        if tdt is None:
            np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)
        else:
            assert_bf16_bits(got.float(), nchw(np.array(want.astype(jnp.float32))),
                             what=str(shape))
        stats = convert.state_dict_to_variables(bn)["batch_stats"]
        want_stats = jax.device_get(mutated["batch_stats"]) if train else \
            variables["batch_stats"]
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[k], np.asarray(want_stats[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        f32_stats = f32_stats or stats
    if train:    # the rule itself: 0.99 / 0.01 and the biased variance
        b = x.reshape(-1, shape[-1]).astype(np.float64)
        np.testing.assert_allclose(
            f32_stats["var"], 0.99 * variables["batch_stats"]["var"] + 0.01 * b.var(0),
            rtol=1e-5)


def test_flax_rule_batch_norm_is_not_the_packages():
    """SK-Net's attention BatchNorm is no `primitives.BatchNorm`, so the
    SENAS_PALLAS_BN gate does not reach it; every other norm of the
    encoder is one."""
    enc = tenc.get_encoder("timm-skresnet18", in_channels=3)
    flax_rule = [m for m in enc.modules() if isinstance(m, ttimm2.FlaxBatchNorm)]
    assert len(flax_rule) == 8 and not any(isinstance(m, BatchNorm) for m in flax_rule)
    assert all(m.momentum == 0.99 for m in flax_rule)


def test_unet_train_step_on_skresnet18_matches():
    """The attention BatchNorms over 2 values a channel leave the step
    ill-conditioned in f32 (the port's own f32 loss 2.1e-5 and grad norm
    1.6e-4 off its f64 step), so each number may also lie F32_SPREAD times
    the port's own f32-vs-f64 distance away."""
    kw = dict(classes=2, in_channels=1, encoder_name="timm-skresnet18", encoder_depth=4,
              decoder_channels=(64, 32, 16, 8))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    label = (rng.rand(2, 32, 32) > 0.6).astype(np.int32)
    jm = jzoo.Unet(**kw)
    variables = unit_scales(random_variables(jm, rng, jnp.asarray(x), False))
    tx = jbuild_optimizer(dict(OPT))
    jstep = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=5.0, donate=False)
    jstate, jm_ = jstep(JState.create(variables, tx),
                        {"image": jnp.asarray(x), "label": jnp.asarray(label)})
    jstate = jax.device_get(jstate)

    runs = {}
    for dt in (torch.float32, torch.float64):
        tm = convert.load_variables(tzoo.Unet(**kw, device="cpu"), variables).to(dt)
        state = FixedTrainState.create(tm, OPT)
        m = make_train_step(tbuild_loss("dice_ce"), grad_clip=5.0)(
            state, {"image": torch.from_numpy(x).to(dt), "label": torch.from_numpy(label)})
        runs[dt] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                    convert.state_dict_to_variables(tm), state.step)
    (m, got, step), (m64, exact, _) = runs[torch.float32], runs[torch.float64]
    for k in ("loss", "grad_norm"):
        own = abs(m[k] - m64[k]) / abs(m64[k])
        assert abs(m[k] - float(jm_[k])) / abs(float(jm_[k])) <= max(1e-5, F32_SPREAD * own), k
    for coll in ("params", "batch_stats"):
        assert_stats_close(got[coll], getattr(jstate, coll), exact[coll], rtol=0, atol=2e-5,
                           what=coll)
    assert step == 1


def test_gated_skresnet18_matches_senas_tpus(monkeypatch):
    """timm-skresnet18 in train mode with SENAS_PALLAS_BN=1 in both
    packages (senas_tpu's Pallas kernels in interpret mode, the port's
    through K1a-K1d's plain twins), batch 2 of 64x64x3: the pyramid and
    the running stats (the train test's bounds); the port's gated path
    runs once a package BatchNorm and never for the attention's."""
    monkeypatch.setenv("SENAS_PALLAS_BN", "1")
    calls = []
    real = primitives.fused_group_epilogue

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(primitives, "fused_group_epilogue", spy)
    x, jm, variables, tm = encoder_pair("timm-skresnet18", seed=2, hw=64)
    want, mutated = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        variables, x)
    exact, twin = port_f64(tm, x, True)
    del calls[:]
    got = tm(nchw(x), train=True)
    assert len(calls) == sum(isinstance(m, BatchNorm) for m in tm.modules())
    assert_pyramid_close(got, want, 2e-4, exact, what="gated skresnet18")
    assert_stats_close(convert.state_dict_to_variables(tm)["batch_stats"],
                       jax.device_get(mutated["batch_stats"]),
                       convert.state_dict_to_variables(twin)["batch_stats"],
                       rtol=1e-4, atol=2e-5, what="gated skresnet18")


@pytest.mark.parametrize("name", sorted({**jtimm2.SKNET_ENCODERS, **jtimm2.GERNET_ENCODERS}))
def test_encoder_out_channels_match(name):
    """Every SK-Net and GERNet name's pyramid channels: the port's meta-device
    forward against senas_tpu's `jax.eval_shape` of its forward."""
    assert tenc.encoder_out_channels(name) == jenc.encoder_out_channels(name)
