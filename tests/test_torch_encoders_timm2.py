"""The port's Res2Net and RegNet encoders
(`senas_torch/models/encoders_timm2.py`) against senas_tpu's on the CPU,
from the same numpy-made weights (non-trivial BN running stats), batch 2:
the eval-mode pyramids at 32x32x3 of timm-res2net50_26w_4s, _48w_2s (two
splits), _14w_8s (eight), timm-res2next50 (grouped 3x3s), timm-regnetx_002
and timm-regnety_002 (the squeeze-excite); the train-mode pyramids at
64x64 with the running stats they leave; output stride 16 and 8 for
RegNet and Res2Net's dilated-mode error; Res2Net's padding-counting pool;
`regnet_stage_widths` and the registry entries of all 37 names; a shallow
RegNet; every Res2Net and RegNet name's pyramid channels against
senas_tpu's forward. SK-Net and GERNet: tests/test_torch_encoders_sknet_gernet.py; in
bf16: tests/test_torch_bf16_encoders_timm2.py.

Tolerances (f32 on both sides), the resnet test's: eval-mode maps within
2e-5 of their largest magnitude, train-mode maps within 2e-4, running
stats atol 2e-5 and rtol 1e-4; where the port's own f32 map or stat lies
far from an f64 run of the port, F32_SPREAD (5) times that distance
(`assert_pyramid_close`, `assert_stats_close`). The big names
(res2net101, regnety_320, ...) are held by their tables, classes and
pyramid channels only (here and in tests/test_torch_encoder_registry.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from senas_torch.models import encoders as tenc
from senas_torch.models import encoders_timm2 as ttimm2
from senas_tpu.models import encoders as jenc
from senas_tpu.models import encoders_timm2 as jtimm2

from torch_port_util import (assert_dilation_error_matches, assert_encoder_eval_matches,
                             assert_encoder_train_matches, nchw)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["timm-res2net50_26w_4s", "timm-res2net50_48w_2s", "timm-res2net50_14w_8s",
         "timm-res2next50", "timm-regnetx_002", "timm-regnety_002"]
STRIDES = {32: [1, 2, 4, 8, 16, 32], 16: [1, 2, 4, 8, 16, 16], 8: [1, 2, 4, 8, 8, 8]}


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_matches(name):
    got = assert_encoder_eval_matches(name)
    assert [32 // f.shape[2] for f in got] == STRIDES[32]


@pytest.mark.parametrize("name", ["timm-res2net50_26w_4s", "timm-regnety_002"])
def test_train_pyramid_and_running_stats_match(name):
    assert_encoder_train_matches(name)


@pytest.mark.parametrize("output_stride", [16, 8])
def test_dilated_regnet_matches(output_stride):
    got = assert_encoder_eval_matches("timm-regnetx_002", output_stride)
    assert [32 // f.shape[2] for f in got] == STRIDES[output_stride]


@pytest.mark.parametrize("output_stride", [16, 8])
def test_res2net_raises_senas_tpus_dilation_error(output_stride):
    assert_dilation_error_matches("timm-res2net50_26w_4s", output_stride)


def test_res2net_pool_counts_the_padding():
    """The last split's pool divides by 9 at the borders too, as
    senas_tpu's `_avg_pool_incl`, at stride 1 and 2 on an odd map."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 5, 3).astype(np.float32) + 2.0
    for stride in (1, 2):
        want = np.asarray(jtimm2._avg_pool_incl(jnp.asarray(x), 3, stride, 1))
        got = ttimm2._avg_pool_incl(nchw(x), 3, stride, 1).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert abs(got[0, 0, 0, 0] - x[0, :2, :2, 0].sum() / 9) < 1e-6


@pytest.mark.parametrize("name", list(jtimm2.REGNET_ENCODERS))
def test_regnet_stage_widths_match(name):
    kw = jtimm2.REGNET_ENCODERS[name]["kw"]
    args = (kw["w0"], kw["wa"], kw["wm"], kw["net_depth"], kw["group_w"])
    assert ttimm2.regnet_stage_widths(*args) == jtimm2.regnet_stage_widths(*args)


def test_every_name_matches():
    assert list(ttimm2.TIMM2_ENCODERS) == list(jtimm2.TIMM2_ENCODERS)
    assert len(ttimm2.TIMM2_ENCODERS) == 37
    for name, entry in jtimm2.TIMM2_ENCODERS.items():
        assert ttimm2.TIMM2_ENCODERS[name]["kw"] == entry["kw"], name
        assert ttimm2.TIMM2_ENCODERS[name]["cls"].__name__ == entry["cls"].__name__, name


@pytest.mark.parametrize("depth", [1, 3])
def test_a_shallow_regnet_builds_what_senas_tpu_builds(depth):
    assert_encoder_eval_matches("timm-regnety_002", depth=depth)
    assert (tenc.encoder_out_channels("timm-regnety_002", depth, 1)
            == jenc.encoder_out_channels("timm-regnety_002", depth, 1))


@pytest.mark.parametrize("name", sorted({**jtimm2.RES2NET_ENCODERS, **jtimm2.REGNET_ENCODERS}))
def test_encoder_out_channels_match(name):
    """Every Res2Net and RegNet name's pyramid channels: the port's meta-device
    forward against senas_tpu's `jax.eval_shape` of its forward."""
    assert tenc.encoder_out_channels(name) == jenc.encoder_out_channels(name)
