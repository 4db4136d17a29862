"""The port's SE-Net, Xception and DPN encoders
(`senas_torch/models/encoders_families.py`) against senas_tpu's on the
CPU, from the same numpy-made weights (non-trivial BN running stats),
batch 2: the eval-mode pyramids at 32x32x3 of se_resnet50,
se_resnext50_32x4d, xception, dpn68 and dpn68b; their train-mode pyramids
at 64x64 with the running stats they leave; output stride 16 and 8 for
SE-Net and DPN; SENet's ceil-mode max pool and the count-excluding average
pool; one clipped SGD train step of a `Unet` on se_resnext50_32x4d; the
registry entries; Xception's dilated-mode error. The Inceptions of the
same module: tests/test_torch_encoders_inception.py; every name's pyramid
channels: tests/test_torch_encoder_registry.py.

Tolerances (f32 on both sides), the resnet test's: eval-mode maps within
2e-5 of their largest magnitude, train-mode maps within 2e-4, running
stats atol 2e-5 and rtol 1e-4; where the port's own f32 map or stat lies
far from an f64 run of the port, F32_SPREAD (5) times that distance
(`assert_pyramid_close`, `assert_stats_close`; a fault of the port moves
its f32 and f64 maps alike, so it stays within none of these bounds). The
SE-Nets need it in eval mode too: se_resnext50_32x4d's deepest map at
32x32 is 2.5e-5 off the port's f64 run in senas_tpu (the port's f32
1.5e-5).

The train step (dice_ce, SGD 6e-3 / 0.9 / 5e-4, clip 5; encoder depth 4,
decoder (64, 32, 16, 8), 32x32x1, every BN scale at 1 as in the zoo's
step test): the loss and the gradient norm rtol 1e-5, every weight and
running stat after it atol 2e-5 (tests/test_torch_zoo.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_torch import convert
from senas_torch.models import encoders as tenc
from senas_torch.models import encoders_families as tfam
from senas_torch.models import zoo as tzoo
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_train_step
from senas_tpu.models import encoders as jenc
from senas_tpu.models import encoders_families as jfam
from senas_tpu.models import zoo as jzoo
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train

from torch_port_util import (assert_dilation_error_matches, assert_encoder_eval_matches,
                             assert_encoder_train_matches, assert_trees_close, nchw,
                             random_variables, unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["se_resnet50", "se_resnext50_32x4d", "xception", "dpn68", "dpn68b"]
DILATABLE = ["se_resnext50_32x4d", "dpn68"]
STRIDES = {32: [1, 2, 4, 8, 16, 32], 16: [1, 2, 4, 8, 16, 16], 8: [1, 2, 4, 8, 8, 8]}
OPT = {"name": "sgd", "lr": 0.006, "weight_decay": 0.0005, "momentum": 0.9}


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_matches(name):
    got = assert_encoder_eval_matches(name)
    assert [32 // f.shape[2] for f in got] == STRIDES[32]


@pytest.mark.parametrize("name", NAMES)
def test_train_pyramid_and_running_stats_match(name):
    assert_encoder_train_matches(name)


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("name", DILATABLE)
def test_dilated_pyramid_matches(name, output_stride):
    got = assert_encoder_eval_matches(name, output_stride)
    assert [32 // f.shape[2] for f in got] == STRIDES[output_stride]


def test_senet_pool_pads_minus_infinity_at_the_end():
    """SENet's ceil_mode max pool: (0, 1) padding with -inf, at an odd and
    an even size, against senas_tpu's `_max_pool`."""
    rng = np.random.RandomState(3)
    for hw in (7, 8, 9):
        x = rng.randn(2, hw, hw, 3).astype(np.float32) - 5.0   # all below 0
        want = np.asarray(jfam._max_pool(jnp.asarray(x), 3, 2, (0, 1)))
        got = tfam._max_pool(nchw(x), 3, 2, (0, 1)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)


def test_average_pool_excludes_the_padding():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 5, 3).astype(np.float32)
    want = np.asarray(jfam._avg_pool_same(jnp.asarray(x), 3))
    got = tfam._avg_pool_same(nchw(x), 3).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_every_name_matches():
    assert list(tfam.FAMILY_ENCODERS) == list(jfam.FAMILY_ENCODERS)
    for name, entry in jfam.FAMILY_ENCODERS.items():
        assert tfam.FAMILY_ENCODERS[name]["kw"] == entry["kw"], name
        assert tfam.FAMILY_ENCODERS[name]["cls"].__name__ == entry["cls"].__name__, name


@pytest.mark.parametrize("output_stride", [16, 8])
def test_undilatable_families_raise_senas_tpus_error(output_stride):
    assert_dilation_error_matches("xception", output_stride)


@pytest.mark.parametrize("depth", [2, 4])
def test_a_shallow_encoder_builds_what_senas_tpu_builds(depth):
    for name in ("se_resnet50", "xception", "dpn68b"):
        assert_encoder_eval_matches(name, depth=depth)
        assert (tenc.encoder_out_channels(name, depth, 1)
                == jenc.encoder_out_channels(name, depth, 1))


def test_unet_train_step_on_se_resnext50_matches():
    kw = dict(classes=2, in_channels=1, encoder_name="se_resnext50_32x4d", encoder_depth=4,
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

    tm = convert.load_variables(tzoo.Unet(**kw, device="cpu"), variables)
    state = FixedTrainState.create(tm, OPT)
    m = make_train_step(tbuild_loss("dice_ce"), grad_clip=5.0)(
        state, {"image": torch.from_numpy(x), "label": torch.from_numpy(label)})
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm_["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm_["grad_norm"]), rtol=1e-5)
    got, jstate = convert.state_dict_to_variables(tm), jax.device_get(jstate)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=2e-5)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, rtol=0, atol=2e-5)
    assert state.step == 1
