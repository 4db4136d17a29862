"""The port's InceptionV4 and InceptionResNetV2 encoders
(`senas_torch/models/encoders_families.py`) against senas_tpu's on the
CPU, from the same numpy-made weights (non-trivial BN running stats),
batch 2: the eval-mode pyramids at 32x32x3; the train-mode pyramids
(inceptionresnetv2 at 64x64, inceptionv4 at 128x128) with the running
stats they leave; pyramids of encoders cut to depth 2 and 4 (their
'corrected' paddings halve the maps at every stage); the dilated mode's
error of both.

Tolerances (f32 on both sides), as tests/test_torch_encoders_families.py
states them. InceptionV4's train-mode check runs at 128x128: at 64x64 its
deepest map (2x2, 8 values a channel for each BatchNorm) is 0.47 of its
magnitude off the f64 run in senas_tpu and 0.12 in the port, so no f32
comparison means anything there; at 128x128 5e-3 and 3e-3."""

import pytest

from senas_tpu.models import encoders as jenc
from senas_torch.models import encoders as tenc

from torch_port_util import (assert_dilation_error_matches, assert_encoder_eval_matches,
                             assert_encoder_train_matches)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["inceptionv4", "inceptionresnetv2"]
TRAIN_HW = {"inceptionv4": 128, "inceptionresnetv2": 64}


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_matches(name):
    got = assert_encoder_eval_matches(name)
    assert [32 // f.shape[2] for f in got] == [1, 2, 4, 8, 16, 32]


@pytest.mark.parametrize("name", NAMES)
def test_train_pyramid_and_running_stats_match(name):
    assert_encoder_train_matches(name, hw=TRAIN_HW[name])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("output_stride", [16, 8])
def test_undilatable_families_raise_senas_tpus_error(name, output_stride):
    assert_dilation_error_matches(name, output_stride)


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_a_shallow_encoder_builds_what_senas_tpu_builds(name, depth):
    got = assert_encoder_eval_matches(name, depth=depth)
    assert [32 // f.shape[2] for f in got] == [1, 2, 4, 8, 16][:depth + 1]
    assert tenc.encoder_out_channels(name, depth, 1) == jenc.encoder_out_channels(name, depth, 1)
