"""The encoder families in bf16, part two: the port's SE-Net, Xception,
InceptionV4, InceptionResNetV2 and DPN (and -b) encoders with
dtype=torch.bfloat16 against senas_tpu's with dtype=jnp.bfloat16 on the
CPU, from the same f32 weights and batch of 2 at 32x32x3: each
representative's eval-mode pyramid, dpn68's train-mode pyramid at 64x64
with the running stats it leaves (a Unet step on se_resnext50_32x4d in
bf16: tests/test_torch_bf16_encoders.py).

Bounds: ROADMAP's bf16 rule, as part one
(tests/test_torch_bf16_encoders.py) states it. The control: the deepest
bf16 map fails 100 times the f32 parity tolerance against the port's f32
map."""

import pytest

from torch_port_util import assert_bf16_pyramid, bf16_pyramids
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["se_resnet50", "se_resnext50_32x4d", "xception", "inceptionv4", "inceptionresnetv2",
         "dpn68", "dpn68b"]


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_bf16(name):
    assert_bf16_pyramid(bf16_pyramids(name, train=False), stats=False)


def test_train_pyramid_and_running_stats_bf16():
    assert_bf16_pyramid(bf16_pyramids("dpn68", train=True, hw=64), stats=True)
