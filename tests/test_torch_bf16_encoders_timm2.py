"""The timm residual variants in bf16: the port's Res2Net, RegNet, SK-Net
and GERNet encoders with dtype=torch.bfloat16 against senas_tpu's with
dtype=jnp.bfloat16 on the CPU, from the same f32 weights and batch of 2:
one representative of each class's eval-mode pyramid at 32x32x3, and
timm-skresnet18's train-mode pyramid at 64x64 with the running stats it
leaves (its attention BatchNorm's flax rule, rounded once to bf16).

Bounds: ROADMAP's bf16 rule, as tests/test_torch_bf16_encoders.py states
it: each map (and the running stats) at most twice as far from
senas_tpu's bf16 result as that lies from senas_tpu's f32 one, plus 1e-6
(relative L2). The control: the deepest bf16 map fails 100 times the f32
parity tolerance against the port's f32 map."""

import pytest

from torch_port_util import assert_bf16_pyramid, bf16_pyramids
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["timm-res2net50_26w_4s", "timm-regnety_016", "timm-skresnet18", "timm-gernet_s"]


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_bf16(name):
    assert_bf16_pyramid(bf16_pyramids(name, train=False), stats=False)


def test_train_pyramid_and_running_stats_bf16():
    assert_bf16_pyramid(bf16_pyramids("timm-skresnet18", train=True, hw=64), stats=True)
