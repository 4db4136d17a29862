"""The encoder families in bf16, part one: the port's VGG, DenseNet,
MobileNetV2, EfficientNet (and -Lite), MobileNetV3 and ResNeSt encoders
with dtype=torch.bfloat16 against senas_tpu's with dtype=jnp.bfloat16 on
the CPU, from the same f32 weights (numpy-made, through
senas_torch.convert) and batch of 2 at 32x32x3: each representative's
eval-mode pyramid, and for three of them the train-mode pyramid at 64x64
and the running stats it leaves (`torch_port_util.bf16_pyramids`); one
Unet train step on se_resnext50_32x4d in bf16 (dice_ce, SGD 6e-3 / 0.9 /
5e-4, clip 5; encoder depth 4, decoder (64, 32, 16, 8), 32x32x1, unit BN
scales). The SE-Net, Xception, Inception and DPN encoders' pyramids:
tests/test_torch_bf16_encoder_families.py.

Bounds (ROADMAP's bf16 rule, as tests/test_torch_bf16_zoo.py): each map
of the pyramid and the running stats lie at most twice as far (relative
L2) from senas_tpu's bf16 result as that lies from senas_tpu's f32
result, plus 1e-6; senas_tpu's encoders run jitted (within one program
XLA drops some bf16 roundings between ops, which the port keeps). Where
the two packages round differently by design: XLA's `reduce_window` sums
of the average pools and of flax's avg_pool add in bf16 op by op, where
PyTorch's CPU pools sum in f32 and round once; both round a swish's and a
hardswish's intermediate ops to bf16. The weights stay f32 and every map
but the input comes out bf16. The control: the deepest bf16 map fails 100
times the f32 parity tolerance (2e-5 of its largest magnitude) against
the port's f32 map, and the bf16 step's update fails it against the f32
step's. The step's weight update and running stats are held by the same
rule, its loss and grad norm within twice senas_tpu's own bf16 error of
the weight update, as tests/test_torch_bf16_zoo.py holds the zoo's
steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_torch import convert
from senas_torch.models import zoo as tzoo
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_train_step
from senas_tpu.models import zoo as jzoo
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train

from torch_port_util import (as_f64, assert_bf16_network, assert_bf16_pyramid, bf16_pyramids,
                             flat_leaves, random_variables, rel_l2, unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

BF = torch.bfloat16
OPT = {"name": "sgd", "lr": 0.006, "weight_decay": 0.0005, "momentum": 0.9}

NAMES = ["vgg11", "vgg11_bn", "densenet121", "mobilenet_v2", "efficientnet-b0",
         "timm-efficientnet-b0", "timm-tf_efficientnet_lite0", "timm-mobilenetv3_large_100",
         "timm-mobilenetv3_small_minimal_100", "timm-resnest14d"]
TRAIN_NAMES = ["efficientnet-b0", "timm-mobilenetv3_large_100", "timm-resnest14d"]


@pytest.mark.parametrize("name", NAMES)
def test_eval_pyramid_bf16(name):
    assert_bf16_pyramid(bf16_pyramids(name, train=False), stats=False)


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_train_pyramid_and_running_stats_bf16(name):
    assert_bf16_pyramid(bf16_pyramids(name, train=True, hw=64), stats=True)


def test_unet_train_step_on_se_resnext50_bf16():
    kw = dict(classes=2, in_channels=1, encoder_name="se_resnext50_32x4d", encoder_depth=4,
              decoder_channels=(64, 32, 16, 8))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    label = (rng.rand(2, 32, 32) > 0.6).astype(np.int32)
    variables = unit_scales(random_variables(jzoo.Unet(**kw), rng, jnp.asarray(x), False))
    batch = {"image": x, "label": label}
    before = flat_leaves(variables["params"])
    res = {}
    for key, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        tx = jbuild_optimizer(dict(OPT))
        step = jmake_train(jzoo.Unet(**kw, dtype=dt).apply, jbuild_loss("dice_ce"), tx,
                           grad_clip=5.0, donate=False)
        state, m = step(JState.create(variables, tx),
                        {k: jnp.asarray(v) for k, v in batch.items()})
        state = jax.device_get(state)
        res[f"jax_{key}"] = dict(loss=as_f64(m["loss"]), grad_norm=as_f64(m["grad_norm"]),
                                 update=flat_leaves(state.params) - before,
                                 stats=flat_leaves(state.batch_stats))
    for key, dt in (("bf16", BF), ("f32", None)):
        tm = convert.load_variables(tzoo.Unet(**kw, dtype=dt, device="cpu"), variables)
        state = FixedTrainState.create(tm, OPT)
        m = make_train_step(tbuild_loss("dice_ce"), grad_clip=5.0)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert all(p.dtype == torch.float32 for p in tm.parameters()) and state.step == 1
        got = convert.state_dict_to_variables(tm)
        res[f"port_{key}"] = dict(loss=as_f64(m["loss"]), grad_norm=as_f64(m["grad_norm"]),
                                  update=flat_leaves(got["params"]) - before,
                                  stats=flat_leaves(got["batch_stats"]))
    pb, jb, jf = res["port_bf16"], res["jax_bf16"], res["jax_f32"]
    _, own = assert_bf16_network(pb["update"], jb["update"], jf["update"], what="weight update")
    assert_bf16_network(pb["stats"], jb["stats"], jf["stats"], what="running stats")
    for k in ("loss", "grad_norm"):
        gap = rel_l2(pb[k], jb[k])
        assert gap <= 2 * own + 1e-6, (k, gap, own)
    assert rel_l2(pb["update"], res["port_f32"]["update"]) > 100 * 1e-5
