"""The port's baseline zoo against senas_tpu's on the CPU: the factory's
nine models at tests/test_zoo.py's sizes (pspnet at depth 3 on 64x64, where
its 8x8 map takes the antialiased 8->3 and 8->6 pooling, and at depth 5),
from the same numpy-made weights (with non-trivial BN running stats) and
batch of 2, through senas_torch.convert.

Checked per model: the eval-mode logits; the train-mode logits and the BN
running stats they leave; one fixed train step through both packages'
steps (dice_ce, SGD 6e-3 / 0.9 / 5e-4, clip 5: the promise12 `training:`
optimizer): the loss, every weight and every running stat after it.
DeepLabV3+'s ASPP draws a Dropout(0.5) mask in train mode, from
another generator in each package, so those checks patch the dropout to
the identity on both sides (inside the test); the port's dropout is
tested on its own (keep fraction, scale, the same mask under the same
generator).

The train step starts from the same weights with every BN and GroupNorm
scale at 1 (their init value): with the random scales of the forward
checks (U(0.7, 1.3)) the gradient of these small models is ill-conditioned
in f32 (unet at depth 4, 64x64: the port's f32 gradient is 2.9% off its
f64 one on single leaves, senas_tpu's 4.5%; with unit scales 3.6e-6), so
no f32 step could be held to either package there.

Tolerances (f32 on both sides; they differ in summation order): logits
within 2e-5 of the largest |logit| (worst seen on an x86 CPU: 6e-6), the
step's loss rtol 1e-5, weights and running stats after it atol 2e-5, the
gradient norm rtol 1e-5 but for PAN (2e-3) and DeepLabV3+ (1e-4), whose
global-pool branches batch-normalise 2 values per channel at batch 2: the
port's f32 norm is 1.4e-4 (pan) and 4e-6 (deeplab) off its f64 one,
senas_tpu's 8.8e-4 and 2.7e-5 off the port's.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import base as jbase
from senas_tpu.models import nasunet as jnasunet
from senas_tpu.models import zoo as jzoo
from senas_tpu.models.factory import get_segmentation_model as jget
from senas_tpu.models.preprocessing import (get_preprocessing_params as j_prep_params,
                                            preprocess_input as j_preprocess)
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch import convert
from senas_torch.models import base as tbase
from senas_torch.models import nasunet as tnasunet
from senas_torch.models import zoo as tzoo
from senas_torch.models.factory import ZOO as FACTORY_ZOO
from senas_torch.models.factory import get_segmentation_model as tget
from senas_torch.models.preprocessing import (get_preprocessing_params as t_prep_params,
                                              preprocess_input as t_preprocess)
from senas_torch.ops import primitives
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_train_step

from torch_port_util import NoDropout, assert_trees_close, random_variables, unit_scales
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

LOGIT_REL = 2e-5
STEP_RTOL = 1e-5
GRAD_NORM_RTOL = {"pan": 2e-3, "deeplab_v3_plus": 1e-4}
STATE_ATOL = 2e-5
B = 2
OPT = {"name": "sgd", "lr": 0.006, "weight_decay": 0.0005, "momentum": 0.9}

# (name, depth, input side): tests/test_zoo.py's sizes, pspnet at depth 3
ZOO = [
    ("unet", 4, 64),
    ("unet_plus_plus", 4, 32),
    ("manet", 4, 32),
    ("linknet", 4, 32),
    ("fpn", 5, 64),
    ("pspnet", 3, 64),
    ("pan", 5, 128),
    ("deeplab_v3_plus", 5, 64),
    ("nasunet", 4, 32),
]


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout as the identity in both packages, for this test only."""
    monkeypatch.setattr(fnn, "Dropout", NoDropout)
    monkeypatch.setattr(primitives.Dropout, "forward", lambda self, x, train=False, rng=None: x)


@pytest.fixture(scope="module", params=ZOO, ids=[z[0] for z in ZOO])
def pair(request):
    name, depth, hw = request.param
    rng = np.random.RandomState(0)
    x = rng.randn(B, hw, hw, 1).astype(np.float32)
    jm = jget(name, dataset="promise12", depth=depth)
    variables = random_variables(jm, rng, jnp.asarray(x), False)
    label = (rng.rand(B, hw, hw) > 0.6).astype(np.int32)
    return dict(name=name, depth=depth, x=x, label=label, jm=jm, variables=variables)


def _port(pair, variables=None):
    return convert.load_variables(tget(pair["name"], dataset="promise12", depth=pair["depth"],
                                       device="cpu"), variables or pair["variables"])



def _close_logits(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_REL, err


def test_eval_logits_match(pair):
    want = np.asarray(jax.jit(lambda v, x: pair["jm"].apply(v, x, False)[0])(
        pair["variables"], pair["x"]))
    tm = _port(pair)
    with torch.no_grad():
        out = tm(torch.from_numpy(pair["x"]), train=False)
    assert isinstance(out, list) and len(out) == 1
    _close_logits(out[0].numpy(), want)


def test_train_mode_logits_and_running_stats_match(pair, no_dropout):
    jm = pair["jm"]
    logits, mutated = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        pair["variables"], pair["x"])
    tm = _port(pair)
    with torch.no_grad():
        got = tm(torch.from_numpy(pair["x"]), train=True, rng=torch.Generator())[0]
    _close_logits(got.numpy(), np.asarray(logits[0]))
    stats = convert.state_dict_to_variables(tm).get("batch_stats", {})
    assert_trees_close(stats, jax.device_get(mutated.get("batch_stats", {})), rtol=0,
                       atol=STATE_ATOL)


def test_one_train_step_matches(pair, no_dropout):
    jm = pair["jm"]
    variables = unit_scales(pair["variables"])
    batch = {"image": pair["x"], "label": pair["label"]}
    tx = jbuild_optimizer(dict(OPT))
    jstep = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=5.0, donate=False)
    jstate, jmetrics = jstep(JState.create(variables, tx),
                             {k: jnp.asarray(v) for k, v in batch.items()})

    tm = _port(pair, variables)
    state = FixedTrainState.create(tm, OPT)
    m = make_train_step(tbuild_loss("dice_ce"), grad_clip=5.0)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=STEP_RTOL)
    got = convert.state_dict_to_variables(tm)
    jstate = jax.device_get(jstate)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=STATE_ATOL)
    assert_trees_close(got.get("batch_stats", {}), jstate.batch_stats, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jmetrics["grad_norm"]),
                               rtol=GRAD_NORM_RTOL.get(pair["name"], STEP_RTOL))
    moved = [k for k, v in tm.state_dict().items() if k.endswith("kernel")]
    assert moved and state.step == 1


def test_the_factory_builds_the_nine_names():
    assert set(FACTORY_ZOO) == {z[0] for z in ZOO}
    with pytest.raises(KeyError, match="unknown model"):
        tget("segformer", device="cpu")
    bf16 = tget("unet", depth=3, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        out = bf16(torch.randn(1, 32, 32, 1))
    assert out[0].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tget("unet", depth=3)


def test_pspnet_at_depth_5_is_4x_smaller():
    """smp's fixed upsampling 8 over a stride-32 encoder: 64 -> 16, as
    senas_tpu gives (tests/test_zoo.py)."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 64, 64, 1).astype(np.float32)
    jm = jget("pspnet", dataset="promise12", depth=5)
    variables = random_variables(jm, rng, jnp.asarray(x), False)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), False)[0])
    tm = convert.load_variables(tget("pspnet", depth=5, device="cpu"), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape == (1, 16, 16, 2)
    _close_logits(got, want)


@pytest.mark.parametrize("size", [3, 6])
def test_psp_pool_is_senas_tpus_antialiased_resize_not_smps(size):
    """On an 8x8 map (depth 5 at 256x256, depth 3 at 64x64) pool sizes 3 and
    6 take senas_tpu's jax.image.resize 'linear' (antialiased), which the
    port copies within 1e-6; smp's AdaptiveAvgPool2d is another function
    there (ROADMAP.md Queue 3, F3)."""
    y = np.random.RandomState(size).randn(2, 8, 8, 16).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(y), (2, size, size, 16), "linear"))
    t = torch.from_numpy(y.transpose(0, 3, 1, 2).copy())
    got = tzoo.psp_pool(t, size).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    smp = torch.nn.functional.adaptive_avg_pool2d(t, size).permute(0, 2, 3, 1).numpy()
    assert np.abs(smp - want).max() > 0.1
    # a size that divides the map is the block mean in all three
    np.testing.assert_allclose(tzoo.psp_pool(t, 2).numpy(),
                               torch.nn.functional.adaptive_avg_pool2d(t, 2).numpy(),
                               rtol=0, atol=1e-6)


def test_dropout_keep_fraction_scale_and_mask():
    drop = primitives.Dropout(0.5)
    x = torch.ones(4, 16, 32, 32)
    assert drop(x, train=False) is x
    y = drop(x, train=True, rng=torch.Generator().manual_seed(7))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    again = drop(x, train=True, rng=torch.Generator().manual_seed(7))
    other = drop(x, train=True, rng=torch.Generator().manual_seed(8))
    assert torch.equal(y, again) and not torch.equal(y, other)
    with pytest.raises(ValueError, match="Generator"):
        drop(x, train=True)


def test_train_step_seeds_the_dropout_generator_by_step():
    """The fixed step reseeds the state's generator from (seed, step), so
    deeplab's ASPP mask is a function of the state: a step repeated from
    the same state draws the same mask, the next step another."""
    model = tget("deeplab_v3_plus", device="cpu")
    state = FixedTrainState.create(model, OPT, seed=3)
    a = torch.rand(5, generator=state.step_generator())
    b = torch.rand(5, generator=state.step_generator())
    state.step += 1
    c = torch.rand(5, generator=state.step_generator())
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert FixedTrainState.create(model, OPT).state_dict()["seed"] == 0


@pytest.mark.parametrize("name,cls", [("unet", "Unet"), ("linknet", "Linknet")])
def test_aux_params_give_masks_and_labels(name, cls):
    """With `aux_params` a ClassificationHead reads the deepest encoder map
    and the model returns ([masks], labels) (tests/test_aux_heads.py)."""
    aux = {"classes": 3, "dropout": 0.2, "activation": "softmax"}
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    jm = getattr(jzoo, cls)(classes=2, in_channels=1, encoder_depth=3, aux_params=aux,
                            **({"decoder_channels": (32, 16, 8)} if name == "unet" else {}))
    variables = random_variables(jm, rng, jnp.asarray(x), False)
    (jmasks,), jlabels = jm.apply(variables, jnp.asarray(x), False)
    tm = getattr(tzoo, cls)(classes=2, in_channels=1, encoder_depth=3, aux_params=aux,
                            device="cpu",
                            **({"decoder_channels": (32, 16, 8)} if name == "unet" else {}))
    convert.load_variables(tm, variables)
    with torch.no_grad():
        (masks,), labels = tm(torch.from_numpy(x))
        _, train_labels = tm(torch.from_numpy(x), train=True, rng=torch.Generator())
    _close_logits(masks.numpy(), np.asarray(jmasks))
    assert labels.shape == (2, 3) == train_labels.shape
    np.testing.assert_allclose(labels.numpy(), np.asarray(jlabels), rtol=0, atol=1e-6)
    np.testing.assert_allclose(labels.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("act", ["sigmoid", "softmax", "softmax2d", "logsoftmax", "tanh",
                                 "argmax2d", None])
def test_smp_activation_matches(act):
    x = np.random.RandomState(0).randn(2, 5, 6, 4).astype(np.float32)
    want = np.asarray(jbase.smp_activation(act)(jnp.asarray(x)))
    got = tbase.smp_activation(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Activation should be"):
        tbase.smp_activation("bogus")


@pytest.mark.parametrize("src,dst", [((5, 7), (8, 3)), ((7, 3), (12, 12)), ((6, 6), (11, 9))])
def test_nasunet_nearest_picks_match(src, dst):
    """nasunet's node merge picks floor(dst * in / out) in integers."""
    x = np.random.RandomState(0).randn(1, src[0], src[1], 3).astype(np.float32)
    want = np.asarray(jnasunet._nearest(jnp.asarray(x), *dst))
    got = tnasunet._nearest(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), *dst)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("op", ["dep_conv", "up_dep_conv", "up_conv", "up_dil_conv",
                                "down_dep_conv", "down_conv", "dil_conv", "avg_pool",
                                "max_pool", "identity", "none", "shuffle_conv"])
def test_nasunet_ops_outside_the_genotype_match(op):
    """The op vocabulary that NAS_UNET_V3 does not use, op by op."""
    x = np.random.RandomState(2).randn(2, 8, 8, 16).astype(np.float32)
    jop = jnasunet.make_nasunet_op(op, 16)
    variables = random_variables(jop, np.random.RandomState(3), jnp.asarray(x), False)
    want = np.asarray(jop.apply(variables, jnp.asarray(x), False))
    top = tnasunet.make_nasunet_op(op, 16)
    primitives.init_params_(top, torch.Generator().manual_seed(0))
    if variables:
        convert.load_variables(top, variables)
    with torch.no_grad():
        got = top(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_preprocessing_matches():
    for name in ("resnet34", "resnext50_32x4d", "xception", "inceptionv4", "inceptionresnetv2",
                 "dpn68", "se_resnext50_32x4d", "vgg11", "efficientnet-b0", "mobilenet_v2",
                 "timm-resnest14d", "timm-mobilenetv3_large_100"):
        assert t_prep_params(name) == j_prep_params(name), name
    assert t_prep_params("efficientnet-b3", "advprop") == \
        j_prep_params("efficientnet-b3", "advprop")
    x = np.random.RandomState(0).rand(4, 4, 3) * 255
    params = t_prep_params("resnet10")
    np.testing.assert_array_equal(t_preprocess(x, **params), j_preprocess(x, **params))
    with pytest.raises(ValueError, match="imagenet"):
        t_prep_params("resnet34", pretrained="other")
    with pytest.raises(KeyError):
        t_prep_params("nope")
    for name in ("timm-res2net50_26w_4s", "timm-regnetx_002", "timm-regnety_016",
                 "timm-skresnet18", "timm-gernet_s"):
        assert t_prep_params(name) == j_prep_params(name), name
