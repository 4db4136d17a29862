"""The baseline zoo in bf16: senas_torch's nine factory models with
dtype=torch.bfloat16 against senas_tpu's with dtype=jnp.bfloat16 on the
CPU, from the same f32 weights (numpy-made, through senas_torch.convert)
and batch of 2 (PAN: 4, see BATCH), at tests/test_torch_zoo.py's sizes;
and the zoo's modules one by one.

Per model: the eval logits, the train-mode logits and the running stats
they leave, and one fixed train step (dice_ce, SGD 6e-3 / 0.9 / 5e-4, clip
5; unit norm scales, as in f32): its loss, weight update, running stats
and gradient norm. The logits' dtype is senas_tpu's: fpn and pan return
f32 (their align-corners resizes keep f32 weights, so a bf16 map comes out
f32), the other seven bf16. DeepLabV3+'s dropout draws from another
generator in each package, so its train-mode checks make the dropout the
identity on both sides, as tests/test_torch_zoo.py does.

Bounds. A network's or a step's bf16 result lies at most twice as far
(relative L2) from senas_tpu's bf16 result as that lies from senas_tpu's
f32 result, plus 1e-6 (ROADMAP's bf16 rule). The step's loss and grad
norm, single numbers that sum it up, within twice senas_tpu's own bf16
error of the weight update (one number has no L2 norm to average its
noise over: PAN's bf16 loss moves 0.4-0.8% from f32 in either package). The control: the bf16
logits fail 100 times the f32 parity tolerance (2e-5 of the largest
|logit|, tests/test_torch_zoo.py) against the port's f32 logits.

Modules, against senas_tpu's run op by op (unjitted: within one jitted
program XLA drops some of the bf16 roundings between ops, e.g. a conv's
output before its BatchNorm, so jitted results are held at the network
bound): GroupNorm(dtype=bf16), the bf16 heads, Conv2dReLU, the SCSE
attention and the bf16 bilinear upsample equal senas_tpu's but on at most
1e-3 of the elements, each by one bf16 ulp (both round once from f32 sums
in other orders); Dropout scales by bf16(1 / keep) as flax does, bit for
bit. senas_tpu's `_resize_bilinear` of a bf16 map is f32 arithmetic on
f32 weights from jnp.linspace, and XLA's result depends on how it compiles
it (jitted and eager results differ on a third of the elements, by up to
3e-6 of the largest value); the port's, the same formula in f32, is held
within 1e-5 of the largest value, and a 1x1 map keeps its bf16.
The logits are compared with the JAX models applied op by op (unjitted:
within one jitted program XLA drops some bf16 roundings, such as a conv's
output before its BatchNorm, which the port, as the model is written,
keeps); the steps with the JAX package's jitted train step. Worst seen on
an x86 CPU: the logits at 0.51 of their bound (nasunet), the GroupNorm of
one group on 9.1e-4 of its elements."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import base as jbase
from senas_tpu.models import zoo as jzoo
from senas_tpu.models.factory import get_segmentation_model as jget
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch import convert
from senas_torch.models import base as tbase
from senas_torch.models import zoo as tzoo
from senas_torch.models.factory import get_segmentation_model as tget
from senas_torch.ops import primitives
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_train_step

from torch_port_util import (NoDropout, as_f64, assert_bf16_bits, assert_bf16_computed,
                             assert_bf16_network, flat_leaves, nchw, random_variables, rel_l2,
                             unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

BF = torch.bfloat16
B = 2
LOGIT_REL = 2e-5
RESIZE_REL = 1e-5
OPT = {"name": "sgd", "lr": 0.006, "weight_decay": 0.0005, "momentum": 0.9}
# (name, depth, input side): tests/test_torch_zoo.py's
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
F32_LOGITS = ("fpn", "pan")
# PAN's FPA and GAU blocks batch-normalise a global pool, per channel over
# the batch: at batch 2, two values whose difference in bf16 is rounding
# noise, so bf16's own step is noise (senas_tpu's bf16 grad norm 110
# against 18 in f32, its weight update 0.79 off f32) and no step can be
# held to it; at batch 4 senas_tpu's bf16 grad norm is within 0.5% of f32.
BATCH = {"pan": 4}


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout as the identity in both packages, for this test only."""
    monkeypatch.setattr(fnn, "Dropout", NoDropout)
    monkeypatch.setattr(primitives.Dropout, "forward", lambda self, x, train=False, rng=None: x)


def _nhwc(t):
    """A port NCHW tensor (bf16 too) -> NHWC f64 numpy."""
    return as_f64(t.permute(0, 2, 3, 1))


def _bf16_values(a):
    """An f32 array of bf16 values."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module", params=ZOO, ids=[z[0] for z in ZOO])
def pair(request):
    name, depth, hw = request.param
    rng = np.random.RandomState(0)
    b = BATCH.get(name, B)
    x = rng.randn(b, hw, hw, 1).astype(np.float32)
    variables = random_variables(jget(name, dataset="promise12", depth=depth), rng,
                                 jnp.asarray(x), False)
    label = (rng.rand(b, hw, hw) > 0.6).astype(np.int32)
    return dict(name=name, depth=depth, x=x, label=label, variables=variables)


def _jmodel(pair, dt):
    return jget(pair["name"], dataset="promise12", depth=pair["depth"], dtype=dt)


def _port(pair, dt, variables=None):
    return convert.load_variables(
        tget(pair["name"], dataset="promise12", depth=pair["depth"], dtype=dt, device="cpu"),
        variables or pair["variables"])


def _want_dtype(name):
    return torch.float32 if name in F32_LOGITS else BF


def _logits(pair, train):
    """{jax,port}_{bf16,f32}: the logits (f64) and the running stats left."""
    out = {}
    for key, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        # op by op, as the model is written: within one jitted program XLA
        # drops some bf16 roundings (a conv's output before its BatchNorm)
        logits, mut = _jmodel(pair, dt).apply(pair["variables"], pair["x"], train,
                                              mutable=["batch_stats"])
        assert logits[0].dtype == (jnp.float32 if dt is None or pair["name"] in F32_LOGITS
                                   else jnp.bfloat16)
        out[f"jax_{key}"] = (as_f64(logits[0]), flat_leaves(mut.get("batch_stats", {})))
    for key, dt in (("bf16", BF), ("f32", None)):
        tm = _port(pair, dt)
        with torch.no_grad():
            got = tm(torch.from_numpy(pair["x"]), train=train, rng=torch.Generator())[0]
        assert got.dtype == (_want_dtype(pair["name"]) if dt else torch.float32)
        assert tuple(got.shape) == pair["x"].shape[:3] + (2,)
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(b.dtype == torch.float32 for b in tm.buffers())
        stats = convert.state_dict_to_variables(tm).get("batch_stats", {})
        out[f"port_{key}"] = (as_f64(got), flat_leaves(stats))
    return out


def test_eval_logits_bf16(pair):
    r = _logits(pair, train=False)
    assert_bf16_network(r["port_bf16"][0], r["jax_bf16"][0], r["jax_f32"][0], what="logits")
    f32 = r["port_f32"][0]
    assert_bf16_computed(r["port_bf16"][0], f32, rtol=0, atol=LOGIT_REL * np.abs(f32).max())


def test_train_mode_logits_and_running_stats_bf16(pair, no_dropout):
    r = _logits(pair, train=True)
    assert_bf16_network(r["port_bf16"][0], r["jax_bf16"][0], r["jax_f32"][0], what="logits")
    if r["jax_f32"][1].size:   # nasunet normalises by groups only: no running stats
        assert_bf16_network(r["port_bf16"][1], r["jax_bf16"][1], r["jax_f32"][1],
                            what="running stats")


def test_one_train_step_bf16(pair, no_dropout):
    variables = unit_scales(pair["variables"])
    batch = {"image": pair["x"], "label": pair["label"]}
    before = flat_leaves(variables["params"])
    res = {}
    for key, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        tx = jbuild_optimizer(dict(OPT))
        step = jmake_train(_jmodel(pair, dt).apply, jbuild_loss("dice_ce"), tx, grad_clip=5.0,
                           donate=False)
        state, m = step(JState.create(variables, tx), {k: jnp.asarray(v) for k, v in batch.items()})
        state = jax.device_get(state)
        res[f"jax_{key}"] = dict(loss=as_f64(m["loss"]), grad_norm=as_f64(m["grad_norm"]),
                                 update=flat_leaves(state.params) - before,
                                 stats=flat_leaves(state.batch_stats))
    for key, dt in (("bf16", BF), ("f32", None)):
        tm = _port(pair, dt, variables)
        state = FixedTrainState.create(tm, OPT)
        m = make_train_step(tbuild_loss("dice_ce"), grad_clip=5.0)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert all(p.dtype == torch.float32 for p in tm.parameters()) and state.step == 1
        got = convert.state_dict_to_variables(tm)
        res[f"port_{key}"] = dict(loss=as_f64(m["loss"]), grad_norm=as_f64(m["grad_norm"]),
                                  update=flat_leaves(got["params"]) - before,
                                  stats=flat_leaves(got.get("batch_stats", {})))
    pb, jb, jf = res["port_bf16"], res["jax_bf16"], res["jax_f32"]
    _, own = assert_bf16_network(pb["update"], jb["update"], jf["update"], what="weight update")
    if jf["stats"].size:
        assert_bf16_network(pb["stats"], jb["stats"], jf["stats"], what="running stats")
    for k in ("loss", "grad_norm"):
        gap = rel_l2(pb[k], jb[k])
        assert gap <= 2 * own + 1e-6, (k, gap, own)
    assert rel_l2(pb["update"], res["port_f32"]["update"]) > 100 * 1e-5


@pytest.mark.parametrize("name,cls", [("unet", "Unet"), ("linknet", "Linknet")])
def test_aux_params_bf16(name, cls):
    """The ClassificationHead in bf16: its Dense computes in bf16, the
    labels come out bf16 (softmax op by op), beside bf16 masks."""
    aux = {"classes": 3, "dropout": 0.2, "activation": "softmax"}
    kw = {"decoder_channels": (32, 16, 8)} if name == "unet" else {}
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    variables = random_variables(getattr(jzoo, cls)(classes=2, in_channels=1, encoder_depth=3,
                                                    aux_params=aux, **kw), rng, jnp.asarray(x),
                                 False)
    want = {}
    for key, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        jm = getattr(jzoo, cls)(classes=2, in_channels=1, encoder_depth=3, aux_params=aux,
                                dtype=dt, **kw)
        (masks,), labels = jm.apply(variables, jnp.asarray(x), False)
        want[key] = (as_f64(masks), as_f64(labels))
    tm = convert.load_variables(getattr(tzoo, cls)(classes=2, in_channels=1, encoder_depth=3,
                                                   aux_params=aux, dtype=BF, device="cpu", **kw),
                                variables)
    with torch.no_grad():
        (masks,), labels = tm(torch.from_numpy(x))
        _, train_labels = tm(torch.from_numpy(x), train=True, rng=torch.Generator())
    assert masks.dtype == labels.dtype == train_labels.dtype == BF
    assert_bf16_network(masks, want["bf16"][0], want["f32"][0], what="masks")
    assert_bf16_network(labels, want["bf16"][1], want["f32"][1], what="labels")


def test_the_factory_builds_every_name_in_bf16():
    for name, depth, hw in ZOO:
        m = tget(name, depth=min(depth, 4) if name != "pan" else depth, dtype=BF, device="cpu")
        side = 128 if name == "pan" else 32
        with torch.no_grad():
            out = m(torch.randn(1, side, side, 1), train=False)
        assert out[0].dtype == _want_dtype(name), name
        assert all(p.dtype == torch.float32 for p in m.parameters())


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _load(module, variables):
    primitives.init_params_(module, torch.Generator().manual_seed(0))
    return convert.load_variables(module, variables)


@pytest.mark.parametrize("groups,in_dtype", [(32, "f32"), (32, "bf16"), (2, "bf16"),
                                             (1, "bf16")])
def test_group_norm_bf16(groups, in_dtype):
    """flax nn.GroupNorm(dtype=bf16): f32 statistics of x promoted, one
    rounding; an f32 input (the f32 islands of FPN) too."""
    x = np.random.RandomState(groups).randn(2, 12, 10, 64).astype(np.float32) * 2 + 0.5
    if in_dtype == "bf16":
        x = _bf16_values(x)
    jx = jnp.asarray(x) if in_dtype == "f32" else jnp.asarray(x).astype(jnp.bfloat16)
    jm = fnn.GroupNorm(num_groups=groups, epsilon=1e-5, dtype=jnp.bfloat16)
    variables = random_variables(jm, np.random.RandomState(7), jx)
    want = jm.apply(variables, jx)
    tm = _load(primitives.GroupNorm(64, groups, dtype=BF), variables)
    tx = nchw(x) if in_dtype == "f32" else nchw(x).to(BF)
    with torch.no_grad():
        got = tm(tx)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_bf16_bits(_nhwc(got), as_f64(want), what=f"GroupNorm({groups}) of {in_dtype}")


def test_dropout_scales_in_bf16_as_flax():
    """flax divides a bf16 x by keep_prob in bf16 (bf16(0.8) = 0.80078125);
    the port's kept elements are the same quotients, the others 0."""
    x = _bf16_values(np.random.RandomState(3).randn(4, 8, 16, 16).astype(np.float32))
    tx = torch.from_numpy(x).to(BF)
    y = primitives.Dropout(0.2)(tx, train=True, rng=torch.Generator().manual_seed(1))
    want = as_f64(jnp.asarray(x).astype(jnp.bfloat16) / 0.8)
    kept = as_f64(y) != 0
    assert y.dtype == BF and 0.75 < kept.mean() < 0.85
    np.testing.assert_array_equal(as_f64(y)[kept], want[kept])
    assert np.abs(as_f64(tx / 0.8) - want).max() > 0   # PyTorch's own f32 scalar differs


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((5, 7), (11, 13)), ((4, 4), (4, 4)),
                                     ((1, 4), (2, 8))])
def test_resize_bilinear_keeps_f32_weights(src, dst):
    """senas_tpu's `_resize_bilinear` (align corners) of a bf16 map: f32
    weights, so the result is f32."""
    x = _bf16_values(np.random.RandomState(0).randn(2, *src, 3).astype(np.float32))
    want = jax.jit(lambda a: jzoo._resize_bilinear(a, dst, True))(
        jnp.asarray(x).astype(jnp.bfloat16))
    got = tzoo._aligned_resize(nchw(x).to(BF), dst)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert np.abs(_nhwc(got) - as_f64(want)).max() <= RESIZE_REL * np.abs(x).max()


def test_resize_bilinear_broadcasts_a_1x1_map_in_bf16():
    x = _bf16_values(np.random.RandomState(1).randn(2, 1, 1, 3).astype(np.float32))
    want = jzoo._resize_bilinear(jnp.asarray(x).astype(jnp.bfloat16), (4, 4), True)
    got = tzoo._aligned_resize(nchw(x).to(BF), (4, 4))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF
    np.testing.assert_array_equal(_nhwc(got), as_f64(want))


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_bilinear_bf16(factor):
    """The heads' upsample with its weights in bf16, op by op."""
    x = _bf16_values(np.random.RandomState(factor).randn(2, 6, 5, 3).astype(np.float32))
    want = jbase.upsample_bilinear(jnp.asarray(x).astype(jnp.bfloat16), factor)
    got = tbase.upsample_bilinear(nchw(x).to(BF), factor)
    assert got.dtype == BF
    assert_bf16_bits(_nhwc(got), as_f64(want), what=f"upsample x{factor}")


def _module_case(jmodule, tmodule, x, *args):
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    variables = random_variables(jmodule, np.random.RandomState(4), jx, *args)
    want = jmodule.apply(variables, jx, *args)
    tm = _load(tmodule, variables)
    with torch.no_grad():
        got = tm(nchw(x).to(BF), *args)
    return got, want


@pytest.mark.parametrize("upsampling", [1, 4])
def test_segmentation_head_bf16(upsampling):
    x = _bf16_values(np.random.RandomState(5).randn(2, 8, 8, 16).astype(np.float32))
    got, want = _module_case(jbase.SegmentationHead(2, upsampling=upsampling),
                             tbase.SegmentationHead(16, 2, upsampling=upsampling), x)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_bf16_bits(_nhwc(got), as_f64(want), what="SegmentationHead")


@pytest.mark.parametrize("pooling", ["avg", "max"])
def test_classification_head_bf16(pooling):
    """The pool and the bf16 Dense (the activation: the next test)."""
    x = _bf16_values(np.random.RandomState(6).randn(16, 4, 4, 64).astype(np.float32))
    got, want = _module_case(
        jbase.ClassificationHead(16, pooling=pooling, dtype=jnp.bfloat16),
        tbase.ClassificationHead(64, 16, pooling=pooling, dtype=BF), x, False)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_bf16_bits(got, as_f64(want), what="ClassificationHead")


@pytest.mark.parametrize("act", ["softmax", "logsoftmax", "sigmoid"])
@pytest.mark.parametrize("classes", [2, 3, 16])
def test_smp_activation_bf16(act, classes):
    """smp's activations on bf16 logits as the JAX package's jitted steps
    compute them (jax.nn.softmax op by op, where XLA sums the unrounded
    f32 exps and rounds the sum once): bit for bit."""
    x = _bf16_values(np.random.RandomState(classes).randn(4, 8, 8, classes).astype(np.float32)
                     * 3)
    want = jax.jit(jbase.smp_activation(act))(jnp.asarray(x).astype(jnp.bfloat16))
    got = tbase.smp_activation(act)(torch.from_numpy(x).to(BF))
    assert got.dtype == BF
    np.testing.assert_array_equal(as_f64(got), as_f64(want))


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_conv2d_relu_bf16(use_batchnorm):
    x = _bf16_values(np.random.RandomState(7).randn(2, 8, 8, 16).astype(np.float32))
    got, want = _module_case(
        jbase.Conv2dReLU(24, use_batchnorm=use_batchnorm, dtype=jnp.bfloat16),
        tbase.Conv2dReLU(16, 24, use_batchnorm=use_batchnorm, dtype=BF), x, False)
    assert got.dtype == BF
    assert_bf16_bits(_nhwc(got), as_f64(want), what="Conv2dReLU")


def test_scse_attention_bf16():
    x = _bf16_values(np.random.RandomState(8).randn(2, 8, 8, 32).astype(np.float32))
    got, want = _module_case(jbase.SCSEModule(dtype=jnp.bfloat16),
                             tbase.SCSEModule(32, dtype=BF), x)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_bf16_bits(_nhwc(got), as_f64(want), what="SCSE")
