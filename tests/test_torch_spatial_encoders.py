"""Every encoder family of the baseline zoo with the image rows split over
the mesh's spatial axis (ROADMAP.md M13d: the rectangular, asymmetric
'SAME' and ceil-mode windows of senas_torch/parallel/spatial.py and the SE,
SK and split-attention means over the split rows), a zoo.Unet on each
(DeepLabV3+ too), over gloo ranks on the CPU:

  * in f64, against the port's own single-process step on the global batch
    (the same weights, batches and optimizer): a Unet at depth 3 on the
    smallest name of each family, 24x24, batch 2, two steps of
    `training:`'s optimizer with clip 5, then the eval step, within 1e-10
    of each result's scale (loss, tp/fp/fn, weights, running stats,
    FlaxBatchNorm's mean and var); and DeepLabV3+ on timm-regnety_002 at
    output stride 16 (its stage 5 dilated) at 48x48. 24 rows make levels
    of 12, 6 and 3 rows (48: 24, 12, 6, 3 and the dilated 3): the 3-row
    level splits 1 + 2 over two ranks and 0 + 1 + 1 + 1 over four, a rank
    empty. timm-resnest14d also runs with SENAS_PALLAS_BN=1 (its
    split-attention BatchNorm through the epilogue's plain twins over the
    data subgroup). Over MeshSpec(1, 2) in a spawn of 2 ranks; over
    MeshSpec(1, 4) (every case) and MeshSpec(2, 2) (mnv3, resnest,
    skresnet, inceptionv4, DeepLabV3+) in a spawn of 4;
  * in f32 over MeshSpec(1, 2), timm-mobilenetv3_large_100,
    timm-resnest14d, timm-skresnet18 and inceptionv4 against senas_tpu's
    jitted single-device step on the global batch (unit BN scales), within
    tests/test_mesh.py's bounds: loss rtol 1e-5, tp/fp/fn equal, weights
    rtol 2e-2 / atol 8e-3. At batch 4: at batch 2 SK-Net's attention
    BatchNorm (2 values a channel) leaves the f32 step ill-conditioned in
    either package (unsplit, the port's f32 loss after one update lay
    4.5e-5 off its f64 one, and senas_tpu's 2.4e-5 off the port's);
  * in bf16 (f32 weights), efficientnet-b0's step over MeshSpec(1, 2)
    within ROADMAP's bf16 network bound of senas_tpu's bf16 step (the
    weight update, the loss), at batch 4 too;
  * without a spawn: a Unet on every encoder class `get_encoder` returns,
    in f64 under a split whose one rank holds every row (every op in its
    row-shard form, `torch_port_util.one_rank_split`), equals its unsplit
    train-mode forward and backward."""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import zoo as jzoo
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch.core.config import load_config
from senas_torch.models import encoders, zoo

from torch_mesh_workers import ENCODER_DECODER, Ranks, combine
from torch_port_util import (as_f64, assert_bf16_network, flat, flat_leaves, one_rank_split,
                             random_fill, rel_l2, unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
F64_REL = 1e-10
HW, B, DEPTH = 24, 2, 3
# the smallest name of each family
ENCODERS = ("vgg11_bn", "densenet121", "mobilenet_v2", "efficientnet-b0",
            "timm-tf_efficientnet_lite0", "se_resnext50_32x4d", "xception", "inceptionv4",
            "inceptionresnetv2", "dpn68", "timm-resnest14d", "timm-res2net50_26w_4s",
            "timm-regnetx_002", "timm-regnety_002", "timm-skresnet18", "timm-gernet_s",
            "timm-mobilenetv3_large_100", "timm-mobilenetv3_small_minimal_100")
# DeepLabV3+ at output stride 16: 48 rows make a 3-row level at stride 16
DEEPLAB = dict(model="deeplab_v3_plus", encoder="timm-regnety_002", depth=5, output_stride=16)
DEEPLAB_HW = 48
F32_ENCODERS = ("timm-mobilenetv3_large_100", "timm-resnest14d", "timm-skresnet18",
                "inceptionv4")
BF16_ENCODER = "efficientnet-b0"
F32_BATCH = 4
DATA_SPATIAL = F32_ENCODERS + ("deeplab",)
SPAWN_TIMEOUT_S = 300
# one encoder name of each class `get_encoder` returns
CLASS_NAMES = {"ResNetEncoder": "resnet10", "VGGEncoder": "vgg11_bn",
               "DenseNetEncoder": "densenet121", "MobileNetV2Encoder": "mobilenet_v2",
               "EfficientNetEncoder": "efficientnet-b0", "SENetEncoder": "se_resnext50_32x4d",
               "XceptionEncoder": "xception", "InceptionV4Encoder": "inceptionv4",
               "InceptionResNetV2Encoder": "inceptionresnetv2", "DPNEncoder": "dpn68",
               "ResNestEncoder": "timm-resnest14d", "Res2NetEncoder": "timm-res2net50_26w_4s",
               "RegNetEncoder": "timm-regnety_002", "SkNetEncoder": "timm-skresnet18",
               "GERNetEncoder": "timm-gernet_s",
               "MobileNetV3Encoder": "timm-mobilenetv3_large_100"}


def _batch(rng, b=B, hw=HW):
    return {"image": rng.randn(b, hw, hw, 1).astype(np.float32),
            "label": (rng.rand(b, hw, hw) > 0.6).astype(np.int32)}


def _unet_kw(name):
    return dict(classes=2, in_channels=1, encoder_name=name, encoder_depth=DEPTH,
                decoder_channels=ENCODER_DECODER["unet"][:DEPTH])


def _jax_steps(name, variables, batches, t, dtype=None):
    """senas_tpu's jitted single-device train step of its Unet on encoder
    `name` on each global batch in turn: the metrics and the state after
    each."""
    tx = jbuild_optimizer(dict(t["model_optimizer"]))
    jm = jzoo.Unet(**_unet_kw(name), dtype=dtype)
    step = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=t["grad_clip"],
                       donate=False)
    state, out = JState.create(variables, tx), []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(({k: np.asarray(v) for k, v in m.items()}, jax.device_get(state)))
    return out


def _variables(name, rng):
    """Numpy-random variables of the Unet on `name` with unit BN scales,
    their shapes read off the port's model."""
    from senas_torch import convert
    net = zoo.Unet(**_unet_kw(name), device="cpu")
    return unit_scales(random_fill(convert.state_dict_to_variables(net), rng))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    t = load_config(CONFIG)["training"]
    opt, clip = t["model_optimizer"], t["grad_clip"]
    rng = np.random.RandomState(0)

    # f64: the port's own steps
    batches, eval_batch = [_batch(rng) for _ in range(2)], _batch(rng)
    common = dict(batches=batches, eval_batch=eval_batch, opt_cfg=opt, clip=clip)
    f64 = {name: dict(common, model="unet", depth=DEPTH, encoder=name) for name in ENCODERS}
    f64["resnest_gated"] = dict(f64["timm-resnest14d"], gated=True)
    f64["deeplab"] = dict(common, batches=[_batch(rng, hw=DEEPLAB_HW) for _ in range(2)],
                          eval_batch=_batch(rng, hw=DEEPLAB_HW), **DEEPLAB)

    # f32 and bf16: both packages from the same variables and batches
    names = F32_ENCODERS + (BF16_ENCODER,)
    jvars = {name: _variables(name, rng) for name in names}
    wide = [_batch(rng, b=F32_BATCH) for _ in range(2)]
    f32 = {f"{name}_f32": dict(f64[name], batches=wide, eval_batch=_batch(rng, b=F32_BATCH),
                               variables=jvars[name], dtype="float32") for name in names}
    bf16 = {"bf16": dict(f32[f"{BF16_ENCODER}_f32"], batches=wide[:1], precision="bf16")}

    # the port's single-process steps on the global batch (f64) run in a
    # process of their own (mesh_spec (): no mesh), beside the split ones
    jobs = {1: [((), k) for k in f64],
            2: [((1, 2), k) for k in (*f64, *f32, *bf16)],
            4: [((1, 4), k) for k in f64] + [((2, 2), k) for k in DATA_SPATIAL]}
    cases = {**f64, **f32, **bf16}
    tmp = tmp_path_factory.mktemp("ranks")
    spawned = {world: Ranks([("spatial_zoo_steps", dict(cases[k], mesh_spec=spec))
                             for spec, k in job], tmp, world, timeout=SPAWN_TIMEOUT_S)
               for world, job in jobs.items()}
    # senas_tpu's single-device steps on the global batch, traced and
    # compiled in threads
    with ThreadPoolExecutor(len(names) + 1) as pool:
        jax_f32 = {name: pool.submit(_jax_steps, name, jvars[name], wide, t)
                   for name in names}
        jax_bf16 = pool.submit(_jax_steps, BF16_ENCODER, jvars[BF16_ENCODER], wide[:1], t,
                               jnp.bfloat16)
        jax_f32 = {name: f.result() for name, f in jax_f32.items()}
        jax_bf16 = jax_bf16.result()
    results = {world: r.results() for world, r in spawned.items()}
    single = {k: results[1][0][i] for i, (_, k) in enumerate(jobs[1])}
    split = {(spec, k): combine([r[i] for r in results[world]], spec)
             for world, job in jobs.items() if world > 1 for i, (spec, k) in enumerate(job)}
    return dict(single=single, split=split, jax_f32=jax_f32, jax_bf16=jax_bf16, jvars=jvars)


def _close(got, want, rel, what):
    """Every leaf of `got` within rel times the largest magnitude of its
    collection in `want`."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), (what, sorted(set(g) ^ set(w)))
    if not w:
        return
    scale = max(float(np.max(np.abs(v))) for v in w.values() if v.size)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=rel * scale, err_msg=f"{what} {k}")


F64_CASES = (*ENCODERS, "resnest_gated", "deeplab")


@pytest.mark.parametrize("spec,case", [((1, 2), k) for k in F64_CASES]
                         + [((1, 4), k) for k in F64_CASES]
                         + [((2, 2), k) for k in DATA_SPATIAL])
def test_split_encoder_step_equals_one_process_f64(runs, spec, case):
    got, want = runs["split"][(spec, case)], runs["single"][case]
    for step in ("step0", "step1", "eval"):
        assert got[step].keys() == want[step].keys()
        for k, v in want[step].items():
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(got[step][k], v, err_msg=f"{spec} {case} {step} {k}")
            else:
                np.testing.assert_allclose(got[step][k], v, rtol=F64_REL, atol=1e-300,
                                           err_msg=f"{spec} {case} {step} {k}")
    for coll in ("params", "batch_stats"):
        _close(got["variables"].get(coll, {}), want["variables"].get(coll, {}), F64_REL,
               f"{spec} {case} {coll}")
    # the rows were split: every rank exchanged halos
    assert got["halo_calls"] > 0 and want["halo_calls"] == 0
    assert want["step0"]["loss"] != want["step1"]["loss"]


@pytest.mark.parametrize("name", F32_ENCODERS)
def test_split_encoder_step_matches_senas_tpu_f32(runs, name):
    got = runs["split"][((1, 2), f"{name}_f32")]
    for i, (want, _) in enumerate(runs["jax_f32"][name]):
        np.testing.assert_allclose(got[f"step{i}"]["loss"], want["loss"], rtol=1e-5)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[f"step{i}"][k], want[k], err_msg=f"step {i} {k}")
    state = runs["jax_f32"][name][-1][1]
    for coll in ("params", "batch_stats"):
        g, w = flat(got["variables"][coll]), flat(getattr(state, coll))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=8e-3, err_msg=f"{coll} {k}")


def test_split_efficientnet_step_bf16_within_the_network_bound(runs):
    """efficientnet-b0 computes in bf16 (its SE means over split rows):
    its one-step weight update and loss lie within twice senas_tpu's own
    bf16-vs-f32 distance of senas_tpu's bf16 step."""
    before = flat_leaves(runs["jvars"][BF16_ENCODER]["params"])
    got = runs["split"][((1, 2), "bf16")]
    (jb_m, jb_state), = runs["jax_bf16"]
    _, jf_state = runs["jax_f32"][BF16_ENCODER][0]
    port_update = flat_leaves(got["variables"]["params"]) - before
    _, own = assert_bf16_network(port_update, flat_leaves(jb_state.params) - before,
                                 flat_leaves(jf_state.params) - before, what="weight update")
    gap = rel_l2(as_f64(got["step0"]["loss"]), as_f64(jb_m["loss"]))
    assert gap <= 2 * own + 1e-6, (gap, own)
    f32 = runs["split"][((1, 2), f"{BF16_ENCODER}_f32")]
    f32_update = flat_leaves(f32["variables"]["params"]) - before
    assert rel_l2(port_update, f32_update) > 100 * 1e-5, "bf16 not computed"


def test_class_table_covers_every_encoder_class():
    """CLASS_NAMES names one encoder of every class `get_encoder` builds
    (the `tu-` names resolve to these classes)."""
    built = {"ResNetEncoder"} | {e["cls"].__name__ for r in encoders._registries()
                                 for e in r.values()}
    assert built == set(CLASS_NAMES)
    for cls, name in CLASS_NAMES.items():
        assert type(encoders.get_encoder(name, depth=1, in_channels=1)).__name__ == cls


@pytest.mark.parametrize("cls", sorted(CLASS_NAMES))
def test_every_encoder_class_runs_under_a_one_rank_split(cls):
    """A Unet on the class's encoder, f64, train mode: under a split whose
    one rank holds every row its output, its input's and weights'
    gradients and its running stats equal the unsplit ones; its ops
    entered the levels of the split image."""
    net = zoo.Unet(**_unet_kw(CLASS_NAMES[cls]), device="cpu").double()
    twin = copy.deepcopy(net)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(B, HW, HW, 1))
    r = torch.from_numpy(rng.randn(B, HW, HW, 2))

    def run(model):
        xl = x.clone().requires_grad_()
        y = model(xl, train=True)[0]
        params = list(model.parameters())
        grads = torch.autograd.grad((y * r).sum(), [xl] + params, allow_unused=True)
        as_np = lambda t: t.detach().numpy()
        return {"output": {"y": as_np(y)}, "input": {"dx": as_np(grads[0])},
                "params": {str(i): as_np(g if g is not None else torch.zeros_like(p))
                           for i, (g, p) in enumerate(zip(grads[1:], params))},
                "buffers": {str(i): as_np(b) for i, b in enumerate(model.buffers())}}

    want = run(net)
    with one_rank_split((HW, HW)) as split:
        got = run(twin)
    assert len(split.levels) >= DEPTH + 1, split.levels
    for coll in want:
        _close(got[coll], want[coll], F64_REL, f"{cls} {coll}")
