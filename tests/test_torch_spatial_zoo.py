"""The baseline zoo's nine factory models with the image rows split over
the mesh's spatial axis (ROADMAP.md M13c: the row resizes, whole levels,
GroupNorm, Dropout and whole-map BatchNorm of senas_torch/parallel/spatial.py
and ops/primitives.py) over gloo ranks on the CPU:

  * in f64, against the port's own single-process step on the global batch
    (the same weights, batches and optimizer): each of the nine models at
    80x80, batch 2, two steps of `training:`'s optimizer with clip 5, then
    the eval step, within 1e-10 of each result's scale (loss, tp/fp/fn,
    weights, running stats, the eval forward's GroupNorm outputs). Depths:
    pspnet 3 (its logits are the input's size there), deeplab_v3_plus 5
    (the factory's), nasunet and pan 3, the others 4. 80 rows make levels
    of 40, 20, 10 and 5 rows (and PAN's 2 and 1, nasunet's 79, 39, 19, 9):
    the 5-row level splits 2 + 3 over two ranks and 1 + 1 + 1 + 2 over
    four, the 1-row level leaves ranks empty. senas_tpu builds and trains
    every model at this size (PAN's pyramid needs a 10-row deepest map at
    depth 3; DeepLabV3+ at stride 16 gives 5 rows, x4 the 20 of its
    skip). DeepLabV3+ trains with its ASPP dropout; unet also runs with
    SENAS_PALLAS_BN=1. Over MeshSpec(1, 2) in a spawn of 2 ranks; over
    MeshSpec(1, 4) (the nine) and MeshSpec(2, 2) (deeplab_v3_plus, pspnet,
    pan, and unet on a batch whose rows the placer did not split) in a
    spawn of 4;
  * in f32 over MeshSpec(1, 2), unet, manet, fpn, pspnet and
    deeplab_v3_plus against senas_tpu's jitted single-device step on the
    global batch (unit BN scales, dropout the identity in both packages, as
    tests/test_torch_zoo.py), within tests/test_mesh.py's bounds: loss rtol
    1e-5, tp/fp/fn equal, weights rtol 2e-2 / atol 8e-3;
  * in bf16 (f32 weights), fpn's step over MeshSpec(1, 2) within ROADMAP's
    bf16 network bound of senas_tpu's bf16 step (the weight update, the
    loss);
  * without a spawn: a zoo model on an encoder outside models/encoders.py
    runs under a row split (M13d; every family over ranks:
    tests/test_torch_spatial_encoders.py)."""

import os
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models.factory import get_segmentation_model as jget
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch.core.config import load_config
from senas_torch.models import zoo

from torch_mesh_workers import Ranks, combine
from torch_port_util import (NoDropout, as_f64, assert_bf16_network, flat, flat_leaves,
                             one_rank_split, random_fill, rel_l2, unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
F64_REL = 1e-10
HW, B = 80, 2
DEPTH = {"nasunet": 3, "unet": 4, "unet_plus_plus": 4, "manet": 4, "linknet": 4, "fpn": 4,
         "pspnet": 3, "pan": 3, "deeplab_v3_plus": 5}
NINE = tuple(DEPTH)
F32_MODELS = ("unet", "manet", "fpn", "pspnet", "deeplab_v3_plus")
DATA_SPATIAL = ("deeplab_v3_plus", "pspnet", "pan", "unet_unsplit")
SPAWN_TIMEOUT_S = 300
# the share of the batch's pixels by which tp, fp and fn may differ from
# senas_tpu's after an update (f32): one pixel of the 12,800
COUNT_SHARE = 1e-4


def _batch(rng, b=B, hw=HW):
    return {"image": rng.randn(b, hw, hw, 1).astype(np.float32),
            "label": (rng.rand(b, hw, hw) > 0.6).astype(np.int32)}


def _jax_steps(name, variables, batches, t, dtype=None):
    """senas_tpu's jitted single-device train step on each global batch in
    turn: the metrics and the state after each."""
    tx = jbuild_optimizer(dict(t["model_optimizer"]))
    jm = jget(name, dataset="synthetic", depth=DEPTH[name], dtype=dtype)
    step = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=t["grad_clip"],
                       donate=False)
    state, out = JState.create(variables, tx), []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(({k: np.asarray(v) for k, v in m.items()}, jax.device_get(state)))
    return out


def _variables(name, rng):
    """`random_variables` of `name` with unit BN scales (the step tests of
    tests/test_torch_zoo.py), its shapes read off the port's model (flax's
    eval_shape of the JAX model costs seconds a model)."""
    from senas_torch import convert
    from torch_mesh_workers import _zoo_model
    net = _zoo_model(name, DEPTH[name], None, torch.float32, None)
    return unit_scales(random_fill(convert.state_dict_to_variables(net), rng))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    t = load_config(CONFIG)["training"]
    opt, clip = t["model_optimizer"], t["grad_clip"]
    rng = np.random.RandomState(0)

    # f64: the port's own steps
    batches, eval_batch = [_batch(rng) for _ in range(2)], _batch(rng)
    common = dict(batches=batches, eval_batch=eval_batch, opt_cfg=opt, clip=clip)
    f64 = {name: dict(common, model=name, depth=DEPTH[name]) for name in NINE}
    f64["unet_gated"] = dict(f64["unet"], gated=True)
    # an H that the spatial size does not divide: the data index's rows
    # whole on each of its ranks, reduced over the data axis
    f64["unet_unsplit"] = dict(f64["unet"], spatial=False)

    # f32 and bf16: both packages from the same variables, dropout off
    jvars = {name: _variables(name, rng) for name in F32_MODELS}
    f32 = {f"{name}_f32": dict(common, model=name, depth=DEPTH[name], variables=jvars[name],
                               dtype="float32", dropout=False) for name in F32_MODELS}
    bf16 = {"fpn_bf16": dict(common, batches=batches[:1], model="fpn", depth=DEPTH["fpn"],
                             variables=jvars["fpn"], dtype="float32", precision="bf16")}

    # the port's single-process steps on the global batch (f64) run in a
    # process of their own (mesh_spec (): no mesh), beside the split ones
    jobs = {1: [((), k) for k in f64],
            2: [((1, 2), k) for k in (*NINE, "unet_gated", *f32, *bf16)],
            4: [((1, 4), k) for k in NINE] + [((2, 2), k) for k in DATA_SPATIAL]}
    cases = {**f64, **f32, **bf16}
    tmp = tmp_path_factory.mktemp("ranks")
    spawned = {world: Ranks([("spatial_zoo_steps", dict(cases[k], mesh_spec=spec))
                             for spec, k in job], tmp, world, timeout=SPAWN_TIMEOUT_S)
               for world, job in jobs.items()}
    # senas_tpu's single-device steps on the global batch, traced and
    # compiled in threads, dropout the identity
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(len(F32_MODELS) + 1) as pool:
        mp.setattr(fnn, "Dropout", NoDropout)
        jax_f32 = {name: pool.submit(_jax_steps, name, jvars[name], batches, t)
                   for name in F32_MODELS}
        jax_bf16 = pool.submit(_jax_steps, "fpn", jvars["fpn"], batches[:1], t, jnp.bfloat16)
        jax_f32 = {name: f.result() for name, f in jax_f32.items()}
        jax_bf16 = jax_bf16.result()
    results = {world: r.results() for world, r in spawned.items()}
    single = {k: results[1][0][i] for i, (_, k) in enumerate(jobs[1])}
    split = {(spec, k): combine([r[i] for r in results[world]], spec)
             for world, job in jobs.items() if world > 1 for i, (spec, k) in enumerate(job)}
    return dict(single=single, split=split, jax_f32=jax_f32, jax_bf16=jax_bf16,
                jvars=jvars)


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


def _steps_close(got, want, what):
    for step in ("step0", "step1", "eval"):
        assert got[step].keys() == want[step].keys()
        for k, v in want[step].items():
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(got[step][k], v, err_msg=f"{what} {step} {k}")
            else:
                np.testing.assert_allclose(got[step][k], v, rtol=F64_REL, atol=1e-300,
                                           err_msg=f"{what} {step} {k}")


@pytest.mark.parametrize("spec,case", [((1, 2), k) for k in (*NINE, "unet_gated")]
                         + [((1, 4), k) for k in NINE] + [((2, 2), k) for k in DATA_SPATIAL])
def test_split_zoo_step_equals_one_process_f64(runs, spec, case):
    got, want = runs["split"][(spec, case)], runs["single"][case]
    _steps_close(got, want, f"{spec} {case}")
    for coll in ("params", "batch_stats"):
        _close(got["variables"].get(coll, {}), want["variables"].get(coll, {}), F64_REL,
               f"{spec} {case} {coll}")
    norms = [k for k in want if k.startswith("sum:gn_")]
    assert bool(norms) == (case in ("nasunet", "fpn")), norms
    for k in norms:
        np.testing.assert_allclose(got[k], want[k], rtol=F64_REL, err_msg=f"{spec} {case} {k}")
    assert want["step0"]["loss"] != want["step1"]["loss"]


@pytest.mark.parametrize("name", F32_MODELS)
def test_split_zoo_step_matches_senas_tpu_f32(runs, name):
    got = runs["split"][((1, 2), f"{name}_f32")]
    for i, (want, _) in enumerate(runs["jax_f32"][name]):
        np.testing.assert_allclose(got[f"step{i}"]["loss"], want["loss"], rtol=1e-5)
        # after the first update a pixel whose two logits lie within f32
        # rounding may flip: the unsplit port's step 1 read fp one pixel
        # off senas_tpu's for manet and for deeplab_v3_plus at other seeds
        slack = 0 if i == 0 else int(COUNT_SHARE * B * HW * HW)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_allclose(got[f"step{i}"][k], want[k], rtol=0, atol=slack,
                                       err_msg=f"step {i} {k}")
    state = runs["jax_f32"][name][-1][1]
    g, w = flat(got["variables"]["params"]), flat(state.params)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=8e-3, err_msg=k)


def test_split_fpn_step_bf16_within_the_network_bound(runs):
    """fpn computes in bf16 (GroupNorm(dtype=bf16) and the f32-weight
    aligned resizes over split rows): its one-step weight update and loss
    lie within twice senas_tpu's own bf16-vs-f32 distance of senas_tpu's
    bf16 step."""
    before = flat_leaves(runs["jvars"]["fpn"]["params"])
    got = runs["split"][((1, 2), "fpn_bf16")]
    (jb_m, jb_state), = runs["jax_bf16"]
    jf_m, jf_state = runs["jax_f32"]["fpn"][0]
    port_update = flat_leaves(got["variables"]["params"]) - before
    _, own = assert_bf16_network(port_update, flat_leaves(jb_state.params) - before,
                                 flat_leaves(jf_state.params) - before, what="weight update")
    gap = rel_l2(as_f64(got["step0"]["loss"]), as_f64(jb_m["loss"]))
    assert gap <= 2 * own + 1e-6, (gap, own)
    f32_update = flat_leaves(runs["split"][((1, 2), "fpn_f32")]["variables"]["params"]) - before
    assert rel_l2(port_update, f32_update) > 100 * 1e-5, "bf16 not computed"


def test_zoo_on_an_encoder_outside_encoders_py_raises_under_split():
    """M13d: a direct zoo.Unet(encoder_name="densenet121") runs under an
    active row split (one rank holding every row: every op in its
    row-shard form, DenseNet's transition pools included), and its eval
    forward equals the unsplit one."""
    net = zoo.Unet(classes=2, in_channels=1, encoder_name="densenet121", encoder_depth=3,
                   decoder_channels=(16, 8, 4), device="cpu").double()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 32, 32, 1))
    with torch.no_grad():
        want = net(x, train=False)[0]
        with one_rank_split((32, 32)) as split:
            got = net(x, train=False)[0]
    assert split.levels == {32: 32, 16: 16, 8: 8, 4: 4, 2: 2}
    assert got.shape == (1, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F64_REL * float(want.abs().max()))
