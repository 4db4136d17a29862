"""The port's steps with the image rows split over the mesh's spatial axis
(senas_torch/parallel/spatial.py, M13b) over gloo ranks on the CPU:

  * in f64, against the port's own single-process step on the global batch
    (the same weights, batches and optimizers), within 1e-10 of each
    result's scale (loss, tp/fp/fn, weights, running stats, arch tables):
    the fixed step (SenasModel senas_node_4, c 8, depth 3, 24x24, so that
    its deepest level of 3 rows splits 1 + 2 over two ranks and 0 + 1 + 1 +
    1 over four, below the 6-row halo of a 5x5 dilation-3 convolution; two
    steps of `training:`'s optimizer, clip 5, then the eval step) plain,
    with `remat`, and with SENAS_PALLAS_BN=1; the search step (meta 2,
    depth 3, c 4, 24x24, two steps with do_arch, then the search eval step)
    plain and with `remat`. Over MeshSpec(1, 2) in a spawn of 2 ranks, and
    over MeshSpec(2, 2) and MeshSpec(1, 4) in a spawn of 4; over (2, 2)
    also a fixed step whose rows the placer did not split (an H the
    spatial size does not divide: the step reduces over the data axis);
  * in f32 over MeshSpec(1, 2), against senas_tpu's single-device step on
    the global batch (jitted), within tests/test_mesh.py's bounds: loss
    rtol 1e-5 (the search step's 2e-5), tp/fp/fn equal, weights rtol 2e-2 /
    atol 8e-3, arch tables rtol 2e-4 / atol 1e-6 (the geometry of
    tests/test_torch_mesh_steps.py: fixed 32x32, search 16x16, batch 8,
    each rank holding every batch row and half the image rows)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_tpu.search import supernet as jsn
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JFixedState
from senas_tpu.train.trainer import SearchTrainState as JSearchState
from senas_tpu.train.trainer import make_search_step as jmake_search
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch.core.config import load_config

from torch_mesh_workers import CASES, Ranks, combine
from torch_port_util import flat, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
F64_REL = 1e-10
F64_HW, F64_B = 24, 4
F64_CASES = ("fixed", "fixed_remat", "gated", "search", "search_remat")
F32_HW, F32_SEARCH_HW, F32_B = 32, 16, 8
SPAWN_TIMEOUT_S = 300


def _batch(rng, b, hw):
    return {"image": rng.randn(b, hw, hw, 1).astype(np.float32),
            "label": (rng.rand(b, hw, hw) > 0.6).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = load_config(CONFIG)
    t, s = cfg["training"], cfg["searching"]
    opt, w_cfg, a_cfg = t["model_optimizer"], s["model_optimizer"], s["arch_optimizer"]
    rng = np.random.RandomState(0)

    # f64: the port's own steps
    fixed = dict(batches=[_batch(rng, F64_B, F64_HW) for _ in range(2)],
                 eval_batch=_batch(rng, F64_B, F64_HW), opt_cfg=opt, clip=t["grad_clip"], c=8,
                 depth=3)
    arch = {k: (0.5 * rng.randn(*v)).astype(np.float32)
            for k, v in jsn.arch_param_count(2, 3).items()}
    search = dict(batches=[(_batch(rng, F64_B, F64_HW), _batch(rng, F64_B, F64_HW))
                           for _ in range(2)], do_arch=(True, True), arch=arch, w_cfg=w_cfg,
                  a_cfg=a_cfg, meta=2, depth=3, c=4)
    f64 = {"fixed": ("spatial_fixed_steps", fixed),
           "fixed_remat": ("spatial_fixed_steps", dict(fixed, remat=True)),
           "gated": ("spatial_fixed_steps", dict(fixed, gated=True)),
           "search": ("spatial_search_steps", search),
           "search_remat": ("spatial_search_steps", dict(search, remat=True))}
    jobs = {2: [((1, 2), k) for k in F64_CASES],
            4: [((2, 2), k) for k in F64_CASES] + [((2, 2), "unsplit")]
            + [((1, 4), k) for k in ("fixed", "search")]}
    f64["unsplit"] = ("spatial_fixed_steps", dict(fixed, spatial=False))

    # f32: the geometry of test_torch_mesh_steps.py, against senas_tpu
    fixed_batches = [_batch(rng, F32_B, F32_HW) for _ in range(3)]
    jm = JModel(nclass=2, in_channels=1, genotype=jgs.senas_node_4, c=8, depth=3)
    fixed_vars = random_variables(jm, rng, jnp.asarray(fixed_batches[0]["image"]), False)
    arch32 = {k: (0.5 * rng.randn(*v)).astype(np.float32)
              for k, v in jsn.arch_param_count(2, 2).items()}
    search_batches = [(_batch(rng, F32_B, F32_SEARCH_HW), _batch(rng, F32_B, F32_SEARCH_HW))
                      for _ in range(2)]
    js = jsn.SenasSearch(in_channels=1, c=4, nclass=2, depth=2, meta_node_num=2)
    search_vars = random_variables(js, rng, jnp.asarray(search_batches[0][0]["image"]),
                                   jsn.normalize_arch(arch32, 2), False)
    f32 = {"fixed_f32": ("spatial_fixed_steps", dict(
               batches=fixed_batches[:2], eval_batch=fixed_batches[2], opt_cfg=opt,
               clip=t["grad_clip"], c=8, depth=3, variables=fixed_vars, dtype="float32")),
           "search_f32": ("spatial_search_steps", dict(
               batches=search_batches, do_arch=(True, True), arch=arch32, w_cfg=w_cfg,
               a_cfg=a_cfg, meta=2, depth=2, c=4, variables=search_vars, dtype="float32"))}
    jobs[2] += [((1, 2), k) for k in f32]
    cases = {**f64, **f32}

    tmp = tmp_path_factory.mktemp("ranks")
    spawn = lambda world: Ranks([(cases[k][0], dict(cases[k][1], mesh_spec=spec))
                                 for spec, k in jobs[world]], tmp, world,
                                timeout=SPAWN_TIMEOUT_S)
    ranks = spawn(2)
    # senas_tpu's single-device steps on the global batch, f32
    tx = jbuild_optimizer(dict(opt))
    jstep = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=t["grad_clip"],
                        donate=False)
    jstate, jfixed = JFixedState.create(fixed_vars, tx), []
    for b in fixed_batches[:2]:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jfixed.append({k: np.asarray(v) for k, v in m.items()})
    w_tx, a_tx = jbuild_optimizer(dict(w_cfg)), jbuild_optimizer(dict(a_cfg))
    jsstep = jmake_search(js.apply, lambda a: jsn.normalize_arch(a, 2), jbuild_loss("dice_ce"),
                          w_tx, a_tx, grad_clip=5.0, donate=False)
    jsstate, jsearch = JSearchState.create(search_vars, arch32, w_tx, a_tx), []
    for tb, vb in search_batches:
        jsstate, m = jsstep(jsstate, {k: jnp.asarray(v) for k, v in tb.items()},
                            {k: jnp.asarray(v) for k, v in vb.items()}, True)
        jsearch.append({k: np.asarray(v) for k, v in m.items()})
    results = {2: ranks.results()}
    ranks = spawn(4)
    # the port's single-process steps on the global batch, f64
    single = {k: CASES[name](None, **kw) for k, (name, kw) in f64.items()}
    results[4] = ranks.results()
    split = {(spec, k): combine([r[i] for r in results[world]], spec)
             for world, job in jobs.items() for i, (spec, k) in enumerate(job)}
    return dict(single=single, split=split, jfixed=jfixed, jstate=jstate, jsearch=jsearch,
                jsstate=jsstate)


def _close(got, want, rel, what):
    """Every leaf of `got` within rel times the largest magnitude of its
    collection in `want`."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), (what, sorted(set(g) ^ set(w)))
    scale = max(float(np.max(np.abs(v))) for v in w.values() if v.size)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=rel * scale, err_msg=f"{what} {k}")


def _steps_close(got, want, what):
    for step in [k for k in want if k.startswith("step")] + ["eval"]:
        assert got[step].keys() == want[step].keys()
        for k, v in want[step].items():
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(got[step][k], v, err_msg=f"{what} {step} {k}")
            else:
                np.testing.assert_allclose(got[step][k], v, rtol=F64_REL, atol=1e-300,
                                           err_msg=f"{what} {step} {k}")


@pytest.mark.parametrize("spec,case", [((1, 2), k) for k in F64_CASES]
                         + [((2, 2), k) for k in F64_CASES + ("unsplit",)]
                         + [((1, 4), k) for k in ("fixed", "search")])
def test_split_step_equals_one_process_f64(runs, spec, case):
    got, want = runs["split"][(spec, case)], runs["single"][case]
    _steps_close(got, want, f"{spec} {case}")
    for coll in ("params", "batch_stats"):
        _close(got["variables"][coll], want["variables"][coll], F64_REL,
               f"{spec} {case} {coll}")
    if "arch" in want:
        _close(got["arch"], want["arch"], F64_REL, f"{spec} {case} arch")
    assert want["step0"]["loss"] != want["step1"]["loss"]


def test_split_fixed_step_matches_senas_tpu_f32(runs):
    got = runs["split"][((1, 2), "fixed_f32")]
    for i, want in enumerate(runs["jfixed"]):
        np.testing.assert_allclose(got[f"step{i}"]["loss"], want["loss"], rtol=1e-5)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[f"step{i}"][k], want[k], err_msg=f"step {i} {k}")
    g, w = flat(got["variables"]["params"]), flat(runs["jstate"].params)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=8e-3, err_msg=k)


def test_split_search_step_matches_senas_tpu_f32(runs):
    got = runs["split"][((1, 2), "search_f32")]
    for i, want in enumerate(runs["jsearch"]):
        np.testing.assert_allclose(got[f"step{i}"]["loss"], want["loss"], rtol=2e-5)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[f"step{i}"][k], want[k], err_msg=f"step {i} {k}")
    for k, v in runs["jsstate"].arch.items():
        np.testing.assert_allclose(got["arch"][k], np.asarray(v), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    g, w = flat(got["variables"]["params"]), flat(runs["jsstate"].params)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=8e-3, err_msg=k)
