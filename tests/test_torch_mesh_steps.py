"""The port's data-parallel steps (senas_torch/parallel/) over two gloo ranks
on the CPU, each rank holding 4 rows of a global batch of 8:

  * in f64, against the port's own single-process step on the global batch
    (the same weights, batches and optimizers), within 1e-10 of each
    result's scale: the fixed step (SenasModel senas_node_4, c 8, depth 3,
    32x32, dice_ce, the optimizer of configs/senas/senas_synthetic.yml's
    `training:`, clip 5; two steps, then the eval step) with dice_ce, with
    smp_lovasz (its global sort), with SENAS_PALLAS_BN=1 (every BatchNorm
    through the fused epilogue's twins), and a zoo Unet on timm-skresnet18
    (its flax-rule attention BatchNorm); the search step (meta 2, depth 2,
    c 4, 16x16, `searching:`'s optimizers, clip 5, two steps with do_arch,
    then the search eval step): loss, metrics, weights, running stats,
    arch tables;
  * in f32, against senas_tpu's single-device step on the global batch
    (jitted), within tests/test_mesh.py's tolerances: loss rtol 1e-5 (the
    search step's 2e-5), tp/fp/fn equal, weights rtol 2e-2 / atol 8e-3,
    arch tables rtol 2e-4 / atol 1e-6. Near init the pre-BN kernels'
    gradients cancel, so f32 rounding moves single weights by O(grad)
    (tests/test_mesh.py:69-85); the f64 comparison is the tight one.

Two spawns of two ranks run the cases, the f64 ones and then the f32
ones (tests/torch_mesh_workers.py), while the parent computes the
references."""

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
B = 8
F64_REL = 1e-10
FIXED = dict(model="senas_node_4", c=8, depth=3)
FIXED_HW, FIXED_STEPS = 32, 2
M, D, SC, SEARCH_HW = 2, 2, 4, 16
DO_ARCH = (True, True)
F64_CASES = ("dice_ce", "smp_lovasz", "gated", "skresnet18")


def _batch(rng, hw):
    return {"image": rng.randn(B, hw, hw, 1).astype(np.float32),
            "label": (rng.rand(B, hw, hw) > 0.6).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = load_config(CONFIG)
    t, s = cfg["training"], cfg["searching"]
    opt, w_cfg, a_cfg = t["model_optimizer"], s["model_optimizer"], s["arch_optimizer"]
    rng = np.random.RandomState(0)
    fixed_batches = [_batch(rng, FIXED_HW) for _ in range(FIXED_STEPS + 1)]
    jm = JModel(nclass=2, in_channels=1, genotype=jgs.senas_node_4, c=FIXED["c"],
                depth=FIXED["depth"])
    fixed_vars = random_variables(jm, rng, jnp.asarray(fixed_batches[0]["image"]), False)
    arch = {k: (0.5 * rng.randn(*v)).astype(np.float32)
            for k, v in jsn.arch_param_count(M, D).items()}
    search_batches = [(_batch(rng, SEARCH_HW), _batch(rng, SEARCH_HW)) for _ in DO_ARCH]
    js = jsn.SenasSearch(in_channels=1, c=SC, nclass=2, depth=D, meta_node_num=M)
    search_vars = random_variables(js, rng, jnp.asarray(search_batches[0][0]["image"]),
                                   jsn.normalize_arch(arch, M), False)

    fixed = dict(batches=fixed_batches[:FIXED_STEPS], eval_batch=fixed_batches[FIXED_STEPS],
                 opt_cfg=opt, clip=t["grad_clip"], **FIXED)
    search = dict(batches=search_batches, do_arch=DO_ARCH, arch=arch, w_cfg=w_cfg,
                  a_cfg=a_cfg, meta=M, depth=D, c=SC, variables=search_vars)
    f64_job = {
        "dice_ce": ("fixed_steps", dict(fixed, variables=fixed_vars)),
        "smp_lovasz": ("fixed_steps", dict(fixed, variables=fixed_vars, loss="smp_lovasz")),
        "gated": ("fixed_steps", dict(fixed, variables=fixed_vars, gated=True)),
        "skresnet18": ("fixed_steps", dict(fixed, model="unet", encoder="timm-skresnet18",
                                           depth=4)),
        "search": ("search_steps", search),
    }
    f32_job = {
        "fixed_f32": ("fixed_steps", dict(fixed, variables=fixed_vars, dtype="float32")),
        "search_f32": ("search_steps", dict(search, dtype="float32")),
    }
    # two spawns, each well inside its deadline on a loaded host; the
    # parent computes the references while they run
    tmp = tmp_path_factory.mktemp("ranks")
    ranks = Ranks(list(f64_job.values()), tmp)

    # senas_tpu's single-device steps on the global batch, f32
    tx = jbuild_optimizer(dict(opt))
    jstep = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=t["grad_clip"],
                        donate=False)
    jstate, jfixed = JFixedState.create(fixed_vars, tx), []
    for b in fixed_batches[:FIXED_STEPS]:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jfixed.append({k: np.asarray(v) for k, v in m.items()})
    w_tx, a_tx = jbuild_optimizer(dict(w_cfg)), jbuild_optimizer(dict(a_cfg))
    jsstep = jmake_search(js.apply, lambda a: jsn.normalize_arch(a, M), jbuild_loss("dice_ce"),
                          w_tx, a_tx, grad_clip=5.0, donate=False)
    jsstate, jsearch = JSearchState.create(search_vars, arch, w_tx, a_tx), []
    for (tb, vb), do_arch in zip(search_batches, DO_ARCH):
        jsstate, m = jsstep(jsstate, {k: jnp.asarray(v) for k, v in tb.items()},
                            {k: jnp.asarray(v) for k, v in vb.items()}, do_arch)
        jsearch.append({k: np.asarray(v) for k, v in m.items()})

    f64_results = ranks.results()
    ranks = Ranks(list(f32_job.values()), tmp)
    # the port's single-process steps on the global batch, f64
    single = {k: CASES[name](None, **kw) for k, (name, kw) in f64_job.items()}
    f32_results = ranks.results()
    two = {k: combine([r[i] for r in results])
           for job, results in ((f64_job, f64_results), (f32_job, f32_results))
           for i, k in enumerate(job)}
    return dict(single=single, two=two, jfixed=jfixed, jstate=jstate, jsearch=jsearch,
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
    """Per-step and eval metrics: the float ones within F64_REL relative,
    the integer ones (tp, fp, fn; the eval masks) equal."""
    for step in [k for k in want if k.startswith("step")] + ["eval"]:
        assert got[step].keys() == want[step].keys()
        for k, v in want[step].items():
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(got[step][k], v, err_msg=f"{what} {step} {k}")
            else:
                np.testing.assert_allclose(got[step][k], v, rtol=F64_REL, atol=1e-300,
                                           err_msg=f"{what} {step} {k}")


@pytest.mark.parametrize("case", F64_CASES)
def test_fixed_step_over_two_ranks_equals_one_process_f64(runs, case):
    got, want = runs["two"][case], runs["single"][case]
    _steps_close(got, want, case)
    for coll in ("params", "batch_stats"):
        _close(got["variables"][coll], want["variables"][coll], F64_REL, f"{case} {coll}")
    # the steps moved the weights
    assert want["step0"]["loss"] != want["step1"]["loss"]


def test_search_step_over_two_ranks_equals_one_process_f64(runs):
    got, want = runs["two"]["search"], runs["single"]["search"]
    _steps_close(got, want, "search")
    for coll in ("params", "batch_stats"):
        _close(got["variables"][coll], want["variables"][coll], F64_REL, f"search {coll}")
    _close(got["arch"], want["arch"], F64_REL, "search arch")
    assert all(float(got[f"step{i}"]["arch_loss"]) > 0 for i in range(len(DO_ARCH)))


def test_fixed_step_over_two_ranks_matches_senas_tpu_f32(runs):
    got = runs["two"]["fixed_f32"]
    for i, want in enumerate(runs["jfixed"]):
        np.testing.assert_allclose(got[f"step{i}"]["loss"], want["loss"], rtol=1e-5)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[f"step{i}"][k], want[k], err_msg=f"step {i} {k}")
    g, w = flat(got["variables"]["params"]), flat(runs["jstate"].params)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=8e-3, err_msg=k)


def test_search_step_over_two_ranks_matches_senas_tpu_f32(runs):
    got = runs["two"]["search_f32"]
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
