"""The port's fixed-model train and eval steps against senas_tpu's
`make_train_step` / `make_eval_step` on the CPU: the same weights (through
senas_torch.convert) and batches, SenasModel(senas_node_4) at c 8, depth 3,
32x32, batch 2, with the optimizer of configs/senas/senas_synthetic.yml's
`training:` (SGD 6e-3 / 0.9 / 5e-4, clip 5) and the dice_ce loss: three
train steps, then the eval step on a fresh batch. The grad norm of these
weights is ~1, under the config's clip 5, so the steps run again with clip
0.5, where the clip scales every gradient.

The JAX step is jitted (one compile costs less than three op-by-op steps).
Tolerances, measured on an x86 CPU (worst seen in brackets): loss and grad
norm rtol 1e-5 [3.5e-7], every weight and BN running stat after the three
steps atol 1e-5 [4.8e-7]; the eval step's loss rtol 1e-5 and its integer
confusion counts and uint8 `pred` equal. Both sides run f32 and differ
only in summation order."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_eval_step as jmake_eval
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.models import geno_searched as tgs
from senas_torch.models.senas_model import SenasModel
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_eval_step, make_train_step

from torch_port_util import assert_trees_close, flat, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
C, D, HW, B, STEPS = 8, 3, 32, 2, 3
STEP_RTOL = 1e-5
STATE_ATOL = 1e-5


@pytest.fixture(scope="module", params=["config", 0.5])
def runs(request):
    t = load_config(CONFIG)["training"]
    opt_cfg = t["model_optimizer"]
    clip = t["grad_clip"] if request.param == "config" else request.param
    rng = np.random.RandomState(0)
    mk = lambda: {"image": rng.randn(B, HW, HW, 1).astype(np.float32),
                  "label": (rng.rand(B, HW, HW) > 0.6).astype(np.int32)}
    batches = [mk() for _ in range(STEPS + 1)]
    jm = JModel(nclass=2, in_channels=1, c=C, depth=D, genotype=jgs.senas_node_4)
    variables = random_variables(jm, rng, jnp.asarray(batches[0]["image"]), False)

    # JAX
    tx = jbuild_optimizer(dict(opt_cfg))
    jstep = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=clip, donate=False)
    jstate = JState.create(variables, tx)
    jm_steps = []
    for batch in batches[:STEPS]:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm_steps.append({k: np.asarray(v) for k, v in m.items()})
    jeval = jmake_eval(jm.apply, jbuild_loss("dice_ce"))
    j_eval = {k: np.asarray(v) for k, v in jeval(
        jstate.params, jstate.batch_stats,
        {k: jnp.asarray(v) for k, v in batches[STEPS].items()}).items()}

    # the port
    tm = convert.load_variables(SenasModel(nclass=2, in_channels=1, c=C, depth=D,
                                           genotype=tgs.senas_node_4, device="cpu"),
                                variables)
    state = FixedTrainState.create(tm, opt_cfg)
    tstep = make_train_step(tbuild_loss("dice_ce"), grad_clip=clip)
    tm_steps = [{k: v.numpy() for k, v in tstep(state, {
        k: torch.from_numpy(v) for k, v in batch.items()}).items()}
        for batch in batches[:STEPS]]
    t_eval = {k: v.numpy() for k, v in make_eval_step(tm, tbuild_loss("dice_ce"))(
        {k: torch.from_numpy(v) for k, v in batches[STEPS].items()}).items()}
    return dict(jstate=jstate, jm=jm_steps, j_eval=j_eval, state=state, tm=tm_steps,
                t_eval=t_eval, variables=variables, clip=clip)


def test_per_step_metrics_match(runs):
    for i, (got, want) in enumerate(zip(runs["tm"], runs["jm"])):
        assert got.keys() == want.keys()
        for k in ("loss", "grad_norm", "acc"):
            np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL,
                                       err_msg=f"step {i} {k}")
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {i} {k}")
    norms = [float(m["grad_norm"]) for m in runs["tm"]]
    assert min(norms) > runs["clip"] if runs["clip"] < 1 else max(norms) < runs["clip"]


def test_weights_and_running_stats_match(runs):
    got = convert.state_dict_to_variables(runs["state"].model)
    assert_trees_close(got["params"], runs["jstate"].params, rtol=0, atol=STATE_ATOL)
    assert_trees_close(got["batch_stats"], runs["jstate"].batch_stats, rtol=0,
                       atol=STATE_ATOL)
    # every leaf moved: weight decay reaches the ones no gradient does
    before = flat(runs["variables"]["params"])
    moved = [k for k, v in flat(got["params"]).items() if not np.array_equal(v, before[k])]
    assert len(moved) == len(before)
    assert runs["state"].step == STEPS


def test_eval_step_matches(runs):
    got, want = runs["t_eval"], runs["j_eval"]
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_RTOL)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=STEP_RTOL)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pred"].dtype == np.uint8 and got["pred"].shape == (B, HW, HW)
    np.testing.assert_array_equal(got["pred"], want["pred"])


def test_no_clip_reports_the_norm():
    """grad_clip 0: the step only measures the norm and applies the raw
    gradients."""
    torch.manual_seed(0)
    tm = SenasModel(nclass=2, in_channels=1, c=4, depth=2, genotype=tgs.senas,
                    device="cpu")
    state = FixedTrainState.create(tm, {"name": "sgd", "lr": 0.0})
    batch = {"image": torch.randn(2, 16, 16, 1), "label": torch.randint(0, 2, (2, 16, 16))}
    m = make_train_step(tbuild_loss("dice_ce"), grad_clip=0.0)(state, batch)
    assert float(m["grad_norm"]) > 0 and state.step == 1
