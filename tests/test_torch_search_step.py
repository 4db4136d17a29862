"""The port's bilevel search step against senas_tpu's `make_search_step` on
the CPU: the same weights (through senas_torch.convert), arch tables and
batches, the optimizers of configs/senas/senas_synthetic.yml (SGD 5e-3 /
0.9 / 3e-4 over weights and arch tables; Adam 1e-4 / (0.5, 0.999) / 1e-3
over the tables), clip 5, at the smallest supernet (meta_node_num 2, depth
2, c 8, 16x16, batch 2): one step with do_arch=False, then two with
do_arch=True.

The JAX step is jitted: at this size one compile of its two traces costs
less than running the three steps op by op under jax.disable_jit().

Tolerances, measured on an x86 CPU (worst seen in brackets): losses and
grad norm rtol 1e-5 [4.4e-7]; weights, arch tables and BN running stats
after the three steps atol 1e-5 [7.2e-7]. Both run in f32 and differ in
summation order, and in the batch variance: the port's epilogue takes the
one-sweep E[x^2] - mu^2, the JAX CPU path the two-pass form. The repo's
own trajectory parity against the torch reference allows rtol 2.5e-3
(tests/test_trajectory_parity.py). The integer confusion counts of a step
must be equal, and the derived genotype identical."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.search import supernet as jsn
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import SearchTrainState as JState
from senas_tpu.train.trainer import make_search_step as jmake_step
from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.search import supernet as tsn
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import SearchTrainState, make_search_step

from torch_port_util import assert_trees_close, flat, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
M, D, C, HW, B = 2, 2, 8, 16, 2
DO_ARCH = (False, True, True)
STEP_RTOL = 1e-5
STATE_ATOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    s = load_config(CONFIG)["searching"]
    w_cfg, a_cfg = s["model_optimizer"], s["arch_optimizer"]
    rng = np.random.RandomState(0)
    arch = {k: (0.5 * rng.randn(*v)).astype(np.float32)
            for k, v in jsn.arch_param_count(M, D).items()}
    mk = lambda: {"image": rng.randn(B, HW, HW, 1).astype(np.float32),
                  "label": (rng.rand(B, HW, HW) > 0.6).astype(np.int32)}
    batches = [(mk(), mk()) for _ in DO_ARCH]
    jm = jsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M)
    variables = random_variables(jm, rng, jnp.asarray(batches[0][0]["image"]),
                                 jsn.normalize_arch(arch, M), False)

    # JAX
    w_tx, a_tx = jbuild_optimizer(dict(w_cfg)), jbuild_optimizer(dict(a_cfg))
    jstep = jmake_step(jm.apply, lambda a: jsn.normalize_arch(a, M),
                       jbuild_loss("dice_ce"), w_tx, a_tx, grad_clip=5.0,
                       donate=False)
    jstate = JState.create(variables, arch, w_tx, a_tx)
    jm_steps = []
    for (tb, vb), do_arch in zip(batches, DO_ARCH):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in tb.items()},
                          {k: jnp.asarray(v) for k, v in vb.items()}, do_arch)
        jm_steps.append({k: np.asarray(v) for k, v in m.items()})

    # the port
    tm = convert.load_variables(
        tsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                        device="cpu"), variables)
    state = SearchTrainState.create(tm, convert.arch_to_torch(arch, "cpu"), w_cfg, a_cfg)
    tstep = make_search_step(lambda a: tsn.normalize_arch(a, M), tbuild_loss("dice_ce"),
                             grad_clip=5.0)
    tm_steps = []
    for (tb, vb), do_arch in zip(batches, DO_ARCH):
        m = tstep(state, {k: torch.from_numpy(v) for k, v in tb.items()},
                  {k: torch.from_numpy(v) for k, v in vb.items()}, do_arch)
        tm_steps.append({k: v.numpy() for k, v in m.items()})
    return dict(jstate=jstate, jm=jm_steps, state=state, tm=tm_steps,
                variables=variables, arch=arch)


def test_per_step_metrics_match(runs):
    for i, (got, want) in enumerate(zip(runs["tm"], runs["jm"])):
        assert got.keys() == want.keys()
        for k in ("loss", "arch_loss", "grad_norm", "acc"):
            np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL,
                                       err_msg=f"step {i} {k}")
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {i} {k}")
    assert [float(m["arch_loss"]) == 0.0 for m in runs["tm"]] == [not a for a in DO_ARCH]


def test_arch_tables_match_and_moved(runs):
    got = convert.arch_to_numpy(runs["state"].arch)
    want = {k: np.asarray(v) for k, v in runs["jstate"].arch.items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STATE_ATOL, err_msg=k)
        if want[k].size:
            assert not np.array_equal(got[k], runs["arch"][k]), f"{k} did not move"


def test_weights_and_bn_stats_match(runs):
    got = convert.state_dict_to_variables(runs["state"].model)
    assert_trees_close(got["params"], runs["jstate"].params, rtol=0, atol=STATE_ATOL)
    assert_trees_close(got["batch_stats"], runs["jstate"].batch_stats, rtol=0,
                       atol=STATE_ATOL)
    # the steps moved every weight that carries a gradient or a weight decay
    before = flat(runs["variables"]["params"])
    moved = [k for k, v in flat(got["params"]).items() if not np.array_equal(v, before[k])]
    assert len(moved) == len(before)


def test_derived_genotype_identical(runs):
    got = tsn.derive_genotype(runs["state"].arch, M, D)
    want = jsn.derive_genotype({k: np.asarray(v) for k, v in runs["jstate"].arch.items()},
                               M, D)
    assert repr(got) == repr(want)
    assert runs["state"].step == len(DO_ARCH)
