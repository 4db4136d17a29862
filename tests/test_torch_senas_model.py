"""The port's fixed SenasModel against senas_tpu's on the CPU: the same
weights (through senas_torch.convert), logits in eval and train mode, and
the BN running stats after a train-mode forward, for senas_node_2/3/4 with
deep supervision on and off and with double_down_channel (c 8, depth 3,
32x32 to 64x64, batch 2). Also the weight tree's names, gamma pruning, the
factory, the genotype constants and the init rules.

The JAX side runs eagerly (op by op) to keep XLA:CPU compile time low. Both
normalise by the two-pass batch variance (the fixed model has no fused
epilogue), so what differs is f32 summation order in the convolutions.
Tolerances, measured on an x86 CPU (worst seen in brackets): logits of
scale up to ~17 rtol 1e-4 / atol 1e-4 in both modes [2.9e-5 abs in eval,
2.3e-5 in train], running stats rtol 1e-4 / atol 5e-5 [1.0e-5]; the
supernet's train-mode parity takes the same atol (test_torch_supernet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_torch import convert
from senas_torch.core.genotype import Genotype
from senas_torch.models import geno_searched as tgs
from senas_torch.models.factory import get_segmentation_model
from senas_torch.models.senas_model import SenasModel

from torch_port_util import assert_trees_close, flat, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

C, D, B = 8, 3, 2
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=5e-5)
CASES = [("senas_node_2", False, False, 32), ("senas_node_2", True, False, 32),
         ("senas_node_3", False, False, 32), ("senas_node_3", True, False, 32),
         ("senas_node_4", False, False, 32), ("senas_node_4", True, False, 32),
         ("senas_node_4", False, True, 64)]
IDS = [f"{g}-sup{int(s)}-dd{int(d)}-{hw}" for g, s, d, hw in CASES]


def _pair(geno, supervision, double_down, hw, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, hw, hw, 1).astype(np.float32)
    jm = JModel(nclass=2, in_channels=1, c=C, depth=D, supervision=supervision,
                genotype=getattr(jgs, geno), double_down_channel=double_down)
    variables = random_variables(jm, rng, jnp.asarray(x), False)
    tm = SenasModel(nclass=2, in_channels=1, c=C, depth=D, supervision=supervision,
                    genotype=getattr(tgs, geno), double_down_channel=double_down,
                    device="cpu")
    return jm, variables, convert.load_variables(tm, variables), x


@pytest.mark.parametrize("geno,supervision,double_down,hw", CASES, ids=IDS)
def test_eval_logits_match(geno, supervision, double_down, hw):
    jm, variables, tm, x = _pair(geno, supervision, double_down, hw)
    want = jm.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    assert len(got) == len(want) >= 1 + supervision
    for g, w in zip(got, want):
        assert g.shape == (B, hw, hw, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)


@pytest.mark.parametrize("geno,supervision,double_down,hw", CASES, ids=IDS)
def test_train_logits_and_running_stats_match(geno, supervision, double_down, hw):
    jm, variables, tm, x = _pair(geno, supervision, double_down, hw, seed=1)
    want, mut = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    assert_trees_close(convert.state_dict_to_variables(tm)["batch_stats"],
                       mut["batch_stats"], **STATS_TOL)


def test_weight_tree_round_trips():
    _, variables, tm, _ = _pair("senas_node_4", False, True, 32)
    back = convert.state_dict_to_variables(tm)
    assert_trees_close(back["params"], variables["params"], rtol=0, atol=0)
    assert_trees_close(back["batch_stats"], variables["batch_stats"], rtol=0, atol=0)


def test_gamma_pruned_cells_are_not_built():
    g = tgs.senas_node_4
    base = dict(down=g.down, down_concat=g.down_concat, up=g.up, up_concat=g.up_concat)
    ups = {}
    for gamma in ([1] * 6, [0] * 6, [0, 0, 1, 1, 1, 1]):
        m = SenasModel(nclass=2, in_channels=1, c=4, depth=4,
                       genotype=Genotype(**base, gamma=gamma), device="cpu")
        ups[tuple(gamma)] = sorted(n for n, _ in m.named_children() if n.startswith("up_"))
        with torch.no_grad():
            assert m(torch.randn(1, 32, 32, 1))[0].shape == (1, 32, 32, 2)
    assert len(ups[(1,) * 6]) == 6
    # only the last diagonal (i + j == depth - 1) survives gamma all zero;
    # gamma[sum(range(i + j)) + j] switches cell (i, j) off the diagonal
    assert ups[(0,) * 6] == ["up_1_2", "up_2_1", "up_3_0"]
    assert ups[(0, 0, 1, 1, 1, 1)] == ["up_1_1", "up_1_2", "up_2_1", "up_3_0"]


def test_genotype_constants_equal_jax():
    for name in ("senas_node_2", "senas_node_3", "senas_node_4", "senas"):
        assert repr(getattr(tgs, name)) == repr(getattr(jgs, name))


def test_factory():
    m = get_segmentation_model("senas", dataset="synthetic", c=4, depth=2,
                               genotype=tgs.senas, device="cpu")
    assert isinstance(m, SenasModel)
    # the baseline zoo is ported since (tests/test_torch_zoo.py holds it)
    from senas_torch.models.zoo import Unet
    assert isinstance(get_segmentation_model("unet", dataset="synthetic", depth=3,
                                             device="cpu"), Unet)
    with pytest.raises(KeyError):
        get_segmentation_model("no_such_model", dataset="synthetic", device="cpu")


@pytest.mark.parametrize("knob,match", [({"dropout_prob": 0.1}, "rng")])
def test_unported_knobs_raise(knob, match):
    """`dropout_prob` above 0 is ported (tests/test_torch_dropout.py holds
    it to senas_tpu): the model builds, and a train-mode forward without
    the step's generator raises, as flax does without a 'dropout' key."""
    model = SenasModel(nclass=2, in_channels=1, c=4, depth=2, genotype=tgs.senas,
                       device="cpu", **knob)
    with pytest.raises(ValueError, match=match):
        model(torch.zeros(1, 8, 8, 1), train=True)


def test_kernel_init_stds_match_jax():
    """Each kernel leaf's std, pooled over 8 seeds of each package, within 4
    standard errors + 2% of the std the port states for it (the rule of
    tests/test_torch_init.py), for every op kind of senas_node_3/4: the
    transposed and depthwise-transposed UP ops included."""
    seeds = 8
    for geno in ("senas_node_3", "senas_node_4"):
        jm = JModel(nclass=2, in_channels=1, c=16, depth=D, genotype=getattr(jgs, geno))
        init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, 16, 16, 1)), False))
        j = [flat(init(jax.random.PRNGKey(s))["params"]) for s in range(seeds)]
        t, stated = [], {}
        for s in range(seeds):
            tm = SenasModel(nclass=2, in_channels=1, c=16, depth=D,
                            genotype=getattr(tgs, geno), device="cpu",
                            generator=torch.Generator().manual_seed(s))
            t.append(flat(convert.state_dict_to_variables(tm)["params"]))
        for name, m in tm.named_modules():
            for leaf, std in m.__dict__.get("init_std", {}).items():
                stated[f"{name}.{leaf}".replace(".", "/")] = std
        assert set(stated) == {k for k, v in t[0].items() if v.ndim > 1}
        for k, std in stated.items():
            for runs in (j, t):
                vals = np.concatenate([r[k].ravel() for r in runs])
                tol = 4.0 / np.sqrt(2 * vals.size) + 0.02
                assert abs(vals.std() / std - 1) <= tol, (geno, k, vals.std(), std)


def test_model_needs_the_card_unless_told():
    """device=None means "cuda"; with no card that raises, never a silent
    CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SenasModel(nclass=2, in_channels=1, c=4, depth=2, genotype=tgs.senas)
    with pytest.raises(RuntimeError, match="cuda"):
        get_segmentation_model("senas", dataset="synthetic", c=4, depth=2,
                               genotype=tgs.senas)
