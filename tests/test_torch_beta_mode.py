"""beta_mode: the beta softmax groups of the port against senas_tpu's.

"reference" keeps the reference's overlapping groups (node i's starts at
i), "grouped" gives disjoint ones (starting at sum(2 + j for j < i)).
`normalize_arch` and `derive_genotype` are held to the JAX package's in
both modes on random tables (within rtol 1e-6: both softmax in f32; the
genotypes identical), a search step with "grouped" at
tests/test_torch_search_step.py's limits, and SearchRunner with
`beta_mode: grouped` for one epoch on the CPU."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.search import supernet as jsn
from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.core.genotype import parse_genotype
from senas_torch.runner.search import SearchRunner
from senas_torch.search import supernet as tsn

from torch_port_util import assert_search_steps_match, search_step_pair
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
MODES = ("reference", "grouped")


def _tables(M, D, seed):
    rng = np.random.RandomState(seed)
    return {k: (2.0 * rng.randn(*v)).astype(np.float32)
            for k, v in jsn.arch_param_count(M, D).items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("mode", MODES)
def test_normalize_and_derive_match(mode, M, seed):
    D = 4
    arch = _tables(M, D, seed)
    want = jsn.normalize_arch({k: jnp.asarray(v) for k, v in arch.items()}, M, mode)
    got = tsn.normalize_arch(convert.arch_to_torch(arch, "cpu"), M, mode)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert repr(tsn.derive_genotype(arch, M, D, beta_mode=mode)) == repr(
        jsn.derive_genotype(arch, M, D, beta_mode=mode))


@pytest.mark.parametrize("M", [2, 3, 4])
def test_grouped_differs_from_reference(M):
    arch = convert.arch_to_torch(_tables(M, 4, 3), "cpu")
    ref, grp = (tsn.normalize_arch(arch, M, mode)["betas_dn"] for mode in MODES)
    assert ref.shape == grp.shape == (sum(2 + i for i in range(M)),)
    assert not torch.allclose(ref, grp)
    # the grouped softmaxes sum to one over disjoint groups covering every beta
    starts = [tsn.beta_group_start(i, "grouped") for i in range(M)]
    for i, s in enumerate(starts):
        assert float(grp[s:s + 2 + i].sum()) == pytest.approx(1.0, abs=1e-6)
    assert starts[-1] + M + 1 == arch["betas_dn"].numel()


def test_unknown_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="beta_mode"):
        tsn.normalize_arch(convert.arch_to_torch(_tables(2, 2, 0), "cpu"), 2, "flat")
    cfg = load_config(CONFIG)
    cfg["searching"]["beta_mode"] = "flat"
    with pytest.raises(ValueError, match="beta_mode"):
        SearchRunner(cfg, log_root=str(tmp_path), device="cpu")


def test_grouped_search_step_matches():
    s = load_config(CONFIG)["searching"]
    runs = search_step_pair(s["model_optimizer"], s["arch_optimizer"], beta_mode="grouped")
    assert_search_steps_match(runs, beta_mode="grouped")


def test_search_runner_with_grouped_betas(tmp_path):
    cfg = load_config(CONFIG)
    cfg["searching"].update(beta_mode="grouped", epoch=1)
    runner = SearchRunner(copy.deepcopy(cfg), log_root=str(tmp_path), device="cpu")
    best = runner.run()
    assert repr(parse_genotype(best)) == best
    assert best == repr(tsn.derive_genotype(runner.state.arch, runner.meta_node_num,
                                            runner.depth, beta_mode="grouped"))
    with open(os.path.join(runner.run_dir, "run.log")) as f:
        assert "beta_mode = grouped" in f.read()
