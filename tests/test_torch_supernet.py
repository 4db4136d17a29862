"""The slice as a whole: senas_torch's SenasSearch, eval step, arch
normalisation and genotype derivation against senas_tpu on the CPU, at a
small size (meta_node_num 3, depth 3, c 8, 32x32, batch 2).

The JAX side runs its CPU default (epilogue off, the same math as the
kernels' plain versions) eagerly, to keep XLA:CPU compile time low.
Tolerance for logits: rtol 2e-4 / atol 2e-5, the repo's own supernet
parity tolerance (tests/test_search_parity.py). In train mode the port
normalises by the epilogue's one-sweep variance E[x^2]-mu^2, the JAX CPU
path by the two-pass one; over 15 chained groups that moves logits of
scale ~1 by up to ~2e-5, so train mode takes atol 1e-4. The integer
confusion counts must be exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.search import supernet as jsn
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.trainer import make_search_eval_step as jmake_eval
from senas_torch import convert
from senas_torch.search import supernet as tsn
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import make_search_eval_step as tmake_eval

from torch_port_util import assert_trees_close, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

M, D, C, HW, B = 3, 3, 8, 32, 2
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
TRAIN_LOGIT_TOL = dict(rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    # distinct random betas: a "fixed" (disjoint) beta grouping would fail
    arch = {k: rng.randn(*v).astype(np.float32)
            for k, v in jsn.arch_param_count(M, D).items()}
    x = rng.randn(B, HW, HW, 1).astype(np.float32)
    label = (rng.rand(B, HW, HW) > 0.6).astype(np.int32)
    jm = jsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M)
    variables = random_variables(jm, rng, jnp.asarray(x),
                                 jsn.normalize_arch(arch, M), False)
    return dict(arch=arch, x=x, label=label, jm=jm, variables=variables)


def _port(nets):
    tm = tsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                         device="cpu")
    return convert.load_variables(tm, nets["variables"])


def test_normalize_arch_matches(nets):
    want = jsn.normalize_arch(nets["arch"], M)
    got = tsn.normalize_arch(convert.arch_to_torch(nets["arch"], "cpu"), M)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_eval_logits_match(nets):
    tm = _port(nets)
    aw = tsn.normalize_arch(convert.arch_to_torch(nets["arch"], "cpu"), M)
    want = nets["jm"].apply(nets["variables"], jnp.asarray(nets["x"]),
                            jsn.normalize_arch(nets["arch"], M), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(nets["x"]), aw, train=False)
    assert len(got) == len(want) == 1
    assert got[0].shape == (B, HW, HW, 2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **LOGIT_TOL)


def test_train_forward_logits_and_batch_stats_match(nets):
    tm = _port(nets)
    aw = tsn.normalize_arch(convert.arch_to_torch(nets["arch"], "cpu"), M)
    want, mut = nets["jm"].apply(nets["variables"], jnp.asarray(nets["x"]),
                                 jsn.normalize_arch(nets["arch"], M), True,
                                 mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(nets["x"]), aw, train=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TRAIN_LOGIT_TOL)
    assert_trees_close(convert.state_dict_to_variables(tm)["batch_stats"],
                       mut["batch_stats"], rtol=2e-4, atol=1e-5)


def test_search_eval_step_metrics_match(nets):
    tm = _port(nets)
    batch = {"image": nets["x"], "label": nets["label"]}
    jstep = jmake_eval(nets["jm"].apply, lambda a: jsn.normalize_arch(a, M),
                       jbuild_loss("dice_ce"))
    # the step's body without jax.jit: eager op-by-op dispatch reuses the
    # compiles of the other tests instead of compiling the whole graph
    want = jstep.__wrapped__(nets["variables"]["params"],
                             nets["variables"]["batch_stats"], nets["arch"],
                             {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = tmake_eval(tm, lambda a: tsn.normalize_arch(a, M), tbuild_loss("dice_ce"))
    got = tstep(convert.arch_to_torch(nets["arch"], "cpu"),
                {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == {"loss", "tp", "fp", "fn", "acc"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["acc"]), float(want["acc"]), rtol=1e-6)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("in_channels", [1, 3])
def test_branch_tensors_reach_the_epilogue_nchw_contiguous(in_channels, monkeypatch):
    """The kernels take NCHW-contiguous tensors; a single-channel NHWC image
    must not leave the network in channels_last strides."""
    from senas_torch.search import fused_cell
    strides = []
    inner = fused_cell.fused_group_epilogue

    def spy(xs, *args, **kw):
        strides.extend((x.is_contiguous(), x.stride()) for x in xs)
        return inner(xs, *args, **kw)

    monkeypatch.setattr(fused_cell, "fused_group_epilogue", spy)
    tm = tsn.SenasSearch(in_channels=in_channels, c=4, nclass=2, depth=2,
                         meta_node_num=2, device="cpu")
    arch = tsn.init_arch_params(2, 2, generator=torch.Generator(), device="cpu")
    with torch.no_grad():
        tm(torch.randn(1, 16, 16, in_channels), tsn.normalize_arch(arch, 2))
    assert strides and all(ok for ok, _ in strides), strides


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("meta,depth", [(3, 3), (3, 5), (2, 4)])
def test_derive_genotype_identical(seed, meta, depth):
    rng = np.random.RandomState(seed)
    arch = {k: rng.randn(*v).astype(np.float32)
            for k, v in jsn.arch_param_count(meta, depth).items()}
    want = jsn.derive_genotype(arch, meta, depth)
    got = tsn.derive_genotype(convert.arch_to_torch(arch, "cpu"), meta, depth)
    assert repr(got) == repr(want)
    shared = {k: v for k, v in arch.items() if k != "alphas_up_nm"}
    assert repr(tsn.derive_genotype(shared, meta, depth)) == \
        repr(jsn.derive_genotype(shared, meta, depth))


def test_init_arch_params_shapes_and_sharing():
    gen = torch.Generator().manual_seed(0)
    arch = tsn.init_arch_params(3, 5, use_sharing=False, generator=gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in arch.items()} == jsn.arch_param_count(3, 5)
    shared = tsn.init_arch_params(3, 5, use_sharing=True, generator=gen, device="cpu")
    assert "alphas_up_nm" not in shared
    aw = tsn.normalize_arch(shared, 3)
    assert torch.equal(aw["alphas_up_nm"], aw["alphas_dn_nm"])


def test_entry_points_need_the_card_unless_told():
    """device=None means "cuda"; with no card that raises, never a silent
    CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tsn.SenasSearch(in_channels=1, c=4, nclass=2, depth=2, meta_node_num=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tsn.init_arch_params(2, 2, generator=torch.Generator())
