"""senas_torch.search.fused_cell against senas_tpu.search.fused_cell on the
CPU, where the port's epilogue runs its plain versions.

GroupedMixedOp runs twice on the JAX side: with SENAS_PALLAS_EPILOGUE unset
(the JAX CPU default, the unfused branch path) and set to 1 (the Pallas
epilogue in interpret mode). Tolerance rtol/atol 2e-5, as
tests/test_grouped_epilogue_integration.py holds the two JAX paths; whole
cells 5e-4 / 5e-5, as tests/test_fused_cell.py holds the fused cell to the
naive one (more convs and BNs chained, f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops.primitives import OpType as JOpType
from senas_tpu.search import fused_cell as jfc
from senas_torch import convert
from senas_torch.ops.primitives import OpType as TOpType
from senas_torch.search.cell import SearchCell
from senas_torch.search.fused_cell import FusedSearchCell, GroupedMixedOp

from torch_port_util import (assert_trees_close, fused_cell_to_naive, nchw,
                             nhwc, random_variables)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B, E = 2, 3
GROUP_TOL = dict(rtol=2e-5, atol=2e-5)
STATS_TOL = dict(rtol=2e-5, atol=1e-6)
CELL_TOL = dict(rtol=5e-4, atol=5e-5)
OPS = {t: list(getattr(TOpType, t).value["ops"]) for t in ("DOWN", "UP", "NORM")}


def _alphas(rng, n_ops):
    a = rng.rand(E, n_ops).astype(np.float32)
    return a / a.sum(-1, keepdims=True)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("op_type,c_in,p", [("NORM", 8, 4), ("DOWN", 8, 4),
                                            ("UP", 8, 4), ("NORM", 4, 4)])
def test_grouped_mixed_op_matches_jax(op_type, c_in, p, train, pallas, monkeypatch):
    rng = np.random.RandomState(0)
    hw = 8
    x = rng.randn(B, hw, hw, c_in).astype(np.float32)
    al = _alphas(rng, 6)
    jm = jfc.GroupedMixedOp(c_in=c_in, c_part=p, num_edges=E,
                            op_type=getattr(JOpType, op_type))
    monkeypatch.delenv("SENAS_PALLAS_EPILOGUE", raising=False)
    variables = random_variables(jm, rng, jnp.asarray(x), jnp.asarray(al), False)
    if not train:
        # one JAX train-mode pass, so that eval mode reads moved running stats
        _, mut = jm.apply(variables, jnp.asarray(x), jnp.asarray(al), True,
                          mutable=["batch_stats"])
        variables = {"params": variables["params"], **mut}
    tm = convert.load_variables(
        GroupedMixedOp(c_in, p, E, getattr(TOpType, op_type)), variables)

    if pallas:
        monkeypatch.setenv("SENAS_PALLAS_EPILOGUE", "1")
    want, mut = jm.apply(variables, jnp.asarray(x), jnp.asarray(al), train,
                         mutable=["batch_stats"])
    got = tm(nchw(x), torch.from_numpy(al), train=train)
    want = np.asarray(want).reshape(*want.shape[:3], E * p)
    np.testing.assert_allclose(nhwc(got), want, **GROUP_TOL)
    assert_trees_close(convert.state_dict_to_variables(tm)["batch_stats"],
                       mut["batch_stats"], **STATS_TOL)


def _cell_inputs(rng, cell_type, c, M):
    c0 = c if cell_type == "down" else 24
    in0 = rng.randn(B, 16, 16, c0).astype(np.float32)
    in1 = rng.randn(B, 8, 8, c).astype(np.float32)
    k = sum(2 + i for i in range(M))
    wn = rng.rand(k, 6).astype(np.float32)
    wc = rng.rand(k, 6).astype(np.float32)
    betas = rng.rand(k).astype(np.float32)
    return in0, in1, wn, wc, betas


@pytest.mark.parametrize("cell_type", ["down", "up"])
def test_fused_cell_matches_jax(cell_type):
    M, C, c_out = 3, 8, 8
    rng = np.random.RandomState(1)
    in0, in1, wn, wc, betas = _cell_inputs(rng, cell_type, C, M)
    jargs = [jnp.asarray(a) for a in (in0, in1, wn, wc, betas)]
    jcell = jfc.FusedSearchCell(M, 1, in0.shape[-1], C, c_out, cell_type)
    variables = random_variables(jcell, rng, *jargs, False)
    tcell = convert.load_variables(
        FusedSearchCell(M, 1, in0.shape[-1], C, c_out, cell_type), variables)
    targs = (nchw(in0), nchw(in1), *(torch.from_numpy(a) for a in (wn, wc, betas)))
    for train in (False, True):
        want, mut = jcell.apply(variables, *jargs, train, mutable=["batch_stats"])
        got = tcell(*targs, train=train)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **CELL_TOL,
                                   err_msg=f"train={train}")
    assert_trees_close(convert.state_dict_to_variables(tcell)["batch_stats"],
                       mut["batch_stats"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell_type", ["down", "up"])
def test_fused_cell_matches_naive_cell(cell_type):
    """The port's grouped cell against its own per-edge SearchCell, with the
    grouped variables sliced per edge (tests/test_fused_cell.py's map)."""
    M, C, c_out = 3, 8, 8
    P = c_out // 4
    rng = np.random.RandomState(2)
    in0, in1, wn, wc, betas = _cell_inputs(rng, cell_type, C, M)
    fused = FusedSearchCell(M, 1, in0.shape[-1], C, c_out, cell_type)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in fused.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        for name, buf in fused.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + (0.5 if name.endswith("var") else -0.5))
    naive = SearchCell(M, 1, in0.shape[-1], C, c_out, cell_type)
    convert.load_variables(naive, fused_cell_to_naive(
        convert.state_dict_to_variables(fused), M, C, P, cell_type, OPS))
    targs = (nchw(in0), nchw(in1), *(torch.from_numpy(a) for a in (wn, wc, betas)))
    with torch.no_grad():
        for train in (False, True):
            np.testing.assert_allclose(nhwc(fused(*targs, train=train)),
                                       nhwc(naive(*targs, train=train)), **CELL_TOL,
                                       err_msg=f"train={train}")
