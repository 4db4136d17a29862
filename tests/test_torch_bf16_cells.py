"""GroupedMixedOp and FusedSearchCell in bf16: senas_torch's with
dtype=torch.bfloat16 against senas_tpu's with dtype=jnp.bfloat16 on the
CPU, from the same f32 weights and inputs.

GroupedMixedOp runs twice on the JAX side: with SENAS_PALLAS_EPILOGUE unset
(the JAX CPU default, the unfused branch path: each branch's BN output
rounded to bf16, then the bf16 alpha mix) and at "1" (the Pallas epilogue
in interpret mode: the mix in f32 from the pre-BN tensors, rounded once,
which is what the port's epilogue computes).

The bound, for every compared tensor (a group's or a cell's output, the
running stats): the relative L2 distance between the two packages' bf16
results is at most twice the JAX package's bf16 result's distance from
its f32 result (bf16's own error), plus 1e-6. The control: each bf16
output is torch.bfloat16 and fails 100 times the f32 parity tolerance of
the matching f32 test (GroupedMixedOp rtol/atol 2e-5, the cell rtol 5e-4 /
atol 5e-5, tests/test_torch_fused_cell.py). Worst seen on an x86 CPU: the
gap at 0.63 of its bound (the down cell in train mode), a group's output at
0.46; a NORM group against the Pallas epilogue equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops.primitives import OpType as JOpType
from senas_tpu.search import fused_cell as jfc
from senas_torch import convert
from senas_torch.ops.primitives import OpType as TOpType
from senas_torch.search.fused_cell import FusedSearchCell, GroupedMixedOp

from torch_port_util import (assert_bf16_computed, assert_bf16_network, flat_leaves, nchw, nhwc,
                             random_variables)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B, E = 2, 3
BF = torch.bfloat16
# the f32 parity tolerances of tests/test_torch_fused_cell.py
GROUP_TOL = dict(rtol=2e-5, atol=2e-5)
CELL_TOL = dict(rtol=5e-4, atol=5e-5)


def _round(a):
    """f32 numpy array of bf16 values."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("op_type", ["NORM", "DOWN", "UP"])
def test_grouped_mixed_op_bf16(op_type, train, pallas, monkeypatch):
    c_in, p, hw = 8, 4, 8
    rng = np.random.RandomState(0)
    x = _round(rng.randn(B, hw, hw, c_in))
    al = rng.rand(E, 6).astype(np.float32)
    al /= al.sum(-1, keepdims=True)
    mk = lambda dt: jfc.GroupedMixedOp(c_in=c_in, c_part=p, num_edges=E,
                                       op_type=getattr(JOpType, op_type), dtype=dt)
    monkeypatch.delenv("SENAS_PALLAS_EPILOGUE", raising=False)
    variables = random_variables(mk(None), rng, jnp.asarray(x), jnp.asarray(al), False)
    if pallas:
        monkeypatch.setenv("SENAS_PALLAS_EPILOGUE", "1")
    want = {}
    for name, dt, xin in (("bf16", jnp.bfloat16, jnp.asarray(x).astype(jnp.bfloat16)),
                          ("f32", None, jnp.asarray(x))):
        out, mut = mk(dt).apply(variables, xin, jnp.asarray(al), train, mutable=["batch_stats"])
        want[name] = (np.asarray(out.astype(jnp.float32)).reshape(B, *out.shape[1:3], E * p),
                      mut.get("batch_stats", {}))
    assert out.dtype == jnp.float32
    got = {}
    for name, dt in (("bf16", BF), ("f32", None)):
        tm = convert.load_variables(GroupedMixedOp(c_in, p, E, getattr(TOpType, op_type),
                                                   dtype=dt), variables)
        y = tm(nchw(x).to(dt or torch.float32), torch.from_numpy(al), train=train)
        assert y.dtype == (dt or torch.float32)
        got[name] = (nhwc(y.float()), convert.state_dict_to_variables(tm).get("batch_stats", {}))
    assert_bf16_network(got["bf16"][0], want["bf16"][0], want["f32"][0], what="output")
    if train:
        assert_bf16_network(flat_leaves(got["bf16"][1]), flat_leaves(want["bf16"][1]),
                            flat_leaves(want["f32"][1]), what="running stats")
    assert_bf16_computed(got["bf16"][0], got["f32"][0], **GROUP_TOL)


@pytest.mark.parametrize("cell_type", ["down", "up"])
def test_fused_cell_bf16(cell_type):
    M, C, c_out = 2, 8, 8
    rng = np.random.RandomState(1)
    c0 = C if cell_type == "down" else 24
    in0, in1 = _round(rng.randn(B, 16, 16, c0)), _round(rng.randn(B, 8, 8, C))
    k = sum(2 + i for i in range(M))
    wn, wc, betas = (rng.rand(k, 6).astype(np.float32), rng.rand(k, 6).astype(np.float32),
                     rng.rand(k).astype(np.float32))
    jargs = [jnp.asarray(a) for a in (in0, in1, wn, wc, betas)]
    mk = lambda dt: jfc.FusedSearchCell(M, 1, c0, C, c_out, cell_type, dtype=dt)
    variables = random_variables(mk(None), rng, *jargs, False)
    targs = (nchw(in0), nchw(in1), *(torch.from_numpy(a) for a in (wn, wc, betas)))
    for train in (False, True):
        want = {name: np.asarray(mk(dt).apply(variables, *jargs, train, mutable=["batch_stats"])[0]
                                 .astype(jnp.float32))
                for name, dt in (("bf16", jnp.bfloat16), ("f32", None))}
        got = {}
        for name, dt in (("bf16", BF), ("f32", None)):
            cell = convert.load_variables(FusedSearchCell(M, 1, c0, C, c_out, cell_type,
                                                          dtype=dt), variables)
            with torch.no_grad():
                y = cell(*targs, train=train)
            assert y.dtype == (dt or torch.float32)
            got[name] = nhwc(y.float())
        assert_bf16_network(got["bf16"], want["bf16"], want["f32"], what=f"train={train}")
        assert_bf16_computed(got["bf16"], got["f32"], **CELL_TOL)
