"""The epilogue in bf16: the plain twins of K1a-K1d and the port's
`fused_group_epilogue` (its autograd Function, which on the CPU runs the
twins) on bf16 branch tensors, against the JAX package's Pallas kernels and
custom-VJP epilogue in interpret mode on the same bf16 values.

Both sides widen each bf16 value to f32, sum and multiply in f32, and round
a bf16 result once. Tolerances: the f32 sums (s1, s2, dA, dK) and the
batch stats rtol/atol 1e-5, as in f32 (summation order only); each bf16
output (`mixed`, dx_o) equals JAX's except on at most 1e-3 of its elements,
and there by at most one bf16 ulp (the two packages' f32 sums round the
other way on a tie-near value); the f32 parameter gradients rtol 2e-4 /
atol 2e-5, the f32 gradient tolerance (tests/test_torch_epilogue_backward.py).
Worst seen on an x86 CPU: 6.5e-4 of a bf16 output's elements differ from
JAX's (a dx of n 6), each by one ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops import grouped_epilogue as jge
from senas_torch.ops import grouped_epilogue as tge

from torch_port_util import assert_bf16_bits, epilogue_case, nchw, nhwc
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B, H, W, E, P = 2, 8, 4, 3, 8
C = E * P
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
_DIFF = ("se_w1", "se_w2", "none_alpha_col", "none_bias")


def _bf16(seed, n):
    """n branch tensors and a cotangent, NHWC f32 arrays holding bf16 values,
    and the random state that made them."""
    rng = np.random.RandomState(seed)
    round_ = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    xs = [round_(rng.randn(B, H, W, C) * (1 + o) + 0.5 * o) for o in range(n)]
    return rng, xs, round_(rng.randn(B, H, W, C))


def _jflat(a):
    return jnp.asarray(a).astype(jnp.bfloat16).reshape(B, H, W * C)


def _tb(a):
    return nchw(a).to(torch.bfloat16)


@pytest.mark.parametrize("n", [1, 6])
def test_branch_stats_plain_bf16_matches_jax_kernel(n):
    _, xs, _ = _bf16(n, n)
    s1, s2 = jge._branch_stats([_jflat(x) for x in xs], interpret=True)
    got1, got2 = tge.branch_stats_plain([_tb(x) for x in xs])
    assert got1.dtype == got2.dtype == torch.float32
    np.testing.assert_allclose(got1.numpy(), np.asarray(s1).reshape(n, B, W, C).sum(2), **TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(s2).reshape(n, B, W, C).sum(2), **TOL)


@pytest.mark.parametrize("n", [1, 6])
def test_apply_mix_plain_bf16_matches_jax_kernel(n):
    rng, xs, _ = _bf16(10 + n, n)
    a = rng.randn(n, B, C).astype(np.float32)
    k = rng.randn(B, C).astype(np.float32)
    want = jge._apply_mix([_jflat(x) for x in xs], jnp.asarray(np.tile(a, (1, 1, W))),
                          jnp.asarray(np.tile(k, (1, W))), jnp.bfloat16, interpret=True)
    got = tge.apply_mix_plain([_tb(x) for x in xs], torch.from_numpy(a), torch.from_numpy(k))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_bits(nhwc(got.float()), np.asarray(want.astype(jnp.float32)).reshape(B, H, W, C),
                     what="apply_mix")


@pytest.mark.parametrize("n", [1, 5, 6])
def test_bwd_reduce_plain_bf16_matches_jax_kernel(n):
    _, xs, g = _bf16(20 + n, n)
    da, dk = jge._bwd_reduce([_jflat(x) for x in xs], _jflat(g), interpret=True)
    got_a, got_k = tge.bwd_reduce_plain([_tb(x) for x in xs], _tb(g))
    assert got_a.dtype == got_k.dtype == torch.float32
    np.testing.assert_allclose(got_a.numpy(), np.asarray(da).reshape(n, B, W, C).sum(2), **TOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(dk).reshape(B, W, C).sum(1), **TOL)


@pytest.mark.parametrize("n", [1, 5, 6])
def test_bwd_dx_plain_bf16_matches_jax_kernel(n):
    rng, xs, g = _bf16(30 + n, n)
    a, ds1, ds2 = (rng.randn(n, B, C).astype(np.float32) for _ in range(3))
    tile = lambda v: jnp.asarray(np.tile(v, (1, 1, W)))
    want = jge._bwd_dx([_jflat(x) for x in xs], _jflat(g), tile(a), tile(ds1), tile(ds2),
                       interpret=True)
    got = tge.bwd_dx_plain([_tb(x) for x in xs], _tb(g), torch.from_numpy(a),
                           torch.from_numpy(ds1), torch.from_numpy(ds2))
    for o in range(n):
        assert got[o].dtype == torch.bfloat16 and want[o].dtype == jnp.bfloat16
        assert_bf16_bits(nhwc(got[o].float()),
                         np.asarray(want[o].astype(jnp.float32)).reshape(B, H, W, C),
                         what=f"dx {o}")


def _bf16_case(seed, n, se, none, train):
    jargs, jkw, targs, tkw = epilogue_case(seed, n, se, none, train)
    jargs = ([x.astype(jnp.bfloat16) for x in jargs[0]], *jargs[1:])
    targs = ([x.to(torch.bfloat16) for x in targs[0]], *targs[1:])
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("se,none", [(True, True), (False, False)])
def test_epilogue_bf16_matches_jax(se, none, train):
    jargs, jkw, targs, tkw = _bf16_case(40, 4, se, none, train)
    want, (jmu, jvar) = jge.fused_group_epilogue(*jargs, interpret=True, **jkw)
    got, (mu, var) = tge.fused_group_epilogue(*targs, **tkw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_bits(nhwc(got.float()), np.asarray(want.astype(jnp.float32)), what="mixed")
    if train:
        assert mu.dtype == var.dtype == torch.float32
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **TOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **TOL)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("se,none", [(True, True), (False, False)])
def test_function_gradients_bf16_match_jax(se, none, train):
    """A bf16 cotangent through both packages' VJPs: the branch gradients
    come back bf16 (K1d's output), the parameters' f32."""
    jargs, jkw, targs, tkw = _bf16_case(50, 4, se, none, train)
    readout = np.random.RandomState(98).randn(B, H, W, C).astype(np.float32)
    jdiff = {"xs": jargs[0], "scales": jargs[1], "biases": jargs[2], "alphas": jargs[3],
             **{k: jkw[k] for k in _DIFF if k in jkw}}
    jrest = {k: v for k, v in jkw.items() if k not in _DIFF}

    def jmixed(d):
        return jge.fused_group_epilogue(d["xs"], d["scales"], d["biases"], d["alphas"],
                                        interpret=True, **jrest,
                                        **{k: d[k] for k in _DIFF if k in d})[0]

    out, vjp = jax.vjp(jmixed, jdiff)
    want = vjp(jnp.asarray(readout).astype(out.dtype))[0]

    tdiff = {"xs": targs[0], "scales": targs[1], "biases": targs[2], "alphas": targs[3],
             **{k: tkw[k] for k in _DIFF if k in tkw}}
    leaves = [t.requires_grad_() for v in tdiff.values()
              for t in (v if isinstance(v, list) else [v])]
    mixed, _ = tge.fused_group_epilogue(*targs, **tkw)
    torch.autograd.backward(mixed, nchw(readout).to(torch.bfloat16))
    assert all(t.grad is not None for t in leaves)
    for name, v in tdiff.items():
        got = v if isinstance(v, list) else [v]
        ref = want[name] if isinstance(want[name], list) else [want[name]]
        for i, (t, gw) in enumerate(zip(got, ref)):
            if name == "xs":
                assert t.grad.dtype == torch.bfloat16 and gw.dtype == jnp.bfloat16
                assert_bf16_bits(nhwc(t.grad.float()), np.asarray(gw.astype(jnp.float32)),
                                 what=f"dx {i} train={train}")
            else:
                assert t.grad.dtype == torch.float32
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(gw), **GRAD_TOL,
                                           err_msg=f"{name}[{i}] train={train}")


def test_cpu_wrappers_take_the_bf16_twins():
    """On the CPU each wrapper returns its twin's bf16 (or f32-sum) result
    and counts no launch, in all or for bf16."""
    rng, xs, g = _bf16(60, 3)
    xs, g = [_tb(x) for x in xs], _tb(g)
    a, k = torch.from_numpy(rng.randn(3, B, C).astype(np.float32)), torch.zeros(B, C)
    wrappers = (tge.branch_stats, tge.apply_mix, tge.bwd_reduce, tge.bwd_dx)
    before = [(f.launches, dict(f.launches_by_dtype)) for f in wrappers]
    for got, want in zip(tge.branch_stats(xs), tge.branch_stats_plain(xs)):
        assert torch.equal(got, want)
    mixed = tge.apply_mix(xs, a, k)
    assert mixed.dtype == torch.bfloat16 and torch.equal(mixed, tge.apply_mix_plain(xs, a, k))
    for got, want in zip(tge.bwd_reduce(xs, g), tge.bwd_reduce_plain(xs, g)):
        assert torch.equal(got, want)
    for got, want in zip(tge.bwd_dx(xs, g, a, a, a), tge.bwd_dx_plain(xs, g, a, a, a)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert [(f.launches, f.launches_by_dtype) for f in wrappers] == before
    assert all(set(f.launches_by_dtype) == {"float32", "bfloat16"} for f in wrappers)
