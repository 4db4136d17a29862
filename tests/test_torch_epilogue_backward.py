"""The epilogue's backward in senas_torch against the JAX package on the
CPU: the plain twins of K1c/K1d (`bwd_reduce_plain`, `bwd_dx_plain`)
against the Pallas kernels `_bwd_reduce`/`_bwd_dx` in interpret mode, and
the gradients of the port's `fused_group_epilogue` (its autograd Function,
which on the CPU runs the twins) against `jax.grad` of the JAX package's
custom-VJP epilogue in interpret mode, for every differentiable input, in
train and eval mode, with and without SE and the 'none' branch.

The JAX kernels work on [B,H,W*C] views: `_bwd_reduce` gives per-(b, w*c)
sums over H, which are folded over W here to the port's [n,B,C]; the
per-plane terms of `_bwd_dx` are tiled over W.

Tolerances: the twins rtol/atol 1e-5 (f32, summation order); gradients
rtol 2e-4 / atol 2e-5, the JAX suite's own gradient tolerance
(tests/test_grouped_epilogue.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops import grouped_epilogue as jge
from senas_torch.ops import grouped_epilogue as tge

from torch_port_util import epilogue_case, nchw, nhwc
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B, H, W, E, P = 2, 8, 4, 3, 8
C = E * P
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _branches(seed, n):
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(B, H, W, C) * (1 + o) + 0.5 * o).astype(np.float32) for o in range(n)]
    g = rng.randn(B, H, W, C).astype(np.float32)
    return rng, xs, g


@pytest.mark.parametrize("n", [1, 5, 6])
def test_bwd_reduce_plain_matches_jax_kernel(n):
    _, xs, g = _branches(n, n)
    da, dk = jge._bwd_reduce([jnp.asarray(x.reshape(B, H, W * C)) for x in xs],
                             jnp.asarray(g.reshape(B, H, W * C)), interpret=True)
    got_a, got_k = tge.bwd_reduce_plain([nchw(x) for x in xs], nchw(g))
    assert got_a.shape == (n, B, C) and got_k.shape == (B, C)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(da).reshape(n, B, W, C).sum(2),
                               **TOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(dk).reshape(B, W, C).sum(1),
                               **TOL)


@pytest.mark.parametrize("n", [1, 5, 6])
def test_bwd_dx_plain_matches_jax_kernel(n):
    rng, xs, g = _branches(10 + n, n)
    a, ds1, ds2 = (rng.randn(n, B, C).astype(np.float32) for _ in range(3))
    tile = lambda v: jnp.asarray(np.tile(v, (1, 1, W)))
    want = jge._bwd_dx([jnp.asarray(x.reshape(B, H, W * C)) for x in xs],
                       jnp.asarray(g.reshape(B, H, W * C)), tile(a), tile(ds1), tile(ds2),
                       interpret=True)
    got = tge.bwd_dx_plain([nchw(x) for x in xs], nchw(g), torch.from_numpy(a),
                           torch.from_numpy(ds1), torch.from_numpy(ds2))
    assert len(got) == n
    for o in range(n):
        np.testing.assert_allclose(nhwc(got[o]), np.asarray(want[o]).reshape(B, H, W, C),
                                   **TOL, err_msg=f"branch {o}")


_DIFF = ("se_w1", "se_w2", "none_alpha_col", "none_bias")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("se,none", [(True, True), (False, False),
                                     (True, False), (False, True)])
def test_function_gradients_match_jax(se, none, train):
    n = 4
    jargs, jkw, targs, tkw = epilogue_case(20, n, se, none, train)
    readout = np.random.RandomState(99).randn(B, H, W, C).astype(np.float32)

    # JAX: grad of the custom-VJP epilogue (its Pallas kernels interpreted)
    jdiff = {"xs": jargs[0], "scales": jargs[1], "biases": jargs[2], "alphas": jargs[3],
             **{k: jkw[k] for k in _DIFF if k in jkw}}
    jrest = {k: v for k, v in jkw.items() if k not in _DIFF}

    def jloss(d):
        out, _ = jge.fused_group_epilogue(
            d["xs"], d["scales"], d["biases"], d["alphas"], interpret=True, **jrest,
            **{k: d[k] for k in _DIFF if k in d})
        return jnp.sum(out * readout)

    want = jax.grad(jloss)(jdiff)

    # the port: autograd through _FusedEpilogue (the twins on the CPU)
    tdiff = {"xs": targs[0], "scales": targs[1], "biases": targs[2], "alphas": targs[3],
             **{k: tkw[k] for k in _DIFF if k in tkw}}
    leaves = [t.requires_grad_() for v in tdiff.values()
              for t in (v if isinstance(v, list) else [v])]
    out, _ = tge.fused_group_epilogue(*targs, **tkw)
    torch.autograd.backward((out * nchw(readout)).sum())
    assert all(t.grad is not None for t in leaves)

    for name, v in tdiff.items():
        got = [t.grad for t in (v if isinstance(v, list) else [v])]
        ref = want[name] if isinstance(want[name], list) else [want[name]]
        for i, (gt, gw) in enumerate(zip(got, ref)):
            gt = nhwc(gt) if name == "xs" else gt.numpy()
            np.testing.assert_allclose(gt, np.asarray(gw), **GRAD_TOL,
                                       err_msg=f"{name}[{i}] train={train}")


def test_function_gradients_with_channels_last_cotangent():
    """A cotangent in channels_last strides gives the same gradients as a
    contiguous one (the backward makes it NCHW-contiguous first)."""
    _, _, targs, tkw = epilogue_case(21, 3, True, True, True)
    readout = torch.from_numpy(np.random.RandomState(5).randn(B, C, H, W).astype(np.float32))
    grads = []
    for cl in (False, True):
        xs = [x.clone().requires_grad_() for x in targs[0]]
        out, _ = tge.fused_group_epilogue(xs, *targs[1:], **tkw)
        g = readout.contiguous(memory_format=torch.channels_last) if cl else readout
        assert g.is_contiguous() != cl
        grads.append(torch.autograd.grad(out, xs, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_batch_stats_take_no_gradient_in_eval_mode():
    _, _, targs, tkw = epilogue_case(22, 2, False, False, False)
    xs = [x.requires_grad_() for x in targs[0]]
    out, (mu, var) = tge.fused_group_epilogue(xs, *targs[1:], **tkw)
    assert out.requires_grad and not mu.requires_grad and not var.requires_grad
    torch.testing.assert_close(mu, torch.stack(tkw["run_means"]))


def test_cpu_backward_launches_nothing():
    rng, xs, g = _branches(30, 3)
    xs, g = [nchw(x) for x in xs], nchw(g)
    a, ds1, ds2 = (torch.from_numpy(rng.randn(3, B, C).astype(np.float32)) for _ in range(3))
    before = (tge.bwd_reduce.launches, tge.bwd_dx.launches)
    for got, want in zip(tge.bwd_reduce(xs, g), tge.bwd_reduce_plain(xs, g)):
        assert torch.equal(got, want)
    for got, want in zip(tge.bwd_dx(xs, g, a, ds1, ds2), tge.bwd_dx_plain(xs, g, a, ds1, ds2)):
        assert torch.equal(got, want)
    assert (tge.bwd_reduce.launches, tge.bwd_dx.launches) == before


def test_backward_wrappers_reject_bad_operands():
    x = torch.zeros(B, C, H, W)
    with pytest.raises(ValueError):
        tge.bwd_reduce([x, x], torch.zeros(B, C, H, W + 1))
    with pytest.raises(ValueError):
        tge.bwd_dx([x, x], x, torch.zeros(3, B, C), torch.zeros(2, B, C), torch.zeros(2, B, C))
    with pytest.raises(ValueError):
        tge.bwd_reduce([x] * 7, x)
