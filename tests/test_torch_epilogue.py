"""senas_torch.ops.grouped_epilogue on the CPU (its plain versions) against
the JAX package's Pallas epilogue in interpret mode (how
tests/test_grouped_epilogue.py runs the kernels on the CPU) and against
its pure-jnp `group_epilogue_reference`.

Tolerance: rtol/atol 1e-5, the JAX suite's own forward tolerance; both
sides compute in f32 and differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops import grouped_epilogue as jge
from senas_torch.ops import grouped_epilogue as tge

from torch_port_util import epilogue_case as _case
from torch_port_util import nchw, nhwc
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B, H, W, E, P = 2, 8, 4, 3, 8
C = E * P
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("se,none", [(True, True), (False, False),
                                     (True, False), (False, True)])
def test_epilogue_matches_jax(se, none, train):
    n = 4
    jargs, jkw, targs, tkw = _case(0, n, se, none, train)
    want_k, (jmu, jvar) = jge.fused_group_epilogue(*jargs, interpret=True, **jkw)
    want_ref = jge.group_epilogue_reference(*jargs, **jkw)
    got, (mu, var) = tge.fused_group_epilogue(*targs, **tkw)
    assert got.shape == (B, C, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(want_k), **TOL)
    np.testing.assert_allclose(nhwc(got), np.asarray(want_ref), **TOL)
    # the port's own two-pass reference agrees as well
    ref = tge.group_epilogue_reference(*targs, **tkw)
    np.testing.assert_allclose(nhwc(got), nhwc(ref), **TOL)
    if train:
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **TOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **TOL)


@pytest.mark.parametrize("n", [1, 6])
def test_branch_stats_plain_matches_jax_kernel(n):
    rng = np.random.RandomState(n)
    xs = [rng.randn(B, H, W, C).astype(np.float32) + i for i in range(n)]
    s1, s2 = jge._branch_stats([jnp.asarray(x.reshape(B, H, W * C)) for x in xs],
                               interpret=True)
    # fold the JAX kernel's per-(b, w*c) H-sums over W
    want1 = np.asarray(s1).reshape(n, B, W, C).sum(2)
    want2 = np.asarray(s2).reshape(n, B, W, C).sum(2)
    got1, got2 = tge.branch_stats_plain([nchw(x) for x in xs])
    assert got1.shape == (n, B, C)
    np.testing.assert_allclose(got1.numpy(), want1, **TOL)
    np.testing.assert_allclose(got2.numpy(), want2, **TOL)


@pytest.mark.parametrize("n", [1, 6])
def test_apply_mix_plain_matches_jax_kernel(n):
    rng = np.random.RandomState(10 + n)
    xs = [rng.randn(B, H, W, C).astype(np.float32) for _ in range(n)]
    a = rng.randn(n, B, C).astype(np.float32)
    k = rng.randn(B, C).astype(np.float32)
    want = jge._apply_mix([jnp.asarray(x.reshape(B, H, W * C)) for x in xs],
                          jnp.asarray(np.tile(a, (1, 1, W))),
                          jnp.asarray(np.tile(k, (1, W))), jnp.float32,
                          interpret=True)
    got = tge.apply_mix_plain([nchw(x) for x in xs], torch.from_numpy(a),
                              torch.from_numpy(k))
    np.testing.assert_allclose(nhwc(got), np.asarray(want).reshape(B, H, W, C), **TOL)


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU the wrappers return the plain results and launch nothing."""
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)) for _ in range(3)]
    a = torch.from_numpy(rng.randn(3, B, C).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, C).astype(np.float32))
    before = (tge.branch_stats.launches, tge.apply_mix.launches)
    for got, want in zip(tge.branch_stats(xs), tge.branch_stats_plain(xs)):
        assert torch.equal(got, want)
    assert torch.equal(tge.apply_mix(xs, a, k), tge.apply_mix_plain(xs, a, k))
    assert (tge.branch_stats.launches, tge.apply_mix.launches) == before


def test_wrappers_reject_bad_operands():
    x = torch.zeros(B, C, H, W)
    with pytest.raises(ValueError):
        tge.branch_stats([x] * 7)
    with pytest.raises(ValueError):
        tge.branch_stats([x, torch.zeros(B, C, H, W + 1)])
    with pytest.raises(ValueError):
        tge.apply_mix([x, x], torch.zeros(3, B, C), torch.zeros(B, C))
    with pytest.raises(ValueError):
        tge.branch_stats([torch.zeros(B, C, H)])
