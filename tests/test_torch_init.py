"""The port's weight init against the JAX package's init rules, leaf by
leaf, on the supernet (meta_node_num 2, depth 2, c 16): every kind of
kernel the search path makes (stem conv, BasicBlock, the grouped convs,
transposed convs, depthwise and pointwise kernels of GroupedMixedOp with
their per-edge fans, the SE weights, the naive inner edges, the
cell-input resamplers, the head) and the BN (1, 0) init.

The two packages draw from different generators, so the test compares
distributions: the standard deviation of each leaf, pooled over 8 seeds of
each package, may differ from the std the port states for it by 4 of its
standard errors (a sample std over n normal values has relative standard
error ~1/sqrt(2n)) plus 2%. A wrong fan is off by sqrt(E) = 1.41 or more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.search import supernet as jsn
from senas_torch import convert
from senas_torch.search import supernet as tsn

from torch_port_util import flat
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

M, D, C = 2, 2, 16
SEEDS = 8


@pytest.fixture(scope="module")
def leaves():
    arch = jsn.init_arch_params(jax.random.PRNGKey(1), M, D, use_sharing=False)
    jm = jsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M)
    x = jnp.zeros((1, 16, 16, 1))
    init = jax.jit(lambda key: jm.init(key, x, jsn.normalize_arch(arch, M), False))
    jax_runs = [init(jax.random.PRNGKey(s)) for s in range(SEEDS)]
    port_runs, stated = [], {}
    for s in range(SEEDS):
        tm = tsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                             device="cpu", generator=torch.Generator().manual_seed(s))
        port_runs.append(convert.state_dict_to_variables(tm))
    for name, m in tm.named_modules():
        for leaf, std in m.__dict__.get("init_std", {}).items():
            stated[f"{name}.{leaf}" if name else leaf] = std
    return jax_runs, port_runs, stated, tm


def _pooled(runs, coll):
    per_run = [flat(r[coll]) for r in runs]
    return {k: np.concatenate([np.asarray(p[k]).ravel() for p in per_run]) for k in per_run[0]}


def test_same_leaves_and_bn_init(leaves):
    jax_runs, port_runs, _, _ = leaves
    j, t = _pooled(jax_runs, "params"), _pooled(port_runs, "params")
    assert j.keys() == t.keys()
    jb, tb = _pooled(jax_runs, "batch_stats"), _pooled(port_runs, "batch_stats")
    assert jb.keys() == tb.keys()
    for k in j:
        if k.endswith("/scale") or k.endswith("/bias"):
            assert np.all(t[k] == (1.0 if k.endswith("/scale") else 0.0)), k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_every_kernel_states_its_std(leaves):
    _, _, stated, tm = leaves
    kernels = {k for k, p in tm.named_parameters() if p.ndim > 1}
    assert kernels == set(stated)


def test_kernel_stds_match_jax(leaves):
    jax_runs, port_runs, stated, tm = leaves
    j, t = _pooled(jax_runs, "params"), _pooled(port_runs, "params")
    # flax leaf path -> the port parameter it maps to (inner_n stacks split)
    names = {k for k, p in tm.named_parameters() if p.ndim > 1}
    checked = 0
    for path, vals in j.items():
        if path.endswith("/scale") or path.endswith("/bias"):
            continue
        key = path.replace("/", ".")
        owners = [n for n in names if n == key or _unstacked(n) == key]
        assert owners, path
        std = stated[owners[0]]
        assert all(stated[o] == std for o in owners), path
        tol = 4.0 / np.sqrt(2 * vals.size) + 0.02
        assert abs(vals.std() / std - 1) <= tol, (path, vals.std(), std)
        assert abs(t[path].std() / std - 1) <= tol, (path, t[path].std(), std)
        checked += 1
    assert checked >= 30


def _unstacked(name):
    """`down_1.inner_1.0.x` -> `down_1.inner_1.x` (flax stacks inner edges)."""
    parts = name.split(".")
    for i, p in enumerate(parts[:-1]):
        if p.startswith("inner_") and parts[i + 1].isdigit():
            return ".".join(parts[:i + 1] + parts[i + 2:])
    return name


def test_arch_init_std():
    gen = torch.Generator().manual_seed(0)
    arch = tsn.init_arch_params(3, 5, use_sharing=False, generator=gen, device="cpu")
    vals = torch.cat([v.ravel() for v in arch.values()])
    assert abs(vals.std().item() / 1e-3 - 1) <= 4.0 / np.sqrt(2 * vals.numel()) + 0.02
