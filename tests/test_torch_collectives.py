"""The collectives of the port's data parallelism (senas_torch/parallel/
collectives.py) and every batch statistic that goes through them, over two
gloo ranks on the CPU, against the single-process result on the global
batch, in f64: `all_reduce_sum` and `gather_batch` forward and backward;
`BatchNorm` on its default path (the synced two-pass BN) and on its gated
path (the fused epilogue's plain twins, SENAS_PALLAS_BN=1); the fused
epilogue in train mode with and without SE, and its unfused reference;
SK-Net's `FlaxBatchNorm`; the running stats after `advance`, at a batch
where a per-rank count would move the unbiased variance by a factor 2/1 in
place of 4/3; dropout's masks. One spawn of two ranks runs every case
(tests/torch_mesh_workers.py); the parent runs the same cases without a
mesh. Without an active mesh every collective is the identity.

Tolerance: 1e-12 of each result's scale. Both sides compute in f64 and
differ in the order of their sums only."""

import numpy as np
import pytest
import torch

from torch_mesh_workers import CASES, Ranks, combine
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

REL = 1e-12
B, C, HW = 8, 6, 5


def _bn_args(rng, shape):
    c = shape[1]
    return dict(x=rng.randn(*shape) * 2 + 0.5, r_weights=rng.randn(*shape),
                params={"scale": rng.uniform(0.5, 1.5, c), "bias": rng.randn(c) * 0.2},
                buffers={"mean": rng.randn(c) * 0.1, "var": rng.uniform(0.5, 1.5, c)})


def _epilogue_args(rng, se: bool):
    n, E, P = 3, 2, 3
    c = E * P
    args = dict(xs=[rng.randn(B, c, HW, HW) for _ in range(n)],
                r_weights=rng.randn(B, c, HW, HW),
                scales=[rng.uniform(0.5, 1.5, c) for _ in range(n)],
                biases=[rng.randn(c) * 0.2 for _ in range(n)],
                alphas=[rng.uniform(0.1, 1.0, c) for _ in range(n)],
                none_alpha=rng.uniform(0.1, 1.0, c), none_bias=rng.randn(c) * 0.2, E=E, P=P)
    if se:
        args.update(se_w1=rng.randn(E, P, 1) * 0.5, se_w2=rng.randn(E, 1, P) * 0.5)
    return args


def _job():
    rng = np.random.RandomState(0)
    return [
        ("reduce_and_gather", dict(x=rng.randn(B, 3), w=rng.randn(B, 3))),
        ("batchnorm", _bn_args(rng, (B, C, HW, HW))),
        ("batchnorm", dict(_bn_args(rng, (B, C, HW, HW)), gated=True)),
        # 4 values a channel: 2 a rank
        ("batchnorm", _bn_args(rng, (4, C, 1, 1))),
        ("batchnorm", dict(_bn_args(rng, (4, C, 1, 1)), gated=True)),
        ("batchnorm", _bn_args(rng, (B, C))),
        ("flax_batchnorm", _bn_args(rng, (B, C, HW, HW))),
        ("flax_batchnorm", _bn_args(rng, (4, C, 1, 1))),
        ("epilogue", _epilogue_args(rng, se=False)),
        ("epilogue", _epilogue_args(rng, se=True)),
        ("dropout", dict(x=rng.randn(B, C, HW, HW), seed=3)),
    ]


def _close(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale, err_msg=what)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = _job()
    ranks = Ranks(job, tmp_path_factory.mktemp("ranks"))
    single = [CASES[name](None, **kw) for name, kw in job]
    per_rank = ranks.results()
    return job, single, [combine([r[i] for r in per_rank]) for i in range(len(job))]


def _cases(runs, name):
    job, single, two = runs
    out = [(kw, s, t) for (n, kw), s, t in zip(job, single, two) if n == name]
    assert out
    return out


def _check(single, two, what):
    assert single.keys() == two.keys(), what
    for k in single:
        _close(two[k], single[k], f"{what} {k}")


def test_all_reduce_sum_and_gather_batch(runs):
    (kw, single, two), = _cases(runs, "reduce_and_gather")
    _check(single, two, "reduce_and_gather")
    np.testing.assert_array_equal(two["labels"], np.arange(B))
    # the single-process numbers are the plain global ones
    np.testing.assert_allclose(single["s"], kw["x"].sum(axis=0))
    x, w = kw["x"], kw["w"]
    np.testing.assert_allclose(single["g"], x * x.sum(axis=0))
    np.testing.assert_allclose(single["rows:dx"], w * x.sum(axis=0) + (w * x).sum(axis=0))


@pytest.mark.parametrize("which", ["default", "gated", "default_count", "gated_count", "2d"])
def test_batchnorm_over_two_ranks(runs, which):
    kw, single, two = _cases(runs, "batchnorm")[
        ["default", "gated", "default_count", "gated_count", "2d"].index(which)]
    _check(single, two, f"batchnorm {which}")
    if which.endswith("count"):
        # the running variance took the global count's factor 4/3
        x = kw["x"]
        var = x.var(axis=(0, 2, 3), ddof=1)
        want = 0.9 * kw["buffers"]["var"] + 0.1 * var
        np.testing.assert_allclose(two["var"], want, rtol=1e-12)


@pytest.mark.parametrize("which", ["map", "count"])
def test_flax_batchnorm_over_two_ranks(runs, which):
    kw, single, two = _cases(runs, "flax_batchnorm")[["map", "count"].index(which)]
    _check(single, two, f"flax_batchnorm {which}")
    x = kw["x"]
    want = 0.99 * kw["buffers"]["var"] + 0.01 * x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(two["var"], want, rtol=1e-12)


@pytest.mark.parametrize("se", [False, True])
def test_fused_epilogue_over_two_ranks(runs, se):
    kw, single, two = _cases(runs, "epilogue")[int(se)]
    _check(single, two, f"epilogue se={se}")
    # the batch stats are the global batch's
    for o, x in enumerate(kw["xs"]):
        np.testing.assert_allclose(two["fused_mu"][o], x.mean(axis=(0, 2, 3)), rtol=1e-12)
    # the fused path and the unfused reference agree over the ranks too
    for k in [k for k in two if k.startswith(("rows:fused", "sum:fused"))]:
        _close(two[k], two[k.replace("fused", "reference")], k)


def test_dropout_masks_are_the_global_batchs(runs):
    (kw, single, two), = _cases(runs, "dropout")
    np.testing.assert_array_equal(two["rows:y"], single["rows:y"])
    assert 0 < np.mean(single["rows:y"] == 0) < 1


def test_no_mesh_is_the_identity():
    from senas_torch.parallel.collectives import (active_mesh, activate, all_reduce_sum,
                                                  gather_batch, global_count)
    from senas_torch.parallel.mesh import make_mesh
    x = torch.randn(4, 3, requires_grad=True)
    assert active_mesh() is None
    assert all_reduce_sum(x) is x and gather_batch(x) is x
    assert global_count(torch.zeros(7, 2)) == 7 and global_count(torch.zeros(2, 3, 4, 5)) == 40
    # a mesh of one process without a group activates nothing
    mesh = make_mesh()
    assert mesh.group is None and mesh.world_size == 1
    with activate(mesh):
        assert active_mesh() is None
