"""The legacy block library and the customize helpers of the port
(`senas_torch/utils/legacy_blocks.py`, `senas_torch/utils/customize.py`)
against senas_tpu's, from the same numpy-made inputs and variables (carried
across by `senas_torch.convert`).

Each block runs in train and in eval mode; the forward outputs, the input
and weight gradients of sum(output * readout) and, in train mode, the
running stats are held within rtol 1e-5 (and an atol of 1e-5 of each
tensor's largest magnitude). The group-norm and
transposed variants, the odd-sized quirks (unpadded convolutions, LinknetUp's
2H+1) and `SENAS_PALLAS_BN=1` (the port's plain twins of K1a-K1d on the
CPU, senas_tpu's Pallas kernels in interpret mode) are cases of their own.
A tied 2x2 window checks SegNet's index (the first maximum) and the
maximum's gradient (split evenly over the tie). One bf16 case is held to
the bf16 network bound of tests/torch_port_util.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.utils import customize as jc
from senas_tpu.utils import legacy_blocks as jl
from senas_torch import convert
from senas_torch.utils import customize as tc
from senas_torch.utils import legacy_blocks as tl

from torch_port_util import assert_bf16_network, assert_trees_close, nchw, nhwc, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, what):
    """Within rtol 1e-5, and atol 1e-5 of the tensor's largest magnitude
    (at least 1e-5): a gradient summed over many readout terms reaches
    ~50, and its f32 rounding is relative to that, not to each element."""
    want = np.asarray(want)
    atol = TOL["atol"] * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=atol, err_msg=what)


def _readout(shape):
    """A fixed, sign-changing readout of an NHWC output shape."""
    return np.sin(np.arange(int(np.prod(shape))) * 0.37 + 1.0).reshape(shape).astype(np.float32)


def _outputs(out, floating: bool):
    """The 4-D float (or integer) arrays among a block's outputs."""
    outs = out if isinstance(out, tuple) else (out,)
    return [o for o in outs if hasattr(o, "dtype") and o.ndim == 4
            and bool(jnp.issubdtype(o.dtype, jnp.floating)) == floating]


def _run_pair(jmod, tmod, xs, train, extra=(), seed=0):
    """senas_tpu's block and the port's on the NHWC inputs `xs` (then the
    non-differentiable `extra` arguments, each as (jax value, port value)):
    returns both packages' float outputs, input and parameter gradients and
    running stats, and the port module."""
    rng = np.random.RandomState(seed)
    jx = [jnp.asarray(x) for x in xs]
    jextra = [e[0] for e in extra]
    v = random_variables(jmod, rng, *jx, *jextra, False)
    convert.load_variables(tmod, v)
    # the round trip of the bridge, raw kernels and transposed ones included
    assert_trees_close(convert.state_dict_to_variables(tmod), v, rtol=0, atol=0)
    stats = v.get("batch_stats", {})

    def outputs(params, *x):
        out, mut = jmod.apply({"params": params, "batch_stats": stats}, *x, *jextra, train,
                              mutable=["batch_stats"])
        return _outputs(out, True), _outputs(out, False), mut

    shapes = [o.shape for o in jax.eval_shape(outputs, v["params"], *jx)[0]]
    readouts = [_readout(s) for s in shapes]

    def loss(params, *x):
        outs, ints, mut = outputs(params, *x)
        return sum(jnp.sum(o * r) for o, r in zip(outs, readouts)), (outs, ints, mut)

    argnums = tuple(range(len(xs) + 1))
    (_, (jouts, jints, mut)), grads = jax.jit(jax.value_and_grad(loss, argnums, has_aux=True))(
        v["params"], *jx)
    tx = [nchw(x).requires_grad_() for x in xs]
    out = tmod(*tx, *[e[1] for e in extra], train=train)
    tall = [o for o in (out if isinstance(out, tuple) else (out,))
            if isinstance(o, torch.Tensor) and o.dim() == 4]
    touts = [o for o in tall if o.is_floating_point()]
    sum((o * nchw(r)).sum() for o, r in zip(touts, readouts)).backward()
    want_pgrads = convert.variables_to_state_dict(tmod, {"params": jax.device_get(grads[0])})
    got_pgrads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                  for k, p in tmod.named_parameters()}
    return dict(
        outs=([nhwc(o) for o in touts], [np.asarray(o) for o in jouts]),
        ints=([nhwc(o) for o in tall if not o.is_floating_point()],
              [np.asarray(o) for o in jints]),
        xgrads=([nhwc(t.grad) for t in tx], [np.asarray(g) for g in grads[1:]]),
        pgrads=(got_pgrads, want_pgrads),
        stats=(convert.state_dict_to_variables(tmod).get("batch_stats", {}),
               jax.device_get(mut.get("batch_stats", {}))),
        out=out)


def _assert_pair(r, train):
    for got, want in zip(*r["ints"]):
        np.testing.assert_array_equal(got, want, err_msg="integer output")
    assert len(r["ints"][0]) == len(r["ints"][1])
    for got, want in zip(*r["outs"]):
        _close(got, want, "output")
    for got, want in zip(*r["xgrads"]):
        _close(got, want, "input gradient")
    got, want = r["pgrads"]
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), k)
    if train:
        assert_trees_close(*r["stats"], **TOL)


def _x(rng, *shape):
    return (rng.randn(*shape) * 1.3 + 0.2).astype(np.float32)


# (id, senas_tpu block, port block, NHWC input shapes[, extra arguments])
CASES = [
    ("convnorm-batch", lambda: jl.ConvNorm(8, 3, stride=2, padding=1, act=True),
     lambda: tl.ConvNorm(5, 8, 3, stride=2, padding=1, act=True), [(2, 11, 9, 5)]),
    ("convnorm-group", lambda: jl.ConvNorm(8, 3, padding=2, dilation=2, norm="group", n_groups=4),
     lambda: tl.ConvNorm(5, 8, 3, padding=2, dilation=2, norm="group", n_groups=4),
     [(2, 10, 10, 5)]),
    ("convnorm-bias", lambda: jl.ConvNorm(6, 3, norm=None),
     lambda: tl.ConvNorm(4, 6, 3, norm=None), [(2, 9, 8, 4)]),
    ("convnorm-transpose-batch", lambda: jl.ConvNorm(6, 3, stride=2, padding=1, act=True,
                                                     transpose=True),
     lambda: tl.ConvNorm(4, 6, 3, stride=2, padding=1, act=True, transpose=True),
     [(2, 5, 6, 4)]),
    ("convnorm-transpose-bias", lambda: jl.ConvNorm(6, 2, stride=2, norm=None, transpose=True),
     lambda: tl.ConvNorm(4, 6, 2, stride=2, norm=None, transpose=True), [(2, 5, 4, 4)]),
    ("unetconv2", lambda: jl.UnetConv2(6), lambda: tl.UnetConv2(3, 6), [(2, 12, 12, 3)]),
    ("unetconv2-nonorm", lambda: jl.UnetConv2(6, is_batchnorm=False),
     lambda: tl.UnetConv2(3, 6, is_batchnorm=False), [(2, 10, 10, 3)]),
    ("unetup-deconv", lambda: jl.UnetUp(6), lambda: tl.UnetUp(8, 5, 6),
     [(2, 13, 13, 5), (2, 7, 7, 8)]),
    ("unetup-bilinear", lambda: jl.UnetUp(6, is_deconv=False),
     lambda: tl.UnetUp(4, 5, 6, is_deconv=False), [(2, 11, 11, 5), (2, 6, 6, 4)]),
    ("residualblock", lambda: jl.ResidualBlock(8, stride=2), lambda: tl.ResidualBlock(4, 8, 2),
     [(2, 10, 10, 4)]),
    ("residualbottleneck", lambda: jl.ResidualBottleneck(3, stride=2),
     lambda: tl.ResidualBottleneck(4, 3, 2), [(2, 9, 9, 4)]),
    ("linknetup", lambda: jl.LinknetUp(8), lambda: tl.LinknetUp(6, 8), [(2, 5, 6, 6)]),
    ("frru-batch", lambda: jl.FRRU(8, 2), lambda: tl.FRRU(6, 8, 2),
     [(2, 5, 6, 6), (2, 10, 12, 32)]),
    ("frru-group", lambda: jl.FRRU(8, 3, group_norm=True, n_groups=4),
     lambda: tl.FRRU(6, 8, 3, group_norm=True, n_groups=4), [(2, 4, 4, 6), (2, 12, 12, 32)]),
    ("ru-batch", lambda: jl.RU(6), lambda: tl.RU(6, 6), [(2, 8, 7, 6)]),
    ("ru-group", lambda: jl.RU(8, group_norm=True, n_groups=2),
     lambda: tl.RU(8, 8, group_norm=True, n_groups=2), [(2, 7, 7, 8)]),
    ("residualconvunit", lambda: jl.ResidualConvUnit(), lambda: tl.ResidualConvUnit(5),
     [(2, 11, 10, 5)]),
    ("mrf-high", lambda: jl.MultiResolutionFusion(6, 2, 1),
     lambda: tl.MultiResolutionFusion(4, 6, 2, 1), [(2, 8, 7, 4)], [(None, None)]),
    ("mrf-both", lambda: jl.MultiResolutionFusion(6, 3, 2),
     lambda: tl.MultiResolutionFusion(4, 6, 3, 2, low_channels=5),
     [(2, 8, 8, 4), (2, 11, 11, 5)]),
    ("chainedresidualpooling", lambda: jl.ChainedResidualPooling(5),
     lambda: tl.ChainedResidualPooling(5, 5), [(2, 9, 9, 5)]),
    ("bottleneckpsp-stride", lambda: jl.BottleNeckPSP(3, 8, stride=2),
     lambda: tl.BottleNeckPSP(4, 3, 8, stride=2), [(2, 9, 9, 4)]),
    ("bottleneckpsp-dilated", lambda: jl.BottleNeckPSP(3, 8, dilation=2),
     lambda: tl.BottleNeckPSP(4, 3, 8, dilation=2), [(2, 8, 8, 4)]),
    ("bottleneckidentifypsp", lambda: jl.BottleNeckIdentifyPSP(3, dilation=2),
     lambda: tl.BottleNeckIdentifyPSP(6, 3, dilation=2), [(2, 8, 8, 6)]),
    ("residualblockpsp", lambda: jl.ResidualBlockPSP(3, 3, 8, stride=2),
     lambda: tl.ResidualBlockPSP(4, 3, 3, 8, stride=2), [(2, 8, 8, 4)]),
    ("cascadefeaturefusion", lambda: jl.CascadeFeatureFusion(3, 6),
     lambda: tl.CascadeFeatureFusion(3, 5, 4, 6), [(2, 5, 6, 5), (2, 10, 12, 4)]),
    # batch 4: train-mode BN over the 2 values of a 1x1 pool at batch 2 leaves
    # the gradients ill-conditioned in f32
    ("pyramidpooling", lambda: jc.PyramidPooling(8), lambda: tc.PyramidPooling(8),
     [(4, 12, 12, 8)]),
    ("pyramidpooling-fallback", lambda: jc.PyramidPooling(8), lambda: tc.PyramidPooling(8),
     [(4, 10, 8, 8)]),
]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_matches_senas_tpu(case, train):
    _, jmake, tmake, shapes, *extra = case
    rng = np.random.RandomState(len(shapes) + 7)
    r = _run_pair(jmake(), tmake(), [_x(rng, *s) for s in shapes], train, *extra)
    _assert_pair(r, train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_segnet_down_up_match(train):
    """SegnetDown's pooled map, indices and size, then SegnetUp from them."""
    rng = np.random.RandomState(3)
    x = _x(rng, 2, 10, 8, 4)
    r = _run_pair(jl.SegnetDown(6, n_convs=3), tl.SegnetDown(4, 6, n_convs=3), [x], train)
    _assert_pair(r, train)
    pooled, idx, hw = r["out"]
    assert hw == (10, 8) and len(r["ints"][0]) == 1
    # SegnetUp from the same pooled map and indices
    p = nhwc(pooled)
    ji = jnp.asarray(nhwc(idx).astype(np.int32))
    r = _run_pair(jl.SegnetUp(5, n_convs=2), tl.SegnetUp(6, 5, n_convs=2), [p], train,
                  extra=[(ji, idx), ((10, 8), (10, 8))])
    _assert_pair(r, train)


def test_max_pool_argmax_tied_window():
    """Ties: the index of the first maximum, and the maximum's gradient split
    evenly over the tied elements (jnp.max's rule), in both packages;
    the unpool puts each maximum back at its index."""
    x = np.zeros((1, 4, 4, 2), np.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 0] = x[0, 1, 1, 0] = 3.0      # a three-way tie
    x[0, 2, 3, 0] = x[0, 3, 2, 0] = 2.0                      # a two-way tie
    x[0, :2, 2:, 1] = [[1.0, 5.0], [5.0, 0.0]]
    x[0, 2:, :2, 1] = -1.0                                   # all four tied
    r = _readout((1, 2, 2, 2))

    def jloss(x):
        pooled, idx = jl.max_pool_argmax_2x2(x)
        return jnp.sum(pooled * r), idx

    (_, jidx), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tx = nchw(x).requires_grad_()
    pooled, tidx = tl.max_pool_argmax_2x2(tx)
    (pooled * nchw(r)).sum().backward()
    np.testing.assert_array_equal(nhwc(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(nhwc(tidx)[0, :, :, 0], [[0, 0], [0, 1]])
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(jgrad), rtol=0, atol=1e-7)
    np.testing.assert_allclose(nhwc(tx.grad)[0, 0, 0, 0], r[0, 0, 0, 0] / 3, rtol=1e-6)
    up = tl.max_unpool_2x2(pooled.detach(), tidx, (4, 4))
    want = jl.max_unpool_2x2(*jl.max_pool_argmax_2x2(jnp.asarray(x)), (4, 4))
    np.testing.assert_array_equal(nhwc(up), np.asarray(want))


def test_max_pool_argmax_odd_height_raises():
    with pytest.raises(TypeError):
        jl.max_pool_argmax_2x2(jnp.zeros((1, 5, 4, 2)))
    with pytest.raises(RuntimeError):
        tl.max_pool_argmax_2x2(torch.zeros(1, 2, 5, 4))


@pytest.mark.parametrize("case", ["segnetdown", "pyramidpooling", "linknetup"])
def test_gated_batchnorm_blocks_match(monkeypatch, case):
    """SENAS_PALLAS_BN=1: both packages' BatchNorms take the fused epilogue
    at n=1 (one-sweep variance), train mode."""
    monkeypatch.setenv("SENAS_PALLAS_BN", "1")
    rng = np.random.RandomState(11)
    pairs = {"segnetdown": (jl.SegnetDown(6), tl.SegnetDown(4, 6), [(2, 8, 8, 4)]),
             "pyramidpooling": (jc.PyramidPooling(8), tc.PyramidPooling(8), [(2, 6, 6, 8)]),
             "linknetup": (jl.LinknetUp(4), tl.LinknetUp(6, 4), [(2, 3, 4, 6)])}
    jmod, tmod, shapes = pairs[case]
    _assert_pair(_run_pair(jmod, tmod, [_x(rng, *s) for s in shapes], True), True)


def test_bf16_block_within_the_bf16_bound():
    """ResidualBlock with bf16 norms on a bf16 map, train mode: the port's
    bf16 output against senas_tpu's within twice senas_tpu's own bf16-vs-f32
    distance."""
    rng = np.random.RandomState(5)
    x = _x(rng, 2, 10, 10, 4)
    jb, tb = jl.ResidualBlock(8, stride=2, dtype=jnp.bfloat16), tl.ResidualBlock(
        4, 8, 2, dtype=torch.bfloat16)
    v = random_variables(jb, rng, jnp.asarray(x), False)
    convert.load_variables(tb, v)
    want, _ = jb.apply(v, jnp.asarray(x, jnp.bfloat16), True, mutable=["batch_stats"])
    f32, _ = jl.ResidualBlock(8, stride=2).apply(v, jnp.asarray(x), True,
                                                  mutable=["batch_stats"])
    got = tb(nchw(x).to(torch.bfloat16), train=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_network(nhwc(got.float()), np.asarray(want, np.float32), np.asarray(f32),
                        what="ResidualBlock bf16")


def test_concurrent_module_matches():
    rng = np.random.RandomState(2)
    x = _x(rng, 2, 7, 7, 4)
    jmod = jc.ConcurrentModule([jl.ConvNorm(3, 3, padding=1), jl.ConvNorm(5, 1)])
    tmod = tc.ConcurrentModule([tl.ConvNorm(4, 3, 3, padding=1), tl.ConvNorm(4, 5, 1)])
    _assert_pair(_run_pair(jmod, tmod, [x], True), True)


@pytest.mark.parametrize("hw", [(12, 18), (10, 7)])
@pytest.mark.parametrize("size", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches(hw, size):
    x = _x(np.random.RandomState(size), 2, hw[0], hw[1], 3)
    r = _readout((2, size, size, 3))
    jgrad = jax.grad(lambda x: jnp.sum(jc.adaptive_avg_pool(x, size) * r))(jnp.asarray(x))
    tx = nchw(x).requires_grad_()
    out = tc.adaptive_avg_pool(tx, size)
    (out * nchw(r)).sum().backward()
    np.testing.assert_allclose(nhwc(out), np.asarray(jc.adaptive_avg_pool(jnp.asarray(x), size)),
                               **TOL)
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(jgrad), **TOL)


def test_customize_functions_match():
    rng = np.random.RandomState(4)
    x = _x(rng, 2, 5, 6, 3)
    np.testing.assert_allclose(tc.gram_matrix(nchw(x)).numpy(),
                               np.asarray(jc.gram_matrix(jnp.asarray(x))), **TOL)
    v = _x(rng, 4, 7)
    for p, axis in [(2.0, -1), (1.0, 0), (3.0, 1)]:
        np.testing.assert_allclose(tc.normalize(torch.from_numpy(v), p, axis).numpy(),
                                   np.asarray(jc.normalize(jnp.asarray(v), p, axis)), **TOL)
    np.testing.assert_allclose(tc.normalize(torch.zeros(2, 3)).numpy(),
                               np.asarray(jc.normalize(jnp.zeros((2, 3)))))
    for keep in (False, True):
        np.testing.assert_allclose(tc.reduce_sum(torch.from_numpy(v), 1, keep).numpy(),
                                   np.asarray(jc.reduce_sum(jnp.asarray(v), 1, keep)), **TOL)
        np.testing.assert_allclose(tc.reduce_mean(torch.from_numpy(v), 0, keep).numpy(),
                                   np.asarray(jc.reduce_mean(jnp.asarray(v), 0, keep)), **TOL)
    assert tuple(tc.view(torch.from_numpy(v), 2, 14).shape) == jc.view(jnp.asarray(v), 2, 14).shape


@pytest.mark.parametrize("k,cin,cout", [(3, 2, 3), (4, 3, 2), (2, 2, 2)])
def test_upsampling_weight_is_the_transposed_layout(k, cin, cout):
    """The port's initializer is senas_tpu's HWIO one in the layout its
    transposed ConvNorm stores (convert's "hwio_t")."""
    want = convert._to_torch_layout(np.asarray(jl.get_upsampling_weight(cin, cout, k)),
                                    "hwio_t", None)
    np.testing.assert_allclose(tl.get_upsampling_weight(cin, cout, k).numpy(), want,
                               rtol=0, atol=1e-7)


def test_interp_helpers_match():
    x = _x(np.random.RandomState(9), 1, 9, 7, 2)
    for s, z in [(1, 1), (2, 1), (1, 2), (3, 2)]:
        assert tl.get_interp_size(nchw(x), s, z) == jl.get_interp_size(jnp.asarray(x), s, z)
    for mode in ("bilinear", "nearest", "bicubic", "lanczos3"):
        for size in [(17, 13), (5, 4)]:
            np.testing.assert_allclose(nhwc(tl.interp(nchw(x), size, mode)),
                                       np.asarray(jl.interp(jnp.asarray(x), size, mode)),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{mode} {size}")
