"""The port's CUDA kernels (the epilogue's four, K2 norm_convs) against
their plain PyTorch versions, on the card. Every test here needs an NVIDIA
GPU with nvcc and skips without one; on the card run (the suite's conftest
imports JAX, which this file does not need):
python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: the kernels sum in another order than PyTorch's reductions.
Sums are held to 1e-5 of the plane's sum of |x| (resp. x^2, |g*x|, |g|),
elementwise outputs (the mix, the branch gradients) to atol 1e-4 on values
of scale ~1-10, the epilogue's gradients to rtol/atol 1e-4. In bf16 the
sums (f32) keep their bound; a bf16 output equals its plain twin's except
on at most 1e-3 of the elements, and there within one bf16 ulp or, where
the f32 sum cancels, within 2^-21 of the sum of its terms' magnitudes (the
kernel fuses each multiply-add, PyTorch rounds the product first); the
epilogue's bf16 gradients are held to the plain reference's in f32 on the
same bf16 inputs and cotangent at rtol/atol 2e-2 (the bf16 branch
gradients round). K1a's two calls on one input are bit-equal, and its
warp path gives a CTA's bits. Every input
is drawn from a seeded CPU generator, so a
run tests the same numbers each time; the one-element allowance is for
bf16 tensors of fewer than 1000 elements, where a share of 1e-3 admits
none. norm_convs is
held to 1e-5 of the same convolutions of |x| and |w| (each output's sum of
|products|): the kernel (3xTF32 on the tensor cores, f32 sums) and cuDNN
sum the products in other orders; its bf16 kernel to the bf16 bound above,
against the f32 convolutions of the same bf16 values rounded once."""

import numpy as np
import pytest
import torch

from senas_torch.ops import grouped_epilogue as ge
from senas_torch.ops import norm_convs as nc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _xs(dev, n, shape, seed=0, dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [(torch.randn(shape, generator=g) * (1 + o) + o).to(dev, dtype) for o in range(n)]


def _per_plane(dev, *shape, seed):
    """Per-(b, c) f32 operands from a seeded CPU generator."""
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def _bf16_ulp(got, want):
    mag = torch.maximum(got.double().abs(), want.double().abs())
    return torch.exp2(torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
                      - 7)


def _assert_bf16_close(got, want, terms):
    """bf16 `got` against `want`: equal but on at most max(1, 1e-3 of the
    elements), each of those within one bf16 ulp or 2^-21 of `terms` (the
    sum of the magnitudes that the f32 result was summed from)."""
    assert got.dtype == want.dtype == torch.bfloat16
    diff = (got.double() - want.double()).abs()
    assert int((diff > 0).sum()) <= max(1, int(1e-3 * diff.numel()))
    assert bool((diff <= torch.maximum(_bf16_ulp(got, want), terms.double() * 2.0 ** -21)).all())


# K1a's cases: (n, shape, element offset of each branch's data) for each
# path of its plan (`ge.branch_stats_plan`): a 1x1 squeeze and 16x16 maps
# (a warp a plane), [12,32,256,256] at n=1, the search path's
# [8,24,256,256] at n=6 and batch 2 of [32,256,256] (fewer planes than
# SMs) (a CTA a plane), and a misaligned slice (scalar loads); then the
# earlier shapes
_STATS_NEW_CASES = [(1, (12, 32, 1, 1), 0), (1, (12, 512, 16, 16), 0),
                    (1, (12, 32, 256, 256), 0), (6, (8, 24, 256, 256), 0),
                    (1, (2, 32, 256, 256), 0), (2, (4, 16, 64, 64), 1)]
_STATS_CASES = _STATS_NEW_CASES + [(n, shape, 0) for n in (1, 5, 6)
                                   for shape in ((8, 24, 64, 64), (2, 24, 8, 8), (2, 3, 5, 7))]


def _stats_xs(dev, n, shape, offset, dtype, seed=0):
    """_xs, each branch a view `offset` elements into a buffer of its own."""
    if not offset:
        return _xs(dev, n, shape, seed=seed, dtype=dtype)
    size = int(np.prod(shape))
    bufs = _xs(dev, n, (size + offset,), seed=seed, dtype=dtype)
    return [buf[offset:].view(shape) for buf in bufs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,shape,offset", _STATS_CASES)
def test_branch_stats_kernel(dev, n, shape, offset, dtype):
    xs = _stats_xs(dev, n, shape, offset, dtype)
    assert all(x.is_contiguous() for x in xs)
    assert offset == 0 or xs[0].data_ptr() % 16 != 0
    key = str(dtype).removeprefix("torch.")
    before = (ge.branch_stats.launches, ge.branch_stats.launches_by_dtype[key])
    s1, s2 = ge.branch_stats(xs)
    torch.cuda.synchronize()
    assert (ge.branch_stats.launches, ge.branch_stats.launches_by_dtype[key]) == (
        before[0] + 1, before[1] + 1)
    assert s1.dtype == s2.dtype == torch.float32
    p1, p2 = ge.branch_stats_plain(xs)
    abs1 = torch.stack([x.float().abs().sum(dim=(2, 3)) for x in xs])
    assert ((s1 - p1).abs() <= 1e-5 * abs1 + 1e-6).all()
    assert ((s2 - p2).abs() <= 1e-5 * p2 + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,shape,offset", _STATS_NEW_CASES)
def test_branch_stats_two_calls_are_bit_equal(dev, n, shape, offset, dtype):
    """One launch, no atomics, a sum order fixed by the shape: two calls
    on the same input give the same bits."""
    xs = _stats_xs(dev, n, shape, offset, dtype, seed=3)
    first, second = ge.branch_stats(xs), ge.branch_stats(xs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,shape,offset", [(1, (12, 32, 1, 1), 0), (1, (12, 512, 16, 16), 0),
                                            (2, (2, 64, 3, 3), 0), (3, (4, 8, 16, 16), 1)])
def test_branch_stats_warp_path_gives_a_ctas_bits(dev, n, shape, offset, dtype):
    """The warp path adds in the order of a CTA a plane: the same bits."""
    xs = _stats_xs(dev, n, shape, offset, dtype, seed=4)
    planes, hw = shape[0] * shape[1], shape[2] * shape[3]
    plan = ge.branch_stats_plan(n, planes, hw, dtype, aligned=offset == 0)
    assert plan.path == "warp"
    warp = ge._launch_branch_stats(xs, plan)
    cta = ge._launch_branch_stats(xs, ge.StatsPlan("cta", plan.vec, n * planes))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(warp, cta))


def test_branch_stats_launcher_refuses_a_plan_it_does_not_take(dev):
    """16-byte loads on a misaligned slice, and on planes of 9 elements,
    are refused with cudaErrorInvalidValue (the wrapper never asks for
    them)."""
    for offset, shape, plan in ((1, (2, 4, 128, 128), ge.StatsPlan("cta", True, 8)),
                                (0, (2, 4, 3, 3), ge.StatsPlan("warp", True, 1))):
        xs = _stats_xs(dev, 1, shape, offset, torch.float32)
        with pytest.raises(RuntimeError, match="invalid argument"):
            ge._launch_branch_stats(xs, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 5, 6])
@pytest.mark.parametrize("shape", [(8, 24, 64, 64), (2, 24, 8, 8), (2, 3, 5, 7)])
def test_apply_mix_kernel(dev, n, shape, dtype):
    xs = _xs(dev, n, shape, seed=1, dtype=dtype)
    b, c = shape[:2]
    a, k = _per_plane(dev, n, b, c, seed=11), _per_plane(dev, b, c, seed=12)
    before = ge.apply_mix.launches
    out = ge.apply_mix(xs, a, k)
    torch.cuda.synchronize()
    assert ge.apply_mix.launches == before + 1 and out.dtype == dtype
    want = ge.apply_mix_plain(xs, a, k)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
    else:
        terms = k.abs()[:, :, None, None] + sum(x.float().abs() * a[o].abs()[:, :, None, None]
                                                for o, x in enumerate(xs))
        _assert_bf16_close(out, want, terms)


@pytest.mark.parametrize("seed", range(20))
def test_apply_mix_bf16_differences_are_one_rounding(dev, seed):
    """At (2,3,5,7), n=6 in bf16 over 20 seeds: where the kernel's output
    differs from its twin's, it lies within one bf16 ulp (or 2^-21 of the
    terms' magnitudes, where the sum cancels) of the f64 sum of the same
    terms, as the twin does: the kernel's fused multiply-adds and the
    twin's rounded products round the f32 sum to neighbouring bf16 values,
    and neither is a fault."""
    shape, n = (2, 3, 5, 7), 6
    xs = _xs(dev, n, shape, seed=100 + seed, dtype=torch.bfloat16)
    a, k = _per_plane(dev, n, 2, 3, seed=200 + seed), _per_plane(dev, 2, 3, seed=300 + seed)
    got, want = ge.apply_mix(xs, a, k), ge.apply_mix_plain(xs, a, k)
    col = lambda t: t.double()[:, :, None, None]
    exact = col(k) + sum(x.double() * col(a[o]) for o, x in enumerate(xs))
    terms = col(k).abs() + sum(x.double().abs() * col(a[o]).abs() for o, x in enumerate(xs))
    bound = torch.maximum(_bf16_ulp(got, want), terms * 2.0 ** -21)
    differ = got != want
    for out in (got, want):
        assert bool(((out.double() - exact).abs() <= bound)[differ].all())
    _assert_bf16_close(got, want, terms)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("se,none", [(True, False), (False, True)])
def test_fused_epilogue_on_card(dev, train, se, none):
    E, P, n = 3, 8, 6 if se else 5
    C = E * P
    xs = _xs(dev, n, (4, C, 16, 16), seed=2)
    g = torch.Generator(device="cpu").manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    kw = dict(train=train)
    if not train:
        kw.update(run_means=[0.3 * r(C) for _ in range(n)],
                  run_vars=[r(C).abs() + 0.5 for _ in range(n)])
    if se:
        kw.update(se_index=1, se_w1=0.3 * r(E, P, 1), se_w2=0.3 * r(E, 1, P), E=E, P=P)
    if none:
        kw.update(none_alpha_col=r(C).abs(), none_bias=0.1 * r(C))
    args = (xs, [1 + 0.1 * r(C) for _ in range(n)], [0.1 * r(C) for _ in range(n)],
            [r(C).abs() for _ in range(n)])
    got, (mu, var) = ge.fused_group_epilogue(*args, **kw)
    want = ge.group_epilogue_reference(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


_SHAPES = [(8, 24, 64, 64), (2, 24, 128, 128), (1, 1, 512, 512), (2, 24, 8, 8), (2, 3, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 5, 6])
@pytest.mark.parametrize("shape", _SHAPES)
def test_bwd_reduce_kernel(dev, n, shape, dtype):
    xs = _xs(dev, n, shape, seed=4, dtype=dtype)
    g = _xs(dev, 1, shape, seed=5, dtype=dtype)[0]
    before = ge.bwd_reduce.launches
    da, dk = ge.bwd_reduce(xs, g)
    torch.cuda.synchronize()
    assert ge.bwd_reduce.launches == before + 1
    assert da.dtype == dk.dtype == torch.float32
    pa, pk = ge.bwd_reduce_plain(xs, g)
    gf = g.float()
    abs_a = torch.stack([(gf * x.float()).abs().sum(dim=(2, 3)) for x in xs])
    assert ((da - pa).abs() <= 1e-5 * abs_a + 1e-6).all()
    assert ((dk - pk).abs() <= 1e-5 * gf.abs().sum(dim=(2, 3)) + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 5, 6])
@pytest.mark.parametrize("shape", _SHAPES)
def test_bwd_dx_kernel(dev, n, shape, dtype):
    xs = _xs(dev, n, shape, seed=6, dtype=dtype)
    g = _xs(dev, 1, shape, seed=7, dtype=dtype)[0]
    b, c = shape[:2]
    a, ds1, ds2 = (_per_plane(dev, n, b, c, seed=13 + i) for i in range(3))
    before = ge.bwd_dx.launches
    got = ge.bwd_dx(xs, g, a, ds1, ds2)
    torch.cuda.synchronize()
    assert ge.bwd_dx.launches == before + 1
    col = lambda t: t.abs()[:, :, None, None]
    for o, want in enumerate(ge.bwd_dx_plain(xs, g, a, ds1, ds2)):
        if dtype == torch.float32:
            torch.testing.assert_close(got[o], want, rtol=0, atol=1e-4)
        else:
            terms = g.float().abs() * col(a[o]) + col(ds1[o]) + 2 * xs[o].float().abs() * col(ds2[o])
            _assert_bf16_close(got[o], want, terms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("se,none", [(True, False), (False, True), (False, False)])
def test_fused_epilogue_gradients_on_card(dev, train, se, none, dtype):
    """The autograd Function's gradients (K1a-K1d and the glue's VJP)
    against torch autograd through the plain two-pass reference; in bf16
    the reference runs in f32 on the same bf16 branch tensors."""
    E, P, n = 3, 8, 6 if se else 5
    C = E * P
    g = torch.Generator(device="cpu").manual_seed(8)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    kw = dict(train=train)
    if not train:
        kw.update(run_means=[0.3 * r(C) for _ in range(n)],
                  run_vars=[r(C).abs() + 0.5 for _ in range(n)])
    diff = dict(xs=_xs(dev, n, (4, C, 16, 16), seed=9, dtype=dtype),
                scales=[1 + 0.1 * r(C) for _ in range(n)],
                biases=[0.1 * r(C) for _ in range(n)],
                alphas=[r(C).abs() for _ in range(n)])
    if se:
        diff.update(se_w1=0.3 * r(E, P, 1), se_w2=0.3 * r(E, 1, P))
        kw.update(se_index=1, E=E, P=P)
    if none:
        diff.update(none_alpha_col=r(C).abs(), none_bias=0.1 * r(C))
    leaves = [t.requires_grad_() for v in diff.values()
              for t in (v if isinstance(v, list) else [v])]
    readout = r(4, C, 16, 16)
    call = lambda fn: fn(diff["xs"], diff["scales"], diff["biases"], diff["alphas"], **kw,
                         **{k: v for k, v in diff.items()
                            if k not in ("xs", "scales", "biases", "alphas")})
    key = str(dtype).removeprefix("torch.")
    before = (ge.bwd_reduce.launches_by_dtype[key], ge.bwd_dx.launches_by_dtype[key])
    got = torch.autograd.grad((call(ge.fused_group_epilogue)[0] * readout).sum(), leaves)
    torch.cuda.synchronize()
    assert (ge.bwd_reduce.launches_by_dtype[key], ge.bwd_dx.launches_by_dtype[key]) == (
        before[0] + 1, before[1] + 1)
    assert all(t.dtype == l.dtype for t, l in zip(got, leaves))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    # the reference's output stays f32; it gets the cotangent the bf16 output
    # gets (the readout rounded to bf16)
    want = torch.autograd.grad((call(lambda *a, **k: ge.group_epilogue_reference(
        *a, out_dtype=torch.float32, **k)) * readout.to(dtype).float()).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_card_rejects_other_dtypes(dev):
    """bf16 branch tensors reach the bf16 kernels; f16 and f64 raise, and
    nothing converts them."""
    xs = _xs(dev, 2, (2, 24, 8, 8))
    before = ge.branch_stats.launches_by_dtype["bfloat16"]
    s1, _ = ge.branch_stats([x.bfloat16() for x in xs])
    torch.cuda.synchronize()
    assert ge.branch_stats.launches_by_dtype["bfloat16"] == before + 1
    assert s1.dtype == torch.float32
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError):
            ge.branch_stats([x.to(dtype) for x in xs])
    a, k = torch.zeros(2, 2, 24, device=dev), torch.zeros(2, 24, device=dev)
    with pytest.raises(ValueError, match="float32"):
        ge.apply_mix([x.bfloat16() for x in xs], a.bfloat16(), k)
    with pytest.raises(NotImplementedError, match="dtype"):
        ge.apply_mix([x.bfloat16() for x in xs], a, k, out_dtype=torch.float32)


# (b, c, h, w, n): a main-sized tile, edge tiles in both directions,
# partial channel chunks and groups, images smaller than the 13-pixel
# receptive field, n > 32 (channel slices over two blocks), and
# chip_smoke.py's edge shapes (100 = 12*8 + 4 rows, 70 = 64 + 6 columns;
# C 20, a 16-channel chunk whose second K half is partial, with N 32, one
# slice of NT 4)
_NORM_SHAPES = [(2, 32, 64, 64, 24), (1, 10, 9, 35, 12), (2, 3, 5, 7, 4),
                (3, 10, 8, 1, 8), (1, 2, 17, 40, 40), (5, 32, 100, 70, 24),
                (2, 20, 30, 70, 32)]


@pytest.mark.parametrize("b,c,h,w,n", _NORM_SHAPES)
def test_norm_convs_kernel(dev, b, c, h, w, n):
    g = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn(b, c, h, w, generator=g).to(dev)
    ks = [(0.1 * torch.randn(n, c, k, k, generator=g)).to(dev) for k in (3, 5, 5)]
    before = nc.norm_convs.launches
    got = nc.norm_convs(x, *ks)
    torch.cuda.synchronize()
    assert nc.norm_convs.launches == before + 1
    assert got.shape == (b, 3 * n, h, w)
    want = nc.norm_convs_plain(x, *ks)
    abs_sum = nc.norm_convs_plain(x.abs(), *[k.abs() for k in ks])
    assert ((got - want).abs() <= 1e-5 * abs_sum + 1e-6).all()


@pytest.mark.parametrize("b,c,h,w,n", _NORM_SHAPES)
def test_norm_convs_bf16_kernel(dev, b, c, h, w, n):
    """The bf16 kernel (one bf16 wgmma per product, f32 sums, one rounding)
    against its twin: the f32 convolutions of the same bf16 values, rounded
    once; its launch counted as bf16, and no f32 kernel launched."""
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(b, c, h, w, generator=g).to(dev, torch.bfloat16)
    ks = [(0.1 * torch.randn(n, c, k, k, generator=g)).to(dev, torch.bfloat16)
          for k in (3, 5, 5)]
    before = dict(nc.norm_convs.launches_by_dtype)
    got = nc.norm_convs(x, *ks)
    torch.cuda.synchronize()
    assert nc.norm_convs.launches_by_dtype == {**before, "bfloat16": before["bfloat16"] + 1}
    assert got.shape == (b, 3 * n, h, w)
    terms = nc.norm_convs_plain(x.float().abs(), *[k.float().abs() for k in ks])
    _assert_bf16_close(got, nc.norm_convs_plain(x, *ks), terms)


def test_norm_convs_rejects_what_it_does_not_take(dev):
    x = torch.randn(1, 2, 8, 8, device=dev)
    ks = [torch.randn(3, 2, k, k, device=dev) for k in (3, 5, 5)]
    with pytest.raises(NotImplementedError):
        nc.norm_convs(x.half(), *ks)
    before = dict(nc.norm_convs.launches_by_dtype)
    with pytest.raises(NotImplementedError, match="one dtype"):   # no hidden cast
        nc.norm_convs(x.bfloat16(), *ks)
    assert nc.norm_convs.launches_by_dtype == before
    with pytest.raises(ValueError, match="contiguous"):
        nc.norm_convs(x.transpose(2, 3), *ks)


@pytest.mark.parametrize("name,depth,hw", [("deeplab_v3_plus", 5, 64), ("nasunet", 3, 32)])
def test_zoo_model_forward_on_card_matches_cpu(dev, name, depth, hw):
    """A baseline-zoo model (no kernel of its own: cuDNN and cuBLAS) on the
    card against the same weights on the CPU, eval and train mode (one
    dropout generator on the CPU gives both devices the same ASPP mask),
    TF32 off: logits within 1e-4 of their largest magnitude."""
    from senas_torch.models.factory import get_segmentation_model

    cpu = get_segmentation_model(name, depth=depth, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    card = get_segmentation_model(name, depth=depth, device=dev)
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()})
    x = torch.randn(2, hw, hw, 1, generator=torch.Generator().manual_seed(1))
    for train in (False, True):
        with torch.no_grad():
            want = cpu(x, train=train, rng=torch.Generator().manual_seed(2))[0]
            got = card(x.to(dev), train=train, rng=torch.Generator().manual_seed(2))[0].cpu()
        assert got.shape == want.shape == (2, hw, hw, 2)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# BatchNorm's shapes under SENAS_PALLAS_BN=1 (K1a-K1d at n=1): the 1x1 planes
# of PSPNet's pooled pyramid and DeepLabV3+'s image pool, PSP pool 3, a plane
# of 35, the encoders' deepest stage
_BN_SHAPES = [(2, 64, 1, 1), (2, 32, 3, 3), (2, 3, 5, 7), (2, 512, 8, 8)]


def _bn_f64(x, g, params, train, shift=0.0):
    """BatchNorm's output and the gradients of x, scale and bias for
    cotangent g, in f64; in train mode the batch mean and variance moved by
    `shift` times 2^-20 sqrt(E[x^2]) and 2^-20 E[x^2]: a few f32 ulps of the
    second moment, what the one-sweep variance E[x^2] - mu^2 (against the
    two-pass form) or another summation order may move them by."""
    scale, bias, mean, var = (t.double().cpu()[None, :, None, None] for t in params)
    xd, gd, dims = x.double().cpu(), g.double().cpu(), (0, 2, 3)
    if train:
        m2 = (xd ** 2).mean(dim=dims, keepdim=True)
        mean = xd.mean(dim=dims, keepdim=True) + shift * 2.0 ** -20 * m2.sqrt()
        var = xd.var(dim=dims, unbiased=False, keepdim=True) + shift * 2.0 ** -20 * m2
    inv = (var + 1e-5).rsqrt()
    xhat = (xd - mean) * inv
    dx = scale * inv * (gd - gd.mean(dim=dims, keepdim=True)
                        - xhat * (gd * xhat).mean(dim=dims, keepdim=True)) if train \
        else scale * inv * gd
    return [xhat * scale + bias, dx, (gd * xhat).sum(dim=dims), gd.sum(dim=dims)]


def _bn_allowance(x, g, params, train):
    """How far two f32 evaluations of BatchNorm may lie apart, per element
    of y, dx, dscale and dbias: 1e-5 of |y| + 1 (a gradient: 1e-4 of its
    largest magnitude), plus, in train mode, how far the batch stats moved
    by a few f32 ulps (`_bn_f64`) move it."""
    exact = _bn_f64(x, g, params, train)
    allow = [1e-5 * (exact[0].abs() + 1)] + [1e-4 * e.abs().max().expand_as(e) for e in exact[1:]]
    if train:
        for shift in (1.0, -1.0):
            allow = [a + (m - e).abs()
                     for a, m, e in zip(allow, _bn_f64(x, g, params, train, shift), exact)]
    return allow


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", _BN_SHAPES)
def test_batchnorm_gate_on_card(dev, monkeypatch, shape, train, dtype):
    """BatchNorm with the gate on (the kernels at n=1) against the same
    module with the gate on over the kernels' plain twins on the CPU, and
    with the gate off (F.batch_norm): in f32 the output and the gradients of
    x, scale and bias within `_bn_allowance` of both (the gate's one-sweep
    variance cancels where E[x^2] >> var: on planes of two values, 1x1 at
    batch 2, it moves y by up to ~1e-2), the running stats within 1e-5. In
    bf16 the output at the bf16 bound against the twins; the gradients
    against the f64 ones of the same bf16 x and cotangent, within the
    allowance (dx, a bf16 tensor, plus one rounding, 2^-8 of its value),
    and within 2e-2 of the largest magnitude of the gate-off path's (whose
    own bf16 scale and bias gradients lie ~4e-3 of their largest magnitude
    off the f64 ones at [2,512,8,8] on an H100)."""
    from senas_torch.ops.primitives import BatchNorm
    c = shape[1]
    x = _xs(dev, 1, shape, seed=20, dtype=dtype)[0]
    readout = _xs(dev, 1, shape, seed=21)[0]
    params = [_per_plane(dev, c, seed=22).abs() + 0.5, 0.1 * _per_plane(dev, c, seed=23),
              0.1 * _per_plane(dev, c, seed=24), _per_plane(dev, c, seed=25).abs() + 0.5]

    def run(gate, device):
        monkeypatch.setenv("SENAS_PALLAS_BN", gate)
        bn = BatchNorm(c, dtype=dtype).to(device)
        with torch.no_grad():
            for t, v in zip((bn.scale, bn.bias, bn.mean, bn.var), params):
                t.copy_(v)
        xi = x.detach().to(device).requires_grad_()
        y = bn(xi, train=train)
        (y.float() * readout.to(device)).sum().backward()
        return [t.detach().float().cpu() for t in (y, xi.grad, bn.scale.grad, bn.bias.grad,
                                                   bn.mean, bn.var)]

    launches = ge.apply_mix.launches_by_dtype[str(dtype).removeprefix("torch.")]
    on, off, twin = run("1", dev), run("0", dev), run("1", "cpu")
    assert ge.apply_mix.launches_by_dtype[str(dtype).removeprefix("torch.")] == launches + 1
    if dtype == torch.float32:
        allow = _bn_allowance(x, readout, params, train)
        for want in (twin, off):
            for got, ref, a in zip(on[:4], want[:4], allow):
                assert bool(((got.double() - ref.double()).abs() <= a).all())
            for got, ref in zip(on[4:], want[4:]):
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        terms = x.float().abs().cpu() * 10 + 10
        _assert_bf16_close(on[0].bfloat16(), twin[0].bfloat16(), terms)
        g = readout.bfloat16().float()
        exact, allow = _bn_f64(x.float(), g, params, train), _bn_allowance(x.float(), g, params,
                                                                            train)
        allow[1] = allow[1] + 2.0 ** -8 * exact[1].abs()
        for got, e, a in zip(on[1:4], exact[1:], allow[1:]):
            assert bool(((got.double() - e).abs() <= a).all())
        for got, ref in zip(on[4:], twin[4:]):
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        for got, want in zip(on, off):
            assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
