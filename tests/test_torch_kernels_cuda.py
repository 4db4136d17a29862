"""The port's CUDA kernels (the epilogue's four, K2 norm_convs) against
their plain PyTorch versions, on the card. Every test here needs an NVIDIA
GPU with nvcc and skips without one; on the card run (the suite's conftest
imports JAX, which this file does not need):
python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: the kernels sum in another order than PyTorch's reductions.
Sums are held to 1e-5 of the plane's sum of |x| (resp. x^2, |g*x|, |g|),
elementwise outputs (the mix, the branch gradients) to atol 1e-4 on values
of scale ~1-10, the epilogue's gradients to rtol/atol 1e-4. norm_convs is
held to 1e-5 of the same convolutions of |x| and |w| (each output's sum of
|products|): the kernel (3xTF32 on the tensor cores, f32 sums) and cuDNN
sum the products in other orders."""

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


def _xs(dev, n, shape, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [(torch.randn(shape, generator=g) * (1 + o) + o).to(dev) for o in range(n)]


@pytest.mark.parametrize("n", [1, 5, 6])
@pytest.mark.parametrize("shape", [(8, 24, 64, 64), (2, 24, 8, 8), (2, 3, 5, 7)])
def test_branch_stats_kernel(dev, n, shape):
    xs = _xs(dev, n, shape)
    before = ge.branch_stats.launches
    s1, s2 = ge.branch_stats(xs)
    torch.cuda.synchronize()
    assert ge.branch_stats.launches == before + 1
    p1, p2 = ge.branch_stats_plain(xs)
    abs1 = torch.stack([x.abs().sum(dim=(2, 3)) for x in xs])
    assert ((s1 - p1).abs() <= 1e-5 * abs1 + 1e-6).all()
    assert ((s2 - p2).abs() <= 1e-5 * p2 + 1e-6).all()


@pytest.mark.parametrize("n", [1, 5, 6])
@pytest.mark.parametrize("shape", [(8, 24, 64, 64), (2, 24, 8, 8), (2, 3, 5, 7)])
def test_apply_mix_kernel(dev, n, shape):
    xs = _xs(dev, n, shape, seed=1)
    b, c = shape[:2]
    a = torch.randn(n, b, c, device=dev)
    k = torch.randn(b, c, device=dev)
    before = ge.apply_mix.launches
    out = ge.apply_mix(xs, a, k)
    torch.cuda.synchronize()
    assert ge.apply_mix.launches == before + 1
    torch.testing.assert_close(out, ge.apply_mix_plain(xs, a, k), rtol=0, atol=1e-4)


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


@pytest.mark.parametrize("n", [1, 5, 6])
@pytest.mark.parametrize("shape", _SHAPES)
def test_bwd_reduce_kernel(dev, n, shape):
    xs = _xs(dev, n, shape, seed=4)
    g = _xs(dev, 1, shape, seed=5)[0]
    before = ge.bwd_reduce.launches
    da, dk = ge.bwd_reduce(xs, g)
    torch.cuda.synchronize()
    assert ge.bwd_reduce.launches == before + 1
    pa, pk = ge.bwd_reduce_plain(xs, g)
    abs_a = torch.stack([(g * x).abs().sum(dim=(2, 3)) for x in xs])
    assert ((da - pa).abs() <= 1e-5 * abs_a + 1e-6).all()
    assert ((dk - pk).abs() <= 1e-5 * g.abs().sum(dim=(2, 3)) + 1e-6).all()


@pytest.mark.parametrize("n", [1, 5, 6])
@pytest.mark.parametrize("shape", _SHAPES)
def test_bwd_dx_kernel(dev, n, shape):
    xs = _xs(dev, n, shape, seed=6)
    g = _xs(dev, 1, shape, seed=7)[0]
    b, c = shape[:2]
    a, ds1, ds2 = (torch.randn(n, b, c, device=dev) for _ in range(3))
    before = ge.bwd_dx.launches
    got = ge.bwd_dx(xs, g, a, ds1, ds2)
    torch.cuda.synchronize()
    assert ge.bwd_dx.launches == before + 1
    for o, want in enumerate(ge.bwd_dx_plain(xs, g, a, ds1, ds2)):
        torch.testing.assert_close(got[o], want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("se,none", [(True, False), (False, True), (False, False)])
def test_fused_epilogue_gradients_on_card(dev, train, se, none):
    """The autograd Function's gradients (K1a-K1d and the glue's VJP)
    against torch autograd through the plain two-pass reference."""
    E, P, n = 3, 8, 6 if se else 5
    C = E * P
    g = torch.Generator(device="cpu").manual_seed(8)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    kw = dict(train=train)
    if not train:
        kw.update(run_means=[0.3 * r(C) for _ in range(n)],
                  run_vars=[r(C).abs() + 0.5 for _ in range(n)])
    diff = dict(xs=_xs(dev, n, (4, C, 16, 16), seed=9),
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
    before = (ge.bwd_reduce.launches, ge.bwd_dx.launches)
    got = torch.autograd.grad((call(ge.fused_group_epilogue)[0] * readout).sum(), leaves)
    torch.cuda.synchronize()
    assert (ge.bwd_reduce.launches, ge.bwd_dx.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad((call(ge.group_epilogue_reference) * readout).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_card_rejects_other_dtypes(dev):
    xs = [x.half() for x in _xs(dev, 2, (2, 24, 8, 8))]
    with pytest.raises(NotImplementedError):
        ge.branch_stats(xs)


# (b, c, h, w, n): a main-sized tile, edge tiles in both directions,
# partial channel chunks and groups, images smaller than the 13-pixel
# receptive field, n > 32 (channel slices over two blocks), and
# chip_smoke.py's edge shape (100 = 12*8 + 4 rows, 70 = 64 + 6 columns)
_NORM_SHAPES = [(2, 32, 64, 64, 24), (1, 10, 9, 35, 12), (2, 3, 5, 7, 4),
                (3, 10, 8, 1, 8), (1, 2, 17, 40, 40), (5, 32, 100, 70, 24)]


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


def test_norm_convs_rejects_what_it_does_not_take(dev):
    x = torch.randn(1, 2, 8, 8, device=dev)
    ks = [torch.randn(3, 2, k, k, device=dev) for k in (3, 5, 5)]
    with pytest.raises(NotImplementedError):
        nc.norm_convs(x.half(), *ks)
    with pytest.raises(ValueError, match="contiguous"):
        nc.norm_convs(x.transpose(2, 3), *ks)
