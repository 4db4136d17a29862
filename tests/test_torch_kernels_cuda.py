"""The epilogue's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU with nvcc and skips without one;
on the card run (the suite's conftest imports JAX, which this file does not
need): python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: the kernels sum in another order than PyTorch's reductions.
Sums are held to 1e-5 of the plane's sum of |x| (resp. x^2), outputs of
the mix to atol 1e-4 on values of scale ~1-10."""

import numpy as np
import pytest
import torch

from senas_torch.ops import grouped_epilogue as ge

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


def test_card_forward_with_grad_raises(dev):
    xs = [x.requires_grad_() for x in _xs(dev, 2, (2, 24, 8, 8))]
    ones = [torch.ones(24, device=dev)] * 2
    with pytest.raises(NotImplementedError, match="training slice"):
        ge.fused_group_epilogue(xs, ones, ones, ones)
    with torch.no_grad():
        ge.fused_group_epilogue(xs, ones, ones, ones)


def test_card_rejects_other_dtypes(dev):
    xs = [x.half() for x in _xs(dev, 2, (2, 24, 8, 8))]
    with pytest.raises(NotImplementedError):
        ge.branch_stats(xs)
