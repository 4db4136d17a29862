"""Fused BN(+SE)+alpha-mix epilogue of GroupedMixedOp, forward and backward.

Port of `senas_tpu/ops/grouped_epilogue.py`. For every branch o of a group
the whole post-conv epilogue is an affine map per (batch, channel):

    mixed[b,c,h,w] = sum_o x_o[b,c,h,w] * A_o[b,c] + K[b,c]

  * BN train mode: y = (x - mu_c) * rsqrt(var_c + eps) * g_c + b_c, affine
    once (mu, var) are known; eval mode is affine in the running stats.
  * SE: the post-BN spatial mean m[b,c] is affine in the raw per-(b,c)
    mean, so the sigmoid-MLP scale s[b,c] folds into A/K.
  * 'none': BN(zeros) is a closed-form constant added into K.
  * alpha mixing: a per-channel scale on each branch.

Four kernels carry it (senas_torch/csrc/grouped_epilogue.cu). Forward:
`branch_stats` sums each (o, b, c) plane and its squares in one sweep over
all n branch tensors; the glue folds those into A and K ([n,B,C]-sized
PyTorch ops); `apply_mix` reads each branch once more and writes the mixed
output. Backward, inside one `torch.autograd.Function` (the JAX package's
custom VJP): `bwd_reduce` gives dA, dK from the output's gradient g; torch
autograd differentiates the glue, which gives the parameters' gradients
and ds1, ds2 (the gradients of the sums); `bwd_dx` forms each branch's
gradient g*A + ds1 + 2*x*ds2. Tensors are NCHW contiguous. Each wrapper
takes its plain PyTorch version for a tensor on the CPU and launches its
kernel for one on the card; it never falls back from one to the other.

Precision, as in the Pallas kernels: the branch tensors, the output's
gradient g, `mixed` and each dx_o are f32 or bf16 (one dtype for all of
them); the per-(b,c) terms A, K, ds1, ds2 and the sums s1, s2, dA, dK are
f32. Sums and products are taken in f32 and a bf16 result is rounded once.
Each dtype has its own kernel: a bf16 tensor on the card reaches the bf16
kernel, and f16 or f64 raises. Every wrapper counts its launches in all
(`launches`) and by dtype (`launches_by_dtype`).

The batch variance is the one-sweep max(E[x^2] - mu^2, 0) in f32, as in
the JAX package; `group_epilogue_reference` uses the two-pass form and the
tests hold the two to f32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

EPS = 1e-5
MAX_BRANCHES = 6
# kReduceTargetBlocks of csrc/grouped_epilogue.cu: the blocks bwd_reduce
# spreads its planes over
_REDUCE_BLOCKS = 8 * 132


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------------


def branch_stats_plain(xs: Sequence[torch.Tensor]):
    """n tensors [B,C,H,W] -> (s1, s2), each [n,B,C] f32: per-plane sums
    of x and x^2 over H and W."""
    xf = [x.float() for x in xs]
    return (torch.stack([x.sum(dim=(2, 3)) for x in xf]),
            torch.stack([(x * x).sum(dim=(2, 3)) for x in xf]))


def apply_mix_plain(xs: Sequence[torch.Tensor], a: torch.Tensor,
                    k: torch.Tensor, out_dtype=None):
    """out = k[b,c] + sum_o a[o,b,c] * x_o  (a: [n,B,C], k: [B,C] f32)."""
    acc = k[:, :, None, None].expand(xs[0].shape)
    for o, x in enumerate(xs):
        acc = acc + x.float() * a[o][:, :, None, None]
    return acc.to(out_dtype or xs[0].dtype)


def bwd_reduce_plain(xs: Sequence[torch.Tensor], g: torch.Tensor):
    """n tensors and g [B,C,H,W] -> (dA [n,B,C], dK [B,C]) f32:
    dA[o] = sum_hw g * x_o, dK = sum_hw g."""
    gf = g.float()
    return (torch.stack([(gf * x.float()).sum(dim=(2, 3)) for x in xs]),
            gf.sum(dim=(2, 3)))


def bwd_dx_plain(xs: Sequence[torch.Tensor], g: torch.Tensor, a: torch.Tensor,
                 ds1: torch.Tensor, ds2: torch.Tensor):
    """dx_o = g * a[o] + ds1[o] + 2 * x_o * ds2[o] with a, ds1, ds2 [n,B,C]
    f32 broadcast over H and W; each dx_o in its x's dtype."""
    gf = g.float()
    col = lambda t: t[:, :, None, None]
    return [(gf * col(a[o]) + col(ds1[o]) + 2.0 * x.float() * col(ds2[o])).to(x.dtype)
            for o, x in enumerate(xs)]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None
# The element types the kernels take, with the suffix of their entry points.
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _lib():
    """Build (first use) and load the kernels' library; declare every
    argument type, so that ctypes passes pointers at their full width."""
    global _LIB
    if _LIB is None:
        from senas_torch.ops import _build
        lib = _build.load("grouped_epilogue")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for sfx in _SUFFIX.values():
            for name, args in (
                    ("branch_stats", [i32, i32, i64, ptr, ptr, ptr]),
                    ("apply_mix", [i32, ptr, ptr, ptr, i32, i64, ptr]),
                    ("bwd_reduce", [i32, ptr, i32, i64, ptr, i64, ptr, ptr, ptr]),
                    ("bwd_dx", [i32, ptr, ptr, ptr, ptr] + [ptr] * MAX_BRANCHES
                     + [i32, i64, ptr])):
                fn = getattr(lib, f"senas_{name}_{sfx}")
                fn.argtypes = [ptr] * MAX_BRANCHES + args
                fn.restype = i32
        lib.senas_cuda_error_string.argtypes = [i32]
        lib.senas_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _kernel(name: str, dtype: torch.dtype):
    """The entry point of kernel `name` for branch tensors of `dtype`."""
    return getattr(_lib(), f"senas_{name}_{_SUFFIX[dtype]}")


def _check_branches(xs: Sequence[torch.Tensor]):
    if not 1 <= len(xs) <= MAX_BRANCHES:
        raise ValueError(f"1..{MAX_BRANCHES} branch tensors, got {len(xs)}")
    x0 = xs[0]
    if x0.dim() != 4:
        raise ValueError(f"branch tensors are [B,C,H,W], got {tuple(x0.shape)}")
    for x in xs:
        if x.shape != x0.shape or x.device != x0.device or x.dtype != x0.dtype:
            raise ValueError("branch tensors differ in shape, device or dtype")


def _check_card(xs: Sequence[torch.Tensor], g: Optional[torch.Tensor] = None,
                per_plane: Sequence[torch.Tensor] = ()):
    """What the CUDA kernels take: the branch tensors (and g) in f32 or bf16,
    one dtype for all of them; the per-(b,c) operands in f32; everything
    NCHW-contiguous on one card. Nothing is converted here: a dtype without
    a kernel raises."""
    if xs[0].device.type != "cuda":
        raise ValueError(f"no kernel for device {xs[0].device}")
    if xs[0].dtype not in _SUFFIX:
        raise NotImplementedError(
            f"the epilogue kernels take float32 or bfloat16, got {xs[0].dtype}")
    streamed = [*xs, *([] if g is None else [g])]
    for t in (*streamed, *per_plane):
        if t.device != xs[0].device:
            raise ValueError("kernel operands must lie on one device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous (NCHW)")
    if any(t.dtype != xs[0].dtype for t in streamed):
        raise ValueError("g must have the branch tensors' dtype")
    if any(t.dtype != torch.float32 for t in per_plane):
        raise ValueError("the per-plane operands (a, k, ds1, ds2) must be float32")


def _ptrs(xs):
    return [x.data_ptr() for x in xs] + [None] * (MAX_BRANCHES - len(xs))


def _raise_on(rc: int, what: str):
    if rc != 0:
        msg = _lib().senas_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def _counted(fn):
    """Give a wrapper its launch counts: `launches`, all of them, and
    `launches_by_dtype`, split by the branch tensors' dtype name."""
    fn.launches = 0
    fn.launches_by_dtype = {str(dt).removeprefix("torch."): 0 for dt in _SUFFIX}
    return fn


def _count(fn, dtype: torch.dtype) -> None:
    fn.launches += 1
    fn.launches_by_dtype[str(dtype).removeprefix("torch.")] += 1


@_counted
def branch_stats(xs: Sequence[torch.Tensor]):
    """Per-plane sums of x and x^2 for n (<= 6) branch tensors [B,C,H,W].

    Kernel `branch_stats` (csrc/grouped_epilogue.cu) on the card, for f32
    or bf16 branches; replaces the TPU kernel `_stats_kernel` through
    `_branch_stats` (senas_tpu/ops/grouped_epilogue.py:86-135).
    Memory-bound: it reads n*B*C*H*W*e bytes (e = 4 or 2) and writes
    2*n*B*C*4. Returns (s1, s2) [n,B,C] f32."""
    _check_branches(xs)
    if xs[0].device.type == "cpu":
        return branch_stats_plain(xs)
    _check_card(xs)
    n = len(xs)
    b, c, h, w = xs[0].shape
    s1 = torch.empty((n, b, c), device=xs[0].device, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("branch_stats", xs[0].dtype)(*_ptrs(xs), n, b * c, h * w,
                                                   s1.data_ptr(), s2.data_ptr(), stream)
    _raise_on(rc, "branch_stats")
    _count(branch_stats, xs[0].dtype)
    return s1, s2


@_counted
def apply_mix(xs: Sequence[torch.Tensor], a: torch.Tensor, k: torch.Tensor,
              out_dtype=None):
    """out[b,c] = k[b,c] + sum_o a[o,b,c] * x_o[b,c] for n (<= 6) branch
    tensors [B,C,H,W]; a [n,B,C] f32, k [B,C] f32. Summed in f32; the out
    is written in the branches' dtype (a bf16 one rounded once).

    Kernel `apply_mix` (csrc/grouped_epilogue.cu) on the card; replaces the
    TPU kernel `_apply_kernel` through `_apply_mix`
    (senas_tpu/ops/grouped_epilogue.py:143-181). Memory-bound: it reads
    n*B*C*H*W*e + (n+1)*B*C*4 bytes and writes B*C*H*W*e (e = 4 or 2)."""
    _check_branches(xs)
    n = len(xs)
    b, c, h, w = xs[0].shape
    if tuple(a.shape) != (n, b, c) or tuple(k.shape) != (b, c):
        raise ValueError(f"a must be {(n, b, c)} and k {(b, c)}, got "
                         f"{tuple(a.shape)} and {tuple(k.shape)}")
    if xs[0].device.type == "cpu":
        return apply_mix_plain(xs, a, k, out_dtype)
    _check_card(xs, per_plane=(a, k))
    if (out_dtype or xs[0].dtype) != xs[0].dtype:
        raise NotImplementedError("the apply_mix kernel writes the branch tensors' dtype, "
                                  f"{xs[0].dtype}, not {out_dtype}")
    out = torch.empty_like(xs[0])
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("apply_mix", xs[0].dtype)(*_ptrs(xs), n, a.data_ptr(), k.data_ptr(),
                                                out.data_ptr(), b * c, h * w, stream)
    _raise_on(rc, "apply_mix")
    _count(apply_mix, xs[0].dtype)
    return out


def _check_planes(xs, g, *per_plane):
    """g like xs[0]; each of `per_plane` [n,B,C]."""
    n = len(xs)
    b, c = xs[0].shape[:2]
    if g.shape != xs[0].shape or g.device != xs[0].device:
        raise ValueError(f"g must be {tuple(xs[0].shape)} on {xs[0].device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    for t in per_plane:
        if tuple(t.shape) != (n, b, c):
            raise ValueError(f"per-plane operands must be {(n, b, c)}, got {tuple(t.shape)}")


@_counted
def bwd_reduce(xs: Sequence[torch.Tensor], g: torch.Tensor):
    """dA[o,b,c] = sum_hw g * x_o and dK[b,c] = sum_hw g for n (<= 6)
    branch tensors and g [B,C,H,W] of one dtype. Returns (dA [n,B,C],
    dK [B,C]) f32.

    Kernel `bwd_reduce` (csrc/grouped_epilogue.cu) on the card, two
    launches (partial sums over chunks of each plane, then their ordered
    sum); replaces the TPU kernel `_bwd_reduce_kernel` through `_bwd_reduce`
    (senas_tpu/ops/grouped_epilogue.py:189-229). Memory-bound: it reads
    (n+1)*B*C*H*W*e bytes (e = 4 or 2) and writes (n+1)*B*C*4."""
    _check_branches(xs)
    _check_planes(xs, g)
    if xs[0].device.type == "cpu":
        return bwd_reduce_plain(xs, g)
    _check_card(xs, g)
    n = len(xs)
    b, c, h, w = xs[0].shape
    dA = torch.empty((n, b, c), device=xs[0].device, dtype=torch.float32)
    dK = torch.empty((b, c), device=xs[0].device, dtype=torch.float32)
    # the partial sums: n+1 per chunk, each plane cut into at most
    # ceil(_REDUCE_BLOCKS / planes) chunks (the kernel checks the size)
    partial = torch.empty((n + 1) * (b * c + _REDUCE_BLOCKS), device=xs[0].device,
                          dtype=torch.float32)
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("bwd_reduce", xs[0].dtype)(*_ptrs(xs), n, g.data_ptr(), b * c, h * w,
                                                 partial.data_ptr(), partial.numel(),
                                                 dA.data_ptr(), dK.data_ptr(), stream)
    _raise_on(rc, "bwd_reduce")
    _count(bwd_reduce, xs[0].dtype)
    return dA, dK


@_counted
def bwd_dx(xs: Sequence[torch.Tensor], g: torch.Tensor, a: torch.Tensor,
           ds1: torch.Tensor, ds2: torch.Tensor):
    """dx_o = g * a[o,b,c] + ds1[o,b,c] + 2 * x_o * ds2[o,b,c] for n (<= 6)
    branch tensors and g [B,C,H,W] of one dtype; a, ds1, ds2 [n,B,C] f32.
    Computed in f32; returns the list of n gradients, each in its x's dtype.

    Kernel `bwd_dx` (csrc/grouped_epilogue.cu) on the card; replaces the
    TPU kernel `_bwd_dx_kernel` through `_bwd_dx`
    (senas_tpu/ops/grouped_epilogue.py:237-273). Memory-bound: it reads
    (n+1)*B*C*H*W*e + 3*n*B*C*4 bytes and writes n*B*C*H*W*e (e = 4 or 2)."""
    _check_branches(xs)
    _check_planes(xs, g, a, ds1, ds2)
    if xs[0].device.type == "cpu":
        return bwd_dx_plain(xs, g, a, ds1, ds2)
    _check_card(xs, g, per_plane=(a, ds1, ds2))
    n = len(xs)
    b, c, h, w = xs[0].shape
    outs = [torch.empty_like(x) for x in xs]
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("bwd_dx", xs[0].dtype)(*_ptrs(xs), n, g.data_ptr(), a.data_ptr(),
                                             ds1.data_ptr(), ds2.data_ptr(), *_ptrs(outs),
                                             b * c, h * w, stream)
    _raise_on(rc, "bwd_dx")
    _count(bwd_dx, xs[0].dtype)
    return outs


# ---------------------------------------------------------------------------
# Glue: fold sums into BN affines / SE scales ([n,B,C]-sized PyTorch ops)
# ---------------------------------------------------------------------------


def _glue(s1, s2, g, bb, al, se_w1, se_w2, none_k, rm, rv, *, b: int,
          hw: int, train: bool, se_index: Optional[int], E: int, P: int):
    """s1, s2: [n,B,C] f32 per-plane sums (None in eval mode without SE);
    g, bb, al: [n,C] BN scale, bias and alpha columns; none_k: [C] or None.
    Returns (a_full [n,B,C], k_full [B,C], mu [n,C], var [n,C])."""
    n, c = g.shape
    if train:
        cnt = b * hw
        mu = s1.sum(dim=1) / cnt                            # [n, C]
        var = torch.clamp(s2.sum(dim=1) / cnt - mu * mu, min=0.0)
    else:
        mu, var = rm, rv
    a_bn = torch.rsqrt(var + EPS) * g                       # [n, C]
    k_bn = bb - mu * a_bn                                   # [n, C]

    if se_index is None:
        # no per-(b, c) scale: the affines are per channel, broadcast over B
        # (the same values as the SE form's products with ones, in fewer ops)
        a_full = (al * a_bn)[:, None, :].expand(n, b, c)     # [n, B, C]
        k_full = (al * k_bn).sum(dim=0).expand(b, c)         # [B, C]
    else:
        # SE: scale per (b, c) from the post-BN spatial mean, an affine of
        # the raw per-(b, c) mean (senas_tpu/ops/grouped_epilogue.py:308-319).
        s_scale = [torch.ones((b, c), device=g.device)] * n
        mean_raw = s1[se_index] / hw                        # [B, C]
        m = (mean_raw * a_bn[se_index] + k_bn[se_index]).reshape(b, E, P)
        hid = torch.relu(torch.einsum("bep,epm->bem", m, se_w1.float()))
        sig = torch.sigmoid(torch.einsum("bem,emp->bep", hid, se_w2.float()))
        s_scale[se_index] = sig.reshape(b, c)
        s_scale = torch.stack(s_scale)                      # [n, B, C]
        # Fold everything into per-(b, c) affines.
        a_full = (al * a_bn)[:, None, :] * s_scale          # [n, B, C]
        k_full = ((al * k_bn)[:, None, :] * s_scale).sum(dim=0)  # [B, C]
    if none_k is not None:
        k_full = k_full + none_k
    return a_full, k_full, mu, var


class _Config(NamedTuple):
    train: bool
    se_index: Optional[int]
    E: int
    P: int
    out_dtype: Optional[torch.dtype]


# The glue's differentiable inputs, in the order _FusedEpilogue takes them
# (after the config): their gradients come from torch autograd.
_PARAMS = ("g", "bb", "al", "se_w1", "se_w2", "none_k")


class _FusedEpilogue(torch.autograd.Function):
    """The JAX package's custom VJP (`_make_epilogue`,
    senas_tpu/ops/grouped_epilogue.py:334-378) as an autograd Function.

    forward(cfg, g, bb, al, se_w1, se_w2, none_k, rm, rv, *xs) -> (mixed,
    mu, var). Saves xs, the sums s1/s2, the parameters and A. The backward
    runs `bwd_reduce` for dA, dK; recomputes the glue under autograd on
    detached copies of s1, s2 and the parameters (the forward ran with
    gradients off) and takes its vector-Jacobian product with (dA, dK, dmu,
    dvar), which gives the parameters' gradients and ds1, ds2; then runs
    `bwd_dx` for the branch tensors. Running stats get no gradient."""

    @staticmethod
    def forward(ctx, cfg: _Config, g, bb, al, se_w1, se_w2, none_k, rm, rv, *xs):
        b, c, h, w = xs[0].shape
        # Eval mode without SE is a pure affine in the running stats: the
        # stats sweep is skipped (senas_tpu/ops/grouped_epilogue.py:341-350).
        s1 = s2 = None
        if cfg.train or cfg.se_index is not None:
            s1, s2 = branch_stats(xs)
        a_full, k_full, mu, var = _glue(s1, s2, g, bb, al, se_w1, se_w2, none_k,
                                        rm, rv, b=b, hw=h * w, train=cfg.train,
                                        se_index=cfg.se_index, E=cfg.E, P=cfg.P)
        a_full = a_full.contiguous()
        mixed = apply_mix(xs, a_full, k_full.contiguous(), cfg.out_dtype)
        ctx.cfg = cfg
        ctx.save_for_backward(s1, s2, g, bb, al, se_w1, se_w2, none_k, rm, rv,
                              a_full, *xs)
        if not cfg.train:
            # the running stats pass through and take no gradient
            mu, var = mu.clone(), var.clone()
            ctx.mark_non_differentiable(mu, var)
        return mixed, mu, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dmixed, dmu, dvar):
        cfg = ctx.cfg
        s1, s2, g, bb, al, se_w1, se_w2, none_k, rm, rv, a_full, *xs = ctx.saved_tensors
        # the incoming gradient may be non-contiguous or channels_last
        dmixed = dmixed.contiguous()
        dA, dK = bwd_reduce(xs, dmixed)

        named = dict(zip(("s1", "s2") + _PARAMS, (s1, s2, g, bb, al, se_w1, se_w2, none_k)))
        leaves = {k: v.detach().requires_grad_() for k, v in named.items() if v is not None}
        b, c, h, w = xs[0].shape
        with torch.enable_grad():
            outs = _glue(leaves.get("s1"), leaves.get("s2"),
                         *(leaves.get(k) for k in _PARAMS), rm, rv, b=b, hw=h * w,
                         train=cfg.train, se_index=cfg.se_index, E=cfg.E, P=cfg.P)
        # in eval mode mu and var are the running stats: nothing to push back
        pairs = [(o, ct) for o, ct in zip(outs, (dA, dK, dmu, dvar)) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], list(leaves.values()),
                                    [ct for _, ct in pairs], allow_unused=True)
        got = dict(zip(leaves, grads))

        dxs = [None] * len(xs)
        if any(ctx.needs_input_grad[9:]):
            # ds1/ds2 are constant over each plane; None where the glue did
            # not read the sum (eval mode: s2, and s1 off the SE branch)
            zeros = torch.zeros_like(dA)
            ds1 = zeros if got.get("s1") is None else got["s1"].contiguous()
            ds2 = zeros if got.get("s2") is None else got["s2"].contiguous()
            dxs = bwd_dx(xs, dmixed, a_full, ds1, ds2)
        return (None, *(got.get(k) for k in _PARAMS), None, None, *dxs)


def fused_group_epilogue(xs, scales, biases, alphas_cols, *,
                         train: bool = True,
                         run_means=None, run_vars=None,
                         se_index: Optional[int] = None,
                         se_w1=None, se_w2=None, E: int = 0, P: int = 0,
                         none_alpha_col=None, none_bias=None,
                         out_dtype=None):
    """Fused BN(+SE)+alpha-mix over a branch set.

    xs:            list of n pre-BN branch tensors [B, C, H, W] (C = E*P).
    scales/biases: per-branch BN scale/bias, each [C].
    alphas_cols:   per-branch per-channel mixing weight [C] (alpha[o, e]
                   broadcast over the P channels of edge e).
    train:         True -> normalise by batch stats (and return them);
                   False -> by run_means/run_vars (lists of [C]).
    se_index:      which branch (if any) has the SE epilogue; se_w1
                   [E, P, mid], se_w2 [E, mid, P].
    none_*:        closed-form 'none' branch constant, mixed in via its
                   alpha column.
    Returns (mixed [B,C,H,W], (means [n,C], vars [n,C])): the biased batch
    stats per branch in train mode, for the caller's running-stat updates.
    Differentiable in xs, scales, biases, alphas_cols, se_w1/se_w2 and the
    'none' inputs (through `_FusedEpilogue`).
    """
    _check_branches(xs)
    g = torch.stack(list(scales)).float()
    bb = torch.stack(list(biases)).float()
    al = torch.stack(list(alphas_cols)).float()
    rm = rv = None
    if not train:
        rm = torch.stack(list(run_means)).float()
        rv = torch.stack(list(run_vars)).float()
    none_k = None
    if none_alpha_col is not None:
        none_k = none_alpha_col.float() * none_bias.float()
    if se_index is None:
        se_w1 = se_w2 = None
    cfg = _Config(bool(train), se_index, E, P, out_dtype)
    mixed, mu, var = _FusedEpilogue.apply(cfg, g, bb, al, se_w1, se_w2, none_k,
                                          rm, rv, *xs)
    return mixed, (mu, var)


def group_epilogue_reference(xs, scales, biases, alphas_cols, *,
                             train: bool = True,
                             run_means=None, run_vars=None,
                             se_index=None, se_w1=None, se_w2=None,
                             E: int = 0, P: int = 0,
                             none_alpha_col=None, none_bias=None,
                             out_dtype=None):
    """The unfused epilogue, branch by branch (mirrors
    senas_tpu/ops/grouped_epilogue.py:429-464): per-branch BN with the
    two-pass variance -> optional SE -> alpha-weighted sum (+ 'none')."""
    b, c, h, w = xs[0].shape
    dt = out_dtype or xs[0].dtype
    acc = torch.zeros((b, c, h, w), dtype=torch.float32, device=xs[0].device)
    for o, (x, g, bb, a) in enumerate(zip(xs, scales, biases, alphas_cols)):
        xf = x.float()
        if train:
            mu = xf.mean(dim=(0, 2, 3))
            var = ((xf - mu[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        else:
            mu, var = run_means[o], run_vars[o]
        y = ((xf - mu[:, None, None]) * torch.rsqrt(var + EPS)[:, None, None]
             * g[:, None, None] + bb[:, None, None]).to(dt)
        if o == se_index:
            m = y.reshape(b, E, P, h, w).mean(dim=(3, 4))   # [B, E, P]
            hid = torch.relu(torch.einsum("bep,epm->bem", m, se_w1.to(y.dtype)))
            sig = torch.sigmoid(torch.einsum("bem,emp->bep", hid, se_w2.to(y.dtype)))
            y = (y.reshape(b, E, P, h, w) * sig[..., None, None]).reshape(b, c, h, w)
        acc = acc + a.float()[:, None, None] * y.float()
    if none_alpha_col is not None:
        acc = acc + (none_alpha_col.float() * none_bias.float())[:, None, None]
    return acc.to(dt)
