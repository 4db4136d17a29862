"""The three NORM convolutions of one input in one kernel (K2).

Port of `senas_tpu/ops/pallas_kernels.py`: `fused_norm_convs` computes the
3x3 dilation-1, 5x5 dilation-2 and 5x5 dilation-3 convolutions (stride 1,
torch 'same' padding 1, 4 and 6) of one input and concatenates them in that
order. In the port's idiom it is NCHW:

    norm_convs(x [B,C,H,W], k3 [N,C,3,3], k5d2 [N,C,5,5], k5d3 [N,C,5,5])
        -> [B,3N,H,W]

On the card it launches the hand-written kernel of csrc/norm_convs.cu, an
implicit GEMM on Hopper's tensor cores (wgmma) in split precision: each
operand is split into two TF32 parts and three TF32 products stand for one
f32 product (3xTF32), so the result stays within f32 rounding of the plain
version. bf16 operands (the Pallas kernel takes x's dtype) go to the bf16
kernel: one bf16 product each, summed in f32, each output rounded once to
bf16, as the Pallas kernel's f32 accumulator is. It first copies x into a
channel-inner layout ([B][ceil(C/8)][H][W][8], 8 channels a 16-byte row),
from which TMA stages each tile and its halo, so that a tap's shift is the
start address of a wgmma descriptor and A and B are both read from shared
memory; a producer warpgroup fills a ring of 3 stages for two consumer
warpgroups (csrc/norm_convs.cu's header note). On the CPU it takes
`norm_convs_plain`, the counterpart of the JAX package's `xla_norm_convs`. The wrapper never falls back from one to the other. As in
the JAX package, no model path calls it: it is forward only (no VJP), and no
group of the supernet has exactly these three branches. Its yardstick is the
three library convolutions (`chip_smoke.py`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

BRANCHES = ((3, 1), (5, 2), (5, 3))  # (kernel, dilation), in output order


def norm_convs_plain(x: torch.Tensor, k3: torch.Tensor, k5d2: torch.Tensor,
                     k5d3: torch.Tensor) -> torch.Tensor:
    """torch.cat of the three F.conv2d calls (padding (k//2)*d, dilation d).
    bf16 operands: the f32 convolutions of their values (every product
    exact), rounded once to bf16, as the Pallas kernel accumulates in f32
    and writes x's dtype; not F.conv2d in bf16, whose CPU kernels round
    otherwise."""
    if x.dtype == torch.bfloat16:
        return norm_convs_plain(x.float(), k3.float(), k5d2.float(), k5d3.float()).to(x.dtype)
    return torch.cat([F.conv2d(x, w, padding=(k // 2) * d, dilation=d)
                      for (k, d), w in zip(BRANCHES, (k3, k5d2, k5d3))], dim=1)


_LIB = None


def _lib():
    """Build (first use) and load the kernel's library; declare every
    argument type, so that ctypes passes pointers at their full width."""
    global _LIB
    if _LIB is None:
        from senas_torch.ops import _build
        lib = _build.load("norm_convs")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        i64 = ctypes.c_longlong
        lib.senas_norm_convs_f32.argtypes = [ptr] * 5 + [i32] * 5 + [ptr, i64, ptr]
        lib.senas_norm_convs_f32.restype = i32
        lib.senas_norm_convs_scratch_floats.argtypes = [i32, i32]
        lib.senas_norm_convs_scratch_floats.restype = i64
        lib.senas_norm_convs_bf16.argtypes = [ptr] * 5 + [i32] * 5 + [ptr, i64, ptr]
        lib.senas_norm_convs_bf16.restype = i32
        lib.senas_norm_convs_bf16_scratch_elems.argtypes = [i32] * 5
        lib.senas_norm_convs_bf16_scratch_elems.restype = i64
        lib.senas_norm_convs_error_string.argtypes = [i32]
        lib.senas_norm_convs_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


DTYPES = (torch.float32, torch.bfloat16)


def _check(x, k3, k5d2, k5d3):
    """What both paths take: NCHW-contiguous operands of one dtype, f32 or
    bf16 (no operand is cast: a bf16 x with f32 kernels raises), on one
    device, with the kernels' shapes."""
    ops = (x, k3, k5d2, k5d3)
    for t in ops:
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise NotImplementedError(
                "norm_convs takes float32 or bfloat16 operands of one dtype, got "
                f"{[str(o.dtype) for o in ops]}")
        if t.device != x.device:
            raise ValueError("norm_convs operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("norm_convs operands must be contiguous (NCHW, OIHW)")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,C,H,W], got {tuple(x.shape)}")
    c = x.shape[1]
    n = k3.shape[0]
    for (k, _), w in zip(BRANCHES, (k3, k5d2, k5d3)):
        if tuple(w.shape) != (n, c, k, k):
            raise ValueError(f"a {k}x{k} kernel must be {(n, c, k, k)}, got {tuple(w.shape)}")


def norm_convs(x: torch.Tensor, k3: torch.Tensor, k5d2: torch.Tensor,
               k5d3: torch.Tensor) -> torch.Tensor:
    """The 3x3 d1, 5x5 d2 and 5x5 d3 convolutions of x, concatenated over
    channels: [B,C,H,W] -> [B,3N,H,W], in x's dtype (f32 or bf16).

    Kernels `norm_convs` and `norm_convs_bf16` (csrc/norm_convs.cu) on the
    card; they replace the TPU kernel `_norm_convs_kernel` through
    `fused_norm_convs` (senas_tpu/ops/pallas_kernels.py:37-99). Bound by
    operations: 2*B*H*W*C*N*59 FLOP, in f32 each as three TF32 products on
    the tensor cores, in bf16 one bf16 product, against
    (B*C + 3*B*N)*H*W bytes of the dtype. Scratch allocated here: the
    split weights (f32); the packed weights and x in the channel-inner
    layout [B][ceil(C/8)][H][W][8], from which TMA stages each tile
    (bf16: B*ceil(C/8)*H*W*8 elements beside the weights)."""
    _check(x, k3, k5d2, k5d3)
    if x.device.type == "cpu":
        return norm_convs_plain(x, k3, k5d2, k5d3)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, c, h, w = x.shape
    n = k3.shape[0]
    lib = _lib()
    out = torch.empty((b, 3 * n, h, w), device=x.device, dtype=x.dtype)
    if x.dtype == torch.bfloat16:
        entry = lib.senas_norm_convs_bf16
        scratch = torch.empty(lib.senas_norm_convs_bf16_scratch_elems(b, c, h, w, n),
                              device=x.device, dtype=torch.bfloat16)
    else:
        entry = lib.senas_norm_convs_f32
        scratch = torch.empty(lib.senas_norm_convs_scratch_floats(c, n), device=x.device,
                              dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(x.data_ptr(), k3.data_ptr(), k5d2.data_ptr(), k5d3.data_ptr(),
                   out.data_ptr(), b, c, h, w, n, scratch.data_ptr(), scratch.numel(), stream)
    if rc != 0:
        msg = lib.senas_norm_convs_error_string(rc).decode()
        raise RuntimeError(f"norm_convs kernel launch failed: {msg} (cudaError {rc})")
    norm_convs.launches += 1
    norm_convs.launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1
    return out


norm_convs.launches = 0
norm_convs.launches_by_dtype = {str(dt).removeprefix("torch."): 0 for dt in DTYPES}


def flops(x_shape, n: int) -> int:
    """Multiply-adds (as 2 FLOP) of one call: every output pixel of every
    branch sums C * k*k products."""
    b, c, h, w = x_shape
    return 2 * b * h * w * c * n * sum(k * k for k, _ in BRANCHES)


def nbytes(x_shape, n: int, itemsize: int = 4) -> int:
    """Bytes one call must move: x and the kernels read once, the output
    written once, `itemsize` bytes an element (4 for f32, 2 for bf16)."""
    b, c, h, w = x_shape
    weights = n * c * sum(k * k for k, _ in BRANCHES)
    return itemsize * (b * c * h * w + weights + 3 * b * n * h * w)
