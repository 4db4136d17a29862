// Hopper (sm_90a) kernels for the fused BN(+SE)+alpha-mix epilogue of
// GroupedMixedOp: the four kernels of senas_tpu/ops/grouped_epilogue.py.
//
// For every branch o of a group the whole post-conv epilogue is an affine
// map per (batch, channel):  mixed[b,c,:,:] = K[b,c] + sum_o A[o,b,c] * x_o[b,c,:,:].
// Two kernels carry the forward and two the backward; the [n,B,C]-sized
// glue between them (batch stats, BN affine, SE MLP, alpha fold, and its
// gradient) is plain PyTorch in senas_torch/ops/grouped_epilogue.py.
//
//   branch_stats  replaces _stats_kernel via _branch_stats
//                 (senas_tpu/ops/grouped_epilogue.py:86-135).
//                 s1[o,b,c] = sum_hw x_o[b,c],  s2[o,b,c] = sum_hw x_o[b,c]^2.
//                 The TPU kernel walked H sequentially and emitted per-(b, w*c)
//                 H-sums in a lane-filling [B,H,W*C] view; here one block owns
//                 one contiguous NCHW (o, b, c) plane and reduces over H and W
//                 at once, which is what the glue needs. No atomics: the
//                 result is deterministic.
//   apply_mix     replaces _apply_kernel via _apply_mix (:143-181).
//                 Each block covers a chunk of one (b, c) plane; it reads its
//                 n coefficients A[o,b,c] and K[b,c] once, then streams the n
//                 inputs with float4 loads and writes the mixed output.
//   bwd_reduce    replaces _bwd_reduce_kernel via _bwd_reduce (:189-229).
//                 dA[o,b,c] = sum_hw g[b,c] * x_o[b,c],  dK[b,c] = sum_hw g[b,c].
//                 g is read once per plane for all n branches. A plane alone
//                 is too little work for the card (the main path has 192
//                 planes for 132 SMs), so each plane is cut into `splits`
//                 chunks, one block each, that write their n+1 partial sums
//                 to a workspace; a second launch adds each row of partials
//                 in a fixed order. No atomics: the result is deterministic.
//   bwd_dx        replaces _bwd_dx_kernel via _bwd_dx (:237-273).
//                 dx_o = g * A[o,b,c] + ds1[o,b,c] + 2 * x_o * ds2[o,b,c], one
//                 elementwise pass that reads g and the n inputs and writes n
//                 outputs, blocked like apply_mix.
//
// Bound on the card: all four are memory-bound streaming passes with ~1-2
// FLOP per byte. branch_stats reads n*B*C*H*W*4 bytes; apply_mix reads that
// plus the [n,B,C] coefficients and writes B*C*H*W*4 bytes; bwd_reduce reads
// (n+1)*B*C*H*W*4; bwd_dx reads (n+1)*B*C*H*W*4 and writes n*B*C*H*W*4. The
// design keeps every input read exactly once per kernel, 16-byte vector
// accesses on coalesced addresses, and no full-size intermediate in device
// memory.
//
// Plain C interface (no PyTorch headers): each launcher returns
// cudaGetLastError() and launches on the stream it is given.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBranches = 6;
constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kApplyVecs = 4;  // float4 vectors per thread per block
constexpr long long kApplyChunk = (long long)kApplyThreads * 4 * kApplyVecs;
constexpr int kReduceThreads = 256;
// bwd_reduce: aim for this many blocks in all (about 8 per SM), but give
// each block at least kReduceMinChunk elements of a plane.
constexpr long long kReduceTargetBlocks = 8 * 132;
constexpr long long kReduceMinChunk = (long long)kReduceThreads * 4 * 2;
constexpr int kFinishThreads = 128;

struct Branches {
  const float* p[kMaxBranches];
};

struct OutBranches {
  float* p[kMaxBranches];
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Elements of a plane per bwd_reduce block (a multiple of 4, so that every
// chunk starts 16-byte aligned when the plane does).
long long reduce_chunk(int planes, long long hw) {
  long long splits = ceil_div(kReduceTargetBlocks, planes);
  const long long most = ceil_div(hw, kReduceMinChunk);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  return ceil_div(ceil_div(hw, splits), 4) * 4;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kStatsThreads)
branch_stats_kernel(Branches xs, long long hw, int planes,
                    float* __restrict__ s1, float* __restrict__ s2) {
  const int plane = blockIdx.x;
  const int o = blockIdx.y;
  const float* __restrict__ x = xs.p[o] + (long long)plane * hw;
  float a = 0.f, q = 0.f;
  if ((hw & 3) == 0 && aligned16(x)) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = hw >> 2;
    for (long long i = threadIdx.x; i < n4; i += kStatsThreads) {
      const float4 v = __ldg(x4 + i);
      a += (v.x + v.y) + (v.z + v.w);
      q += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kStatsThreads) {
      const float v = __ldg(x + i);
      a += v;
      q += v * v;
    }
  }
  __shared__ float sa[kStatsThreads / 32];
  __shared__ float sq[kStatsThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  q = warp_sum(q);
  if (lane == 0) {
    sa[warp] = a;
    sq[warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kStatsThreads / 32 ? sa[lane] : 0.f;
    q = lane < kStatsThreads / 32 ? sq[lane] : 0.f;
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane == 0) {
      s1[(long long)o * planes + plane] = a;
      s2[(long long)o * planes + plane] = q;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kApplyThreads)
apply_mix_kernel(Branches xs, const float* __restrict__ A,
                 const float* __restrict__ K, float* __restrict__ out,
                 long long hw, int planes) {
  const int plane = blockIdx.x;
  const long long base = (long long)plane * hw;
  float a[N];
  const float* xp[N];
  bool vec = (hw & 3) == 0 && aligned16(out + base);
#pragma unroll
  for (int o = 0; o < N; ++o) {
    a[o] = __ldg(A + (long long)o * planes + plane);
    xp[o] = xs.p[o] + base;
    vec = vec && aligned16(xp[o]);
  }
  const float k = __ldg(K + plane);
  float* __restrict__ y = out + base;
  if (vec) {
    const long long n4 = hw >> 2;
#pragma unroll
    for (int j = 0; j < kApplyVecs; ++j) {
      const long long i =
          ((long long)blockIdx.y * kApplyVecs + j) * kApplyThreads + threadIdx.x;
      if (i < n4) {
        float4 acc = make_float4(k, k, k, k);
#pragma unroll
        for (int o = 0; o < N; ++o) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xp[o]) + i);
          acc.x = fmaf(v.x, a[o], acc.x);
          acc.y = fmaf(v.y, a[o], acc.y);
          acc.z = fmaf(v.z, a[o], acc.z);
          acc.w = fmaf(v.w, a[o], acc.w);
        }
        reinterpret_cast<float4*>(y)[i] = acc;
      }
    }
  } else {
    const long long begin = (long long)blockIdx.y * kApplyChunk;
    const long long end = begin + kApplyChunk < hw ? begin + kApplyChunk : hw;
    for (long long i = begin + threadIdx.x; i < end; i += kApplyThreads) {
      float acc = k;
#pragma unroll
      for (int o = 0; o < N; ++o) acc = fmaf(__ldg(xp[o] + i), a[o], acc);
      y[i] = acc;
    }
  }
}

template <int N>
void launch_apply(const Branches& xs, const float* A, const float* K, float* out,
                  long long hw, int planes, cudaStream_t stream) {
  const dim3 grid(planes, (unsigned)((hw + kApplyChunk - 1) / kApplyChunk));
  apply_mix_kernel<N><<<grid, kApplyThreads, 0, stream>>>(xs, A, K, out, hw, planes);
}

// One block per (plane, chunk): the n sums of g*x_o and the sum of g over
// its chunk, written to partial[(r * planes + plane) * splits + chunk] for
// row r = o (dA) and r = N (dK).
template <int N>
__global__ void __launch_bounds__(kReduceThreads)
bwd_reduce_partial_kernel(Branches xs, const float* __restrict__ g, long long hw,
                          long long chunk, int planes, float* __restrict__ partial) {
  const int plane = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const long long base = (long long)plane * hw;
  const long long begin = (long long)split * chunk;
  const long long end = begin + chunk < hw ? begin + chunk : hw;
  const float* __restrict__ gp = g + base;
  const float* xp[N];
  bool vec = (hw & 3) == 0 && aligned16(gp);
#pragma unroll
  for (int o = 0; o < N; ++o) {
    xp[o] = xs.p[o] + base;
    vec = vec && aligned16(xp[o]);
  }
  float acc[N + 1];
#pragma unroll
  for (int r = 0; r <= N; ++r) acc[r] = 0.f;
  if (vec) {
    for (long long i = (begin >> 2) + threadIdx.x; i < (end >> 2); i += kReduceThreads) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gp) + i);
      acc[N] += (gv.x + gv.y) + (gv.z + gv.w);
#pragma unroll
      for (int o = 0; o < N; ++o) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xp[o]) + i);
        acc[o] += (gv.x * v.x + gv.y * v.y) + (gv.z * v.z + gv.w * v.w);
      }
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kReduceThreads) {
      const float gv = __ldg(gp + i);
      acc[N] += gv;
#pragma unroll
      for (int o = 0; o < N; ++o) acc[o] = fmaf(gv, __ldg(xp[o] + i), acc[o]);
    }
  }
  __shared__ float s[N + 1][kReduceThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r <= N; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) s[r][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r <= N; ++r) {
      const float v = warp_sum(lane < kReduceThreads / 32 ? s[r][lane] : 0.f);
      if (lane == 0) partial[((long long)r * planes + plane) * splits + split] = v;
    }
  }
}

// One thread per row of partials: adds its `splits` values in order; rows
// [0, n*planes) are dA, the last `planes` rows dK.
__global__ void __launch_bounds__(kFinishThreads)
bwd_reduce_finish_kernel(const float* __restrict__ partial, int n, int planes,
                         int splits, float* __restrict__ dA, float* __restrict__ dK) {
  const long long row = (long long)blockIdx.x * kFinishThreads + threadIdx.x;
  const long long rows = (long long)(n + 1) * planes;
  if (row >= rows) return;
  const float* p = partial + row * splits;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += p[s];
  if (row < (long long)n * planes) {
    dA[row] = v;
  } else {
    dK[row - (long long)n * planes] = v;
  }
}

template <int N>
cudaError_t launch_bwd_reduce(const Branches& xs, const float* g, long long hw, int planes,
                              float* partial, float* dA, float* dK, cudaStream_t stream) {
  const long long chunk = reduce_chunk(planes, hw);
  const int splits = (int)ceil_div(hw, chunk);
  bwd_reduce_partial_kernel<N><<<dim3(planes, splits), kReduceThreads, 0, stream>>>(
      xs, g, hw, chunk, planes, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)(N + 1) * planes;
  bwd_reduce_finish_kernel<<<(unsigned)ceil_div(rows, kFinishThreads), kFinishThreads, 0,
                             stream>>>(partial, N, planes, splits, dA, dK);
  return cudaGetLastError();
}

template <int N>
__global__ void __launch_bounds__(kApplyThreads)
bwd_dx_kernel(Branches xs, const float* __restrict__ g, const float* __restrict__ A,
              const float* __restrict__ ds1, const float* __restrict__ ds2,
              OutBranches dxs, long long hw, int planes) {
  const int plane = blockIdx.x;
  const long long base = (long long)plane * hw;
  const float* __restrict__ gp = g + base;
  float a[N], c1[N], c2[N];
  const float* xp[N];
  float* yp[N];
  bool vec = (hw & 3) == 0 && aligned16(gp);
#pragma unroll
  for (int o = 0; o < N; ++o) {
    const long long at = (long long)o * planes + plane;
    a[o] = __ldg(A + at);
    c1[o] = __ldg(ds1 + at);
    c2[o] = 2.f * __ldg(ds2 + at);
    xp[o] = xs.p[o] + base;
    yp[o] = dxs.p[o] + base;
    vec = vec && aligned16(xp[o]) && aligned16(yp[o]);
  }
  if (vec) {
    const long long n4 = hw >> 2;
#pragma unroll
    for (int j = 0; j < kApplyVecs; ++j) {
      const long long i =
          ((long long)blockIdx.y * kApplyVecs + j) * kApplyThreads + threadIdx.x;
      if (i < n4) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(gp) + i);
#pragma unroll
        for (int o = 0; o < N; ++o) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xp[o]) + i);
          float4 d;
          d.x = fmaf(v.x, c2[o], fmaf(gv.x, a[o], c1[o]));
          d.y = fmaf(v.y, c2[o], fmaf(gv.y, a[o], c1[o]));
          d.z = fmaf(v.z, c2[o], fmaf(gv.z, a[o], c1[o]));
          d.w = fmaf(v.w, c2[o], fmaf(gv.w, a[o], c1[o]));
          reinterpret_cast<float4*>(yp[o])[i] = d;
        }
      }
    }
  } else {
    const long long begin = (long long)blockIdx.y * kApplyChunk;
    const long long end = begin + kApplyChunk < hw ? begin + kApplyChunk : hw;
    for (long long i = begin + threadIdx.x; i < end; i += kApplyThreads) {
      const float gv = __ldg(gp + i);
#pragma unroll
      for (int o = 0; o < N; ++o)
        yp[o][i] = fmaf(__ldg(xp[o] + i), c2[o], fmaf(gv, a[o], c1[o]));
    }
  }
}

template <int N>
void launch_bwd_dx(const Branches& xs, const float* g, const float* A, const float* ds1,
                   const float* ds2, const OutBranches& dxs, long long hw, int planes,
                   cudaStream_t stream) {
  const dim3 grid(planes, (unsigned)((hw + kApplyChunk - 1) / kApplyChunk));
  bwd_dx_kernel<N><<<grid, kApplyThreads, 0, stream>>>(xs, g, A, ds1, ds2, dxs, hw, planes);
}

}  // namespace

extern "C" {

// xs: n (1..6) NCHW-contiguous f32 tensors of `planes` = B*C planes of `hw`
// elements each (unused pointers may be null). s1, s2: [n, planes] f32.
int senas_branch_stats_f32(const float* x0, const float* x1, const float* x2,
                           const float* x3, const float* x4, const float* x5,
                           int n, int planes, long long hw, float* s1,
                           float* s2, void* stream) {
  if (n < 1 || n > kMaxBranches || planes < 1 || hw < 1)
    return (int)cudaErrorInvalidValue;
  const Branches xs = {{x0, x1, x2, x3, x4, x5}};
  const dim3 grid(planes, n);
  branch_stats_kernel<<<grid, kStatsThreads, 0, (cudaStream_t)stream>>>(
      xs, hw, planes, s1, s2);
  return (int)cudaGetLastError();
}

// out[p, :] = K[p] + sum_o A[o, p] * x_o[p, :] for each of the `planes`
// planes; A: [n, planes] f32, K: [planes] f32, out like x0.
int senas_apply_mix_f32(const float* x0, const float* x1, const float* x2,
                        const float* x3, const float* x4, const float* x5,
                        int n, const float* A, const float* K, float* out,
                        int planes, long long hw, void* stream) {
  if (n < 1 || n > kMaxBranches || planes < 1 || hw < 1 ||
      (hw + kApplyChunk - 1) / kApplyChunk > 65535)
    return (int)cudaErrorInvalidValue;
  const Branches xs = {{x0, x1, x2, x3, x4, x5}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1: launch_apply<1>(xs, A, K, out, hw, planes, s); break;
    case 2: launch_apply<2>(xs, A, K, out, hw, planes, s); break;
    case 3: launch_apply<3>(xs, A, K, out, hw, planes, s); break;
    case 4: launch_apply<4>(xs, A, K, out, hw, planes, s); break;
    case 5: launch_apply<5>(xs, A, K, out, hw, planes, s); break;
    default: launch_apply<6>(xs, A, K, out, hw, planes, s); break;
  }
  return (int)cudaGetLastError();
}

// dA[o, p] = sum_hw g[p, :] * x_o[p, :],  dK[p] = sum_hw g[p, :] for each of
// the `planes` planes; dA: [n, planes] f32, dK: [planes] f32; `partial` is a
// workspace of `partial_len` floats, which (n + 1) * (planes + 8 * 132)
// always covers: a plane is cut into at most ceil(8 * 132 / planes) chunks.
// Two launches.
int senas_bwd_reduce_f32(const float* x0, const float* x1, const float* x2,
                         const float* x3, const float* x4, const float* x5,
                         int n, const float* g, int planes, long long hw,
                         float* partial, long long partial_len, float* dA, float* dK,
                         void* stream) {
  if (n < 1 || n > kMaxBranches || planes < 1 || hw < 1)
    return (int)cudaErrorInvalidValue;
  const long long splits = ceil_div(hw, reduce_chunk(planes, hw));
  if (splits > 65535 || partial_len < (long long)(n + 1) * planes * splits)
    return (int)cudaErrorInvalidValue;
  const Branches xs = {{x0, x1, x2, x3, x4, x5}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1: return (int)launch_bwd_reduce<1>(xs, g, hw, planes, partial, dA, dK, s);
    case 2: return (int)launch_bwd_reduce<2>(xs, g, hw, planes, partial, dA, dK, s);
    case 3: return (int)launch_bwd_reduce<3>(xs, g, hw, planes, partial, dA, dK, s);
    case 4: return (int)launch_bwd_reduce<4>(xs, g, hw, planes, partial, dA, dK, s);
    case 5: return (int)launch_bwd_reduce<5>(xs, g, hw, planes, partial, dA, dK, s);
    default: return (int)launch_bwd_reduce<6>(xs, g, hw, planes, partial, dA, dK, s);
  }
}

// dx_o[p, :] = g[p, :] * A[o, p] + ds1[o, p] + 2 * x_o[p, :] * ds2[o, p] for
// each of the `planes` planes; A, ds1, ds2: [n, planes] f32; dx_o like x_o.
int senas_bwd_dx_f32(const float* x0, const float* x1, const float* x2,
                     const float* x3, const float* x4, const float* x5,
                     int n, const float* g, const float* A, const float* ds1,
                     const float* ds2, float* y0, float* y1, float* y2, float* y3,
                     float* y4, float* y5, int planes, long long hw, void* stream) {
  if (n < 1 || n > kMaxBranches || planes < 1 || hw < 1 ||
      (hw + kApplyChunk - 1) / kApplyChunk > 65535)
    return (int)cudaErrorInvalidValue;
  const Branches xs = {{x0, x1, x2, x3, x4, x5}};
  const OutBranches dxs = {{y0, y1, y2, y3, y4, y5}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1: launch_bwd_dx<1>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 2: launch_bwd_dx<2>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 3: launch_bwd_dx<3>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 4: launch_bwd_dx<4>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 5: launch_bwd_dx<5>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    default: launch_bwd_dx<6>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
  }
  return (int)cudaGetLastError();
}

const char* senas_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
