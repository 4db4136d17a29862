// Hopper (sm_90a) kernels for the fused BN(+SE)+alpha-mix epilogue of
// GroupedMixedOp, the forward half of senas_tpu/ops/grouped_epilogue.py.
//
// For every branch o of a group the whole post-conv epilogue is an affine
// map per (batch, channel):  mixed[b,c,:,:] = K[b,c] + sum_o A[o,b,c] * x_o[b,c,:,:].
// Two kernels carry it; the [n,B,C]-sized glue between them (batch stats,
// BN affine, SE MLP, alpha fold) is plain PyTorch in
// senas_torch/ops/grouped_epilogue.py.
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
//
// Bound on the card: both are memory-bound streaming passes with ~1-2 FLOP
// per byte. branch_stats reads n*B*C*H*W*4 bytes; apply_mix reads that plus
// the [n,B,C] coefficients and writes B*C*H*W*4 bytes. The design keeps every
// input read exactly once per kernel, 16-byte vector accesses on coalesced
// addresses, and no intermediate in device memory.
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

struct Branches {
  const float* p[kMaxBranches];
};

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

const char* senas_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
