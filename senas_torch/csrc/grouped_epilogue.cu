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
//                 H-sums in a lane-filling [B,H,W*C] view; here each contiguous
//                 NCHW (o, b, c) plane is reduced over H and W at once, which
//                 is what the glue needs. One launch, no atomics, and a sum
//                 order fixed by the shape: the result is deterministic.
//                 Its design is in the note above stats_range.
//   apply_mix     replaces _apply_kernel via _apply_mix (:143-181).
//                 Each block covers a chunk of one (b, c) plane; it reads its
//                 n coefficients A[o,b,c] and K[b,c] once, then streams the n
//                 inputs with 16-byte loads and writes the mixed output.
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
// Element types: each kernel is a template over the type T of the branch
// tensors, g, `mixed` and dx_o: float or __nv_bfloat16, as the Pallas
// kernels take either. The per-(b,c) operands A, K, ds1, ds2 and the sums
// s1, s2, dA, dK are f32 for both. Every value is widened to f32 on load,
// every sum and product is taken in f32, and each bf16 written is rounded
// once, to nearest even (__float2bfloat16_rn, what .to(torch.bfloat16) and
// astype(jnp.bfloat16) do). A 16-byte vector holds 4 f32 or 8 bf16 values
// (`Pack<T>`); a plane whose size or address does not allow it is read
// with scalar loads. apply_mix, bwd_reduce and bwd_dx in f32 do the
// arithmetic of the f32 kernels that came before them, in the same order.
//
// Bound on the card: all four are memory-bound streaming passes with ~1-2
// FLOP per byte. With e = sizeof(T), branch_stats reads n*B*C*H*W*e bytes;
// apply_mix reads that plus the [n,B,C] coefficients and writes B*C*H*W*e
// bytes; bwd_reduce reads (n+1)*B*C*H*W*e; bwd_dx reads (n+1)*B*C*H*W*e and
// writes n*B*C*H*W*e. The design keeps every input read exactly once per
// kernel, 16-byte vector accesses on coalesced addresses, and no full-size
// intermediate in device memory.
//
// Plain C interface (no PyTorch headers): each launcher returns
// cudaGetLastError() and launches on the stream it is given; the entry
// points end in _f32 or _bf16 after the element type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxBranches = 6;
// branch_stats: 256-thread blocks (a warp a plane on the warp path). The
// CTA path keeps to 32 registers a thread, so that 8 CTAs fit an SM: at 34
// (nvcc's own choice for bf16) n=1 [12,32,256,256] read 3% slower.
constexpr int kStatsThreads = 256;
constexpr int kStatsCtasPerSm = 8;
constexpr int kStatsWarps = kStatsThreads / 32;
// the plan's paths (`path` of the entry point)
constexpr int kStatsWarpPath = 0;
constexpr int kStatsCtaPath = 1;
constexpr int kApplyThreads = 256;
constexpr int kApplyVecs = 4;  // 16-byte vectors per thread per block
constexpr int kReduceThreads = 256;
// bwd_reduce: aim for this many blocks in all (about 8 per SM), but give
// each block at least kReduceMinChunk elements of a plane.
constexpr long long kReduceTargetBlocks = 8 * 132;
constexpr long long kReduceMinChunk = (long long)kReduceThreads * 4 * 2;
constexpr int kFinishThreads = 128;

// 16 bytes of T, widened to f32 on load and rounded back on store.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  float v[kN];
  __device__ __forceinline__ void load(const float* p, long long i) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ __forceinline__ void set(const uint4& raw) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ void store(float* p, long long i) const {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<bf16> {
  static constexpr int kN = 8;
  float v[kN];
  __device__ __forceinline__ void load(const bf16* p, long long i) {
    set(__ldg(reinterpret_cast<const uint4*>(p) + i));
  }
  __device__ __forceinline__ void set(const uint4& raw) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ void store(bf16* p, long long i) const {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    reinterpret_cast<uint4*>(p)[i] = raw;
  }
};

__device__ __forceinline__ float load1(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load1(const bf16* p, long long i) {
  return __bfloat162float(__ldg(p + i));
}
__device__ __forceinline__ void store1(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store1(bf16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Pairwise sums over a pack: ((v0 + v1) + (v2 + v3)) for 4 values, and the
// two halves' sums added for 8; `sq` sums v*v, `dot` g*v.
template <int N>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (N == 2) {
    return v[0] + v[1];
  } else {
    return tree_sum<N / 2>(v) + tree_sum<N / 2>(v + N / 2);
  }
}

template <int N>
__device__ __forceinline__ float tree_sq(const float* v) {
  if constexpr (N == 2) {
    return v[0] * v[0] + v[1] * v[1];
  } else {
    return tree_sq<N / 2>(v) + tree_sq<N / 2>(v + N / 2);
  }
}

template <int N>
__device__ __forceinline__ float tree_dot(const float* g, const float* v) {
  if constexpr (N == 2) {
    return g[0] * v[0] + g[1] * v[1];
  } else {
    return tree_dot<N / 2>(g, v) + tree_dot<N / 2>(g + N / 2, v + N / 2);
  }
}

template <typename T>
struct Branches {
  const T* p[kMaxBranches];
};

template <typename T>
struct OutBranches {
  T* p[kMaxBranches];
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Elements of a plane per apply_mix / bwd_dx block.
template <typename T>
__host__ __device__ constexpr long long apply_chunk() {
  return (long long)kApplyThreads * Pack<T>::kN * kApplyVecs;
}

// Elements of a plane per bwd_reduce block (a multiple of a pack, so that
// every chunk starts 16-byte aligned when the plane does).
long long reduce_chunk(int planes, long long hw, int pack) {
  long long splits = ceil_div(kReduceTargetBlocks, planes);
  const long long most = ceil_div(hw, kReduceMinChunk);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  return ceil_div(ceil_div(hw, splits), pack) * pack;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// branch_stats (K1a): its design.
//
// What bounds it: it reads n*B*C*H*W*e bytes once and writes 8*n*B*C, at
// 3 FLOP an element: HBM at 3.35 TB/s bounds it. The kernel it replaces
// gave a 256-thread block to each (plane, branch), each thread with one
// 16-byte load in flight. The plan (branch_stats_plan in
// senas_torch/ops/grouped_epilogue.py, computed on the host from (n,
// planes, hw, dtype, alignment) and checked here by branch_stats) takes
// one of two paths:
//  - A warp a plane, eight planes a block, where a plane is at most 2 KB
//    (1x1 squeezes; 16x16 maps in f32, 32x32 in bf16). A block a plane
//    left most of its threads idle through two block-wide reductions:
//    [12,32,1,1] is 48 blocks, not 384. The warp adds in the CTA path's
//    order, so its sums are the CTA path's bits: a plan that moves a plane
//    between the two (a row split halves the planes) moves no rounding.
//  - A CTA a plane for the larger planes. Each thread loads four 16-byte
//    packs before it adds the first, and the kernel keeps to 32 registers
//    a thread, so that 8 CTAs fit an SM.
// A plane whose size or address rules out 16-byte loads (hw not a
// multiple of the 16-byte pack, or a base pointer off 16 bytes) takes the
// same paths with scalar loads (VEC false).
// Measured and not kept (NVIDIA H100 80GB HBM3 at 700 W, L2-cold device
// times; PERF.md section 6): splitting a plane over a thread-block cluster
// of 2, 4 or 8 CTAs, their partial sums added in the leader CTA through
// distributed shared memory, so that the planes fill whole waves of the
// 132 SMs. On the planes the port's paths give K1a (192 or more large
// ones) it was slower at every cluster size, the more so the shorter the
// chunks: a cluster's CTAs are launched and retired together. It was
// faster only where the planes are fewer than the SMs, which none of
// those paths gives. A ring of cp.async.bulk copies into shared memory
// read no faster than the unrolled loads.
// Sum order, fixed by the plan and so by the shape: each thread adds its
// items (packs, or elements on the scalar path) at item index t, t + 256,
// ... in that order, each pack by a pairwise tree (tree_sum, tree_sq);
// then warp_sum, then warp 0's warp_sum of the block's warp sums. That is
// the order of the block-a-plane kernel before this design, and so the
// same bits: the Adam step on the arch tables turns a rounding-level
// change of a gradient into a whole step, and `chip_smoke.py` phase 22
// holds a row-split search step to one process within 1e-2 of the update,
// which another summation order alone can exceed.

// Adds this thread's items of x (packs when VEC, else elements; `items`
// in all) at t, t + STRIDE, ..., to (a, q) in that order. Four items are
// loaded before the first of them is added, so that four 16-byte loads a
// thread are in flight (left to itself, nvcc put the bf16 loop's four
// loads in flight two at a time); STRIDE, the threads that share the
// plane, is a constant, so that the loads take immediate offsets.
template <typename T, bool VEC, int STRIDE>
__device__ __forceinline__ void stats_range(const T* __restrict__ x, long long items, int t,
                                            float& a, float& q) {
  constexpr int U = 4;
  long long i = t;
  if constexpr (VEC) {
    const uint4* p = reinterpret_cast<const uint4*>(x);
    for (; i + (U - 1) * STRIDE < items; i += U * STRIDE) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) raw[u] = __ldg(p + i + u * STRIDE);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        Pack<T> v;
        v.set(raw[u]);
        a += tree_sum<Pack<T>::kN>(v.v);
        q += tree_sq<Pack<T>::kN>(v.v);
      }
    }
    for (; i < items; i += STRIDE) {
      Pack<T> v;
      v.set(__ldg(p + i));
      a += tree_sum<Pack<T>::kN>(v.v);
      q += tree_sq<Pack<T>::kN>(v.v);
    }
  } else {
#pragma unroll 4
    for (; i < items; i += STRIDE) {
      const float v = load1(x, i);
      a += v;
      q += v * v;
    }
  }
}

// The CTA path's last step, as the warp path repeats it: the sum that
// warp 0's warp_sum makes of the block's kStatsWarps (8) warp sums v, held
// in lanes 0-7 with zeros above (x + 0 is kept: it turns -0 into +0).
__device__ __forceinline__ float block_tail_sum(const float (&v)[kStatsWarps]) {
  static_assert(kStatsWarps == 8, "the tree below is warp_sum's over 8 lanes");
  float t[kStatsWarps];
#pragma unroll
  for (int w = 0; w < kStatsWarps; ++w) t[w] = (v[w] + 0.f) + 0.f;
  return ((t[0] + t[4]) + (t[2] + t[6])) + ((t[1] + t[5]) + (t[3] + t[7]));
}

// Warp path: grid (ceil(planes / kStatsWarps), n); warp w of block (bx, o)
// owns plane bx * kStatsWarps + w of branch o. It sums the plane in the
// order the CTA path does (each lane plays the CTA's threads lane, lane +
// 32, ..., lane + 224 in turn; a warp_sum for each of them; then the CTA's
// sum of its 8 warp sums), so a plane's sums are the same bits whichever
// path its plan takes.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kStatsThreads)
branch_stats_warp_kernel(Branches<T> xs, long long hw, int planes, float* __restrict__ s1,
                         float* __restrict__ s2) {
  constexpr int V = VEC ? Pack<T>::kN : 1;
  const int plane = blockIdx.x * kStatsWarps + (threadIdx.x >> 5);
  if (plane >= planes) return;   // whole warps; no block-wide barrier follows
  const int o = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const T* __restrict__ x = xs.p[o] + (long long)plane * hw;
  const long long items = hw / V;
  float va[kStatsWarps], vq[kStatsWarps];
#pragma unroll
  for (int w = 0; w < kStatsWarps; ++w) {
    va[w] = vq[w] = 0.f;   // a warp of the CTA with no items sums to +0
    if (32LL * w < items) {
      float a = 0.f, q = 0.f;
      stats_range<T, VEC, kStatsThreads>(x, items, 32 * w + lane, a, q);
      va[w] = warp_sum(a);
      vq[w] = warp_sum(q);
    }
  }
  if (lane == 0) {
    s1[(long long)o * planes + plane] = block_tail_sum(va);
    s2[(long long)o * planes + plane] = block_tail_sum(vq);
  }
}

// CTA path: grid (planes, n); block (plane, o) sums that plane of branch o.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kStatsThreads, kStatsCtasPerSm)
branch_stats_cta_kernel(Branches<T> xs, long long hw, int planes, float* __restrict__ s1,
                        float* __restrict__ s2) {
  constexpr int V = VEC ? Pack<T>::kN : 1;
  __shared__ float sa[kStatsWarps], sq[kStatsWarps];
  const int plane = blockIdx.x;
  const int o = blockIdx.y;
  float a = 0.f, q = 0.f;
  stats_range<T, VEC, kStatsThreads>(xs.p[o] + (long long)plane * hw, hw / V, threadIdx.x, a,
                                     q);
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
    a = warp_sum(lane < kStatsWarps ? sa[lane] : 0.f);
    q = warp_sum(lane < kStatsWarps ? sq[lane] : 0.f);
    if (lane == 0) {
      s1[(long long)o * planes + plane] = a;
      s2[(long long)o * planes + plane] = q;
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch_stats(const Branches<T>& xs, long long hw, int n, int planes, int path,
                         float* s1, float* s2, cudaStream_t stream) {
  if (path == kStatsWarpPath) {
    const dim3 grid((unsigned)ceil_div(planes, kStatsWarps), (unsigned)n);
    branch_stats_warp_kernel<T, VEC><<<grid, kStatsThreads, 0, stream>>>(xs, hw, planes, s1, s2);
  } else {
    branch_stats_cta_kernel<T, VEC><<<dim3(planes, n), kStatsThreads, 0, stream>>>(
        xs, hw, planes, s1, s2);
  }
  return cudaGetLastError();
}

template <typename T, int N>
__global__ void __launch_bounds__(kApplyThreads)
apply_mix_kernel(Branches<T> xs, const float* __restrict__ A,
                 const float* __restrict__ K, T* __restrict__ out,
                 long long hw, int planes) {
  constexpr int V = Pack<T>::kN;
  const int plane = blockIdx.x;
  const long long base = (long long)plane * hw;
  float a[N];
  const T* xp[N];
  bool vec = hw % V == 0 && aligned16(out + base);
#pragma unroll
  for (int o = 0; o < N; ++o) {
    a[o] = __ldg(A + (long long)o * planes + plane);
    xp[o] = xs.p[o] + base;
    vec = vec && aligned16(xp[o]);
  }
  const float k = __ldg(K + plane);
  T* __restrict__ y = out + base;
  if (vec) {
    const long long nv = hw / V;
#pragma unroll
    for (int j = 0; j < kApplyVecs; ++j) {
      const long long i =
          ((long long)blockIdx.y * kApplyVecs + j) * kApplyThreads + threadIdx.x;
      if (i < nv) {
        Pack<T> acc;
#pragma unroll
        for (int e = 0; e < V; ++e) acc.v[e] = k;
#pragma unroll
        for (int o = 0; o < N; ++o) {
          Pack<T> v;
          v.load(xp[o], i);
#pragma unroll
          for (int e = 0; e < V; ++e) acc.v[e] = fmaf(v.v[e], a[o], acc.v[e]);
        }
        acc.store(y, i);
      }
    }
  } else {
    const long long begin = (long long)blockIdx.y * apply_chunk<T>();
    const long long end = begin + apply_chunk<T>() < hw ? begin + apply_chunk<T>() : hw;
    for (long long i = begin + threadIdx.x; i < end; i += kApplyThreads) {
      float acc = k;
#pragma unroll
      for (int o = 0; o < N; ++o) acc = fmaf(load1(xp[o], i), a[o], acc);
      store1(y, i, acc);
    }
  }
}

template <typename T, int N>
void launch_apply(const Branches<T>& xs, const float* A, const float* K, T* out,
                  long long hw, int planes, cudaStream_t stream) {
  const dim3 grid(planes, (unsigned)ceil_div(hw, apply_chunk<T>()));
  apply_mix_kernel<T, N><<<grid, kApplyThreads, 0, stream>>>(xs, A, K, out, hw, planes);
}

// One block per (plane, chunk): the n sums of g*x_o and the sum of g over
// its chunk, written to partial[(r * planes + plane) * splits + chunk] for
// row r = o (dA) and r = N (dK).
template <typename T, int N>
__global__ void __launch_bounds__(kReduceThreads)
bwd_reduce_partial_kernel(Branches<T> xs, const T* __restrict__ g, long long hw,
                          long long chunk, int planes, float* __restrict__ partial) {
  constexpr int V = Pack<T>::kN;
  const int plane = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const long long base = (long long)plane * hw;
  const long long begin = (long long)split * chunk;
  const long long end = begin + chunk < hw ? begin + chunk : hw;
  const T* __restrict__ gp = g + base;
  const T* xp[N];
  bool vec = hw % V == 0 && aligned16(gp);
#pragma unroll
  for (int o = 0; o < N; ++o) {
    xp[o] = xs.p[o] + base;
    vec = vec && aligned16(xp[o]);
  }
  float acc[N + 1];
#pragma unroll
  for (int r = 0; r <= N; ++r) acc[r] = 0.f;
  if (vec) {
    for (long long i = begin / V + threadIdx.x; i < end / V; i += kReduceThreads) {
      Pack<T> gv;
      gv.load(gp, i);
      acc[N] += tree_sum<V>(gv.v);
#pragma unroll
      for (int o = 0; o < N; ++o) {
        Pack<T> v;
        v.load(xp[o], i);
        acc[o] += tree_dot<V>(gv.v, v.v);
      }
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kReduceThreads) {
      const float gv = load1(gp, i);
      acc[N] += gv;
#pragma unroll
      for (int o = 0; o < N; ++o) acc[o] = fmaf(gv, load1(xp[o], i), acc[o]);
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

template <typename T, int N>
cudaError_t launch_bwd_reduce(const Branches<T>& xs, const T* g, long long hw, int planes,
                              float* partial, float* dA, float* dK, cudaStream_t stream) {
  const long long chunk = reduce_chunk(planes, hw, Pack<T>::kN);
  const int splits = (int)ceil_div(hw, chunk);
  bwd_reduce_partial_kernel<T, N><<<dim3(planes, splits), kReduceThreads, 0, stream>>>(
      xs, g, hw, chunk, planes, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)(N + 1) * planes;
  bwd_reduce_finish_kernel<<<(unsigned)ceil_div(rows, kFinishThreads), kFinishThreads, 0,
                             stream>>>(partial, N, planes, splits, dA, dK);
  return cudaGetLastError();
}

template <typename T, int N>
__global__ void __launch_bounds__(kApplyThreads)
bwd_dx_kernel(Branches<T> xs, const T* __restrict__ g, const float* __restrict__ A,
              const float* __restrict__ ds1, const float* __restrict__ ds2,
              OutBranches<T> dxs, long long hw, int planes) {
  constexpr int V = Pack<T>::kN;
  const int plane = blockIdx.x;
  const long long base = (long long)plane * hw;
  const T* __restrict__ gp = g + base;
  float a[N], c1[N], c2[N];
  const T* xp[N];
  T* yp[N];
  bool vec = hw % V == 0 && aligned16(gp);
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
    const long long nv = hw / V;
#pragma unroll
    for (int j = 0; j < kApplyVecs; ++j) {
      const long long i =
          ((long long)blockIdx.y * kApplyVecs + j) * kApplyThreads + threadIdx.x;
      if (i < nv) {
        Pack<T> gv;
        gv.load(gp, i);
#pragma unroll
        for (int o = 0; o < N; ++o) {
          Pack<T> v;
          v.load(xp[o], i);
          Pack<T> d;
#pragma unroll
          for (int e = 0; e < V; ++e) d.v[e] = fmaf(v.v[e], c2[o], fmaf(gv.v[e], a[o], c1[o]));
          d.store(yp[o], i);
        }
      }
    }
  } else {
    const long long begin = (long long)blockIdx.y * apply_chunk<T>();
    const long long end = begin + apply_chunk<T>() < hw ? begin + apply_chunk<T>() : hw;
    for (long long i = begin + threadIdx.x; i < end; i += kApplyThreads) {
      const float gv = load1(gp, i);
#pragma unroll
      for (int o = 0; o < N; ++o)
        store1(yp[o], i, fmaf(load1(xp[o], i), c2[o], fmaf(gv, a[o], c1[o])));
    }
  }
}

template <typename T, int N>
void launch_bwd_dx(const Branches<T>& xs, const T* g, const float* A, const float* ds1,
                   const float* ds2, const OutBranches<T>& dxs, long long hw, int planes,
                   cudaStream_t stream) {
  const dim3 grid(planes, (unsigned)ceil_div(hw, apply_chunk<T>()));
  bwd_dx_kernel<T, N><<<grid, kApplyThreads, 0, stream>>>(xs, g, A, ds1, ds2, dxs, hw, planes);
}

bool bad_shape(int n, int planes, long long hw) {
  return n < 1 || n > kMaxBranches || planes < 1 || hw < 1;
}

// The launchers behind the entry points, one per element type T.

template <typename T>
int branch_stats(const Branches<T>& xs, int n, int planes, long long hw, int path, int vec,
                 float* s1, float* s2, cudaStream_t stream) {
  if (bad_shape(n, planes, hw) || (path != kStatsWarpPath && path != kStatsCtaPath))
    return (int)cudaErrorInvalidValue;
  if (vec) {
    // 16-byte packs: every plane of every branch starts 16-byte aligned
    if (hw % Pack<T>::kN != 0) return (int)cudaErrorInvalidValue;
    for (int o = 0; o < n; ++o)
      if ((reinterpret_cast<uintptr_t>(xs.p[o]) & 15u) != 0) return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = vec ? launch_stats<T, true>(xs, hw, n, planes, path, s1, s2, stream)
                              : launch_stats<T, false>(xs, hw, n, planes, path, s1, s2, stream);
  return (int)err;
}

template <typename T>
int apply_mix(const Branches<T>& xs, int n, const float* A, const float* K, T* out,
              int planes, long long hw, cudaStream_t s) {
  if (bad_shape(n, planes, hw) || ceil_div(hw, apply_chunk<T>()) > 65535)
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1: launch_apply<T, 1>(xs, A, K, out, hw, planes, s); break;
    case 2: launch_apply<T, 2>(xs, A, K, out, hw, planes, s); break;
    case 3: launch_apply<T, 3>(xs, A, K, out, hw, planes, s); break;
    case 4: launch_apply<T, 4>(xs, A, K, out, hw, planes, s); break;
    case 5: launch_apply<T, 5>(xs, A, K, out, hw, planes, s); break;
    default: launch_apply<T, 6>(xs, A, K, out, hw, planes, s); break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_reduce(const Branches<T>& xs, int n, const T* g, int planes, long long hw,
               float* partial, long long partial_len, float* dA, float* dK, cudaStream_t s) {
  if (bad_shape(n, planes, hw)) return (int)cudaErrorInvalidValue;
  const long long splits = ceil_div(hw, reduce_chunk(planes, hw, Pack<T>::kN));
  if (splits > 65535 || partial_len < (long long)(n + 1) * planes * splits)
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1: return (int)launch_bwd_reduce<T, 1>(xs, g, hw, planes, partial, dA, dK, s);
    case 2: return (int)launch_bwd_reduce<T, 2>(xs, g, hw, planes, partial, dA, dK, s);
    case 3: return (int)launch_bwd_reduce<T, 3>(xs, g, hw, planes, partial, dA, dK, s);
    case 4: return (int)launch_bwd_reduce<T, 4>(xs, g, hw, planes, partial, dA, dK, s);
    case 5: return (int)launch_bwd_reduce<T, 5>(xs, g, hw, planes, partial, dA, dK, s);
    default: return (int)launch_bwd_reduce<T, 6>(xs, g, hw, planes, partial, dA, dK, s);
  }
}

template <typename T>
int bwd_dx(const Branches<T>& xs, int n, const T* g, const float* A, const float* ds1,
           const float* ds2, const OutBranches<T>& dxs, int planes, long long hw,
           cudaStream_t s) {
  if (bad_shape(n, planes, hw) || ceil_div(hw, apply_chunk<T>()) > 65535)
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1: launch_bwd_dx<T, 1>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 2: launch_bwd_dx<T, 2>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 3: launch_bwd_dx<T, 3>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 4: launch_bwd_dx<T, 4>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    case 5: launch_bwd_dx<T, 5>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
    default: launch_bwd_dx<T, 6>(xs, g, A, ds1, ds2, dxs, hw, planes, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points, _f32 and _bf16 (T = float, __nv_bfloat16):
//
// senas_branch_stats_*(x0..x5, n, planes, hw, path, vec, s1, s2, stream)
//   xs: n (1..6) NCHW-contiguous tensors of `planes` = B*C planes of `hw`
//   elements each (unused pointers may be null). s1, s2: [n, planes] f32.
//   The launch plan (path 0: a warp a plane; 1: a CTA a plane; vec:
//   16-byte loads) is checked: a plan the kernels do not take returns
//   cudaErrorInvalidValue. One launch.
// senas_apply_mix_*(x0..x5, n, A, K, out, planes, hw, stream)
//   out[p, :] = K[p] + sum_o A[o, p] * x_o[p, :] for each of the `planes`
//   planes; A: [n, planes] f32, K: [planes] f32, out like x0.
// senas_bwd_reduce_*(x0..x5, n, g, planes, hw, partial, partial_len, dA, dK, stream)
//   dA[o, p] = sum_hw g[p, :] * x_o[p, :],  dK[p] = sum_hw g[p, :]; g like
//   x0; dA: [n, planes] f32, dK: [planes] f32; `partial` is a workspace of
//   `partial_len` floats, which (n + 1) * (planes + 8 * 132) always covers:
//   a plane is cut into at most ceil(8 * 132 / planes) chunks. Two launches.
// senas_bwd_dx_*(x0..x5, n, g, A, ds1, ds2, y0..y5, planes, hw, stream)
//   dx_o[p, :] = g[p, :] * A[o, p] + ds1[o, p] + 2 * x_o[p, :] * ds2[o, p];
//   A, ds1, ds2: [n, planes] f32; g and each dx_o (y_o) like x_o.
#define SENAS_ENTRY_POINTS(SUFFIX, T)                                                    \
  int senas_branch_stats_##SUFFIX(const T* x0, const T* x1, const T* x2, const T* x3,   \
                                  const T* x4, const T* x5, int n, int planes,           \
                                  long long hw, int path, int vec, float* s1, float* s2, \
                                  void* stream) {                                        \
    return branch_stats<T>({{x0, x1, x2, x3, x4, x5}}, n, planes, hw, path, vec, s1, s2, \
                           (cudaStream_t)stream);                                       \
  }                                                                                      \
  int senas_apply_mix_##SUFFIX(const T* x0, const T* x1, const T* x2, const T* x3,      \
                               const T* x4, const T* x5, int n, const float* A,          \
                               const float* K, T* out, int planes, long long hw,         \
                               void* stream) {                                           \
    return apply_mix<T>({{x0, x1, x2, x3, x4, x5}}, n, A, K, out, planes, hw,           \
                        (cudaStream_t)stream);                                          \
  }                                                                                      \
  int senas_bwd_reduce_##SUFFIX(const T* x0, const T* x1, const T* x2, const T* x3,     \
                                const T* x4, const T* x5, int n, const T* g, int planes, \
                                long long hw, float* partial, long long partial_len,     \
                                float* dA, float* dK, void* stream) {                    \
    return bwd_reduce<T>({{x0, x1, x2, x3, x4, x5}}, n, g, planes, hw, partial,         \
                         partial_len, dA, dK, (cudaStream_t)stream);                    \
  }                                                                                      \
  int senas_bwd_dx_##SUFFIX(const T* x0, const T* x1, const T* x2, const T* x3,         \
                            const T* x4, const T* x5, int n, const T* g, const float* A, \
                            const float* ds1, const float* ds2, T* y0, T* y1, T* y2,     \
                            T* y3, T* y4, T* y5, int planes, long long hw,               \
                            void* stream) {                                              \
    return bwd_dx<T>({{x0, x1, x2, x3, x4, x5}}, n, g, A, ds1, ds2,                     \
                     {{y0, y1, y2, y3, y4, y5}}, planes, hw, (cudaStream_t)stream);     \
  }

extern "C" {

SENAS_ENTRY_POINTS(f32, float)
SENAS_ENTRY_POINTS(bf16, bf16)

const char* senas_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
