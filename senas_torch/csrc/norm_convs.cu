// Hopper (sm_90a) kernel for the three NORM convolutions of one input: the
// kernel of senas_tpu/ops/pallas_kernels.py, on the tensor cores.
//
//   norm_convs  replaces _norm_convs_kernel via fused_norm_convs
//               (senas_tpu/ops/pallas_kernels.py:37-99).
//               For the branches br = (3x3 d1, 5x5 d2, 5x5 d3):
//                 out[b, br*N + n, y, x] = sum_c sum_{dy,dx} w_br[n, c, dy, dx]
//                     * x[b, c, y + (dy - k/2)*d, x + (dx - k/2)*d]
//               with zeros outside the image (torch 'same' padding, stride 1).
//               x is [B,C,H,W], each w_br [N,C,k,k] (OIHW), out [B,3N,H,W],
//               all f32 NCHW-contiguous.
//
// Work and bound: 2*B*H*W*C*N*59 FLOP against (B*C + 3*B*N)*H*W*4 bytes. At
// bench.py's shape (B 64, 128x128, C 32, N 24): 95.0 GFLOP and 436 MB. On
// the CUDA cores that is 1.418 ms at 67 TFLOP/s f32; on the tensor cores an
// f32-accurate product costs three TF32 products (below), so 285 GFLOP at
// 495 TFLOP/s TF32: 0.576 ms, against 0.130 ms for the bytes. Bound by
// operations either way (H100 SXM data-sheet peaks, at a 700 W limit).
//
// Design: an implicit GEMM per branch on wgmma, in split precision (3xTF32).
//  - M is 64 adjacent output pixels of one row (one wgmma m64), N the output
//    channels of a slice of at most 32 (NT = 1..4 groups of 8, zero-padded),
//    K the input channels times the taps, 8 channels (one k8 step) per tap.
//  - A (the input window shifted by the tap's (dy*d, dx*d)) comes from
//    registers: each thread reads its fragment (pixels lane/4 and +8,
//    channels lane%4 and +4) from the halo'd tile in shared memory, whose
//    channel stride is 8 mod 32 words, so a warp's 32 reads hit 32 banks.
//    It splits each value v into hi = rna_tf32(v) (explicit rounding: the
//    tensor cores read a register as TF32 by dropping its low 13 bits) and
//    lo = v - hi (exact in f32; read as TF32 it keeps v to ~2^-21), and
//    issues lo*W_hi, hi*W_lo and hi*W_hi into one f32 accumulator. The
//    dropped lo*W_lo term and the truncation of lo leave ~2^-21 of each
//    product, where one TF32 product leaves ~2^-11.
//  - B (W_hi, W_lo, both rounded) is split and laid out once per call by
//    norm_convs_split_kernel into a scratch buffer, in the K-major
//    no-swizzle core-matrix order a wgmma descriptor reads (a core matrix:
//    8 output channels x 4 input channels, 16 bytes a row).
//  - A block owns 12 output rows x 64 columns of one image and one channel
//    slice: 3 warpgroups, each 4 rows (M-tiles); per tap one group of 12
//    wgmmas (4 M-tiles x 3 products). It walks stages (branch, chunk of 8
//    channels), branch outer, so only one branch's accumulators are live.
//    Each stage copies the chunk's halo'd x tile (24 x 80 pixels, columns
//    from x0 - 8) with cp.async, 16 bytes a copy when W % 4 == 0 (a quad of
//    columns then lies all inside or all outside the image), else 4; a
//    src-size of 0 zero-fills outside the image and past C. The branch's
//    split weights for the chunk come with one cp.async.bulk onto an
//    mbarrier. Both are double buffered: stage s+1's copies run under
//    stage s's wgmmas.
//  - A partial channel chunk reads zeros (x zero-filled, weights zero);
//    N past the slice's channels has zero weights and is masked at the
//    store, as are pixels past W and H.
//  - On an NVIDIA H100 80GB HBM3 at a 700 W limit, at bench.py's shape, it
//    takes ~1.34 ms, ~43% of the 3xTF32 bound (chip_smoke.py); its wgmmas
//    alone take ~0.94 ms and its loads and copies alone ~0.39 ms, and the
//    two hardly overlap (tools/k2_ceiling.py; PERF.md).
//
//   norm_convs_bf16  the same convolutions of bf16 operands (the Pallas
//               kernel's x-dtype operands, f32 accumulation and x-dtype
//               output, senas_tpu/ops/pallas_kernels.py:52-59): x, the
//               kernels and out bf16, every product of two bf16 values
//               exact in f32 and summed in f32 over all taps and
//               channels, each output rounded once to nearest even.
//
// bf16 work and bound: the same 95.0 GFLOP at bench.py's shape, one bf16
// tensor-core product each: 0.0961 ms at 989 TFLOP/s bf16, against 218 MB
// ((B*C + 3*B*N)*H*W*2 bytes) in 0.0651 ms at 3.35 TB/s: bound by
// operations.
//
// bf16 design: the f32 kernel's blocks, stages and staging, with one bf16
// wgmma (m64nNk16, A in registers, B by descriptor) per product and no
// split: K is 16 input channels per tap, so a stage is (branch, chunk of
// 16 channels). A thread's fragment per M-tile is 8 bf16 in 4 registers:
// pixels lane/4 and +8, channels 2*(lane%4) + {0,1} and + 8, the lower
// channel in the low half. The halo'd x tile is channel-planar in shared
// memory (24 x 80 bf16 a channel, stride 1928 = 8 mod 64 elements, so a
// warp's four channel rows of 8 pixels fall on disjoint banks), staged
// with 16-byte cp.async granules of 8 pixels when W % 8 == 0, else by
// plain loads. B's core matrices are 8 output channels x 8 input channels
// (16 bytes a row), the two K halves 128 bytes apart, groups of 8 outputs
// 256 apart: the f32 kernel's descriptor. norm_convs_bf16_pack_kernel
// lays the kernels out once per call in that order.
//
// Plain C interface (no PyTorch headers): the launcher returns
// cudaGetLastError() and launches on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 6;          // widest reach: 5x5 dilation 3
constexpr int kTileW = 64;        // output columns per block: one wgmma M
constexpr int kWarpGroups = 3;
constexpr int kMTiles = 4;        // output rows per warpgroup, one M-tile each
constexpr int kTileH = kWarpGroups * kMTiles;
constexpr int kThreads = 128 * kWarpGroups;
constexpr int kColOrigin = 8;     // tile column 0 is output column x0 - 8
constexpr int kInH = kTileH + 2 * kHalo;
constexpr int kInW = kTileW + 2 * kColOrigin;  // 80: 16-byte rows from x0 - 8
constexpr int kChunk = 8;                  // input channels per k8 step
// channel stride of the x tile: the least >= kInH*kInW that is 8 (mod 32)
// words, so a fragment's 4 channels x 8 pixels fall on 32 banks
constexpr int kChanStride = (kInH * kInW - 8 + 31) / 32 * 32 + 8;
constexpr int kXFloats = kChunk * kChanStride;
constexpr int kMaxNT = 4;                  // output channels per slice / 8
constexpr int kAllTaps = 9 + 25 + 25;
// floats of one tap's split weights: {hi, lo} x NT groups x 64 (2 core
// matrices of 8 output channels x 4 input channels)
__host__ __device__ constexpr int tap_floats(int nt) { return 2 * nt * 64; }
constexpr int kWFloats = 25 * tap_floats(kMaxNT);
constexpr int kSmemBytes = 2 * (kXFloats + kWFloats) * 4 + 2 * 8;

static_assert(kInH * kInW <= kChanStride && kChanStride % 32 == 8, "x tile stride");
static_assert((kXFloats * 4) % 128 == 0 && (kWFloats * 4) % 128 == 0, "buffer alignment");

__host__ __device__ constexpr int branch_taps(int br) { return br == 0 ? 9 : 25; }
__host__ __device__ constexpr int branch_tap_base(int br) { return br == 0 ? 0 : (br == 1 ? 9 : 34); }

// Round to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away from zero,
// low 13 bits cleared.
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major, no swizzle: core matrices of 8 rows x 16 bytes, the two K halves
// of a k8 step 128 bytes apart (LBO), groups of 8 output channels 256 apart (SBO).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 8R] += a[64 x 8] * B[8 x 8R], f32 accumulate, TF32 operands; a in
// registers (this thread's fragment), B from shared memory; d this thread's
// 4R accumulators.
template <int R> struct Mma;

template <> struct Mma<1> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma<2> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma<3> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma<4> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Keep the compiler from reading or writing the accumulators across a wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One tap's fragments for the warpgroup's M-tiles: M-tile m is output row
// m of the warpgroup, its rows g and g + 8 of warp w the pixels 16w + g and
// 16w + g + 8; channels tig and tig + 4. Each value split into TF32 hi and
// lo (lo exact in f32: the tensor cores read its top 19 bits).
__device__ __forceinline__ void load_tap(uint32_t (&hi)[kMTiles][4], uint32_t (&lo)[kMTiles][4],
                                         const float* __restrict__ p0) {
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
    const float* p = p0 + m * kInW;
    const float v[4] = {p[0], p[8], p[4 * kChanStride], p[4 * kChanStride + 8]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[m][i] = rna_tf32(v[i]);
      lo[m][i] = __float_as_uint(v[i] - __uint_as_float(hi[m][i]));
    }
  }
}

// One tap's wgmmas: per M-tile lo*W_hi, hi*W_lo, hi*W_hi.
template <int NT>
__device__ __forceinline__ void mma_tap(float (&acc)[kMTiles][4 * NT],
                                        const uint32_t (&hi)[kMTiles][4],
                                        const uint32_t (&lo)[kMTiles][4], uint32_t w_tap) {
  const uint64_t d_hi = b_desc(w_tap), d_lo = b_desc(w_tap + NT * 64 * 4);
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
    Mma<NT>::run(acc[m], lo[m], d_hi);
    Mma<NT>::run(acc[m], hi[m], d_lo);
    Mma<NT>::run(acc[m], hi[m], d_hi);
  }
}

// One branch on one chunk, a tap at a time. The loop stays a loop and each
// tap waits for its wgmmas: unrolled, or with a second tap's fragments in
// flight, ptxas ran out of registers and serialized every wgmma.
template <int NT, int K, int D>
__device__ __forceinline__ void branch_chunk(float (&acc)[kMTiles][4 * NT],
                                             const float* __restrict__ xs, uint32_t w_s,
                                             int wg, int warp, int g, int tig) {
  constexpr int pad = (K / 2) * D;
  constexpr int tap_bytes = tap_floats(NT) * 4;
  const float* base = xs + tig * kChanStride + (kMTiles * wg + kHalo - pad) * kInW +
                      16 * warp + g + kColOrigin - pad;
#pragma unroll 1
  for (int t = 0; t < K * K; ++t) {
    uint32_t hi[kMTiles][4], lo[kMTiles][4];
    load_tap(hi, lo, base + (t / K) * D * kInW + (t % K) * D);
    wgmma_fence();
    mma_tap<NT>(acc, hi, lo, w_s + t * tap_bytes);
    wgmma_commit();
    wgmma_wait_all();
  }
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) fence_regs(acc[m]);
}

// Split the three kernels into W_hi, W_lo in the order the main kernel's
// stages copy them: [slice][branch][chunk][tap][hi|lo][group][k half][8 n][4 c].
__global__ void norm_convs_split_kernel(const float* __restrict__ w3,
                                        const float* __restrict__ w52,
                                        const float* __restrict__ w53,
                                        float* __restrict__ scratch, int C, int N, int nt,
                                        int nps, int chunks, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int kk = (int)(i & 3), r = (int)((i >> 2) & 7), kh = (int)((i >> 5) & 1);
    long long rest = i >> 6;
    const int grp = (int)(rest % nt);
    rest /= nt;
    const int part = (int)(rest & 1);
    rest >>= 1;
    const int z = (int)(rest / (chunks * kAllTaps));
    int q = (int)(rest % (chunks * kAllTaps));
    int br = 0;
    while (br < 2 && q >= branch_tap_base(br + 1) * chunks) ++br;
    q -= branch_tap_base(br) * chunks;
    const int taps = branch_taps(br);
    const int c = q / taps, tap = q % taps;
    const int n = z * nps + grp * 8 + r;
    const int ch = c * kChunk + kh * 4 + kk;
    const float* src = br == 0 ? w3 : (br == 1 ? w52 : w53);
    const float w = (n < N && ch < C) ? src[((long long)n * C + ch) * taps + tap] : 0.f;
    const float hi = __uint_as_float(rna_tf32(w));
    scratch[i] = part == 0 ? hi : __uint_as_float(rna_tf32(w - hi));
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
norm_convs_kernel(const float* __restrict__ x, const float* __restrict__ wsplit,
                  float* __restrict__ out, int C, int H, int W, int N, int nps, int chunks,
                  int tiles_x, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs_base = reinterpret_cast<float*>(smem);            // 2 x tiles
  float* ws_base = xs_base + 2 * kXFloats;                     // 2 weight stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws_base + 2 * kWFloats);

  const int t = threadIdx.x;
  const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y, z = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const long long plane = (long long)H * W;
  const float* xb = x + (long long)b * C * plane;
  const float* wz = wsplit + (long long)z * chunks * kAllTaps * tap_floats(NT);
  const int stages = 3 * chunks;

  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[1])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage s = (branch s / chunks, chunk s % chunks) into buffer s & 1.
  auto issue = [&](int s) {
    const int br = s / chunks, c = s % chunks, buf = s & 1;
    const uint32_t xs = smem_addr(xs_base + buf * kXFloats);
    if (vec) {  // W % 4 == 0: a quad of columns is all inside or all outside
      constexpr int kQuads = kInW / 4;
      for (int e = t; e < kChunk * kInH * kQuads; e += kThreads) {
        const int ci = e / (kInH * kQuads);
        const int rem = e - ci * (kInH * kQuads);
        const int rr = rem / kQuads, qd = rem - (rem / kQuads) * kQuads;
        const int gy = y0 - kHalo + rr, gx = x0 - kColOrigin + 4 * qd, gc = c * kChunk + ci;
        const bool valid = gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float* src = valid ? xb + gc * plane + (long long)gy * W + gx : x;
        cp_async16(xs + (ci * kChanStride + rr * kInW + 4 * qd) * 4, src, valid);
      }
    } else {
      for (int e = t; e < kChunk * kInH * kInW; e += kThreads) {
        const int ci = e / (kInH * kInW);
        const int rem = e - ci * (kInH * kInW);
        const int rr = rem / kInW, cc = rem - (rem / kInW) * kInW;
        const int gy = y0 - kHalo + rr, gx = x0 - kColOrigin + cc, gc = c * kChunk + ci;
        const bool valid = gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float* src = valid ? xb + gc * plane + (long long)gy * W + gx : x;
        cp_async4(xs + (ci * kChanStride + rr * kInW + cc) * 4, src, valid);
      }
    }
    if (t == 0) {
      const int taps = branch_taps(br);
      const uint32_t bytes = taps * tap_floats(NT) * 4;
      const float* src = wz + ((long long)branch_tap_base(br) * chunks + c * taps) * tap_floats(NT);
      const uint32_t mb = smem_addr(&bar[buf]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(ws_base + buf * kWFloats)),
          "l"(src), "r"(bytes), "r"(mb)
          : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[kMTiles][4 * NT];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[m][i] = 0.f;

  issue(0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      issue(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    mbar_wait(smem_addr(&bar[s & 1]), (s >> 1) & 1);
    __syncthreads();  // every thread's x copies of stage s have landed

    const int br = s / chunks, c = s % chunks;
    const float* xs = xs_base + (s & 1) * kXFloats;
    const uint32_t w_s = smem_addr(ws_base + (s & 1) * kWFloats);
    if (br == 0)
      branch_chunk<NT, 3, 1>(acc, xs, w_s, wg, warp, g, tig);
    else if (br == 1)
      branch_chunk<NT, 5, 2>(acc, xs, w_s, wg, warp, g, tig);
    else
      branch_chunk<NT, 5, 3>(acc, xs, w_s, wg, warp, g, tig);

    if (c == chunks - 1) {  // the branch is summed: store and restart
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const int yo = y0 + kMTiles * wg + m;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              // register 4j + 2h + q: M row g + 8h (pixel 16w + g + 8h),
              // column 8j + 2*tig + q
              const int n = z * nps + 8 * j + 2 * tig + q;
              const int xo = x0 + 16 * warp + g + 8 * h;
              if (n < N && yo < H && xo < W)
                out[((long long)b * 3 * N + (long long)br * N + n) * plane +
                    (long long)yo * W + xo] = acc[m][4 * j + 2 * h + q];
              acc[m][4 * j + 2 * h + q] = 0.f;
            }
      }
    }
    __syncthreads();  // buffer s & 1 is free for stage s + 2
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Channel slices of at most 32 outputs, each padded to NT groups of 8.
void plan(int C, int N, int* slices, int* nps, int* chunks) {
  *slices = ceil_div(N, 8 * kMaxNT);
  *nps = 8 * ceil_div(ceil_div(N, *slices), 8);
  *chunks = ceil_div(C, kChunk);
}

template <int NT>
cudaError_t launch(const float* x, const float* scratch, float* out, int B, int C, int H,
                   int W, int N, int slices, int nps, int chunks, cudaStream_t stream) {
  const int vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(norm_convs_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(W, kTileW);
  const long long tiles = (long long)tiles_x * ceil_div(H, kTileH);
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, B, slices);
  norm_convs_kernel<NT><<<grid, kThreads, kSmemBytes, stream>>>(x, scratch, out, C, H, W, N,
                                                                 nps, chunks, tiles_x, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 operands
// ---------------------------------------------------------------------------

constexpr int kChunk16 = 16;               // input channels per k16 step
// channel stride of the bf16 x tile, in elements: the least >= kInH*kInW
// that is 8 (mod 64), so a warp's channel rows 2*tig (tig 0..3) lie 32
// bytes apart mod 128 and their 8 pixels (<= 5 words) never share a bank
constexpr int kChanStride16 = (kInH * kInW - 8 + 63) / 64 * 64 + 8;
constexpr int kXElems16 = kChunk16 * kChanStride16;
// bf16 elements of one tap's weights: NT groups x 2 K halves x 8 x 8
__host__ __device__ constexpr int tap_elems16(int nt) { return nt * 128; }
constexpr int kWElems16 = 25 * tap_elems16(kMaxNT);
constexpr int kSmemBytes16 = 2 * (kXElems16 + kWElems16) * 2 + 2 * 8;

static_assert(kInH * kInW <= kChanStride16 && kChanStride16 % 64 == 8, "bf16 x tile stride");
static_assert((kXElems16 * 2) % 128 == 0 && (kWElems16 * 2) % 128 == 0, "bf16 buffer alignment");
static_assert(kSmemBytes16 <= 232448, "bf16 shared memory");

// d[64 x 8R] += a[64 x 16] * B[16 x 8R], f32 accumulate, bf16 operands; a
// in registers, B (K-major, not transposed) from shared memory.
template <int R> struct Mma16;

template <> struct Mma16<1> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma16<2> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma16<3> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma16<4> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, "
        "1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Two bf16 values as one register, `lo` in the low half (the lower K index).
__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// One tap's fragments for the warpgroup's M-tiles: M-tile m is output row
// m of the warpgroup; register 0 holds pixel 16w + g at channels 2*tig and
// 2*tig + 1, register 1 pixel + 8, registers 2 and 3 the same at channels
// + 8. p0 points at channel 2*tig, pixel 16w + g of row 0.
__device__ __forceinline__ void load_tap16(uint32_t (&a)[kMTiles][4],
                                           const unsigned short* __restrict__ p0) {
  constexpr int S = kChanStride16;
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
    const unsigned short* p = p0 + m * kInW;
    a[m][0] = pack2(p[0], p[S]);
    a[m][1] = pack2(p[8], p[S + 8]);
    a[m][2] = pack2(p[8 * S], p[9 * S]);
    a[m][3] = pack2(p[8 * S + 8], p[9 * S + 8]);
  }
}

// One branch on one 16-channel chunk, a tap at a time (as the f32 kernel:
// each tap waits for its wgmmas).
template <int NT, int K, int D>
__device__ __forceinline__ void branch_chunk16(float (&acc)[kMTiles][4 * NT],
                                               const unsigned short* __restrict__ xs,
                                               uint32_t w_s, int wg, int warp, int g, int tig) {
  constexpr int pad = (K / 2) * D;
  constexpr int tap_bytes = tap_elems16(NT) * 2;
  const unsigned short* base = xs + 2 * tig * kChanStride16 +
                               (kMTiles * wg + kHalo - pad) * kInW + 16 * warp + g +
                               kColOrigin - pad;
#pragma unroll 1
  for (int t = 0; t < K * K; ++t) {
    uint32_t a[kMTiles][4];
    load_tap16(a, base + (t / K) * D * kInW + (t % K) * D);
    const uint64_t desc = b_desc(w_s + t * tap_bytes);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) Mma16<NT>::run(acc[m], a[m], desc);
    wgmma_commit();
    wgmma_wait_all();
  }
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) fence_regs(acc[m]);
}

// The three kernels as bf16 in the order the main kernel's stages copy
// them: [slice][branch][chunk][tap][group][k half][8 n][8 c].
__global__ void norm_convs_bf16_pack_kernel(const unsigned short* __restrict__ w3,
                                            const unsigned short* __restrict__ w52,
                                            const unsigned short* __restrict__ w53,
                                            unsigned short* __restrict__ scratch, int C, int N,
                                            int nt, int nps, int chunks, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int kk = (int)(i & 7), r = (int)((i >> 3) & 7), kh = (int)((i >> 6) & 1);
    long long rest = i >> 7;
    const int grp = (int)(rest % nt);
    rest /= nt;
    const int z = (int)(rest / (chunks * kAllTaps));
    int q = (int)(rest % (chunks * kAllTaps));
    int br = 0;
    while (br < 2 && q >= branch_tap_base(br + 1) * chunks) ++br;
    q -= branch_tap_base(br) * chunks;
    const int taps = branch_taps(br);
    const int c = q / taps, tap = q % taps;
    const int n = z * nps + grp * 8 + r;
    const int ch = c * kChunk16 + kh * 8 + kk;
    const unsigned short* src = br == 0 ? w3 : (br == 1 ? w52 : w53);
    scratch[i] = (n < N && ch < C) ? src[((long long)n * C + ch) * taps + tap] : 0;
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
norm_convs_bf16_kernel(const unsigned short* __restrict__ x,
                       const unsigned short* __restrict__ wpack, __nv_bfloat16* __restrict__ out,
                       int C, int H, int W, int N, int nps, int chunks, int tiles_x, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* xs_base = reinterpret_cast<unsigned short*>(smem);    // 2 x tiles
  unsigned short* ws_base = xs_base + 2 * kXElems16;                     // 2 weight stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws_base + 2 * kWElems16);

  const int t = threadIdx.x;
  const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y, z = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const long long plane = (long long)H * W;
  const unsigned short* xb = x + (long long)b * C * plane;
  const unsigned short* wz = wpack + (long long)z * chunks * kAllTaps * tap_elems16(NT);
  const int stages = 3 * chunks;

  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[1])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage s = (branch s / chunks, chunk s % chunks) into buffer s & 1.
  auto issue = [&](int s) {
    const int buf = s & 1, br = s / chunks, c = s % chunks;
    unsigned short* xt = xs_base + buf * kXElems16;
    if (vec) {  // W % 8 == 0: a granule of 8 columns is all inside or all outside
      constexpr int kGranules = kInW / 8;
      const uint32_t xs = smem_addr(xt);
      for (int e = t; e < kChunk16 * kInH * kGranules; e += kThreads) {
        const int ci = e / (kInH * kGranules);
        const int rem = e - ci * (kInH * kGranules);
        const int rr = rem / kGranules, gi = rem - (rem / kGranules) * kGranules;
        const int gy = y0 - kHalo + rr, gx = x0 - kColOrigin + 8 * gi, gc = c * kChunk16 + ci;
        const bool valid = gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
        const unsigned short* src = valid ? xb + gc * plane + (long long)gy * W + gx : x;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         xs + (ci * kChanStride16 + rr * kInW + 8 * gi) * 2),
                     "l"(src), "r"(valid ? 16 : 0)
                     : "memory");
      }
    } else {
      for (int e = t; e < kChunk16 * kInH * kInW; e += kThreads) {
        const int ci = e / (kInH * kInW);
        const int rem = e - ci * (kInH * kInW);
        const int rr = rem / kInW, cc = rem - (rem / kInW) * kInW;
        const int gy = y0 - kHalo + rr, gx = x0 - kColOrigin + cc, gc = c * kChunk16 + ci;
        const bool valid = gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
        xt[ci * kChanStride16 + rr * kInW + cc] =
            valid ? xb[gc * plane + (long long)gy * W + gx] : (unsigned short)0;
      }
    }
    if (t == 0) {
      const int taps = branch_taps(br);
      const uint32_t bytes = taps * tap_elems16(NT) * 2;
      const unsigned short* src =
          wz + ((long long)branch_tap_base(br) * chunks + c * taps) * tap_elems16(NT);
      const uint32_t mb = smem_addr(&bar[buf]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(ws_base + buf * kWElems16)),
          "l"(src), "r"(bytes), "r"(mb)
          : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[kMTiles][4 * NT];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[m][i] = 0.f;

  issue(0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      issue(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    mbar_wait(smem_addr(bar + (s & 1)), (s >> 1) & 1);
    __syncthreads();  // every thread's x copies (or stores) of stage s have landed

    const int br = s / chunks, c = s % chunks;
    const unsigned short* xs = xs_base + (s & 1) * kXElems16;
    const uint32_t w_s = smem_addr(ws_base + (s & 1) * kWElems16);
    if (br == 0)
      branch_chunk16<NT, 3, 1>(acc, xs, w_s, wg, warp, g, tig);
    else if (br == 1)
      branch_chunk16<NT, 5, 2>(acc, xs, w_s, wg, warp, g, tig);
    else
      branch_chunk16<NT, 5, 3>(acc, xs, w_s, wg, warp, g, tig);

    if (c == chunks - 1) {  // the branch is summed: round once, store, restart
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const int yo = y0 + kMTiles * wg + m;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              // register 4j + 2h + q: M row g + 8h (pixel 16w + g + 8h),
              // column 8j + 2*tig + q
              const int n = z * nps + 8 * j + 2 * tig + q;
              const int xo = x0 + 16 * warp + g + 8 * h;
              if (n < N && yo < H && xo < W)
                out[((long long)b * 3 * N + (long long)br * N + n) * plane +
                    (long long)yo * W + xo] = __float2bfloat16_rn(acc[m][4 * j + 2 * h + q]);
              acc[m][4 * j + 2 * h + q] = 0.f;
            }
      }
    }
    __syncthreads();  // buffer s & 1 is free for stage s + 2
  }
}

template <int NT>
cudaError_t launch16(const unsigned short* x, const unsigned short* packed, __nv_bfloat16* out,
                     int B, int C, int H, int W, int N, int slices, int nps, int chunks,
                     cudaStream_t stream) {
  const int vec = W % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(norm_convs_bf16_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes16);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(W, kTileW);
  const long long tiles = (long long)tiles_x * ceil_div(H, kTileH);
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, B, slices);
  norm_convs_bf16_kernel<NT><<<grid, kThreads, kSmemBytes16, stream>>>(
      x, packed, out, C, H, W, N, nps, chunks, tiles_x, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the scratch buffer senas_norm_convs_f32 needs for (C, N).
long long senas_norm_convs_scratch_floats(int C, int N) {
  if (C < 1 || N < 1) return 0;
  int slices, nps, chunks;
  plan(C, N, &slices, &nps, &chunks);
  return (long long)slices * chunks * kAllTaps * tap_floats(nps / 8);
}

// x [B,C,H,W]; w3 [N,C,3,3]; w52, w53 [N,C,5,5]; out [B,3N,H,W]; f32.
// scratch: senas_norm_convs_scratch_floats(C, N) floats, 16-byte aligned.
int senas_norm_convs_f32(const float* x, const float* w3, const float* w52,
                         const float* w53, float* out, int B, int C, int H, int W,
                         int N, float* scratch, long long scratch_floats,
                         cudaStream_t stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const long long need = senas_norm_convs_scratch_floats(C, N);
  if (scratch_floats < need || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int slices, nps, chunks;
  plan(C, N, &slices, &nps, &chunks);
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const int nt = nps / 8;
  const int blocks = (int)((need + 255) / 256 < 2048 ? (need + 255) / 256 : 2048);
  norm_convs_split_kernel<<<blocks, 256, 0, stream>>>(w3, w52, w53, scratch, C, N, nt, nps,
                                                      chunks, need);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (nt) {
    case 1: return (int)launch<1>(x, scratch, out, B, C, H, W, N, slices, nps, chunks, stream);
    case 2: return (int)launch<2>(x, scratch, out, B, C, H, W, N, slices, nps, chunks, stream);
    case 3: return (int)launch<3>(x, scratch, out, B, C, H, W, N, slices, nps, chunks, stream);
    default: return (int)launch<4>(x, scratch, out, B, C, H, W, N, slices, nps, chunks, stream);
  }
}

// bf16 elements of the scratch buffer senas_norm_convs_bf16 needs for (C, N).
long long senas_norm_convs_bf16_scratch_elems(int C, int N) {
  if (C < 1 || N < 1) return 0;
  int slices, nps, chunks;
  plan(C, N, &slices, &nps, &chunks);
  chunks = ceil_div(C, kChunk16);
  return (long long)slices * chunks * kAllTaps * tap_elems16(nps / 8);
}

// x [B,C,H,W]; w3 [N,C,3,3]; w52, w53 [N,C,5,5]; out [B,3N,H,W]; all bf16.
// scratch: senas_norm_convs_bf16_scratch_elems(C, N) bf16, 16-byte aligned.
int senas_norm_convs_bf16(const void* x, const void* w3, const void* w52, const void* w53,
                          void* out, int B, int C, int H, int W, int N, void* scratch,
                          long long scratch_elems, cudaStream_t stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const long long need = senas_norm_convs_bf16_scratch_elems(C, N);
  if (scratch_elems < need || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int slices, nps, chunks;
  plan(C, N, &slices, &nps, &chunks);
  chunks = ceil_div(C, kChunk16);
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const int nt = nps / 8;
  const int blocks = (int)((need + 255) / 256 < 2048 ? (need + 255) / 256 : 2048);
  auto* packed = static_cast<unsigned short*>(scratch);
  norm_convs_bf16_pack_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const unsigned short*>(w3), static_cast<const unsigned short*>(w52),
      static_cast<const unsigned short*>(w53), packed, C, N, nt, nps, chunks, need);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* xp = static_cast<const unsigned short*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (nt) {
    case 1: return (int)launch16<1>(xp, packed, op, B, C, H, W, N, slices, nps, chunks, stream);
    case 2: return (int)launch16<2>(xp, packed, op, B, C, H, W, N, slices, nps, chunks, stream);
    case 3: return (int)launch16<3>(xp, packed, op, B, C, H, W, N, slices, nps, chunks, stream);
    default: return (int)launch16<4>(xp, packed, op, B, C, H, W, N, slices, nps, chunks, stream);
  }
}

const char* senas_norm_convs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
