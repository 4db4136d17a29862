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
// bf16 design (Hopper: TMA, mbarriers, wgmma with A and B from shared
// memory, a warp-specialised block):
//  - A layout pass (norm_convs_bf16_layout_kernel) copies x into the
//    scratch buffer as [B][ceil(C/8)][H][W][8]: a pixel's 8 channels of a
//    group in one 16-byte row, channels past C zero. It moves x twice
//    (2 x 67 MB at bench.py's shape, ~0.04 ms at 3.35 TB/s), which counts
//    in the kernel's time but not in its bound. (A 16-byte version through
//    shared memory measured no faster.)
//  - A tile is 8 output rows x 64 columns of one image and one channel
//    slice; a stage is (branch, chunk of 16 channels). Its x box is the
//    tile with the branch's own halo, (8 + 2p) x (64 + 2p) pixels (p = 1,
//    4, 6), one TMA box per K half of 8 channels, over a map of 8-byte
//    elements (a pixel is two) so that a box row is one 1-1.2 KB run;
//    TMA fills zeros for negative coordinates, past H and W, and for a K
//    half past ceil(C/8) (the map's channel-group axis is its own
//    dimension). Then 8 adjacent pixels are one no-swizzle K-major core
//    matrix (128 contiguous bytes), and a tap's A operand for an M-tile
//    is a descriptor whose start address moves by (dy*d*pitch + dx*d)*16
//    bytes: SBO 128 (the next 8 pixels), LBO 24,320 (the K halves, one
//    widest box apart). No A fragment passes through registers. B is as
//    in the f32 kernel (LBO 128, SBO 256), packed once per call by
//    norm_convs_bf16_pack_kernel; one cp.async.bulk brings a stage's taps.
//  - A block is 3 warpgroups. Warpgroup 0 produces: one thread starts the
//    TMA boxes and the bulk copy onto the stage's full mbarrier, and warps
//    1-3 (the storers) copy a branch's staged sums to global memory in
//    16-byte rows of 8 pixels; setmaxnreg gives its registers to the
//    consumers. Warpgroups 1-2 consume, 4 output rows (M-tiles) each: a
//    stage's taps back to back, 4 wgmma m64nNk16 and one commit group a
//    tap; one wait (wait_group 1) a stage, after the next stage's first
//    tap, hands the previous buffer back on its empty mbarrier; the wait
//    for all (wait_group 0) comes only at a branch's end, where they round
//    the sums once and stage them in the last stage's buffer by stmatrix
//    (.trans: a row is one channel's 8 pixels). scale-d 0 on a branch's
//    first tap starts its accumulators.
//  - What made ptxas serialize every wgmma (a wait after each: as many
//    WARPGROUP.DEPBAR as HGMMA in the SASS): the consumers staging the
//    sums with 2-byte st.shared (0.3803 ms against 0.3033,
//    tools/k2_ceiling.py --bf16). The sums go out by stmatrix; arrives are
//    predicated instructions and row 0 of the taps is its own
//    instantiation, so no branch lies among the wgmmas.
//  - Shared memory: a ring of 3 stages of 74,240 bytes (two boxes of the
//    widest halo, 20 x 76 x 16 = 24,320 bytes each, and 25 taps of NT = 4
//    weights, 25,600) and 9 mbarriers: 222,792 of the 232,448 bytes a
//    block may use. That sets the tile's height: 12 rows (3 consumers)
//    would need 251,904 with 3 stages; with 2 stages it measured slower.
//    One block per SM; the grid is persistent (one block per SM walks the
//    work items, tiles fastest), so the ring runs on from one tile into
//    the next.
//  - Registers: the accumulators, 4 x 4*NT floats a thread (64 at NT = 4),
//    and no fragments; ptxas reports 0 bytes spilled at every NT.
//  - Its ceiling: a wgmma m64n24k16 reads 2,048 bytes of A and 768 of B
//    from shared memory, ~22 cycles at 128 bytes a cycle, against ~12 of
//    tensor-core time (2,048 bf16 multiply-adds a cycle an SM): bound by
//    shared memory at ~0.55 of the operations bound (measured: 538.81
//    TFLOP/s, 0.545 of 989, tools/k2_ceiling.py --bf16).
//  - Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W limit, at
//    bench.py's shape: 0.3060 ms, 0.314 of the operations bound, 4.04x
//    faster than cuDNN's three bf16 convolutions (chip_smoke.py phase
//    18); without the layout pass 0.2530, the layout pass alone 0.0546,
//    the wgmmas alone 0.2026 (tools/k2_ceiling.py --bf16; PERF.md).

// Plain C interface (no PyTorch headers): the launcher returns
// cudaGetLastError() and launches on the stream it is given.

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
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

constexpr int kChunk16 = 16;       // input channels per k16 step: two K halves of 8
constexpr int kTileH16 = 8;        // output rows per tile: kConsumers x kMTiles
constexpr int kConsumers = 2;      // consumer warpgroups; warpgroup 0 is the producer
constexpr int kThreads16 = 128 * (1 + kConsumers);
constexpr int kStorers = 96;       // warps 1-3 of the producer warpgroup store the outputs
constexpr int kStages16 = 3;       // depth of the ring of stage buffers
__host__ __device__ constexpr int branch_pad(int br) { return br == 0 ? 1 : (br == 1 ? 4 : 6); }
// One K half of a branch's x box: (8 + 2 pad) rows x (64 + 2 pad) pixels,
// a pixel's 8 channels in one 16-byte row.
__host__ __device__ constexpr int box_bytes(int br) {
  return (kTileH16 + 2 * branch_pad(br)) * (kTileW + 2 * branch_pad(br)) * 16;
}
constexpr int kBoxBytes = box_bytes(2);    // 24,320: the widest halo; also the A descriptor's LBO
constexpr int kXBytes16 = 2 * kBoxBytes;   // both K halves
// bf16 elements of one tap's weights: NT groups x 2 K halves x 8 x 8
__host__ __device__ constexpr int tap_elems16(int nt) { return nt * 128; }
constexpr int kWBytes16 = 25 * tap_elems16(kMaxNT) * 2;    // 25,600
constexpr int kStageBytes16 = kXBytes16 + kWBytes16;       // 74,240
constexpr int kSmemBytes16 = kStages16 * kStageBytes16 + 3 * kStages16 * 8;
// A branch's sums are staged for the storers in the buffer of its last
// stage as [tile row][output channel][64 pixels + 8]: 144 bytes a channel,
// so the 8 rows of 16 bytes that one stmatrix matrix writes fall on
// disjoint banks.
constexpr int kOutPitch = kTileW + 8;

static_assert(kTileH16 == kConsumers * kMTiles, "a consumer warpgroup's M-tiles are tile rows");
static_assert(kBoxBytes % 128 == 0 && kXBytes16 % 128 == 0 && kStageBytes16 % 128 == 0,
              "TMA destinations 128-byte aligned");
static_assert(kSmemBytes16 <= 232448, "bf16 shared memory");
static_assert(kTileH16 * 8 * kMaxNT * kOutPitch * 2 <= kStageBytes16, "staged outputs");

// The three branches' x boxes (TMA tensor maps over the channel-inner copy
// of x), one per halo.
struct XBoxes {
  CUtensorMap m[3];
};

// No-swizzle K-major wgmma descriptor: core matrices of 8 rows x 16 bytes,
// LBO the stride of the two K halves, SBO that of groups of 8 rows.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// The arrive of the threads where `on` holds, as a predicated instruction,
// so that no branch lies among a stage's wgmmas (ptxas flagged such a
// branch, C7520, in an earlier form of this kernel).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::
          "r"(bar),
      "r"((int)on)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One box [1][1][rows][2 cols] of the 4-D map at (b, c8, y, 2x): zeros
// where a coordinate lies outside x (negative ones too).
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                        int y, int c8, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(2 * x), "r"(y), "r"(c8), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d[64 x 8R] (+)= A[64 x 16] * B[16 x 8R], f32 accumulate, bf16 operands,
// A and B from shared memory (K-major, not transposed); scale 0 ignores d.
template <int R> struct MmaSS;

template <> struct MmaSS<1> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale));
  }
};

template <> struct MmaSS<2> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale));
  }
};

template <> struct MmaSS<3> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(scale));
  }
};

template <> struct MmaSS<4> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale));
  }
};

// Two f32 values rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}

// One row dy of a stage's taps for one consumer warpgroup: per tap its 4
// M-tiles' wgmmas, A and B both read by descriptor from the stage's
// buffer, and one commit group. Row 0 (kRow0) starts the accumulators
// when `first` (scale-d 0 on its tap 0) and, once that tap is committed,
// waits (wait_group 1) for every earlier group; with `release` (lane 0 of
// each warp) the previous stage's buffer then goes back on its empty
// barrier `prev`. No branch lies between the wgmmas (see mbar_arrive_if).
template <int NT, int K, int D, bool kRow0>
__device__ __forceinline__ void taps_row(float (&acc)[kMTiles][4 * NT], uint64_t a0, uint64_t b0,
                                         int dy, int pitch, bool first, bool release,
                                         uint32_t prev) {
  constexpr int tap_units = tap_elems16(NT) * 2 / 16;   // one tap's B, in 16-byte units
#pragma unroll
  for (int dx = 0; dx < K; ++dx) {
    const uint64_t a = a0 + (uint64_t)(dy * D * pitch + dx * D);
    const uint64_t b = b0 + (uint64_t)((dy * K + dx) * tap_units);
    const int scale = !(kRow0 && dx == 0 && first);
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) MmaSS<NT>::run(acc[m], a + m * pitch, b, scale);
    wgmma_commit();
    if (kRow0 && dx == 0) {
      wgmma_wait<1>();
      mbar_arrive_if(prev, release);
    }
  }
}

// One stage (a branch on one 16-channel chunk) of one consumer warpgroup.
// M-tile m is output row 4*cw + m of the tile: at tap (dy, dx) its 64
// pixels start at box row 4*cw + m + dy*D, column dx*D (a pixel is one
// 16-byte unit of the descriptor's start address).
template <int NT, int K, int D>
__device__ __forceinline__ void stage16(float (&acc)[kMTiles][4 * NT], uint32_t xs, uint32_t ws,
                                        int cw, bool first, bool release, uint32_t prev) {
  constexpr int pitch = kTileW + 2 * (K / 2) * D;
  const uint64_t a0 = kmajor_desc(xs + kMTiles * cw * pitch * 16, kBoxBytes, 128);
  const uint64_t b0 = b_desc(ws);
  wgmma_fence();
  taps_row<NT, K, D, true>(acc, a0, b0, 0, pitch, first, release, prev);
#pragma unroll 1
  for (int dy = 1; dy < K; ++dy) taps_row<NT, K, D, false>(acc, a0, b0, dy, pitch, first, false, 0);
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

// x [B,C,H,W] -> xl [B][C8][H][W][8]: the 8 channels of a group at a pixel
// in one 16-byte row, channels past C zero. Element i of xl (16 bytes) is
// pixel i % (H*W) of group (i / (H*W)) % C8 of image i / (H*W*C8).
__global__ void norm_convs_bf16_layout_kernel(const unsigned short* __restrict__ x,
                                              uint4* __restrict__ xl, int C, int C8,
                                              long long plane, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = i % plane, bc = i / plane;
    const int c0 = (int)(bc % C8) * 8;
    const unsigned short* src = x + ((bc / C8) * C + c0) * plane + p;
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = c0 + 2 * k < C ? src[2 * k * plane] : 0u;
      const uint32_t hi = c0 + 2 * k + 1 < C ? src[(2 * k + 1) * plane] : 0u;
      v[k] = lo | (hi << 16);
    }
    xl[i] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Work item -> (tile column, tile row, image, channel slice), tiles fastest.
__device__ __forceinline__ void decode_item(int item, int tiles_x, int tiles_y, int B, int& tx,
                                            int& ty, int& b, int& z) {
  tx = item % tiles_x;
  ty = (item / tiles_x) % tiles_y;
  const int rest = item / (tiles_x * tiles_y);
  b = rest % B;
  z = rest / B;
}

// One branch of a work item for one consumer warpgroup: its chunks' stages
// (the ring's stages g, g + 1, ...), then its sums, rounded once and staged
// for the storers in the last stage's buffer at
// [tile row][output channel][kOutPitch]. A stage's wgmmas stay in flight
// into the next stage; the wait for all of them comes only here.
template <int NT, int K, int D>
__device__ __forceinline__ void branch16(float (&acc)[kMTiles][4 * NT], unsigned char* smem,
                                         uint32_t full, uint32_t empty, uint32_t staged, int& g,
                                         int chunks, int cw, int warp, int lane) {
  const uint32_t base = smem_addr(smem);
  uint32_t prev = 0;
  int slot = 0;
  for (int c = 0; c < chunks; ++c, ++g) {
    slot = g % kStages16;
    const uint32_t buf = base + slot * kStageBytes16;
    mbar_wait(full + 8 * slot, (g / kStages16) & 1);
    stage16<NT, K, D>(acc, buf, buf + kXBytes16, cw, c == 0, c > 0 && lane == 0, prev);
    prev = empty + 8 * slot;
  }
  // the branch is summed: wait for its wgmmas and the other consumer's,
  // round once and stage the sums in the last stage's buffer
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) fence_regs(acc[m]);
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  // Registers 4j + 2h + q hold M row 16*warp + gq + 8h (the pixel) and
  // column 8j + 2*tig + q (the output channel): for each (j, h) an 8 x 8
  // matrix in stmatrix's fragment layout. Stored transposed, its row i is
  // channel 8j + i at 8 adjacent pixels, 16 bytes; lanes 0-15 give the
  // rows' addresses (lane 8h + i: matrix h, row i). (2-byte st.shared of
  // the sums here made ptxas serialize every wgmma of the kernel.)
  const uint32_t tile = smem_addr(smem + slot * kStageBytes16);
  const int row = lane & 7, half = (lane >> 3) & 1;
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t addr =
          tile + (((kMTiles * cw + m) * 8 * NT + 8 * j + row) * kOutPitch + 16 * warp + 8 * half) * 2;
      asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr),
                   "r"(bf16x2(acc[m][4 * j], acc[m][4 * j + 1])),
                   "r"(bf16x2(acc[m][4 * j + 2], acc[m][4 * j + 3]))
                   : "memory");
    }
  // the producer's TMA overwrites what the generic proxy wrote
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(staged + 8 * slot);
  mbar_arrive_if(prev, lane == 0);
}

template <int NT>
__global__ void __launch_bounds__(kThreads16, 1)
norm_convs_bf16_kernel(const __grid_constant__ XBoxes boxes,
                       const unsigned short* __restrict__ wpack, unsigned short* __restrict__ out,
                       int B, int H, int W, int N, int chunks, int tiles_x, int tiles_y, int items,
                       int vec) {
  constexpr int kCh = 8 * NT;   // output channels of a slice
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kStages16 * kStageBytes16, empty = full + 8 * kStages16;
  const uint32_t staged = empty + 8 * kStages16;
  const int wg = threadIdx.x >> 7;
  const int stages = 3 * chunks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages16; ++i) {
      mbar_init(full + 8 * i, 1);                  // the producer's expect_tx, then the bytes
      mbar_init(empty + 8 * i, 4 * kConsumers + kStorers);   // consumer warps, storer threads
      mbar_init(staged + 8 * i, 128 * kConsumers);           // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread fills the ring, stage after stage, item
    // after item: the two K halves' x boxes by TMA, the chunk's packed
    // weights by one bulk copy, all onto the stage's full barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int tx, ty, b, z;
        decode_item(item, tiles_x, tiles_y, B, tx, ty, b, z);
        const unsigned short* wz = wpack + (long long)z * chunks * kAllTaps * tap_elems16(NT);
        for (int s = 0; s < stages; ++s, ++g) {
          const int slot = g % kStages16, br = s / chunks, c = s % chunks;
          const int pad = branch_pad(br), taps = branch_taps(br);
          const uint32_t buf = base + slot * kStageBytes16, bar = full + 8 * slot;
          const uint32_t wbytes = taps * tap_elems16(NT) * 2;
          mbar_wait(empty + 8 * slot, ((g / kStages16) + 1) & 1);   // passes on first use
          mbar_expect_tx(bar, 2 * box_bytes(br) + wbytes);
          const int x = tx * kTileW - pad, y = ty * kTileH16 - pad;
          tma_box(buf, &boxes.m[br], bar, x, y, 2 * c, b);
          tma_box(buf + kBoxBytes, &boxes.m[br], bar, x, y, 2 * c + 1, b);
          bulk_copy(buf + kXBytes16,
                    wz + ((long long)branch_tap_base(br) * chunks + c * taps) * tap_elems16(NT),
                    wbytes, bar);
        }
      }
    } else if (threadIdx.x >= 32) {
      // The storers: every buffer goes back to the producer through them
      // too, a branch's last one only once they have copied the sums the
      // consumers staged there to global memory, a 16-byte row of 8
      // pixels of one channel at a time (2-byte stores at the image's
      // right edge, or everywhere when W % 8 != 0).
      const int st = threadIdx.x - 32;
      const long long plane = (long long)H * W;
      uint32_t staged_parity = 0;   // bit i: parity of staged[i]'s next phase
      int g = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int tx, ty, b, z;
        decode_item(item, tiles_x, tiles_y, B, tx, ty, b, z);
        for (int s = 0; s < stages; ++s, ++g) {
          const int slot = g % kStages16, br = s / chunks;
          if (s % chunks < chunks - 1) {
            mbar_wait(full + 8 * slot, (g / kStages16) & 1);   // this use of the slot is loaded
          } else {
            mbar_wait(staged + 8 * slot, (staged_parity >> slot) & 1);
            staged_parity ^= 1u << slot;
            const unsigned char* tile = smem + slot * kStageBytes16;
            for (int e = st; e < kTileH16 * kCh * 8; e += kStorers) {
              const int k8 = e & 7, ch = (e >> 3) % kCh, r = (e >> 3) / kCh;
              const int n = z * kCh + ch, yo = ty * kTileH16 + r, xo = tx * kTileW + 8 * k8;
              if (n >= N || yo >= H || xo >= W) continue;
              const uint4 v =
                  *reinterpret_cast<const uint4*>(tile + ((r * kCh + ch) * kOutPitch + 8 * k8) * 2);
              unsigned short* dst = out + ((long long)b * 3 * N + (long long)br * N + n) * plane +
                                    (long long)yo * W + xo;
              if (vec && xo + 8 <= W) {
                *reinterpret_cast<uint4*>(dst) = v;
              } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  const uint32_t word = i < 2 ? v.x : (i < 4 ? v.y : (i < 6 ? v.z : v.w));
                  if (xo + i < W) dst[i] = (unsigned short)(word >> (16 * (i & 1)));
                }
              }
            }
            // the producer's TMA overwrites what the generic proxy read
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          }
          mbar_arrive(empty + 8 * slot);
        }
      }
    }
  } else {
    // The consumers: wgmmas; they wait on "full", give buffers back on
    // "empty", and stage a branch's sums for the storers once its last
    // chunk is summed, branch after branch (branch16).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[kMTiles][4 * NT];
    int g = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      branch16<NT, 3, 1>(acc, smem, full, empty, staged, g, chunks, cw, warp, lane);
      branch16<NT, 5, 2>(acc, smem, full, empty, staged, g, chunks, cw, warp, lane);
      branch16<NT, 5, 3>(acc, smem, full, empty, staged, g, chunks, cw, warp, lane);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the library links
// libcudart only).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The maps of xl [B][C8][H][W][8] bf16 as [B][C8][H][2W] 8-byte elements,
// innermost first (2W, H, C8, B): a box row is one run of 2 * (64 + 2p)
// elements (1,056-1,216 bytes; with the 8 channels as the innermost
// dimension TMA moved 16 bytes a request), and a K half past C8 reads
// zeros as the halo does.
cudaError_t make_boxes(XBoxes* boxes, void* xl, int B, int C8, int H, int W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {2ull * W, (cuuint64_t)H, (cuuint64_t)C8, (cuuint64_t)B};
  const cuuint64_t strides[3] = {16ull * W, 16ull * W * H, 16ull * W * H * C8};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int br = 0; br < 3; ++br) {
    const cuuint32_t box[4] = {(cuuint32_t)(2 * (kTileW + 2 * branch_pad(br))),
                               (cuuint32_t)(kTileH16 + 2 * branch_pad(br)), 1, 1};
    if (encode(&boxes->m[br], CU_TENSOR_MAP_DATA_TYPE_UINT64, 4, xl, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int NT>
cudaError_t launch16(const XBoxes& boxes, const unsigned short* packed, unsigned short* out, int B,
                     int H, int W, int N, int slices, int chunks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(norm_convs_bf16_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes16);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(W, kTileW), tiles_y = ceil_div(H, kTileH16);
  const long long items = (long long)slices * B * tiles_x * tiles_y;
  if (items > 0x7FFFFFFF) return cudaErrorInvalidValue;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // persistent: one block per SM (its shared memory allows no second)
  const int grid = (int)(items < sms ? items : sms);
  const int vec = W % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  norm_convs_bf16_kernel<NT><<<grid, kThreads16, kSmemBytes16, stream>>>(
      boxes, packed, out, B, H, W, N, chunks, tiles_x, tiles_y, (int)items, vec);
  return cudaGetLastError();
}

// bf16 elements of the packed kernels senas_norm_convs_bf16 writes for (C, N).
long long packed_elems16(int C, int N) {
  int slices, nps, chunks;
  plan(C, N, &slices, &nps, &chunks);
  return (long long)slices * ceil_div(C, kChunk16) * kAllTaps * tap_elems16(nps / 8);
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

// bf16 elements of the scratch buffer senas_norm_convs_bf16 needs: the
// packed kernels, then, from the next 128-byte boundary, x in the
// channel-inner layout [B][ceil(C/8)][H][W][8].
long long senas_norm_convs_bf16_scratch_elems(int B, int C, int H, int W, int N) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || N < 1) return 0;
  return (packed_elems16(C, N) + 63) / 64 * 64 + (long long)B * ceil_div(C, 8) * H * W * 8;
}

// x [B,C,H,W]; w3 [N,C,3,3]; w52, w53 [N,C,5,5]; out [B,3N,H,W]; all bf16.
// scratch: senas_norm_convs_bf16_scratch_elems(B, C, H, W, N) bf16,
// 128-byte aligned.
int senas_norm_convs_bf16(const void* x, const void* w3, const void* w52, const void* w53,
                          void* out, int B, int C, int H, int W, int N, void* scratch,
                          long long scratch_elems, cudaStream_t stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const long long need = senas_norm_convs_bf16_scratch_elems(B, C, H, W, N);
  if (scratch_elems < need || (reinterpret_cast<uintptr_t>(scratch) & 127) != 0)
    return (int)cudaErrorInvalidValue;
  int slices, nps, chunks;
  plan(C, N, &slices, &nps, &chunks);
  chunks = ceil_div(C, kChunk16);
  const int nt = nps / 8, C8 = ceil_div(C, 8);
  auto* packed = static_cast<unsigned short*>(scratch);
  const long long npacked = packed_elems16(C, N);
  auto* xl = packed + (npacked + 63) / 64 * 64;
  XBoxes boxes;
  cudaError_t err = make_boxes(&boxes, xl, B, C8, H, W);
  if (err != cudaSuccess) return (int)err;
  const int wblocks = (int)((npacked + 255) / 256 < 2048 ? (npacked + 255) / 256 : 2048);
  norm_convs_bf16_pack_kernel<<<wblocks, 256, 0, stream>>>(
      static_cast<const unsigned short*>(w3), static_cast<const unsigned short*>(w52),
      static_cast<const unsigned short*>(w53), packed, C, N, nt, nps, chunks, npacked);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long plane = (long long)H * W, nxl = (long long)B * C8 * plane;
  const int xblocks = (int)((nxl + 255) / 256 < 8192 ? (nxl + 255) / 256 : 8192);
  norm_convs_bf16_layout_kernel<<<xblocks, 256, 0, stream>>>(
      static_cast<const unsigned short*>(x), reinterpret_cast<uint4*>(xl), C, C8, plane, nxl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto* op = static_cast<unsigned short*>(out);
  switch (nt) {
    case 1: return (int)launch16<1>(boxes, packed, op, B, H, W, N, slices, chunks, stream);
    case 2: return (int)launch16<2>(boxes, packed, op, B, H, W, N, slices, chunks, stream);
    case 3: return (int)launch16<3>(boxes, packed, op, B, H, W, N, slices, chunks, stream);
    default: return (int)launch16<4>(boxes, packed, op, B, H, W, N, slices, chunks, stream);
  }
}

const char* senas_norm_convs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
