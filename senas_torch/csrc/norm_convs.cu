// Hopper (sm_90a) kernel for the three NORM convolutions of one input: the
// kernel of senas_tpu/ops/pallas_kernels.py.
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
// The TPU kernel read three adjacent row blocks of a row-padded input (its
// block specs cannot express a halo) and ran k*k [rows*W, C] x [C, N] matmuls
// per branch. Here one block owns one (b, 8x32 output tile) and all three
// branches: for each chunk of 8 input channels it stages the tile with its
// 6-pixel halo (zeros outside the image) and the three kernels' slices for
// those channels in shared memory, so x is read from device memory once per
// block and the weights once per block and chunk. Each warp owns 32 adjacent
// columns, 4 rows and 8 output channels of one branch: per tap and channel a
// lane reads 4 inputs (32 lanes on 32 adjacent words, no bank conflict) and
// 8 weights (the same two float4 for the whole warp, a broadcast) and does
// 32 FMAs in f32 on the CUDA cores. When 3*ceil(N/8) groups of 8 output
// channels exceed 12, blockIdx.z splits them over several blocks.
//
// Bound on the card: 2*B*H*W*C*N*59 FLOP against (B*C + 3*B*N)*H*W*4 bytes;
// at the shape bench.py times (B 64, 128x128, C 32, N 24) that is 95.0 GFLOP
// (1.418 ms at 67 TFLOP/s f32) against 436 MB (0.130 ms at 3.35 TB/s), so it
// is bound by operations. TF32 tensor cores would change the numbers, and
// parity with the f32 CPU path comes first.
//
// Plain C interface (no PyTorch headers): the launcher returns
// cudaGetLastError() and launches on the stream it is given.

#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 6;          // widest reach: 5x5 dilation 3
constexpr int kTileW = 32;        // output columns per block: one per lane
constexpr int kRows = 4;          // output rows per thread
constexpr int kRowGroups = 2;     // warps down the tile per channel group
constexpr int kTileH = kRows * kRowGroups;
constexpr int kInH = kTileH + 2 * kHalo;
constexpr int kInW = kTileW + 2 * kHalo;
constexpr int kChunk = 8;         // input channels staged at a time
constexpr int kGroupN = 8;        // output channels per thread
constexpr int kMaxGroups = 12;    // channel groups per block
constexpr int kMaxThreads = 32 * kRowGroups * kMaxGroups;
constexpr int kInFloats = kChunk * kInH * kInW;
// shared floats for the weights of one group: a chunk of channels, the
// branch's taps (9 or 25), kGroupN outputs
constexpr int kMaxGroupFloats = kChunk * 25 * kGroupN;
constexpr int kMaxSmemBytes = (kInFloats + kMaxGroups * kMaxGroupFloats) * 4;

__host__ __device__ constexpr int branch_taps(int br) { return br == 0 ? 9 : 25; }

template <int K, int D>
__device__ __forceinline__ void accumulate(const float* __restrict__ in_s,
                                           const float* __restrict__ w_g, int cc,
                                           int cx, int ry, float (&acc)[kRows][kGroupN]) {
  constexpr int pad = (K / 2) * D;
  for (int ci = 0; ci < cc; ++ci) {
    const float* in_c = in_s + ci * kInH * kInW;
    const float* w_c = w_g + ci * K * K * kGroupN;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float4* w4 = reinterpret_cast<const float4*>(w_c + (dy * K + dx) * kGroupN);
        const float4 wa = w4[0];
        const float4 wb = w4[1];
        const float wv[kGroupN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float* col = in_c + (ry + kHalo - pad + dy * D) * kInW + cx + kHalo - pad + dx * D;
#pragma unroll
        for (int py = 0; py < kRows; ++py) {
          const float v = col[py * kInW];
#pragma unroll
          for (int j = 0; j < kGroupN; ++j) acc[py][j] = fmaf(v, wv[j], acc[py][j]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
norm_convs_kernel(const float* __restrict__ x, const float* __restrict__ w3,
                  const float* __restrict__ w52, const float* __restrict__ w53,
                  float* __restrict__ out, int C, int H, int W, int N,
                  int groups_per_branch, int groups_per_block, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);
  float* w_s = in_s + kInFloats;

  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int groups = 3 * groups_per_branch;
  const int g0 = blockIdx.z * groups_per_block;
  const int gba = min(groups_per_block, groups - g0);  // groups of this block

  // this thread's place: column, row group, channel group
  const int cx = t & 31;
  const int ry = ((t >> 5) % kRowGroups) * kRows;
  const int l = (t >> 5) / kRowGroups;
  const bool computes = l < gba;
  const int g = g0 + (computes ? l : 0);
  const int br = g / groups_per_branch;
  const int n0 = (g % groups_per_branch) * kGroupN;
  int w_off = 0;  // start of this group's weights in w_s
  for (int lg = 0; lg < l && lg < gba; ++lg)
    w_off += kChunk * branch_taps((g0 + lg) / groups_per_branch) * kGroupN;

  float acc[kRows][kGroupN];
#pragma unroll
  for (int py = 0; py < kRows; ++py)
#pragma unroll
    for (int j = 0; j < kGroupN; ++j) acc[py][j] = 0.f;

  const long long plane = (long long)H * W;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cc = min(kChunk, C - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = t; e < kInFloats; e += nthreads) {
      const int ci = e / (kInH * kInW);
      const int r = (e / kInW) % kInH;
      const int c = e % kInW;
      const int gy = y0 - kHalo + r;
      const int gx = x0 - kHalo + c;
      float v = 0.f;
      if (ci < cc && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(x + ((long long)b * C + c0 + ci) * plane + (long long)gy * W + gx);
      in_s[e] = v;
    }
    for (int lg = 0, off = 0; lg < gba; ++lg) {
      const int gg = g0 + lg;
      const int gbr = gg / groups_per_branch;
      const int gn0 = (gg % groups_per_branch) * kGroupN;
      const int taps = branch_taps(gbr);
      const float* src = gbr == 0 ? w3 : (gbr == 1 ? w52 : w53);
      const int n_el = kChunk * taps * kGroupN;
      for (int e = t; e < n_el; e += nthreads) {
        const int j = e % kGroupN;
        const int tap = (e / kGroupN) % taps;
        const int ci = e / (kGroupN * taps);
        float v = 0.f;
        if (gn0 + j < N && ci < cc)
          v = __ldg(src + ((long long)(gn0 + j) * C + c0 + ci) * taps + tap);
        w_s[off + e] = v;
      }
      off += n_el;
    }
    __syncthreads();
    if (computes) {  // warp-uniform: a warp holds one channel group
      if (br == 0)
        accumulate<3, 1>(in_s, w_s + w_off, cc, cx, ry, acc);
      else if (br == 1)
        accumulate<5, 2>(in_s, w_s + w_off, cc, cx, ry, acc);
      else
        accumulate<5, 3>(in_s, w_s + w_off, cc, cx, ry, acc);
    }
  }

  if (!computes) return;
  const int xo = x0 + cx;
  if (xo >= W) return;
  const long long out_c0 = (long long)b * 3 * N + (long long)br * N + n0;
#pragma unroll
  for (int py = 0; py < kRows; ++py) {
    const int yo = y0 + ry + py;
    if (yo >= H) continue;
#pragma unroll
    for (int j = 0; j < kGroupN; ++j)
      if (n0 + j < N) out[(out_c0 + j) * plane + (long long)yo * W + xo] = acc[py][j];
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// x [B,C,H,W]; w3 [N,C,3,3]; w52, w53 [N,C,5,5]; out [B,3N,H,W]; f32.
int senas_norm_convs_f32(const float* x, const float* w3, const float* w52,
                         const float* w53, float* out, int B, int C, int H, int W,
                         int N, cudaStream_t stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int groups_per_branch = ceil_div(N, kGroupN);
  const int groups = 3 * groups_per_branch;
  const int slices = ceil_div(groups, kMaxGroups);
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const int groups_per_block = ceil_div(groups, slices);  // balanced over the slices
  const int threads = 32 * kRowGroups * groups_per_block;
  const int smem = (kInFloats + groups_per_block * kMaxGroupFloats) * 4;
  cudaError_t err = cudaFuncSetAttribute(norm_convs_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = ceil_div(W, kTileW);
  const int tiles_y = ceil_div(H, kTileH);
  dim3 grid(tiles_x * tiles_y, B, slices);
  norm_convs_kernel<<<grid, threads, smem, stream>>>(x, w3, w52, w53, out, C, H, W, N,
                                                     groups_per_branch, groups_per_block,
                                                     tiles_x);
  return (int)cudaGetLastError();
}

const char* senas_norm_convs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
