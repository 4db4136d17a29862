"""What holds K2 (senas_torch/csrc/norm_convs.cu) back from its bound, on one
NVIDIA GPU.

    python3 tools/k2_ceiling.py [--out k2_ceiling.json]
    python3 tools/k2_ceiling.py --bf16 [--out k2_ceiling_bf16.json]

Two measurements, each printed with the card's name and power limit:

1. The tensor cores' own ceiling for K2's instruction: a kernel that issues
   only register-A `wgmma m64nNk8 .tf32` (the kernel's `Mma` wrappers,
   included from the source) in K2's order: per tap a group of 12 (4
   M-tiles x lo*W_hi, hi*W_lo, hi*W_hi, the tap's two B tiles) and a wait,
   on one block of 3 warpgroups per SM; TFLOP/s against the 495 TFLOP/s
   TF32 data-sheet peak, at N 24 (K2 at bench.py's shape) and N 32. Where
   ptxas serializes the wgmmas (nvcc prints "wgmma.mma_async instructions
   are serialized"), the rate is a floor, not the ceiling.
2. Ablations of K2 itself at bench.py's shape (x [64,32,128,128], N 24):
   the committed source, and copies with text patches that drop the
   wgmmas, the fragment loads from shared memory, the staging copies, or
   two of them; each timed with CUDA events in turns. The patched copies
   compute wrong values on purpose and are never checked.

With --bf16, the same two for the bf16 kernel (norm_convs_bf16_kernel):

1. The rate of its instruction: two warpgroups a block (its consumers)
   run `wgmma m64nNk16 .bf16` with A and B both from shared memory in its
   order (per tap 4 M-tiles, one commit group; a wait every 25 taps),
   against the 989 TFLOP/s bf16 data-sheet peak, at N 24 and N 32: what
   reading A (2,048 bytes) and B from shared memory leaves of the peak.
2. Ablations at bench.py's shape on bf16 operands: without the wgmmas,
   without the staging (the producer arrives on each stage's full barrier
   with no copy), without the storers' global stores, without the layout
   pass, the layout pass alone, and the wgmmas alone (no staging, stores
   or layout pass); and the design alternatives beside it (ABLATIONS_BF16).
   Each prints its NT=3 instantiation's HGMMA and WARPGROUP.DEPBAR counts
   from cuobjdump: as many DEPBARs as HGMMAs means ptxas serialized every
   wgmma.

Builds with nvcc into a temporary directory; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from senas_torch.ops import _build  # noqa: E402
from senas_torch.ops import norm_convs as nc  # noqa: E402

SOURCE = _build.CSRC / "norm_convs.cu"
BENCH_SHAPE = (64, 32, 128, 128, 24)

# (anchor, replacement) text patches of the kernel source
_NO_MMA = ("""    Mma<NT>::run(acc[m], lo[m], d_hi);
    Mma<NT>::run(acc[m], hi[m], d_lo);
    Mma<NT>::run(acc[m], hi[m], d_hi);""",
           """    asm volatile("" ::"r"(lo[m][0]), "r"(lo[m][1]), "r"(lo[m][2]), "r"(lo[m][3]), "l"(d_hi));
    asm volatile("" ::"r"(hi[m][0]), "r"(hi[m][1]), "r"(hi[m][2]), "r"(hi[m][3]), "l"(d_lo));""")
_NO_LOAD = ("const float v[4] = {p[0], p[8], p[4 * kChanStride], p[4 * kChanStride + 8]};",
            "const float v[4] = {__int_as_float((int)(size_t)p), 1.f, 2.f, 3.f};")
_NO_STAGE = [("    const int br = s / chunks, c = s % chunks, buf = s & 1;",
              "    return;\n    const int br = s / chunks, c = s % chunks, buf = s & 1;"),
             ("    mbar_wait(smem_addr(&bar[s & 1]), (s >> 1) & 1);", "")]
ABLATIONS = {
    "kernel": [],
    "no wgmma": [_NO_MMA],
    "no fragment loads": [_NO_LOAD],
    "no staging": _NO_STAGE,
    "no staging, no wgmma": _NO_STAGE + [_NO_MMA],
    "wgmma only (no staging, no loads)": _NO_STAGE + [_NO_LOAD],
}

# the bf16 kernel's ablations
_NO_MMA16 = ("for (int m = 0; m < kMTiles; ++m) MmaSS<NT>::run(acc[m], a + m * pitch, b, scale);",
             'for (int m = 0; m < kMTiles; ++m) asm volatile("" ::"l"(a + m * pitch), "l"(b), '
             '"r"(scale));')
_NO_STAGE16 = ("          mbar_expect_tx(bar, 2 * box_bytes(br) + wbytes);",
               "          mbar_arrive(bar);\n          continue;")
_NO_STORE16 = ("              if (n >= N || yo >= H || xo >= W) continue;", "              continue;")
_NO_LAYOUT16 = ("  norm_convs_bf16_layout_kernel<<<", "  if (false) norm_convs_bf16_layout_kernel<<<")
_LAYOUT_ONLY16 = ("  switch (nt) {\n    case 1: return (int)launch16<1>",
                  "  if (nt > 0) return 0;\n  switch (nt) {\n    case 1: return (int)launch16<1>")
# design alternatives measured beside it: the consumers staging the sums
# with 2-byte shared stores, and the arrive on the previous stage's buffer
# under a branch (each made ptxas serialize every wgmma); the storers
# freeing a buffer before they copy from it (the cost of holding it; the
# output is wrong); a 12-row tile with 3 consumers and 2 stages
_STS16 = ("""      asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\\n" ::"r"(addr),
                   "r"(bf16x2(acc[m][4 * j], acc[m][4 * j + 1])),
                   "r"(bf16x2(acc[m][4 * j + 2], acc[m][4 * j + 3]))
                   : "memory");""", """      unsigned short* t = reinterpret_cast<unsigned short*>(smem + slot * kStageBytes16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t[((kMTiles * cw + m) * 8 * NT + 8 * j + 2 * (lane & 3) + (i & 1)) * kOutPitch + 16 * warp +
          (lane >> 2) + 8 * (i >> 1)] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[m][4 * j + i]));""")
_BRANCH16 = ("      mbar_arrive_if(prev, release);", "      if (release) mbar_arrive(prev);")
_EARLY16 = [("""            staged_parity ^= 1u << slot;""", """            staged_parity ^= 1u << slot;
            mbar_arrive(empty + 8 * slot);"""),
            ("""            asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
          }
          mbar_arrive(empty + 8 * slot);""", """            asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
            continue;
          }
          mbar_arrive(empty + 8 * slot);""")]
_TILE12 = [("constexpr int kTileH16 = 8;", "constexpr int kTileH16 = 12;"),
           ("constexpr int kConsumers = 2;", "constexpr int kConsumers = 3;"),
           ("constexpr int kStages16 = 3;", "constexpr int kStages16 = 2;"),
           ("setmaxnreg.inc.sync.aligned.u32 232;", "setmaxnreg.inc.sync.aligned.u32 152;")]
ABLATIONS_BF16 = {
    "kernel": [],
    "no wgmma": [_NO_MMA16],
    "no staging": [_NO_STAGE16],
    "no store": [_NO_STORE16],
    "no layout pass": [_NO_LAYOUT16],
    "layout pass only": [_LAYOUT_ONLY16],
    "wgmma only (no staging, store or layout pass)": [_NO_STAGE16, _NO_STORE16, _NO_LAYOUT16],
    "sums staged by 2-byte st.shared": [_STS16],
    "arrive under a branch": [_BRANCH16],
    "storers free the buffer before copying (wrong output)": _EARLY16,
    "12-row tile, 3 consumers, 2 stages": _TILE12,
}

BENCH_CU = r'''
#include "norm_convs.cu"
#include <stdio.h>

template <int R>
__global__ void __launch_bounds__(384, 1) wgmma_only(float* out, int iters) {
  extern __shared__ __align__(128) float b_tiles[];   // 75 B tiles of 8R x 8
  const int nb = 75 * 2 * 8 * R * 8;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) b_tiles[i] = 0.001f * (i % 7);
  __syncthreads();
  float acc[4][4 * R];
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < 4 * R; ++i) acc[m][i] = 0.f;
  const uint32_t a[2][4] = {{threadIdx.x, 3u * threadIdx.x, 7u, 9u}, {1u, 2u, threadIdx.x, 5u}};
  const uint32_t base = smem_addr(b_tiles);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
    // one K2 tap: per M-tile lo*W_hi, hi*W_lo, hi*W_hi on its accumulator
    const uint32_t tap = base + (it % 75) * 2 * 8 * R * 8 * 4;
#pragma unroll
    for (int u = 0; u < 12; ++u)
      Mma<R>::run(acc[u / 3], a[u % 3 == 0], b_desc(tap + (u % 3 == 1) * 8 * R * 8 * 4));
    wgmma_commit();
    wgmma_wait_all();
    for (int m = 0; m < 4; ++m) fence_regs(acc[m]);
  }
  float s = 0.f;
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < 4 * R; ++i) s += acc[m][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int R>
void run(float* out, int sms) {
  const int iters = 20000, smem = 75 * 2 * 8 * R * 8 * 4;
  cudaFuncSetAttribute(wgmma_only<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  wgmma_only<R><<<sms, 384, smem>>>(out, 100);
  cudaEventRecord(e0);
  wgmma_only<R><<<sms, 384, smem>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = (double)sms * 3 * iters * 12 * 2.0 * 64 * 8 * R * 8;
  printf("{\"n\": %d, \"ms\": %.4f, \"tflops\": %.2f, \"error\": \"%s\"}\n", 8 * R, ms,
         flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 384 * sizeof(float));
  run<3>(out, sms);
  run<4>(out, sms);
  return 0;
}
'''


BENCH_CU16 = r'''
#include "norm_convs.cu"
#include <stdio.h>

// two warpgroups (the bf16 kernel's consumers) run its wgmmas: per tap 4
// M-tiles of m64n(8R)k16, A and B from shared memory, one commit group;
// a wait every 25 taps (a stage)
template <int R>
__global__ void __launch_bounds__(256, 1) wgmma_ss(float* out, int iters) {
  extern __shared__ __align__(128) unsigned char tile[];
  for (int i = threadIdx.x; i < kStageBytes16; i += blockDim.x) tile[i] = (i % 7) << 2;
  __syncthreads();
  float acc[4][4 * R];
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < 4 * R; ++i) acc[m][i] = 0.f;
  const int cw = threadIdx.x >> 7;
  const uint32_t base = smem_addr(tile);
  const uint64_t a0 = kmajor_desc(base + 4 * cw * 76 * 16, kBoxBytes, 128);
  const uint64_t b0 = b_desc(base + kXBytes16);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll 1
    for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          MmaSS<R>::run(acc[m], a0 + (dy * 3 + m) * 76 + dx * 3, b0 + (dy * 5 + dx) * R * 16, 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    for (int m = 0; m < 4; ++m) fence_regs(acc[m]);
  }
  float s = 0.f;
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < 4 * R; ++i) s += acc[m][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int R>
void run(float* out, int sms) {
  const int iters = 4000;
  cudaFuncSetAttribute(wgmma_ss<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  wgmma_ss<R><<<sms, 256, kStageBytes16>>>(out, 20);
  cudaEventRecord(e0);
  wgmma_ss<R><<<sms, 256, kStageBytes16>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = (double)sms * 2 * iters * 25 * 4 * 2.0 * 64 * 8 * R * 16;
  printf("{\"n\": %d, \"ms\": %.4f, \"tflops\": %.2f, \"error\": \"%s\"}\n", 8 * R, ms,
         flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 256 * sizeof(float));
  run<3>(out, sms);
  run<4>(out, sms);
  return 0;
}
'''


def patched(patches) -> str:
    text = SOURCE.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"patch anchor not found once in {SOURCE.name}: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def wgmma_waits(lib: Path, function: str) -> dict:
    """HGMMA and WARPGROUP.DEPBAR counts in the SASS of `function`."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body = "".join(part for part in sass.split("Function : ")[1:]
                   if function in part.split("\n", 1)[0])
    return dict(hgmma=body.count("HGMMA"), depbar=body.count("WARPGROUP.DEPBAR"))


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ceiling(tmp: Path, bf16: bool = False) -> list:
    src = tmp / "wgmma_only.cu"
    src.write_text(BENCH_CU16 if bf16 else BENCH_CU)
    exe = tmp / "wgmma_only"
    subprocess.run([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-I", str(_build.CSRC), "-o", str(exe), str(src)], check=True)
    lines = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    rows = [json.loads(line) for line in lines.splitlines()]
    for r in rows:
        if bf16:
            r["share_of_bf16_peak"] = r["tflops"] / 989.0
            print(f"wgmma m64n{r['n']}k16 bf16, A and B from shared memory, K2's order: "
                  f"{r['tflops']:.2f} TFLOP/s, {r['share_of_bf16_peak']:.3f} of 989 "
                  f"({r['error']})", flush=True)
            continue
        r["share_of_tf32_peak"] = r["tflops"] / 495.0
        print(f"wgmma m64n{r['n']}k8 tf32, register A, K2's order: {r['tflops']:.2f} TFLOP/s, "
              f"{r['share_of_tf32_peak']:.3f} of 495 ({r['error']})", flush=True)
    return rows


def ablations(tmp: Path, bf16: bool = False) -> dict:
    libs, procs = {}, []
    for i, (name, patches) in enumerate((ABLATIONS_BF16 if bf16 else ABLATIONS).items()):
        src, lib = tmp / f"nc{i}.cu", tmp / f"nc{i}.so"
        src.write_text(patched(patches))
        procs.append((name, lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    sass_counts = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
        if bf16:
            sass_counts[name] = wgmma_waits(lib, "norm_convs_bf16_kernelILi3E")
    b, c, h, w, n = BENCH_SHAPE
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, c, h, w, generator=g).cuda()
    ks = [(0.1 * torch.randn(n, c, k, k, generator=g)).cuda() for k, _ in nc.BRANCHES]
    if bf16:
        x, ks = x.bfloat16(), [k.bfloat16() for k in ks]
    library_path = _build.library_path

    def use(lib):
        _build.library_path = lambda name: lib
        _build._LOADED.pop("norm_convs", None)
        nc._LIB = None

    times = {name: [] for name in libs}
    try:
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                use(libs[name])
                times[name].append(time_ms(lambda: nc.norm_convs(x, *ks)))
    finally:
        _build.library_path = library_path
        _build._LOADED.pop("norm_convs", None)
        nc._LIB = None
    out = {}
    for name, t in times.items():
        out[name] = dict(in_turns=t, ms=sum(t) / len(t), **sass_counts.get(name, {}))
        print(f"K2{' bf16' if bf16 else ''} {name}: {out[name]['ms']:.4f} ms (in turns {[round(v, 4) for v in t]})"
              + (f", NT=3 SASS {sass_counts[name]}" if bf16 else ""), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 kernel (norm_convs_bf16_kernel) instead of the f32 one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_ceiling: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as d:
        result = dict(card=card, ceiling=ceiling(Path(d), args.bf16),
                      ablations=ablations(Path(d), args.bf16))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
