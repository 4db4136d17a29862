"""What holds K2 (senas_torch/csrc/norm_convs.cu) back from its bound, on one
NVIDIA GPU.

    python3 tools/k2_ceiling.py [--out k2_ceiling.json]

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


def patched(patches) -> str:
    text = SOURCE.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"patch anchor not found once in {SOURCE.name}: {old[:60]!r}")
        text = text.replace(old, new)
    return text


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


def ceiling(tmp: Path) -> list:
    src = tmp / "wgmma_only.cu"
    src.write_text(BENCH_CU)
    exe = tmp / "wgmma_only"
    subprocess.run([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-I", str(_build.CSRC), "-o", str(exe), str(src)], check=True)
    lines = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    rows = [json.loads(line) for line in lines.splitlines()]
    for r in rows:
        r["share_of_tf32_peak"] = r["tflops"] / 495.0
        print(f"wgmma m64n{r['n']}k8 tf32, register A, K2's order: {r['tflops']:.2f} TFLOP/s, "
              f"{r['share_of_tf32_peak']:.3f} of 495 ({r['error']})", flush=True)
    return rows


def ablations(tmp: Path) -> dict:
    libs, procs = {}, []
    for i, (name, patches) in enumerate(ABLATIONS.items()):
        src, lib = tmp / f"nc{i}.cu", tmp / f"nc{i}.so"
        src.write_text(patched(patches))
        procs.append((name, lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    b, c, h, w, n = BENCH_SHAPE
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, c, h, w, generator=g).cuda()
    ks = [(0.1 * torch.randn(n, c, k, k, generator=g)).cuda() for k, _ in nc.BRANCHES]
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
        out[name] = dict(in_turns=t, ms=sum(t) / len(t))
        print(f"K2 {name}: {out[name]['ms']:.4f} ms (in turns {[round(v, 4) for v in t]})",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_ceiling: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as d:
        result = dict(card=card, ceiling=ceiling(Path(d)), ablations=ablations(Path(d)))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
