"""Drive the PyTorch port (senas_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run:
  1. environment: the card's name and power limit (nvidia-smi), versions,
     and which of cv2, PIL, matplotlib and scipy import;
  2. build: the CUDA kernels of senas_torch/csrc (grouped_epilogue.cu and
     norm_convs.cu) with nvcc (sm_90a), one nvcc per source, together;
     the SASS of norm_convs_kernel (cuobjdump) must hold tensor-core
     instructions (HGMMA: wgmma), and that of norm_convs_bf16_kernel bf16
     HGMMA only; ptxas's report of norm_convs_bf16_kernel<1..4> must show
     0 bytes spilled and no wgmma serialized (its registers are logged);
  3. kernels: each of the four epilogue kernels against its plain PyTorch
     version on the same tensors on the card, at the shapes the supernet
     gives it (train- and eval-mode operands), timed; the epilogue's
     autograd gradients against autograd through the plain reference;
     K2 (norm_convs, 3xTF32 on the tensor cores) against its plain version
     at bench.py's shape (B 64, 128x128, C 32, N 24) and at an edge-tile
     shape, timed beside its plain version and the library convolutions
     with TF32 off and on; the library with TF32 on (the control) must
     fail K2's limit, which the kernel meets;
  4. the norm_convs path: one call of `norm_convs` at bench.py's shape on
     f32 operands and one on bf16 operands, as a user (and bench.py) calls
     it, with each dtype's launch counted: no model path of either package
     calls K2;
  5. the eval path: the supernet's inference path at the
     configs/senas/senas_promise12.yml `searching:` geometry (batch 8 of
     256x256x1, init_channels 32, depth 5, meta_node_num 3, f32): one
     train-mode forward (running stats move), then the search-eval step on
     3 batches, with the kernels' launch counts checked; the card's logits
     held to the plain CPU path on the first 2 images; one eval step under
     torch.profiler, the eval step with the kernels against the plain
     epilogue in turns;
  6. the search path at the same geometry (batch 8 train + 8 val, the
     yml's SGD and Adam): one bilevel step with do_arch=False, then 3 with
     do_arch=True, with launch counts checked per step; one step under
     torch.profiler; the same step from one saved state with the kernels
     (twice: the card's own spread), with the kernels' plain twins and with
     the plain epilogue, compared leaf by leaf, and timed in turns;
  7. a search training step on the card held to the same step on the CPU,
     at a reduced size (depth 3, c 8, 64x64, batch 2) from identical state,
     with TF32 off; the same step with TF32 on must fail the same limits;
  8. the search runner: `python -m senas_torch.search_arc` on
     configs/senas/senas_synthetic.yml for its 3 epochs, then resumed from
     its checkpoint for one more;
  9. the fixed path: SenasModel(senas) at the senas_promise12.yml
     `training:` geometry (batch 12 of 256x256x1, init_channels 32, depth
     5, SGD 6e-3/0.9/5e-4, clip 5, dice_ce): 1 + 3 train steps, one under
     torch.profiler, the eval step on 3 batches with its uint8 `pred`, the
     card's logits held to the CPU path on 2 images;
 10. a fixed training step on the card held to the same step on the CPU
     (depth 3, c 8, 64x64, batch 2), TF32 off; with TF32 on it must fail;
 11. the fixed CLIs: `python -m senas_torch.train_model` on
     senas_synthetic.yml, then `python -m senas_torch.testing_model` on its
     best checkpoint;
 12. serving: phase 9's trained model saved with CheckpointManager and
     exported by `python -m senas_torch.export_model --check --f32` on the
     card; the artifact's Predictor answers batches of 1, 3 and 12 with the
     eager model's logits (1e-4) and their argmax as uint8 masks (the
     compared calls with cuDNN's deterministic algorithms, which must give
     the same bits call after call; the call-to-call spread with its
     default ones is logged), timed per request at batch 1 and 12; the same artifact on the CPU within
     phase 9's card-vs-CPU limit; two replicas on the card at batch 5 (the
     pad path); the TF32 control (a backend-default artifact with TF32 on
     strays from the CPU, the --f32 one does not);
 13. the PROMISE12 submission path: three cases at 320-pixel native
     resolution written with the port's write_mhd, their slices predicted
     at 256x256 through the Predictor, `predict_test` and
     `volumetric_metrics`, and the same through
     `TestRunner.run_promise12_submission` on the card; the written
     volumes keep their sources' shape, origin, spacing and direction;
 14. the PROMISE12 data path: a phantom in PROMISE12's layout (10 training
     cases of 10-16 slices at 320x320, 2 test cases) written with
     write_mhd; the cache built through get_dataset("promise12"), timed as
     CLAHE, resize and the native curvature flow (which must run, and
     agree exactly with its numpy twin); the augmented loader timed at
     batch 8 and 12, serial and pooled; then the CLIs in this process on
     configs/senas/senas_promise12.yml with --data_root the phantom:
     search_arc for 1 epoch at full width (K1a-K1d launches held to the
     count the epoch's steps and eval batches need; ms/step and the
     loop's wait on the loader), train_model for 1 epoch, testing_model on
     its best checkpoint, the submission from the test split through
     `TestRunner.run_promise12_submission` (each volume with its source's
     geometry), and `best_worst_contour_grid` where matplotlib imports;
 15. the other shipped configs' data paths, on phantoms written here (no
     Pillow) in each dataset's layout: CHAOS CT (4 cases of 24 DICOM slices
     at 512x512 with RescaleSlope/Intercept, Ground/liver_GT_*.png), CHAOS
     MR (T1DUAL and T2SPIR at 256x256), MSD Task02_Heart (3 volumes of
     320x320x16 as .nii.gz, extracted once by the port's extract_task) and
     MoNuSAC (RGB tiles); the port's DICOM, NIfTI and PNG readers held to
     the written arrays; decode ms per slice, ms per augmented batch
     (serial and pooled) and the extraction's seconds; search_arc on
     configs/senas/senas_chaos.yml for 1 epoch at full width (K1a-K1d
     launches held to the count; ms/step and the loop's waits),
     train_model on configs/senas/senas_heart.yml for 1 epoch (batch 12 of
     256x320) and testing_model on its best checkpoint; a monusac and a
     chaos_mr batch through get_dataset;
 16. the baseline zoo: the factory's nine models (nasunet, unet,
     unet_plus_plus, manet, linknet, fpn, pspnet at depth 3, pan,
     deeplab_v3_plus) at the senas_promise12.yml `training:` geometry, each
     1 + 3 train steps and the eval step on 3 batches (ms/step, peak memory,
     the logits' shape, finite losses, every weight moved), a unet, an fpn
     and a deeplab_v3_plus step under torch.profiler; each model's train step on
     the card against the CPU (batch 2, depth 3-5, 64x64 or PAN's 128x128)
     in f32 (TF32 off) and in f64, one CPU generator giving both devices the
     same dropout mask; `train_model` and `testing_model` with --model unet
     and --model nasunet on senas_synthetic.yml; the trained unet exported by
     `export_model --model unet --check --f32` and served at batch 1 and 12;
     the six smp_* losses on full-size logits, card against CPU.
 17. bf16 (`precision: bf16`): the bf16 variants of K1a-K1d against their
     plain twins on bf16 tensors at the supernet's group shapes (train and
     eval operands; f32 sums within 1e-5, bf16 outputs equal but on <= 1e-3
     of the elements, each within one bf16 ulp or the f32 cancellation of
     its terms), timed beside the f32 variants and the bf16 byte bound, and
     the epilogue's bf16 gradients; the supernet in bf16 at phase 6's
     geometry, 1 + 3 search steps (the bf16 variants' launches held to the
     count, the f32 ones' to 0) and the search-eval step on 3 batches, each
     with one step under torch.profiler and the peak memory; the fixed
     model in bf16 at phase 9's geometry, 1 + 3 train steps (one profiled)
     and the eval step on 3 batches; a search and a fixed step in bf16 on
     the card against the CPU at phases 7 and 10's size (held as the CPU
     tests hold the port to the JAX package: at most twice the CPU's own
     bf16-vs-f32 distance) with the control that the card's bf16 step
     fails phase 7's f32 limits against its f32 step; senas_synthetic.yml
     with `precision: bf16` through search_arc and train_model (1 epoch)
     and testing_model (f32) on the bf16 run's best checkpoint.
 18. the zoo in bf16 and K2 in bf16: K2's bf16 kernel (one bf16 wgmma per
     product, f32 sums, one rounding) against its twin (the f32
     convolutions of the bf16 values, rounded once) at bench.py's shape and
     the edge shape (equal but on <= 1e-3 of the outputs, each within one
     bf16 ulp or 2^-21 of its sum of |products|), timed beside the f32
     kernel, its bf16 bound and cuDNN's three bf16 convolutions; the nine
     zoo models with `dtype=torch.bfloat16` at phase 16's geometry (1 + 3
     train steps, the eval step on 3 batches, ms/step, peak memory, the
     logits' dtype: fpn and pan f32, the rest bf16; a unet, an fpn and a
     deeplab_v3_plus step under torch.profiler), beside phase 16's f32
     numbers; each model's bf16 train step on the card against the CPU at
     phase 16's reduced sizes (PAN at batch 4), at most twice the CPU's own
     bf16-vs-f32 distance, with the control that the card's bf16 step
     leaves phase 16's f32 limits of its f32 step; `train_model --model
     unet` and `--model fpn` on senas_synthetic.yml with `precision: bf16`,
     then `testing_model --model unet` (f32) on the bf16 checkpoint; the six
     smp_* losses on full-size bf16 logits, card against CPU.
 19. the config keys and SENAS_PALLAS_BN (the environment variable set and
     restored inside the phase): BatchNorm with the gate on (K1a-K1d at
     n=1) against the same path on the kernels' plain twins and against
     the gate off, at every BatchNorm shape of the fixed model and at
     [2,64,1,1], [2,64,3,3], [2,64,6,6], [2,512,8,8] and [12,32,256,256],
     train and eval, f32 and bf16, forward, backward and running stats;
     K1a-K1d at n=1 on [12,32,256,256] timed beside their twins, their byte
     bounds and F.batch_norm's forward and backward, with the launches of
     one BatchNorm forward and backward each way; the promise12-fixed-train
     step, the fixed step in bf16 and the zoo's unet step in bf16 with the
     gate on and off in turns (each gated step's K1 launches held to its
     BatchNorm calls), one step each way under torch.profiler; one fixed
     step card against CPU at phase 10's size with the gate on and with
     each of adamax, adadelta, adagrad, rmsprop, asgd and adabound, within
     phase 7's limits; remat at full width (the search step with do_arch
     and the fixed step, off and on: ms/step, peak memory, the recompute's
     launches) and at phase 7's size under cuDNN's deterministic algorithms
     (the same metrics and state on and off); senas_synthetic.yml through
     search_arc (beta_mode grouped, multi_gpus, mesh_spatial 2, adabound)
     and train_model (remat, rmsprop) for one epoch each.
Phases 12-13, 16 and 18's zoo launch none of the kernels (neither the
fixed model nor the zoo has any, unless SENAS_PALLAS_BN=1).
Every kernel variant must be launched on at least one path (phases 4-6, 9,
14, 15, 17, 19; K2's bf16 variant in phase 4). The line before the last is a
JSON list of the kernels, the bf16 variants as `<name>_bf16`; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import copy
import gzip
import importlib
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from senas_torch import export_model, search_arc, testing_model, train_model
from senas_torch.challenge import predict_test, volumetric_metrics
from senas_torch.challenge.promise12 import best_worst_contour_grid
from senas_torch.core.config import load_config
from senas_torch.core.genotype import parse_genotype
from senas_torch.data import DataLoader, augment, get_dataset, imgproc, native, promise12
from senas_torch.data.dicom import read_dicom_pixels
from senas_torch.data.imfile import float_to_l, read_image, write_png_l
from senas_torch.data.io import MetaImage, read_mhd, read_nifti, write_mhd
from senas_torch.data.msd import extract_task
from senas_torch.utils.logging import write_png
from senas_torch.models import geno_searched
from senas_torch.models.factory import get_segmentation_model
from senas_torch.models.senas_model import SenasModel
from senas_torch.ops import _build
from senas_torch.ops import grouped_epilogue as ge
from senas_torch.ops import norm_convs as nc
from senas_torch.ops.primitives import BatchNorm
from senas_torch.runner.test import TestRunner
from senas_torch.search.fused_cell import GroupedMixedOp
from senas_torch.search.supernet import (SenasSearch, derive_genotype,
                                         init_arch_params, normalize_arch)
from senas_torch.serve import Predictor, export_predict_fn, save_artifact
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.loss import build_loss
from senas_torch.train.optim import build_optimizer
from senas_torch.train.trainer import (FixedTrainState, SearchTrainState,
                                       make_eval_step, make_search_eval_step,
                                       make_search_step, make_train_step)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_promise12.yml")
RUNNER_CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
IN_CHANNELS, NCLASS, HW = 1, 2, 256     # promise12: 1-channel MR slices, 2 classes
N_BATCHES = 3
DO_ARCH = (False, True, True, True)     # the search path's steps
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores, 495
# TFLOP/s TF32 on them, dense (data sheet, at a 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# Group geometry of the flagship supernet: E=3 edges x c_part=8 channels,
# and the sides of its largest and a middle-sized group output.
GROUP_C = 24
KERNEL_HW = (256, 64)
LIBRARY_NOTE = "no one PyTorch call reduces or writes over n separate tensors"
EPILOGUE_SOURCE = "senas_torch/csrc/grouped_epilogue.cu"
EPILOGUE_REPLACES = {
    "branch_stats": "senas_tpu/ops/grouped_epilogue.py:114 (_branch_stats -> _stats_kernel :86)",
    "apply_mix": "senas_tpu/ops/grouped_epilogue.py:157 (_apply_mix -> _apply_kernel :143)",
    "bwd_reduce": "senas_tpu/ops/grouped_epilogue.py:206 (_bwd_reduce -> _bwd_reduce_kernel :189)",
    "bwd_dx": "senas_tpu/ops/grouped_epilogue.py:251 (_bwd_dx -> _bwd_dx_kernel :237)",
}
# Each kernel variant: its wrapper, and the dtype whose launches it counts
# (`launches_by_dtype`); the bf16 variants of K1a-K1d are `<name>_bf16`.
BF16_SUFFIX = "_bf16"
KERNELS = {
    **{name: dict(wrapper=getattr(ge, name), dtype="float32", source=EPILOGUE_SOURCE,
                  replaces=replaces) for name, replaces in EPILOGUE_REPLACES.items()},
    "norm_convs": dict(
        wrapper=nc.norm_convs, dtype="float32", source="senas_torch/csrc/norm_convs.cu",
        replaces="senas_tpu/ops/pallas_kernels.py:65 (fused_norm_convs -> "
                 "_norm_convs_kernel :37)"),
    **{name + BF16_SUFFIX: dict(wrapper=getattr(ge, name), dtype="bfloat16",
                                source=EPILOGUE_SOURCE, replaces=replaces)
       for name, replaces in EPILOGUE_REPLACES.items()},
    "norm_convs" + BF16_SUFFIX: dict(
        wrapper=nc.norm_convs, dtype="bfloat16", source="senas_torch/csrc/norm_convs.cu",
        replaces="senas_tpu/ops/pallas_kernels.py:65 (fused_norm_convs -> "
                 "_norm_convs_kernel :37), bf16 operands"),
}
SOURCES = ("grouped_epilogue", "norm_convs")


def log(msg: str):
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A failed check ends the run (and survives `python -O`, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts():
    for k in KERNELS.values():
        wrapper = k["wrapper"]
        wrapper.launches = 0
        for dtype in getattr(wrapper, "launches_by_dtype", {}):
            wrapper.launches_by_dtype[dtype] = 0


def counts():
    """Launches per kernel variant, each read from its wrapper's count of
    the variant's dtype."""
    out = {}
    for name, k in KERNELS.items():
        by_dtype = getattr(k["wrapper"], "launches_by_dtype", None)
        out[name] = by_dtype[k["dtype"]] if by_dtype is not None else k["wrapper"].launches
    return out


def add_counts(total: dict, got: dict) -> None:
    for k in total:
        total[k] += got[k]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# ---------------------------------------------------------------------------
# Phase 1-2: environment and build
# ---------------------------------------------------------------------------

def environment() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"python {sys.version.split()[0]}")
    return smi


def build() -> str:
    """Build every source; print ptxas's registers and spills. Returns the
    tensor-core instruction that norm_convs_kernel's SASS holds; that of
    norm_convs_bf16_kernel must be bf16 HGMMA."""
    t0 = time.perf_counter()
    seconds = _build.build(SOURCES)
    log(f"build: {seconds} (wall {time.perf_counter() - t0:.2f} s)")
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "error", "warning", "Function")):
                log(f"  ptxas {name}: {line.strip()}")
    bf16 = tensor_core_sass("norm_convs", "norm_convs_bf16_kernel", operands="BF16")
    check(bf16 == "HGMMA", f"norm_convs_bf16_kernel holds {bf16}, not HGMMA")
    ptxas_report("norm_convs", "norm_convs_bf16_kernel", 4)
    return tensor_core_sass("norm_convs", "norm_convs_kernel")


def ptxas_report(source: str, kernel: str, instances: int) -> dict:
    """Registers and spilled bytes of each instantiation of `kernel` (the
    mangled names of kernel<1..instances>) in ptxas's -v log of `source`.
    Fails unless every one is there, spills 0 bytes and has no wgmma
    serialized (ptxas's "Potential Performance Loss" notes)."""
    found, name = {}, None
    for line in _build.build_log(source).splitlines():
        entry = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?(?: for|$)",
                          line)
        if entry:
            name = entry.group(1)
            continue
        if name is None or kernel not in name:
            continue
        row = found.setdefault(name, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            row["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            row["registers"] = int(used.group(1))
    serialized = [line.strip() for line in _build.build_log(source).splitlines()
                  if "serialized" in line and kernel in line]
    by_nt = {re.search(r"ILi(\d+)E", n).group(1): r for n, r in found.items()}
    log(f"  ptxas {kernel}<NT>: {by_nt}")
    check(sorted(by_nt) == [str(i) for i in range(1, instances + 1)]
          and all("spill_bytes" in r and "registers" in r for r in by_nt.values()),
          f"ptxas's log lacks {kernel}<1..{instances}>: {by_nt}")
    check(all(r["spill_bytes"] == 0 for r in by_nt.values()), f"{kernel} spills: {by_nt}")
    check(not serialized, f"ptxas serialized {kernel}'s wgmmas: {serialized[:2]}")
    return by_nt


def tensor_core_sass(source: str, kernel: str, operands: str = "") -> str:
    """cuobjdump --dump-sass of the built library: the tensor-core
    instructions of each function whose name holds `kernel`. Fails unless
    every such function holds HGMMA (wgmma) or HMMA (mma.sync), and, with
    `operands` (e.g. "BF16"), unless every one of them names that type."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        if kernel in name:
            lines = [ln for ln in body.splitlines() if "HGMMA" in ln or "HMMA" in ln]
            found[name.strip()] = {op: body.count(op) for op in ("HGMMA", "HMMA")}
            if operands:
                found[name.strip()][operands] = sum(f".{operands}" in ln for ln in lines)
                check(found[name.strip()][operands] == len(lines),
                      f"{kernel}: tensor-core instructions without {operands}: {lines[:3]}")
    log(f"  SASS of {kernel}: {found}")
    check(bool(found), f"no function {kernel} in the SASS of {source}")
    kinds = {"HGMMA" if c["HGMMA"] else ("HMMA" if c["HMMA"] else None) for c in found.values()}
    check(None not in kinds, f"{kernel} holds no tensor-core instruction: {found}")
    return "HGMMA" if kinds == {"HGMMA"} else "HMMA"


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version on the card (K1a-K1d)
# ---------------------------------------------------------------------------

_DIFF = ("se_w1", "se_w2", "none_alpha_col", "none_bias")


def _group_inputs(dev, n, h, seed, train, se, none):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    E, P, C = 3, 8, GROUP_C
    xs = [r(8, C, h, h) * (1 + 0.5 * o) + 0.1 * o for o in range(n)]
    kw = dict(train=train)
    if not train:
        kw.update(run_means=[0.1 * r(C) for _ in range(n)],
                  run_vars=[r(C).abs() + 0.5 for _ in range(n)])
    if se:
        kw.update(se_index=1, se_w1=0.5 * r(E, P, 1), se_w2=0.5 * r(E, 1, P), E=E, P=P)
    if none:
        kw.update(none_alpha_col=r(C).abs() / n, none_bias=0.1 * r(C))
    args = (xs, [1 + 0.1 * r(C) for _ in range(n)], [0.1 * r(C) for _ in range(n)],
            [r(C).abs() / n for _ in range(n)])
    return args, kw


def _epilogue_grad_err(args, kw, readout, ref_dtype=None) -> float:
    """The autograd Function's gradients for every differentiable input
    against torch autograd through the plain two-pass reference, on the
    same tensors: the worst max|got - want| / max|want| over the inputs.
    `ref_dtype` is the reference's output dtype (None: the branches')."""
    leaves = [t.detach().clone().requires_grad_() for part in args for t in part]
    n = len(args[0])
    split = [leaves[i * n:(i + 1) * n] for i in range(4)]
    extra = {k: kw[k].detach().clone().requires_grad_() for k in _DIFF if k in kw}
    rest = {k: v for k, v in kw.items() if k not in _DIFF}
    inputs = leaves + list(extra.values())
    got = torch.autograd.grad(
        (ge.fused_group_epilogue(*split, **rest, **extra)[0] * readout).sum(), inputs)
    want = torch.autograd.grad(
        (ge.group_epilogue_reference(*split, **rest, **extra, out_dtype=ref_dtype)
         * readout).sum(), inputs)
    return max(rel_err(a.float(), b.float()) for a, b in zip(got, want))


def check_kernels(dev) -> dict:
    """Returns per-kernel records: the worst errors over every case, times at
    each shape in `timed`, and those of the heaviest main-path shape
    ([8,24,256,256], n=6) as `ms`, `plain_ms`, `bound_ms`."""
    names = [name for name, _ in _TIMED]
    records = {name: {} for name in names}
    worst = {name: 0.0 for name in names}
    worst.update(stats_rel=0.0, reduce_rel=0.0, epilogue=0.0, grad_rel=0.0)
    for h in KERNEL_HW:
        for n, se, none in ((6, True, False), (5, False, True)):
            b, planes = 8, 8 * GROUP_C
            for train in (True, False):
                args, kw = _group_inputs(dev, n, h, seed=h + n, train=train, se=se, none=none)
                xs = args[0]
                # K1a: sums within 1e-5 of the plane's sum of |x| (resp. x^2):
                # the kernel sums in another order than torch.sum.
                s1, s2 = ge.branch_stats(xs)
                p1, p2 = ge.branch_stats_plain(xs)
                abs1 = torch.stack([x.abs().sum(dim=(2, 3)) for x in xs])
                rel = max(((s1 - p1).abs() / abs1).max().item(),
                          ((s2 - p2).abs() / p2).max().item())
                err1 = max((s1 - p1).abs().max().item(), (s2 - p2).abs().max().item())
                check(rel <= 1e-5, f"branch_stats disagrees: rel {rel:.3g} (h={h} n={n})")
                # K1b: outputs within atol 1e-4 (values of scale ~1-10).
                a = torch.randn(n, b, GROUP_C, device=dev)
                k = torch.randn(b, GROUP_C, device=dev)
                err2 = (ge.apply_mix(xs, a, k) - ge.apply_mix_plain(xs, a, k)).abs().max().item()
                check(err2 <= 1e-4, f"apply_mix disagrees: {err2:.3g} (h={h} n={n})")
                # the whole epilogue against the port's two-pass reference
                got, _ = ge.fused_group_epilogue(*args, **kw)
                want = ge.group_epilogue_reference(*args, **kw)
                err3 = (got - want).abs().max().item()
                check(err3 <= 1e-4, f"fused_group_epilogue disagrees: {err3:.3g}")
                # K1c on a cotangent g: sums within 1e-5 of the plane's
                # sum of |g*x| (resp. |g|).
                g = torch.randn(b, GROUP_C, h, h, device=dev)
                da, dk = ge.bwd_reduce(xs, g)
                pa, pk = ge.bwd_reduce_plain(xs, g)
                abs_a = torch.stack([(g * x).abs().sum(dim=(2, 3)) for x in xs])
                rel_c = max(((da - pa).abs() / abs_a).max().item(),
                            ((dk - pk).abs() / g.abs().sum(dim=(2, 3))).max().item())
                err4 = max((da - pa).abs().max().item(), (dk - pk).abs().max().item())
                check(rel_c <= 1e-5, f"bwd_reduce disagrees: rel {rel_c:.3g} (h={h} n={n})")
                # K1d with the per-plane terms of this mode: in eval mode ds2
                # is 0 and ds1 lives on the SE branch only.
                ds1 = torch.randn(n, b, GROUP_C, device=dev)
                ds2 = torch.randn(n, b, GROUP_C, device=dev)
                if not train:
                    ds2.zero_()
                    ds1 = ds1 * torch.tensor([float(o == kw.get("se_index")) for o in range(n)],
                                             device=dev)[:, None, None]
                err5 = max((o1 - o2).abs().max().item() for o1, o2 in zip(
                    ge.bwd_dx(xs, g, a, ds1, ds2), ge.bwd_dx_plain(xs, g, a, ds1, ds2)))
                check(err5 <= 1e-4, f"bwd_dx disagrees: {err5:.3g} (h={h} n={n})")
                # the Function's gradients against autograd through the reference
                err6 = _epilogue_grad_err(args, kw, g)
                check(err6 <= 1e-4, f"epilogue gradients disagree: rel {err6:.3g}")
                torch.cuda.synchronize()
                for key, v in (("stats_rel", rel), ("branch_stats", err1), ("apply_mix", err2),
                               ("epilogue", err3), ("reduce_rel", rel_c), ("bwd_reduce", err4),
                               ("bwd_dx", err5), ("grad_rel", err6)):
                    worst[key] = max(worst[key], v)
                log(f"  h={h:3d} n={n} train={train!s:5} se={se!s:5} none={none!s:5}: "
                    f"stats abs {err1:.3g} rel {rel:.3g} | mix {err2:.3g} | epilogue {err3:.3g}"
                    f" | bwd_reduce abs {err4:.3g} rel {rel_c:.3g} | bwd_dx {err5:.3g}"
                    f" | grads rel {err6:.3g}")

            # times at this shape (n branches, train mode)
            args, kw = _group_inputs(dev, n, h, seed=1, train=True, se=se, none=none)
            xs = args[0]
            a = torch.rand(n, b, GROUP_C, device=dev)
            k = torch.rand(b, GROUP_C, device=dev)
            g = torch.randn(b, GROUP_C, h, h, device=dev)
            ds1, ds2 = torch.randn(n, b, GROUP_C, device=dev), torch.randn(n, b, GROUP_C, device=dev)
            elems = n * planes * h * h
            plane_bytes = planes * h * h * 4          # one [8,24,h,h] f32 tensor
            nbytes = dict(
                stats=n * plane_bytes + 2 * n * planes * 4,
                mix=n * plane_bytes + (n + 1) * planes * 4 + plane_bytes,
                reduce=(n + 1) * plane_bytes + (n + 1) * planes * 4,
                dx=(2 * n + 1) * plane_bytes + 3 * n * planes * 4)
            flops = dict(stats=3 * elems, mix=2 * elems, reduce=2 * elems + elems // n,
                         dx=4 * elems)
            t = dict(
                stats=time_ms(lambda: ge.branch_stats(xs)),
                stats_plain=time_ms(lambda: ge.branch_stats_plain(xs)),
                mix=time_ms(lambda: ge.apply_mix(xs, a, k)),
                mix_plain=time_ms(lambda: ge.apply_mix_plain(xs, a, k)),
                reduce=time_ms(lambda: ge.bwd_reduce(xs, g)),
                reduce_plain=time_ms(lambda: ge.bwd_reduce_plain(xs, g)),
                dx=time_ms(lambda: ge.bwd_dx(xs, g, a, ds1, ds2)),
                dx_plain=time_ms(lambda: ge.bwd_dx_plain(xs, g, a, ds1, ds2)),
                epi=time_ms(lambda: ge.fused_group_epilogue(*args, **kw)),
                epi_plain=time_ms(lambda: ge.group_epilogue_reference(*args, **kw)),
            )
            bound = {key: max(nbytes[key] / PEAK_BYTES_PER_S, flops[key] / PEAK_F32_FLOPS) * 1e3
                     for key in nbytes}
            log(f"  times [8,{GROUP_C},{h},{h}] n={n} (ms / plain / bound): "
                + " | ".join(f"{name} {t[key]:.4f} / {t[key + '_plain']:.4f} / {bound[key]:.4f}"
                             for name, key in _TIMED)
                + f" | fused_group_epilogue {t['epi']:.4f} (plain reference {t['epi_plain']:.4f})")
            for name, key in _TIMED:
                rec = dict(shape=[8, GROUP_C, h, h], n=n, ms=t[key], plain_ms=t[f"{key}_plain"],
                           bound_ms=bound[key])
                records[name].setdefault("timed", []).append(rec)
                if (h, n) == (KERNEL_HW[0], 6):
                    records[name].update(ms=rec["ms"], plain_ms=rec["plain_ms"],
                                         bound_ms=rec["bound_ms"])
    for name in names:
        records[name]["max_abs_err"] = worst[name]
    records["branch_stats"]["max_rel_err"] = worst["stats_rel"]
    records["bwd_reduce"]["max_rel_err"] = worst["reduce_rel"]
    log(f"kernels agree with their plain versions (worst: {worst})")
    return records


_TIMED = (("branch_stats", "stats"), ("apply_mix", "mix"), ("bwd_reduce", "reduce"),
          ("bwd_dx", "dx"))


# K2 shapes (B, C, H, W, N): bench.py's (bench_pallas_norm_convs), edge
# tiles in both directions (100 = 12*8 + 4 rows, 70 = 2*32 + 6 columns), and
# C 20 (a 16-channel chunk whose second K half is partial) with N 32 (one
# slice at NT 4, the widest wgmma) at W 70 (not a multiple of 8).
K2_SHAPES = {"bench": (64, 32, 128, 128, 24), "edge": (5, 32, 100, 70, 24),
             "nt4": (2, 20, 30, 70, 32)}
# K2 against its plain version: within this share of each output's sum of
# |products| (the same convolutions of |x| and |w|): both sum the 59*C
# products in f32, in other orders, the kernel each product as three TF32
# ones (3xTF32, ~2^-21 of it). One TF32 product (~2^-11) fails it.
K2_REL_TOL = 1e-5


def _norm_inputs(dev, b, c, h, w, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g).to(dev)
    ks = [(0.1 * torch.randn(n, c, k, k, generator=g)).to(dev) for k in (3, 5, 5)]
    return x, ks


def _library_norm_convs(x, ks):
    """The library's yardstick: the three cuDNN convolutions and the cat."""
    return torch.cat([F.conv2d(x, w, padding=(k // 2) * d, dilation=d)
                      for (k, d), w in zip(nc.BRANCHES, ks)], dim=1)


def _embedded_13x13(ks):
    """The three kernels placed in one [3N,C,13,13] kernel (dilation 1,
    padding 6): one F.conv2d call computes the same function, with 3N*169
    taps per input channel where the three branches need N*59 (8.6x)."""
    n, c = ks[0].shape[:2]
    big = ks[0].new_zeros(3 * n, c, 13, 13)
    for i, ((k, d), w) in enumerate(zip(nc.BRANCHES, ks)):
        off = 6 - (k // 2) * d
        big[i * n:(i + 1) * n, :, off:off + (k - 1) * d + 1:d, off:off + (k - 1) * d + 1:d] = w
    return big


@contextlib.contextmanager
def tf32_convolutions():
    """cuDNN's convolutions in TF32 within it (off again after)."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def check_norm_convs(dev, seed: int) -> dict:
    """K2 against its plain version (and both against an f64 reference) at
    each of K2_SHAPES; at bench.py's shape, the TF32 control (the library
    convolutions with TF32 on must fail K2_REL_TOL), times of the kernel,
    its plain version and the library calls in turns, and its bounds: the
    3xTF32 one on the tensor cores, the f32 one on the CUDA cores, bytes."""
    rec = {"timed": []}
    worst_rel = worst_abs = 0.0
    for label, (b, c, h, w, n) in K2_SHAPES.items():
        x, ks = _norm_inputs(dev, b, c, h, w, n, seed)
        got = nc.norm_convs(x, *ks)
        want = nc.norm_convs_plain(x, *ks)
        abs_sum = nc.norm_convs_plain(x.abs(), *[k.abs() for k in ks]).clamp_min(1e-30)
        exact = nc.norm_convs_plain(x.double(), *[k.double() for k in ks])
        torch.cuda.synchronize()
        rel = ((got - want).abs() / abs_sum).max().item()
        err = (got - want).abs().max().item()
        rel_exact = ((got.double() - exact).abs() / abs_sum).max().item()
        plain_exact = ((want.double() - exact).abs() / abs_sum).max().item()
        del exact
        log(f"  norm_convs {label} [{b},{c},{h},{w}] N={n}: max abs err {err:.3g}, "
            f"rel (of the sum of |products|) {rel:.3g}; against f64: kernel {rel_exact:.3g}, "
            f"plain {plain_exact:.3g}")
        check(rel <= K2_REL_TOL, f"norm_convs disagrees with its plain version at {label}: "
              f"rel {rel:.3g} > {K2_REL_TOL}")
        check(tuple(got.shape) == (b, 3 * n, h, w), f"norm_convs gave {tuple(got.shape)}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        if label != "bench":
            continue
        big = _embedded_13x13(ks)
        single = lambda: F.conv2d(x, big, padding=6)
        single_rel = ((single() - want).abs() / abs_sum).max().item()
        # a library call, not a kernel of the port: cuDNN may take an FFT or
        # Winograd algorithm for 13x13, so it is held to a looser 1e-4
        check(single_rel <= 1e-4, f"the 13x13 embedding disagrees: {single_rel:.3g}")
        # the TF32 control: the same library convolutions in TF32 must fail
        # the limit that the kernel's 3xTF32 meets
        with tf32_convolutions():
            tf32_rel = ((_library_norm_convs(x, ks) - want).abs() / abs_sum).max().item()
        log(f"  TF32 control: the library convolutions with TF32 on are {tf32_rel:.3g} of "
            f"the sum of |products| off the plain version (limit {K2_REL_TOL})")
        check(tf32_rel > K2_REL_TOL, f"K2's limit let the TF32 library pass: {tf32_rel:.3g}")
        del got, want, abs_sum
        t = {"kernel": [], "plain": [], "library": [], "library_tf32": [], "single": []}
        calls = dict(kernel=lambda: nc.norm_convs(x, *ks),
                     plain=lambda: nc.norm_convs_plain(x, *ks),
                     library=lambda: _library_norm_convs(x, ks),
                     library_tf32=lambda: _library_norm_convs(x, ks), single=single)
        turns = ("kernel", "plain", "library", "library_tf32", "single",
                 "single", "library_tf32", "library", "plain", "kernel")
        for which in turns:
            with tf32_convolutions() if which == "library_tf32" else contextlib.nullcontext():
                t[which].append(time_ms(calls[which]))
        ms = {k: float(np.mean(v)) for k, v in t.items()}
        flops = nc.flops(x.shape, n)
        tf32_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
        f32_ms = flops / PEAK_F32_FLOPS * 1e3
        byte_ms = nc.nbytes(x.shape, n) / PEAK_BYTES_PER_S * 1e3
        log(f"  norm_convs times at bench.py's shape (ms, in turns {','.join(turns)}): {t}; "
            f"bounds: 3xTF32 operations {tf32_ms:.4f} (3 x {flops / 1e9:.2f} GFLOP at "
            f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), f32 operations {f32_ms:.4f} (at "
            f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), bytes {byte_ms:.4f} "
            f"({nc.nbytes(x.shape, n) / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s); "
            f"kernel at {flops / ms['kernel'] / 1e9:.2f} TFLOP/s of f32-equivalent work "
            f"({3 * flops / ms['kernel'] / 1e9:.2f} TFLOP/s TF32), "
            f"{max(tf32_ms, byte_ms) / ms['kernel']:.3f} of its bound")
        rec.update(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   library_tf32_ms=ms["library_tf32"], library_single_call_ms=ms["single"],
                   bound_ms=max(tf32_ms, byte_ms), f32_bound_ms=f32_ms, bytes_bound_ms=byte_ms,
                   tf32_control_rel=tf32_rel, tflops_f32_equivalent=flops / ms["kernel"] / 1e9,
                   shape=[b, c, h, w], n=n)
        rec["timed"].append(dict(shape=[b, c, h, w], n=n, bound_ms=rec["bound_ms"],
                                 **{f"{k}_in_turns": v for k, v in t.items()}))
    rec.update(max_abs_err=worst_abs, max_rel_err=worst_rel)
    return rec


def run_norm_convs_path(dev, seed: int) -> dict:
    """One call of norm_convs at bench.py's shape on f32 operands and one on
    bf16 operands, as a user calls it; the launches read from the counters
    (each dtype its own kernel)."""
    b, c, h, w, n = K2_SHAPES["bench"]
    x, ks = _norm_inputs(dev, b, c, h, w, n, seed + 4)
    xb, kb = x.to(BF16), [k.to(BF16) for k in ks]
    reset_counts()
    out = nc.norm_convs(x, *ks)
    out_bf16 = nc.norm_convs(xb, *kb)
    torch.cuda.synchronize()
    got = counts()
    want = {**{name: 0 for name in KERNELS}, "norm_convs": 1, "norm_convs" + BF16_SUFFIX: 1}
    check(got == want, f"the norm_convs calls launched {got}, expected {want}")
    for o, dt in ((out, torch.float32), (out_bf16, BF16)):
        check(tuple(o.shape) == (b, 3 * n, h, w) and o.dtype == dt
              and bool(torch.isfinite(o).all()),
              f"norm_convs gave non-finite values or a wrong shape or dtype ({o.dtype})")
    log(f"norm_convs call [{b},{c},{h},{w}] N={n}: launches {got}")
    return dict(launches=got)


# ---------------------------------------------------------------------------
# Profiles and the plain epilogue swapped in
# ---------------------------------------------------------------------------

_KERNEL_CLASSES = (
    ("branch_stats (K1a)", ("branch_stats_kernel",)),
    ("apply_mix (K1b)", ("apply_mix_kernel",)),
    ("bwd_reduce (K1c)", ("bwd_reduce_partial_kernel", "bwd_reduce_finish_kernel")),
    ("bwd_dx (K1d)", ("bwd_dx_kernel",)),
    ("norm_convs (K2)", ("norm_convs_kernel",)),
    ("norm_convs bf16 (K2)", ("norm_convs_bf16_kernel",)),
    ("matmul", ("xmma_gemm", "sgemm", "gemv")),
    # before "convolution": cuDNN's BN kernels carry "cudnn" in their names
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("convolution", ("conv", "cudnn", "implicit", "gemm", "xmma", "sm90", "fprop",
                     "dgrad", "wgrad", "depthwise", "winograd", "cutlass")),
    ("pool / upsample", ("pool", "upsample", "interp")),
    ("copy / cat", ("copy", "memcpy", "memset", "cat", "Cat")),
    ("optimizer", ("foreach", "multi_tensor", "sgd", "adam")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile(fn, label: str) -> dict:
    """fn() under torch.profiler after one warm-up call: device busy and
    idle share over its wall time, and kernel time by class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile ({label}): the profiler recorded no device time (not measured)")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    by_class: dict = {}
    for e in kernels:
        name = e.name
        cls = next((c for c, keys in _KERNEL_CLASSES
                    if any(k.lower() in name.lower() for k in keys)), "other")
        t, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (t + e.time_range.end - e.time_range.start, n + 1)
    idle = 1 - busy / wall_us
    log(f"profile ({label}): wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
        f"idle share {idle:.3f}, {len(kernels)} kernel launches")
    for cls, (t, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        log(f"  {cls:20s} {t / 1e3:8.3f} ms  {n:5d} launches  {t / busy:.3f} of busy")
    top = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)[:8]
    for a in top:
        log(f"  top: {a.self_device_time_total / 1e3:8.3f} ms  x{a.count:<4d} {a.key[:100]}")
    # the kernels launched most often, which the host pays for
    launched: dict = {}
    for e in kernels:
        launched[e.name] = launched.get(e.name, 0) + 1
    for name, n in sorted(launched.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  most launched: x{n:<5d} {name[:100]}")
    # the heaviest operators with the shapes they were called on
    ops = [a for a in prof.key_averages(group_by_input_shape=True)
           if a.key.startswith("aten::")]
    for a in sorted(ops, key=lambda a: -a.device_time_total)[:6]:
        log(f"  by shape: {a.device_time_total / 1e3:8.3f} ms  x{a.count:<4d} {a.key} "
            f"{str(a.input_shapes)[:160]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle_share=idle, launches=len(kernels),
                by_class_ms={c: t / 1e3 for c, (t, _) in by_class.items()})


def plain_epilogue(xs, scales, biases, alphas_cols, *, train=True, **kw):
    """The epilogue's plain two-pass reference in the place of the kernels
    (a measurement-only swap), with the biased batch stats that
    GroupedMixedOp advances its running stats with in train mode."""
    out = ge.group_epilogue_reference(xs, scales, biases, alphas_cols, train=train, **kw)
    if not train:
        return out, (None, None)
    with torch.no_grad():
        mu = torch.stack([x.float().mean(dim=(0, 2, 3)) for x in xs])
        var = torch.stack([x.float().var(dim=(0, 2, 3), unbiased=False) for x in xs])
    return out, (mu, var)


@contextlib.contextmanager
def twins_swapped():
    """Within it the epilogue's Function calls the kernels' plain twins in
    their place: the same glue, only the sums and streams in PyTorch."""
    names = [name for name, _ in _TIMED]
    kernels = {name: getattr(ge, name) for name in names}
    for name in names:
        setattr(ge, name, getattr(ge, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(ge, name, fn)


@contextlib.contextmanager
def plain_epilogue_swapped():
    """Within it GroupedMixedOp runs `plain_epilogue`."""
    from senas_torch.search import fused_cell
    kernel_fn = fused_cell.fused_group_epilogue
    fused_cell.fused_group_epilogue = plain_epilogue
    try:
        yield
    finally:
        fused_cell.fused_group_epilogue = kernel_fn


def in_turns(fn, label: str, reps: int) -> dict:
    """Host-clock ms per call of fn() with the kernels and with the plain
    epilogue, in turns k, p, p, k."""
    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    times = {"kernels": [], "plain": []}
    for mode in ("kernels", "plain", "plain", "kernels"):
        if mode == "plain":
            with plain_epilogue_swapped():
                times[mode].append(timed())
        else:
            times[mode].append(timed())
    log(f"{label} ms, kernels vs plain epilogue (in turns k,p,p,k): "
        f"kernels {[round(t, 3) for t in times['kernels']]}, "
        f"plain {[round(t, 3) for t in times['plain']]}")
    return times


# ---------------------------------------------------------------------------
# Phase 5: the eval path
# ---------------------------------------------------------------------------

def expected_launches(model, suffix: str = "") -> dict:
    """Launches per forward and per backward, from the model: every
    GroupedMixedOp applies its mix; in eval mode only the groups with an SE
    branch (DOWN, UP) need the stats sweep. A backward runs bwd_reduce for
    every group and bwd_dx for every group whose branch tensors need a
    gradient: all of them, since every branch comes out of a convolution,
    pooling or resampling of a tensor that depends on the weights. The
    counts land on the variants named `<kernel><suffix>` (BF16_SUFFIX for a
    bf16 model); every other variant expects 0."""
    groups = [m for m in model.modules() if isinstance(m, GroupedMixedOp)]
    with_se = sum("se_conv_3" in g.ops for g in groups)
    zero = {name: 0 for name in KERNELS}
    g = len(groups)
    return {"train": {**zero, "branch_stats" + suffix: g, "apply_mix" + suffix: g},
            "eval": {**zero, "branch_stats" + suffix: with_se, "apply_mix" + suffix: g},
            "backward": {**zero, "bwd_reduce" + suffix: g, "bwd_dx" + suffix: g}}


def per_step(expect: dict, do_arch: bool, remat: bool = False) -> dict:
    """A search step: one train-mode forward and backward, two with do_arch;
    with remat each backward runs every cell's forward once more."""
    k, forwards = (2 if do_arch else 1), (2 if remat else 1)
    return {name: k * (forwards * expect["train"][name] + expect["backward"][name])
            for name in KERNELS}


def _supernet(s, dev, gen, dtype=None, remat=False):
    return SenasSearch(IN_CHANNELS, s["init_channels"], NCLASS, s["depth"], s["meta_node_num"],
                       double_down_channel=s["double_down_channel"],
                       supervision=s["deep_supervision"], dtype=dtype, remat=remat, device=dev,
                       generator=gen)


def _batches(rng, n, bs, hw, dev):
    out = []
    for _ in range(n):
        img = rng.randn(bs, hw, hw, IN_CHANNELS).astype(np.float32)
        label = (rng.rand(bs, hw, hw) > 0.7).astype(np.int64)
        out.append({"image": torch.from_numpy(img).to(dev),
                    "label": torch.from_numpy(label).to(dev)})
    return out


def run_eval_path(dev, seed: int, n_batches: int = N_BATCHES) -> dict:
    s = load_config(CONFIG)["searching"]
    meta, depth, bs = s["meta_node_num"], s["depth"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed)
    model = _supernet(s, dev, gen)
    arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"],
                            generator=gen, device=dev)
    normalize = lambda a: normalize_arch(a, meta)
    step = make_search_eval_step(model, normalize, build_loss(s["loss"]["name"],
                                                              s["deep_supervision"]))
    expect = expected_launches(model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"supernet: init_channels {s['init_channels']} depth {depth} meta {meta} "
        f"batch {bs} {HW}x{HW}x{IN_CHANNELS}, {n_params} parameters, "
        f"expected launches {expect}")
    batches = _batches(np.random.RandomState(seed), n_batches, bs, HW, dev)

    reset_counts()
    total = {name: 0 for name in KERNELS}
    # a train-mode forward first, so that the running stats are the batch's
    with torch.no_grad():
        out = model(batches[0]["image"], normalize(arch), train=True)
    torch.cuda.synchronize()
    got = counts()
    log(f"train-mode forward launches {got}")
    check(got == expect["train"], f"train forward launched {got}, expected {expect['train']}")
    check(bool(torch.isfinite(out[0]).all()), "train forward gave non-finite logits")
    add_counts(total, got)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, batch in enumerate(batches):
        reset_counts()
        t0 = time.perf_counter()
        m = step(arch, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(got == expect["eval"], f"eval batch {i} launched {got}, expected {expect['eval']}")
        add_counts(total, got)
        tp, fp, fn = (m[k].cpu().numpy() for k in ("tp", "fp", "fn"))
        positives = int((batch["label"] == 1).sum())
        check(np.isfinite(float(m["loss"])) and tp[0] + fn[0] == positives,
              f"eval batch {i}: loss {float(m['loss'])}, tp+fn {tp[0] + fn[0]} "
              f"for {positives} positive pixels")
        log(f"eval batch {i}: loss {float(m['loss']):.6f} tp {tp} fp {fp} fn {fn} "
            f"acc {float(m['acc']):.6f} launches {got} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    steady = times[1:] or times
    log(f"eval step: {np.mean(steady):.2f} ms/batch of {bs} (batches after the first; "
        f"all: {[round(t, 2) for t in times]}), peak memory {peak / 2**20:.1f} MiB")

    # hold the card to the plain CPU path: eval-mode BN is per sample, so the
    # first 2 images alone give the same logits as in the batch of 8
    state = model.state_dict()
    with torch.inference_mode():
        card = model(batches[0]["image"], normalize(arch), train=False)[0][:2].cpu()
    cpu_model = _supernet(s, "cpu", None)
    cpu_model.load_state_dict({k: v.cpu() for k, v in state.items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_model(batches[0]["image"][:2].cpu(),
                        normalize({k: v.cpu() for k, v in arch.items()}), train=False)[0]
    cpu_s = time.perf_counter() - t0
    check(card.shape == ref.shape == (2, HW, HW, NCLASS),
          f"logits {tuple(card.shape)} (card), {tuple(ref.shape)} (CPU)")
    check(bool(torch.isfinite(card).all() and torch.isfinite(ref).all()),
          "non-finite logits")
    abs_err = (card - ref).abs().max().item()
    rel = ((card - ref).abs() / (ref.abs() + 1e-3)).max().item()
    scale = ref.abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"card vs CPU plain path (2 images): max |logit| {scale:.4g}, max abs err "
        f"{abs_err:.3g}, max rel err {rel:.3g}, argmax agreement {agree:.6f} "
        f"(CPU forward {cpu_s:.1f} s)")
    torch.testing.assert_close(card, ref, rtol=1e-3, atol=1e-3)
    check(agree >= 0.999, f"argmax agreement {agree:.6f} < 0.999")

    prof = profile(lambda: step(arch, batches[-1]), f"one eval step, batch {bs}")
    turns = in_turns(lambda: step(arch, batches[-1]), "eval step", reps=5)

    geno = derive_genotype(arch, meta, depth)
    log(f"genotype: {geno!r}")
    return dict(launches=total, expect=expect, eval_ms=float(np.mean(steady)),
                peak_mib=peak / 2**20, cpu_abs_err=abs_err, argmax_agreement=agree,
                profile=prof, turns=turns)


# ---------------------------------------------------------------------------
# Phase 6: the search path
# ---------------------------------------------------------------------------

def _snapshot(state: SearchTrainState) -> dict:
    return {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "arch": {k: v.detach().clone() for k, v in state.arch.items()},
            "w_opt": copy.deepcopy(state.w_opt.state_dict()),
            "a_opt": copy.deepcopy(state.a_opt.state_dict()), "step": state.step}


def _restore(state: SearchTrainState, snap: dict) -> None:
    state.model.load_state_dict(snap["model"])
    with torch.no_grad():
        for k, t in state.arch.items():
            t.copy_(snap["arch"][k])
    state.w_opt.load_state_dict(copy.deepcopy(snap["w_opt"]))
    state.a_opt.load_state_dict(copy.deepcopy(snap["a_opt"]))
    state.step = snap["step"]


def _update_rel(before: dict, a: dict, b: dict, keys) -> float:
    """||(a - before) - (b - before)|| / ||b - before|| over `keys`."""
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in keys)
    den = sum(float(((b[k] - before[k]).double() ** 2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def _leaf_rel(before: dict, a: dict, b: dict, top: int) -> list:
    """The `top` leaves (weights and arch tables) that carry most of the
    squared difference of two updates: (name, share of it, the leaf's own
    relative update difference, the leaf's share of the update's norm²)."""
    rows, num_all, den_all = [], 0.0, 0.0
    for part in ("model", "arch"):
        for k in b[part]:
            if part == "model" and k.rsplit(".", 1)[-1] in ("mean", "var"):
                continue
            upd = (b[part][k] - before[part][k]).double()
            num = float(((a[part][k] - b[part][k]).double() ** 2).sum())
            den = float((upd ** 2).sum())
            rows.append((f"{part}:{k}", num, den))
            num_all, den_all = num_all + num, den_all + den
    rows.sort(key=lambda r: -r[1])
    return [(k, num / max(num_all, 1e-300), (num / max(den, 1e-300)) ** 0.5,
             den / max(den_all, 1e-300)) for k, num, den in rows[:top]]


def _state_rel(before: dict, a: dict, b: dict) -> dict:
    """How far two runs of a step from `before` moved the state apart: the
    relative difference of the updates of the weights and of the arch
    tables, and the largest difference of a BN running stat, relative to
    the largest magnitude of its vector (at least 1)."""
    params = [k for k in b["model"] if k.rsplit(".", 1)[-1] not in ("mean", "var")]
    stats = [k for k in b["model"] if k not in params]
    return dict(
        weights=_update_rel(before["model"], a["model"], b["model"], params),
        arch=_update_rel(before["arch"], a["arch"], b["arch"], list(b["arch"])),
        bn_stats=max(float((a["model"][k] - b["model"][k]).abs().max()
                           / b["model"][k].abs().max().clamp_min(1.0)) for k in stats))


def _metrics_rel(a: dict, b: dict, keys=("loss", "arch_loss", "grad_norm")) -> dict:
    return {k: abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-30) for k in keys}


# Limits of the full-width step with the kernels against the same step with
# their plain twins or the plain epilogue, from one state. The card's own
# spread sets them: the kernels' step run twice from one state differs by
# 7.9e-4 (weight update) and 1.2e-3 (arch update) on an H100, spread evenly
# over the leaves (each ~2e-3 of its own update), and the twins and the
# plain epilogue sit at that spread (1.1e-3 to 1.4e-3).
STEP_LIMITS = dict(metrics=1e-3, weights=5e-3, arch=5e-3, bn_stats=1e-5)


def run_search_path(dev, seed: int) -> dict:
    cfg = load_config(CONFIG)
    s = cfg["searching"]
    meta, depth, bs = s["meta_node_num"], s["depth"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed + 1)
    model = _supernet(s, dev, gen)
    arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"],
                            generator=gen, device=dev)
    state = SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])
    step = make_search_step(lambda a: normalize_arch(a, meta),
                            build_loss(s["loss"]["name"], s["deep_supervision"]),
                            grad_clip=s["grad_clip"])
    expect = expected_launches(model)
    rng = np.random.RandomState(seed + 1)
    pairs = [tuple(_batches(rng, 2, bs, HW, dev)) for _ in DO_ARCH]
    arch0 = {k: v.detach().clone() for k, v in arch.items()}
    log(f"search step: batch {bs} train + {bs} val, {HW}x{HW}x{IN_CHANNELS}, SGD "
        f"{s['model_optimizer']} over weights and arch tables, Adam {s['arch_optimizer']}, "
        f"clip {s['grad_clip']}; expected launches per step: do_arch=False "
        f"{per_step(expect, False)}, do_arch=True {per_step(expect, True)}")

    torch.cuda.reset_peak_memory_stats()
    total = {name: 0 for name in KERNELS}
    read = {}   # the counters of the first step of each kind
    times = []
    for i, ((tb, vb), do_arch) in enumerate(zip(pairs, DO_ARCH)):
        reset_counts()
        t0 = time.perf_counter()
        m = step(state, tb, vb, do_arch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        want = per_step(expect, do_arch)
        check(got == want, f"search step {i} (do_arch={do_arch}) launched {got}, expected {want}")
        read.setdefault(str(do_arch), got)
        add_counts(total, got)
        vals = {k: float(m[k]) for k in ("loss", "arch_loss", "grad_norm", "acc")}
        check(all(np.isfinite(v) for v in vals.values()), f"search step {i}: {vals}")
        check((vals["arch_loss"] > 0) == do_arch, f"search step {i}: arch_loss {vals}")
        log(f"search step {i} do_arch={do_arch}: {vals} tp {m['tp'].cpu().numpy()} "
            f"launches {got} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    moved = max(float((arch[k].detach() - arch0[k]).abs().max()) for k in arch if arch[k].numel())
    check(moved > 0, "the arch tables did not move")
    steady = times[1:]
    log(f"search step: {np.mean(steady):.2f} ms/step (steps after the first: "
        f"{[round(t, 2) for t in steady]}; first {times[0]:.2f} ms), peak memory "
        f"{peak / 2**20:.1f} MiB, arch tables moved by up to {moved:.3g}")

    tb, vb = pairs[-1]
    prof = profile(lambda: step(state, tb, vb, True), f"one search step, do_arch, batch {bs}")

    # the same step from one saved state: with the kernels twice (the card's
    # own spread from run to run: the step's library kernels do not sum in
    # a fixed order), with the kernels' plain twins in the same Function
    # (the order of the kernels' sums alone), and with the plain two-pass
    # epilogue (that and the one-sweep variance)
    before = _snapshot(state)

    def from_before(ctx):
        _restore(state, before)
        with ctx:
            m = step(state, tb, vb, True)
        return m, _snapshot(state)

    m_k, after_k = from_before(contextlib.nullcontext())
    m_k2, after_k2 = from_before(contextlib.nullcontext())
    m_t, after_t = from_before(twins_swapped())
    m_p, after_p = from_before(plain_epilogue_swapped())
    _restore(state, before)
    spread = dict(kernels_again=(_metrics_rel(m_k, m_k2), _state_rel(before, after_k, after_k2)),
                  twins=(_metrics_rel(m_k, m_t), _state_rel(before, after_k, after_t)),
                  plain=(_metrics_rel(m_k, m_p), _state_rel(before, after_k, after_p)))
    for name, (rm, rs) in spread.items():
        log(f"search step from one state, kernels vs {name}: metrics rel {rm}, state {rs}")
    for name, after in (("kernels_again", after_k2), ("plain", after_p)):
        log(f"  kernels vs {name}, leaves that carry the weight and arch update difference "
            "(share of it, the leaf's own rel, the leaf's share of the update):")
        for k, share, rel, upd in _leaf_rel(before, after_k, after, top=8):
            log(f"    {share:.3f}  rel {rel:.3g}  update share {upd:.3g}  {k}")
    for name in ("twins", "plain"):
        rel_m, rel_s = spread[name]
        check(max(rel_m.values()) <= STEP_LIMITS["metrics"],
              f"the steps with the kernels and with {name} disagree: {rel_m}")
        check(all(rel_s[k] <= STEP_LIMITS[k] for k in ("weights", "arch", "bn_stats")),
              f"the steps with the kernels and with {name} moved the state apart: {rel_s}")
    turns = in_turns(lambda: step(state, tb, vb, True), "search step (do_arch)", reps=2)
    return dict(launches=total, per_step=read, step_ms=float(np.mean(steady)),
                peak_mib=peak / 2**20, profile=prof, turns=turns, spread=spread)


# ---------------------------------------------------------------------------
# Phase 7: a search training step on the card against the CPU
# ---------------------------------------------------------------------------

# Limits of the card-vs-CPU steps, from their readings on an H100, with
# room on both sides: the same steps with TF32 on must fail them. The
# search step read loss, arch loss and grad norm within 2.7e-7, weight
# update 1.5e-5, arch update 1.2e-6, running stats 4.6e-7; the fixed step
# loss and grad norm within 6.9e-8, weight update 1.6e-5, running stats
# 1.7e-7 (with TF32 on: grad norm 2.7e-4, weight update 1.6e-2).
CARD_CPU_LIMITS = dict(metrics=1e-5, weights=1e-4, arch=1e-5, bn_stats=1e-5)


def _within(rel_m: dict, rel_s: dict) -> bool:
    return (max(rel_m.values()) <= CARD_CPU_LIMITS["metrics"]
            and all(rel_s[k] <= CARD_CPU_LIMITS[k] for k in ("weights", "arch", "bn_stats")))


def train_card_vs_cpu(dev, seed: int) -> dict:
    """One do_arch step from identical state on the CPU and on the card,
    with TF32 off (held to CARD_CPU_LIMITS) and once more with TF32 on (which
    the limits must catch)."""
    s = dict(load_config(CONFIG)["searching"], depth=3, init_channels=8)
    meta, depth, bs, hw = s["meta_node_num"], s["depth"], 2, 64
    gen = torch.Generator().manual_seed(seed + 2)
    model0 = _supernet(s, "cpu", gen).state_dict()
    arch0 = init_arch_params(meta, depth, use_sharing=False, generator=gen, device="cpu")
    tb, vb = _batches(np.random.RandomState(seed + 2), 2, bs, hw, "cpu")
    to_cpu = lambda snap: {k: ({kk: vv.cpu() for kk, vv in v.items()}
                               if k in ("model", "arch") else v) for k, v in snap.items()}

    def run_on(d):
        model = _supernet(s, d, None)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        arch = {k: v.clone().to(d) for k, v in arch0.items()}
        state = SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])
        step = make_search_step(lambda a: normalize_arch(a, meta),
                                build_loss(s["loss"]["name"]), grad_clip=s["grad_clip"])
        before = to_cpu(_snapshot(state))
        m = step(state, {k: v.to(d) for k, v in tb.items()},
                 {k: v.to(d) for k, v in vb.items()}, True)
        return before, {k: v.cpu() for k, v in m.items()}, to_cpu(_snapshot(state))

    before, m_cpu, after_cpu = run_on("cpu")
    _, m_card, after_card = run_on(dev)
    rel_m, rel_s = _metrics_rel(m_card, m_cpu), _state_rel(before, after_card, after_cpu)
    log(f"training step card vs CPU (depth {depth}, c {s['init_channels']}, {hw}x{hw}, "
        f"batch {bs}, do_arch): metrics {({k: float(v) for k, v in m_card.items() if v.numel() == 1})} "
        f"rel {rel_m}, state {rel_s} (limits {CARD_CPU_LIMITS})")
    check(_within(rel_m, rel_s), f"card and CPU steps disagree: metrics {rel_m}, state {rel_s}")

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, m_tf32, after_tf32 = run_on(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    tf32_m, tf32_s = _metrics_rel(m_tf32, m_cpu), _state_rel(before, after_tf32, after_cpu)
    log(f"the same step with TF32 on, card vs CPU: metrics rel {tf32_m}, state {tf32_s}")
    check(not _within(tf32_m, tf32_s), "the card-vs-CPU limits let a step with TF32 on pass")
    return dict(metrics=rel_m, state=rel_s, tf32=dict(metrics=tf32_m, state=tf32_s))


# ---------------------------------------------------------------------------
# Phase 8: the search runner and its resume
# ---------------------------------------------------------------------------

def _cli(module: str, config: str, *args: str) -> str:
    """`python -m <module> --config <config> ...` from the checkout; its stdout."""
    cmd = [sys.executable, "-m", module, "--config", config, *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"  {' '.join(cmd[1:])}: rc {out.returncode}, {time.perf_counter() - t0:.1f} s")
    check(out.returncode == 0, f"{module} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout


def _run_dir(stdout: str) -> str:
    return stdout.split("run dir: ")[1].splitlines()[0].strip()


def _val_epochs(run_dir: str) -> list:
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if r["tag"] == "Val/dice"]


def run_runner() -> dict:
    cfg = load_config(RUNNER_CONFIG)
    epochs = cfg["searching"]["epoch"]
    with tempfile.TemporaryDirectory() as log_root:
        first = _cli("senas_torch.search_arc", RUNNER_CONFIG, "--log_root", log_root)
        run_dir = _run_dir(first)
        check(_val_epochs(run_dir) == list(range(epochs)),
              f"runner ran epochs {_val_epochs(run_dir)}, expected {epochs}")
        best = parse_genotype(first.split("best genotype: ")[1].strip())
        # the same config with `searching.resume` naming the checkpoint
        cfg["searching"].update(resume=os.path.join(run_dir, "ckpt"), epoch=epochs + 1)
        cfg["searching"]["arch_optimizer"]["betas"] = list(
            cfg["searching"]["arch_optimizer"]["betas"])
        resume_config = os.path.join(log_root, "resume.yml")
        with open(resume_config, "w") as f:
            yaml.safe_dump(cfg, f)
        resumed = _cli("senas_torch.search_arc", resume_config, "--log_root",
                       os.path.join(log_root, "resumed"))
        check(f"at epoch {epochs}" in resumed, "the resumed run did not start at the "
              f"checkpoint's epoch {epochs}")
        run_dir2 = _run_dir(resumed)
        check(_val_epochs(run_dir2) == [epochs],
              f"the resumed run ran epochs {_val_epochs(run_dir2)}, expected [{epochs}]")
        log(f"runner: {epochs} epochs then 1 resumed; genotype {best!r}")
    return dict(epochs=epochs, resumed_epochs=1)


# ---------------------------------------------------------------------------
# Phase 9: the fixed model's train and eval steps at full width
# ---------------------------------------------------------------------------

FIXED_STEPS = 4      # 1 + 3 train steps
# the fixed model's logits on the card against the CPU path (phase 9; the
# serving artifact loaded on the CPU is held to it in phase 12)
CARD_CPU_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def _fixed_model(t, dev, gen, dtype=None, remat=False):
    return SenasModel(NCLASS, IN_CHANNELS, c=t["init_channels"], depth=t["depth"],
                      supervision=t["deep_supervision"],
                      genotype=getattr(geno_searched, t["geno_type"]),
                      double_down_channel=t["double_down_channel"], dtype=dtype, remat=remat,
                      device=dev, generator=gen)


def _fixed_loss(t):
    return build_loss(t["loss"]["name"], t["deep_supervision"])


def run_fixed_path(dev, seed: int) -> dict:
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed + 3))
    state = FixedTrainState.create(model, t["model_optimizer"])
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    evaluate = make_eval_step(model, _fixed_loss(t))
    rng = np.random.RandomState(seed + 3)
    train_batches = _batches(rng, FIXED_STEPS, bs, HW, dev)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"fixed model: {t['geno_type']} init_channels {t['init_channels']} depth "
        f"{t['depth']}, {n_params} parameters; batch {bs} {HW}x{HW}x{IN_CHANNELS}, SGD "
        f"{t['model_optimizer']}, clip {t['grad_clip']}, {t['loss']['name']}")

    reset_counts()
    total = {name: 0 for name in KERNELS}
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, batch in enumerate(train_batches):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(m[k]) for k in ("loss", "grad_norm", "acc")}
        check(all(np.isfinite(v) for v in vals.values()), f"fixed train step {i}: {vals}")
        log(f"fixed train step {i}: {vals} tp {m['tp'].cpu().numpy()} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    steady = times[1:]
    log(f"fixed train step: {np.mean(steady):.2f} ms/step (steps after the first: "
        f"{[round(x, 2) for x in steady]}; first {times[0]:.2f} ms), peak memory "
        f"{peak / 2**20:.1f} MiB")
    add_counts(total, counts())

    reset_counts()
    eval_times = []
    for i, batch in enumerate(eval_batches):
        t0 = time.perf_counter()
        m = evaluate(batch)
        torch.cuda.synchronize()
        eval_times.append((time.perf_counter() - t0) * 1e3)
        pred, label = m["pred"], batch["label"]
        check(pred.dtype == torch.uint8 and tuple(pred.shape) == (bs, HW, HW),
              f"eval pred is {pred.dtype} {tuple(pred.shape)}")
        tp = int(((pred == 1) & (label == 1)).sum())
        check(np.isfinite(float(m["loss"])) and tp == int(m["tp"][0])
              and int(m["tp"][0] + m["fn"][0]) == int((label == 1).sum()),
              f"eval batch {i}: loss {float(m['loss'])}, tp {m['tp']} (pred gives {tp})")
        log(f"fixed eval batch {i}: loss {float(m['loss']):.6f} tp {m['tp'].cpu().numpy()} "
            f"fp {m['fp'].cpu().numpy()} fn {m['fn'].cpu().numpy()} {eval_times[-1]:.2f} ms")
    add_counts(total, counts())
    # the fixed model has no GroupedMixedOp and does not call K2
    check(not any(total.values()), f"the fixed path launched {total}")

    # the card's logits against the CPU path on 2 images (eval-mode BN is
    # per sample), within CARD_CPU_LOGIT_TOL
    with torch.inference_mode():
        card = model(eval_batches[0]["image"][:2], train=False)[0].cpu()
    cpu_model = _fixed_model(t, "cpu", None)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        ref = cpu_model(eval_batches[0]["image"][:2].cpu(), train=False)[0]
    abs_err = (card - ref).abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"fixed model card vs CPU (2 images): max |logit| {ref.abs().max().item():.4g}, "
        f"max abs err {abs_err:.3g}, argmax agreement {agree:.6f}")
    check(bool(torch.isfinite(card).all()), "non-finite fixed-model logits")
    torch.testing.assert_close(card, ref, **CARD_CPU_LOGIT_TOL)
    check(agree >= 0.999, f"argmax agreement {agree:.6f} < 0.999")

    prof = profile(lambda: step(state, train_batches[-1]), f"one fixed train step, batch {bs}")
    return dict(launches=total, step_ms=float(np.mean(steady)), first_ms=times[0],
                eval_ms=float(np.mean(eval_times[1:])), peak_mib=peak / 2**20,
                cpu_abs_err=abs_err, argmax_agreement=agree, profile=prof, state=state)


# ---------------------------------------------------------------------------
# Phase 10: a fixed training step on the card against the CPU
# ---------------------------------------------------------------------------

def fixed_card_vs_cpu(dev, seed: int) -> dict:
    """`fixed_step_card_vs_cpu` with TF32 off (held to CARD_CPU_LIMITS) and
    once more with TF32 on (which the limits must catch)."""
    rel_m, rel_s = fixed_step_card_vs_cpu(dev, seed)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_m, tf32_s = fixed_step_card_vs_cpu(dev, seed)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    log(f"fixed training step card vs CPU (depth 3, c 8, 64x64, batch 2): metrics rel "
        f"{rel_m}, state {rel_s}; with TF32 on: metrics rel {tf32_m}, state {tf32_s} "
        f"(limits {CARD_CPU_LIMITS})")
    check(_within(rel_m, rel_s),
          f"card and CPU fixed steps disagree: metrics {rel_m}, state {rel_s}")
    check(not _within(tf32_m, tf32_s),
          "the fixed card-vs-CPU limits let a step with TF32 on pass")
    return dict(metrics=rel_m, state=rel_s, tf32=dict(metrics=tf32_m, state=tf32_s))


def fixed_step_card_vs_cpu(dev, seed: int, **training) -> tuple:
    """One fixed train step (depth 3, c 8, 64x64, batch 2, the `training:`
    section updated by `training`) from identical state on the CPU and on
    the card: (metrics rel, state rel)."""
    t = dict(load_config(CONFIG)["training"], depth=3, init_channels=8, **training)
    model0 = _fixed_model(t, "cpu", torch.Generator().manual_seed(seed + 5)).state_dict()
    batch = _batches(np.random.RandomState(seed + 5), 1, 2, 64, "cpu")[0]

    def run_on(d):
        model = _fixed_model(t, d, None)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        state = FixedTrainState.create(model, t["model_optimizer"])
        m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
            state, {k: v.to(d) for k, v in batch.items()})
        return ({k: v.cpu() for k, v in m.items()},
                {"model": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                 "arch": {}})

    before = {"model": {k: v.clone() for k, v in model0.items()}, "arch": {}}
    m_cpu, after_cpu = run_on("cpu")
    m_card, after_card = run_on(dev)
    return (_metrics_rel(m_card, m_cpu, ("loss", "grad_norm")),
            _state_rel(before, after_card, after_cpu))


# ---------------------------------------------------------------------------
# Phase 11: the fixed CLIs
# ---------------------------------------------------------------------------

def run_fixed_clis() -> dict:
    cfg = load_config(RUNNER_CONFIG)
    epochs = cfg["training"]["epoch"]
    with tempfile.TemporaryDirectory() as log_root:
        out = _cli("senas_torch.train_model", RUNNER_CONFIG, "--log_root", log_root)
        run_dir = _run_dir(out)
        best = ast.literal_eval(out.split("best: ")[1].splitlines()[0])
        check(_val_epochs(run_dir) == list(range(epochs)),
              f"train_model ran epochs {_val_epochs(run_dir)}, expected {epochs}")
        grids = [f for f in os.listdir(run_dir) if f.startswith("Val_images_")]
        check(len(grids) == epochs and os.path.exists(os.path.join(run_dir, "ckpt", "best.pt")),
              f"train_model wrote {grids} and no best checkpoint")
        # at the training run's batch, so that cuDNN takes the same algorithms
        out = _cli("senas_torch.testing_model", RUNNER_CONFIG, "--resume",
                   os.path.join(run_dir, "ckpt"), "--log_root", log_root,
                   "--batch_size", str(cfg["training"]["batch_size"]))
        result = ast.literal_eval(out.strip().splitlines()[-1])
        image_dir = os.path.join(_run_dir(out), "images")
        pngs = sorted(os.listdir(image_dir))
        for name in pngs:
            with open(os.path.join(image_dir, name), "rb") as f:
                check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name} is not a PNG")
        # eval-mode BN is per sample, so the best epoch's val dice comes back;
        # a batch of 6 against the run's 4 gave 90.298 against 90.301 on an
        # H100 (other cuDNN algorithms flip a pixel or two), hence 0.01 points
        check(abs(result["dice"] - best["best_dice"]) <= 0.01,
              f"testing_model dice {result['dice']} on the best checkpoint, the run's best "
              f"{best['best_dice']}")
        log(f"fixed CLIs: {epochs} epochs, best {best}; testing_model {result}, "
            f"{len(pngs)} PNGs")
    return dict(epochs=epochs, best=best, test=result, pngs=len(pngs))


# ---------------------------------------------------------------------------
# Phase 12: serving the trained fixed model from an exported artifact
# ---------------------------------------------------------------------------

SERVE_BATCHES = (1, 3, 12)
# the artifact against the eager model on the card, both in f32
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
# the TF32 control: a backend-default artifact run with TF32 on must stray
# from the CPU at least this many times further than the --f32 one does
TF32_CONTROL_FACTOR = 10.0


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, the process's choice restored."""
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = kept


REPEAT_CALLS = 8


def call_to_call(pred, x) -> dict:
    """REPEAT_CALLS calls of the served program on one input, with cuDNN's
    default algorithms and with its deterministic ones: the largest logit
    difference from the first call, the mask pixels that differ from its
    argmax, and the largest gap between the two best logits at such a
    pixel. The default algorithms may sum in a different order each call
    (e.g. with atomics), which the deterministic ones do not."""
    out = {}
    for name, ctx in (("default", contextlib.nullcontext), ("deterministic", deterministic_cudnn)):
        with ctx():
            first = pred.logits(x)
            rest = [pred.logits(x) for _ in range(REPEAT_CALLS - 1)]
        top2 = first.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        flipped = torch.zeros_like(gap, dtype=torch.bool)
        for r in rest:
            flipped |= r.argmax(-1) != first.argmax(-1)
        out[name] = dict(max_abs=max((r - first).abs().max().item() for r in rest),
                         flipped=int(flipped.sum()),
                         max_gap_flipped=gap[flipped].max().item() if flipped.any() else None)
    log(f"call to call ({REPEAT_CALLS} calls at batch {len(x)}, against the first): {out}")
    return out


def _request_ms(pred, x, reps: int = 20, warmup: int = 3) -> dict:
    """Host-clock ms per request (numpy in, logits on the card), each one
    ended by a synchronise: warm-up, then `reps` timed."""
    for _ in range(warmup):
        pred.logits(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred.logits(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(mean=float(np.mean(times)), p50=float(np.median(times)),
                min=float(np.min(times)), max=float(np.max(times)))


def run_serve_path(dev, fixed: dict, seed: int, work: str) -> dict:
    """Phase 9's trained model saved, exported by the CLI (--check --f32),
    served by a Predictor on the card, the CPU and two replicas, timed; the
    TF32 control. Returns the Predictor on the card with the numbers."""
    state = fixed["state"]
    model = state.model
    reset_counts()
    ckpt = CheckpointManager(os.path.join(work, "ckpt"))
    ckpt.save(state, {"epoch": 1, "model_name": "senas"}, is_best=True)
    art = os.path.join(work, "artifact")
    t0 = time.perf_counter()
    out = _cli("senas_torch.export_model", CONFIG, "--resume", ckpt.directory, "--out", art,
               "--check", "--f32")
    cli_s = time.perf_counter() - t0
    for line in out.strip().splitlines():
        log(f"  export_model: {line}")
    check("check OK" in out, "export_model --check did not pass")
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    size_mb = os.path.getsize(os.path.join(art, "model.pt2")) / 1e6
    check(meta["matmul_precision"] == "float32" and meta["input_hw"] == [HW, HW],
          f"artifact meta {meta}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = Predictor(art, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x_all = np.random.RandomState(seed + 6).randn(12, HW, HW, IN_CHANNELS).astype(np.float32)
    errs = {}
    for b in SERVE_BATCHES:
        x = x_all[:b]
        # the masks are the argmax of the logits, exactly: the two calls run
        # cuDNN's deterministic algorithms, so that they compute the same bits
        with deterministic_cudnn():
            got = pred.logits(x)
            masks = pred.predict_masks(x)
        with torch.inference_mode():
            want = model(torch.from_numpy(x).to(dev), train=False)[-1]
        check(tuple(got.shape) == (b, HW, HW, NCLASS) and got.device == want.device,
              f"served logits {tuple(got.shape)} on {got.device}")
        errs[b] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **SERVE_TOL)
        check(masks.dtype == np.uint8 and masks.shape == (b, HW, HW)
              and np.array_equal(masks, got.argmax(-1).to(torch.uint8).cpu().numpy()),
              f"masks at batch {b}: {masks.dtype} {masks.shape}, or not the argmax")
    log(f"served vs eager on the card (batches {SERVE_BATCHES}; the program's batch range "
        f"{pred.batch_range}, a smaller request is zero-padded): max abs err {errs} "
        f"(limit {SERVE_TOL})")
    repeat = call_to_call(pred, x_all)
    check(repeat["deterministic"]["max_abs"] == 0,
          f"two calls with deterministic cuDNN differ: {repeat['deterministic']}")

    torch.cuda.reset_peak_memory_stats()
    ms = {b: _request_ms(pred, x_all[:b]) for b in (1, 12)}
    peak = torch.cuda.max_memory_allocated()
    images_s = 12 / (ms[12]["mean"] / 1e3)
    prof = {b: profile(lambda: pred.logits(x_all[:b]), f"one served request, batch {b}")
            for b in (1, 12)}
    log(f"serving: batch 1 {ms[1]['mean']:.3f} ms/request (p50 {ms[1]['p50']:.3f}), batch 12 "
        f"{ms[12]['mean']:.3f} ms/request (p50 {ms[12]['p50']:.3f}), {images_s:.1f} images/s; "
        f"export {meta['export_seconds']:.2f} s (CLI with its check {cli_s:.1f} s), artifact "
        f"{size_mb:.2f} MB, load {load_s:.2f} s, peak memory {peak / 2**20:.1f} MiB")

    # the same artifact on the CPU, held to phase 9's card-vs-CPU limit
    t0 = time.perf_counter()
    cpu_pred = Predictor(art, device="cpu")
    cpu_load_s = time.perf_counter() - t0
    x2 = x_all[:2]
    cpu = cpu_pred.logits(x2)
    card = pred.logits(x2).cpu()
    cpu_err = (card - cpu).abs().max().item()
    torch.testing.assert_close(card, cpu, **CARD_CPU_LOGIT_TOL)

    # two replicas on the one card, at batch 5 (padded to 6, split 3 + 3)
    dp = Predictor(art, data_parallel=True, devices=[dev, dev])
    x5 = x_all[:5]
    with deterministic_cudnn():
        got = dp.logits(x5)
        dp_masks = dp.predict_masks(x5)
    padded = np.concatenate([x5, np.zeros((1,) + x5.shape[1:], np.float32)])
    halves = torch.cat([pred.logits(padded[:3]), pred.logits(padded[3:])])[:5]
    dp_err = dict(halves=(got - halves).abs().max().item(),
                  single=(got - pred.logits(x5)).abs().max().item())
    torch.testing.assert_close(got, halves, **SERVE_TOL)
    torch.testing.assert_close(got, pred.logits(x5), **SERVE_TOL)
    check(np.array_equal(dp_masks, got.argmax(-1).to(torch.uint8).cpu().numpy()),
          "data-parallel masks are not the argmax")
    log(f"served on the CPU (load {cpu_load_s:.2f} s): card vs CPU max abs err {cpu_err:.3g} "
        f"(limit {CARD_CPU_LOGIT_TOL}); two replicas at batch 5 vs their halves / vs the "
        f"single Predictor: {dp_err}")

    # the TF32 control: the process's TF32 on; a backend-default artifact
    # keeps it, the --f32 one turns it off around each call
    default_art = os.path.join(work, "artifact_default")
    save_artifact(export_predict_fn(model, (HW, HW, IN_CHANNELS)), {}, default_art)
    default_pred = Predictor(default_art, device=dev)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_err = (default_pred.logits(x2).cpu() - cpu).abs().max().item()
        f32_err = (pred.logits(x2).cpu() - cpu).abs().max().item()
        kept = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    log(f"TF32 control, the process's TF32 on: backend-default artifact vs CPU {tf32_err:.3g}, "
        f"--f32 artifact vs CPU {f32_err:.3g} (ratio {tf32_err / max(f32_err, 1e-30):.3g}, "
        f"must be > {TF32_CONTROL_FACTOR})")
    check(kept == (True, True), f"the --f32 Predictor did not restore the TF32 flags: {kept}")
    check(f32_err <= CARD_CPU_LOGIT_TOL["atol"], f"--f32 artifact with TF32 on: {f32_err:.3g}")
    check(tf32_err > TF32_CONTROL_FACTOR * f32_err,
          f"the TF32 control did not stray: {tf32_err:.3g} against {f32_err:.3g}")

    got_counts = counts()
    check(not any(got_counts.values()), f"the serve path launched {got_counts}")
    return dict(pred=pred, launches=got_counts, ms=ms, images_per_s=images_s,
                export_s=meta["export_seconds"], export_cli_s=cli_s, artifact_mb=size_mb,
                load_s=load_s, cpu_load_s=cpu_load_s, peak_mib=peak / 2**20, errs=errs,
                profile=prof, batch_range=pred.batch_range,
                cpu_err=cpu_err, dp_err=dp_err, tf32_control=dict(tf32=tf32_err, f32=f32_err),
                call_to_call=repeat)


# ---------------------------------------------------------------------------
# Phase 13: the PROMISE12 submission path
# ---------------------------------------------------------------------------

# native case geometry (slices, rows, cols): 320x320 as many PROMISE12 MR
# volumes are, and one narrower; non-unit spacing
SUBMISSION_CASES = ((14, 320, 320), (12, 320, 288), (18, 320, 320))


def _write_cases(case_dir: str, rng) -> list:
    """Case volumes (int16 MR-like intensities) and their segmentations
    (uint8 ellipsoids), written with the port's write_mhd."""
    os.makedirs(case_dir, exist_ok=True)
    paths = []
    for i, (n, h, w) in enumerate(SUBMISSION_CASES):
        zz, yy, xx = np.mgrid[0:n, 0:h, 0:w]
        seg = (((yy - h / 2) / (h / 5)) ** 2 + ((xx - w / 2) / (w / 6)) ** 2
               + ((zz - n / 2) / (n / 3)) ** 2 < 1).astype(np.uint8)
        vol = (400.0 * seg + 100 + 60 * rng.randn(n, h, w)).astype(np.int16)
        geometry = dict(spacing=(0.625, 0.625, 3.6 - 0.4 * i), origin=(-100.0 + i, -80.5, 12.25),
                        direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
        path = os.path.join(case_dir, f"Case{i:02d}.mhd")
        write_mhd(path, MetaImage(vol, **geometry))
        write_mhd(os.path.join(case_dir, f"Case{i:02d}_segmentation.mhd"),
                  MetaImage(seg, **geometry))
        paths.append(path)
    return paths


def _case_slices(paths) -> np.ndarray:
    """Each case's slices, z-scored per volume and resized to HW x HW:
    [N, HW, HW, 1] f32 in case order."""
    out = []
    for path in paths:
        vol = read_mhd(path).array.astype(np.float32)
        vol = (vol - vol.mean()) / vol.std()
        out.append(F.interpolate(torch.from_numpy(vol)[:, None], size=(HW, HW),
                                 mode="bilinear", align_corners=False)[:, 0, ..., None].numpy())
    return np.concatenate(out)


class _SliceSet:
    """The case slices as a dataset for TestRunner's queue (labels unused)."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], np.zeros(self.images.shape[1:3], np.int32)


def _geometry_kept(written, sources) -> None:
    """Each written mask volume has its source's shape and geometry."""
    for w, src in zip(written, sources):
        back, source = read_mhd(w), read_mhd(src)
        check(back.array.shape == source.array.shape and back.array.dtype == np.uint8
              and back.origin == source.origin and back.spacing == source.spacing
              and back.direction == source.direction,
              f"{w}: {back.array.shape} {back.array.dtype} origin {back.origin} spacing "
              f"{back.spacing}, source {source.array.shape} {source.origin} {source.spacing}")


def run_submission(dev, pred, work: str, seed: int) -> dict:
    """Three cases at their native resolution, their slices predicted at
    HW x HW by the serving Predictor, stitched back with predict_test and
    scored with volumetric_metrics; then the same through
    TestRunner.run_promise12_submission on phase 9's checkpoint."""
    reset_counts()
    case_dir = os.path.join(work, "cases")
    paths = _write_cases(case_dir, np.random.RandomState(seed + 7))
    images = _case_slices(paths)
    t0 = time.perf_counter()
    slices = [m for start in range(0, len(images), 12)
              for m in pred.predict_masks(images[start:start + 12])]
    predict_s = time.perf_counter() - t0
    written = predict_test(slices, paths, dest=os.path.join(work, "predictions"))
    metrics = volumetric_metrics(slices, case_dir)
    _geometry_kept(written, paths)
    check(metrics["n_cases"] == len(SUBMISSION_CASES)
          and all(np.isfinite(v) for v in metrics.values()), f"metrics {metrics}")
    log(f"submission through the Predictor: {len(slices)} slices of {len(paths)} cases "
        f"{[c[1:] for c in SUBMISSION_CASES]} predicted at {HW}x{HW} in {predict_s:.2f} s, "
        f"{len(written)} volumes written with their source geometry; metrics {metrics}")

    # TestRunner on the card: the fixed `training:` geometry over the
    # synthetic data config (the promise12 loader is not ported: M9)
    cfg = load_config(RUNNER_CONFIG)
    cfg["training"] = load_config(CONFIG)["training"]
    runner = TestRunner(cfg, resume=os.path.join(work, "ckpt"), log_root=work,
                        batch_size=12, device=dev)
    written_r, metrics_r = runner.run_promise12_submission(
        case_dir, dest=os.path.join(work, "predictions_runner"),
        queue=DataLoader(_SliceSet(images), 12))
    _geometry_kept(written_r, paths)
    same = np.mean([float((read_mhd(a).array == read_mhd(b).array).mean())
                    for a, b in zip(written, written_r)])
    log(f"submission through TestRunner on the card: {len(written_r)} volumes, metrics "
        f"{metrics_r}; voxels equal to the Predictor's {same:.6f}")
    check(metrics_r is not None and abs(metrics_r["mean_volumetric_dsc"]
                                        - metrics["mean_volumetric_dsc"]) <= 1e-3
          and same >= 0.999, f"TestRunner's submission differs: {metrics_r}, agreement {same}")
    got_counts = counts()
    check(not any(got_counts.values()), f"the submission path launched {got_counts}")
    return dict(launches=got_counts, metrics=metrics, runner_metrics=metrics_r,
                agreement=same, predict_s=predict_s, slices=len(slices))


# ---------------------------------------------------------------------------
# Phase 14: the PROMISE12 data path
# ---------------------------------------------------------------------------

# the phantom in PROMISE12's layout: training cases of 10-16 slices at 320 x
# 320 (case 05, the val split, among them) and test cases at 320 x 320 and
# 320 x 288, int16 volumes with uint8 masks, PROMISE12-like spacing
PHANTOM_TRAIN_CASES = 10
PHANTOM_TEST_SHAPES = ((12, 320, 320), (14, 320, 288))
LOADER_BATCHES = 4        # batches timed per loader setting
LIBRARIES = ("cv2", "PIL", "matplotlib", "scipy")


def libraries() -> dict:
    """Which of LIBRARIES import in this interpreter (the port needs only
    scipy; the JAX package's data path needs cv2)."""
    found = {}
    for name in LIBRARIES:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    log("libraries: " + ", ".join(f"{k} {'imports' if v else 'missing'}"
                                  for k, v in found.items()))
    return found


def _phantom_case(rng, n, h, w):
    """An MR-like int16 volume and its uint8 ellipsoid mask."""
    zz, yy, xx = np.mgrid[0:n, 0:h, 0:w]
    cy, cx = h * rng.uniform(0.4, 0.6), w * rng.uniform(0.4, 0.6)
    seg = (((yy - cy) / (h * rng.uniform(0.12, 0.2))) ** 2
           + ((xx - cx) / (w * rng.uniform(0.12, 0.2))) ** 2
           + ((zz - n / 2) / (n / 2.5)) ** 2 < 1).astype(np.uint8)
    shade = 300 + 80 * np.sin(yy / rng.uniform(20, 40)) * np.cos(xx / rng.uniform(20, 40))
    vol = np.clip(shade + 260.0 * seg + 45 * rng.randn(n, h, w), 0, 2000).astype(np.int16)
    return vol, seg


def write_phantom(root: str, rng) -> list:
    """PROMISE2012/TrainingData and TestData under `root`, written with the
    port's write_mhd. Returns the test volumes' paths in case order."""
    base = os.path.join(root, "PROMISE2012")
    for sub in ("TrainingData", "TestData"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for i in range(PHANTOM_TRAIN_CASES):
        vol, seg = _phantom_case(rng, int(rng.randint(10, 17)), 320, 320)
        geometry = dict(spacing=(0.625, 0.625, float(rng.uniform(2.2, 4.0))),
                        origin=(-100.0 + i, -90.0, 10.0 * i))
        path = os.path.join(base, "TrainingData", f"Case{i:02d}")
        write_mhd(path + ".mhd", MetaImage(vol, **geometry))
        write_mhd(path + "_segmentation.mhd", MetaImage(seg, **geometry))
    tests = []
    for i, (n, h, w) in enumerate(PHANTOM_TEST_SHAPES):
        vol, _ = _phantom_case(rng, n, h, w)
        path = os.path.join(base, "TestData", f"Case{i:02d}.mhd")
        write_mhd(path, MetaImage(vol, spacing=(0.6 + 0.05 * i, 0.625, 3.6),
                                  origin=(-80.5, 12.25 - i, 3.0),
                                  direction=(1, 0, 0, 0, -1, 0, 0, 0, 1)))
        tests.append(path)
    return tests


@contextlib.contextmanager
def _timed(module, name: str, seconds: dict):
    """module.name timed into seconds[name] (and its calls counted) while
    the block runs."""
    fn = getattr(module, name)
    seconds.setdefault(name, 0.0)
    seconds.setdefault(name + "_calls", 0)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] += time.perf_counter() - t0
            seconds[name + "_calls"] += 1

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def build_promise12_cache(root: str) -> dict:
    """The cache built through get_dataset, its time split into CLAHE,
    resize and curvature flow; the native curvature flow must have run, and
    agree with its numpy twin exactly on 3 slices."""
    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    split: dict = {}
    t0 = time.perf_counter()
    with _timed(augment, "equalize_adapthist", split), \
            _timed(imgproc, "resize_nearest", split), \
            _timed(native, "curvature_flow", split):
        trainset = get_dataset("promise12", path=root, mode="train")
    wall = time.perf_counter() - t0
    store = os.path.join(root, "PROMISE2012", f"npy_image_{HW}")
    sizes = {f: np.load(os.path.join(store, f), mmap_mode="r").shape
             for f in sorted(os.listdir(store))}
    log(f"promise12 cache: native curvature flow built with g++ in {build_s:.2f} s; "
        f"cache {wall:.2f} s wall; CLAHE {split['equalize_adapthist']:.2f} s "
        f"({split['equalize_adapthist_calls']} slices), resize "
        f"{split['resize_nearest']:.2f} s ({split['resize_nearest_calls']}), curvature flow "
        f"{split['curvature_flow']:.2f} s ({split['curvature_flow_calls']} native calls); "
        f"files {sizes}")
    check(split["curvature_flow_calls"] == sizes["X_train.npy"][0] + sizes["X_val.npy"][0]
          + sizes["X_test.npy"][0],
          f"the native curvature flow ran {split['curvature_flow_calls']} times for {sizes}")
    vol = read_mhd(os.path.join(root, "PROMISE2012", "TrainingData", "Case00.mhd")).array
    slices = promise12._img_resize(vol[:3], HW, HW, equalize=True)
    for s_ in slices:
        check(np.array_equal(native.curvature_flow(s_, 0.125, 5),
                             augment._curvature_flow(s_, 0.125, 5)),
              "the native curvature flow and its numpy twin disagree")
    x = np.load(os.path.join(store, "X_train.npy"))
    check(np.isfinite(x).all() and abs(float(x.mean())) < 1e-3
          and abs(float(x.std()) - 1) < 1e-3, f"X_train mean {x.mean()}, std {x.std()}")
    return dict(build_s=build_s, wall_s=wall, clahe_s=split["equalize_adapthist"],
                resize_s=split["resize_nearest"], curvature_flow_s=split["curvature_flow"],
                native_calls=split["curvature_flow_calls"], files=sizes, trainset=trainset)


def time_loader(trainset) -> dict:
    """ms per augmented batch at 8 and 12, serial and with the default
    pool of threads."""
    out = {}
    for bs in (8, 12):
        for workers in (0, None):
            loader = DataLoader(trainset, bs, shuffle=True, drop_last=True, workers=workers)
            it = iter(loader)
            times = []
            for _ in range(min(LOADER_BATCHES, len(loader))):
                t0 = time.perf_counter()
                batch = next(it)
                times.append((time.perf_counter() - t0) * 1e3)
            check(batch["image"].shape == (bs, HW, HW, IN_CHANNELS)
                  and np.isfinite(batch["image"]).all()
                  and set(np.unique(batch["label"])) <= {0, 1},
                  f"loader batch {batch['image'].shape} labels {np.unique(batch['label'])}")
            key = f"batch{bs}_workers{loader.workers}"
            out[key] = float(np.mean(times))
            log(f"loader {key}: {out[key]:.1f} ms/batch ({[round(t, 1) for t in times]})")
    return out


def _in_process(main_fn, *argv: str) -> str:
    """A CLI's main(argv) in this process (so that the kernels' counters
    see its launches); its stdout, also logged."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(list(argv))
    out = buf.getvalue()
    log(f"  {main_fn.__module__} {' '.join(argv)}: rc {rc}, {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        log(f"    {line}")
    check(rc == 0, f"{main_fn.__module__} returned {rc}")
    return out


def _scalars(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return {r["tag"]: r["value"] for r in map(json.loads, f)}


def run_promise12_path(dev, expect: dict, work: str, seed: int, found: dict) -> dict:
    """The PROMISE12 files through the port's CLIs at the flagship config:
    search_arc (1 epoch, full width), train_model (1 epoch, the default
    genotype), testing_model on its best checkpoint, and the submission from
    the test split through TestRunner.run_promise12_submission."""
    root = os.path.join(work, "data")
    tests = write_phantom(root, np.random.RandomState(seed + 11))
    cache = build_promise12_cache(root)
    trainset = cache.pop("trainset")
    loader = time_loader(trainset)

    s = load_config(CONFIG)["searching"]
    n = len(trainset)
    split = int(np.floor(s["train_portion"] * n))
    steps, val_batches = split // s["batch_size"], (n - split) // s["batch_size"]
    do_arch = s["alpha_begin"] <= 0
    want = {k: steps * per_step(expect, do_arch)[k] + val_batches * expect["eval"][k]
            for k in KERNELS}
    log_root = os.path.join(work, "logs")
    reset_counts()
    t0 = time.perf_counter()
    out = _in_process(search_arc.main, "--config", CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    search_s = time.perf_counter() - t0
    got = counts()
    log(f"search_arc on the phantom: {steps} steps (do_arch={do_arch}) and {val_batches} "
        f"eval batches of {s['batch_size']}; launches {got}, expected {want}")
    check(got == want, f"search_arc launched {got}, expected {want}")
    search = _scalars(_run_dir(out))
    search_ms = 1e3 / search["Train/steps_per_sec"]
    log(f"search_arc: {search_ms:.2f} ms/step (steps' second half), prefetch wait "
        f"{search['Train/prefetch_wait_share']:.4f} of a step's wall, val batch fetch "
        f"{search['Train/val_fetch_share']:.4f}; {search_s:.1f} s in all; val dice "
        f"{search['Val/dice']:.4f}")
    check(all(np.isfinite(v) for v in search.values()), f"search scalars {search}")

    reset_counts()
    out = _in_process(train_model.main, "--config", CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    train_dir = _run_dir(out)
    train = _scalars(train_dir)
    train_ms = 1e3 / train["Train/steps_per_sec"]
    log(f"train_model: {train_ms:.2f} ms/step, prefetch wait "
        f"{train['Train/prefetch_wait_share']:.4f} of a step's wall; val dice "
        f"{train['Val/dice']:.4f}")
    check(all(np.isfinite(v) for v in train.values()), f"train scalars {train}")
    ckpt = os.path.join(train_dir, "ckpt")
    check(os.path.exists(os.path.join(ckpt, "best.pt")), "train_model wrote no best checkpoint")

    out = _in_process(testing_model.main, "--config", CONFIG, "--data_root", root,
                      "--resume", ckpt, "--log_root", log_root, "--batch_size",
                      str(load_config(CONFIG)["training"]["batch_size"]))
    tested = ast.literal_eval(out.strip().splitlines()[-1])
    check(abs(tested["dice"] - train["Val/dice"]) <= 0.01,
          f"testing_model dice {tested['dice']}, the run's {train['Val/dice']}")
    fixed_launches = counts()
    check(not any(fixed_launches.values()), f"the fixed CLIs launched {fixed_launches}")

    # the submission from the test split, in case order
    cfg = load_config(CONFIG)
    runner = TestRunner(cfg, resume=ckpt, data_root=root, log_root=log_root,
                        batch_size=12, device=dev)
    testset = promise12.Promise12(root, mode="test")
    check([os.path.basename(p) for p in testset.test_file_list]
          == [os.path.basename(p) for p in tests]
          and list(testset.n_imgs) == [c[0] for c in PHANTOM_TEST_SHAPES],
          f"test split {testset.test_file_list} {testset.n_imgs}")
    t0 = time.perf_counter()
    written, summary = runner.run_promise12_submission(
        os.path.dirname(tests[0]), dest=os.path.join(work, "submission"),
        queue=DataLoader(testset, 12))
    submit_s = time.perf_counter() - t0
    _geometry_kept(written, tests)
    check(summary is None and len(written) == len(tests), f"submission {written} {summary}")
    log(f"submission from the test split: {len(written)} volumes "
        f"{[read_mhd(w).array.shape for w in written]} in {submit_s:.2f} s, each with its "
        "source's shape, origin, spacing and direction")

    # the contour grid draws with matplotlib, where the machine has it
    if found["matplotlib"]:
        val = DataLoader(promise12.Promise12(root, mode="val"), 12)
        images, labels, preds = [], [], []
        for batch in val:
            preds.append(runner.eval_step(runner._place(batch))["pred"].cpu().numpy())
            images.append(batch["image"][..., 0])
            labels.append(batch["label"])
        grid = best_worst_contour_grid(np.concatenate(images), np.concatenate(labels),
                                       np.concatenate(preds), os.path.join(work, "grid.png"))
        with open(grid, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "the contour grid is not a PNG")
        contour = f"drawn ({os.path.getsize(grid)} bytes)"
    else:
        contour = "not drawn: matplotlib does not import on this machine"
    log(f"best_worst_contour_grid: {contour}")
    return dict(launches=got, expected=want, cache={k: v for k, v in cache.items()},
                loader_ms=loader, search_ms_per_step=search_ms,
                search_prefetch_wait_share=search["Train/prefetch_wait_share"],
                search_val_fetch_share=search["Train/val_fetch_share"], search_s=search_s,
                train_ms_per_step=train_ms,
                train_prefetch_wait_share=train["Train/prefetch_wait_share"],
                test=tested, submission_s=submit_s, contour_grid=contour)


# ---------------------------------------------------------------------------
# Phase 15: the other shipped configs' data paths
# ---------------------------------------------------------------------------

CHAOS_CONFIG = os.path.join(ROOT, "configs", "senas", "senas_chaos.yml")
HEART_CONFIG = os.path.join(ROOT, "configs", "senas", "senas_heart.yml")
# the phantoms: each dataset's own slice size, few cases. CHAOS CT: 512 x
# 512 int16 slices; CHAOS MR: 256 x 256 uint16 slices (T1DUAL in and out
# phase, T2SPIR); MSD heart: 320 x 320 MR volumes; MoNuSAC: RGB tiles
CHAOS_CT = dict(cases=4, slices=24, hw=512)
CHAOS_MR = dict(slices=8, hw=256)
HEART = dict(volumes=3, slices=16, hw=320)
MONUSAC = dict(images=12, hw=(300, 340))
DECODE_REPS = 10           # slices timed per reader


def _dicom_element(group, elem, vr, value: bytes) -> bytes:
    """An explicit-VR little-endian data element."""
    if len(value) % 2:
        value += b"\x00" if vr == b"UI" else b" "
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"UN", b"SQ", b"UT"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def write_dicom(path: str, pixels: np.ndarray, slope: float, intercept: float) -> None:
    """A CHAOS-like DICOM slice: preamble, file meta group (explicit VR
    little endian), SOP UIDs, the image pixel module with
    RescaleSlope/Intercept, and the 16-bit pixel data."""
    meta = _dicom_element(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    data = (_dicom_element(0x0008, 0x0016, b"UI", b"1.2.840.10008.5.1.4.1.1.2")
            + _dicom_element(0x0008, 0x0018, b"UI", b"1.2.826.0.1.3680043.2.1125.1")
            + _dicom_element(0x0028, 0x0002, b"US", struct.pack("<H", 1))
            + _dicom_element(0x0028, 0x0010, b"US", struct.pack("<H", pixels.shape[0]))
            + _dicom_element(0x0028, 0x0011, b"US", struct.pack("<H", pixels.shape[1]))
            + _dicom_element(0x0028, 0x0100, b"US", struct.pack("<H", 16))
            + _dicom_element(0x0028, 0x0103, b"US",
                             struct.pack("<H", int(pixels.dtype == np.int16)))
            + _dicom_element(0x0028, 0x1052, b"DS", repr(float(intercept)).encode())
            + _dicom_element(0x0028, 0x1053, b"DS", repr(float(slope)).encode())
            + _dicom_element(0x7FE0, 0x0010, b"OW", pixels.astype(pixels.dtype.newbyteorder("<"))
                             .tobytes()))
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM"
                + _dicom_element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)))
                + meta + data)


def write_nifti_gz(path: str, vol: np.ndarray) -> None:
    """A gzipped NIfTI-1 volume of int16 or uint8 `vol` [X, Y, Z]."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *vol.shape, 1, 1, 1, 1)
    struct.pack_into("<hh", hdr, 70, {np.dtype(np.int16): 4, np.dtype(np.uint8): 2}[vol.dtype],
                     8 * vol.itemsize)
    struct.pack_into("<4f", hdr, 76, 1.0, 1.25, 1.25, 1.37)
    struct.pack_into("<fff", hdr, 108, 352.0, 0.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4 + vol.astype(vol.dtype.newbyteorder("<"))
                .tobytes(order="F"))


def _organ(rng, h, w, scale=1.0):
    """A smooth field (-1..1) and an ellipse mask inside it."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * rng.uniform(0.4, 0.6), w * rng.uniform(0.35, 0.55)
    inside = (((yy - cy) / (h * rng.uniform(0.12, 0.2) * scale)) ** 2
              + ((xx - cx) / (w * rng.uniform(0.15, 0.25) * scale)) ** 2) < 1
    field = np.sin(yy / rng.uniform(15, 40)) * np.cos(xx / rng.uniform(15, 40))
    return field, inside


def write_shipped_phantoms(root: str, rng) -> dict:
    """CHAOS CT and MR, MSD Task02_Heart volumes and MoNuSAC tiles under
    `root`, in each dataset's layout; returns a few written arrays to check
    the readers against."""
    written = {}
    ct = os.path.join(root, "CHAOS", "CT_data_batch")
    n = CHAOS_CT["hw"]
    for case in range(CHAOS_CT["cases"]):
        d = os.path.join(ct, str(case + 1), "DICOM_anon")
        g = os.path.join(ct, str(case + 1), "Ground")
        os.makedirs(d)
        os.makedirs(g)
        for i in range(CHAOS_CT["slices"]):
            field, liver = _organ(rng, n, n, 0.6 + 0.5 * np.sin(np.pi * i / CHAOS_CT["slices"]))
            _, body = _organ(rng, n, n, 2.3)
            hu = np.where(body, 40 + 30 * field + 60 * liver, -1000) + 20 * rng.randn(n, n)
            raw = (hu + 1024).astype(np.int16)            # stored = HU - intercept
            write_dicom(os.path.join(d, f"IMG-{case + 1:04d}-{i + 1:05d}.dcm"), raw, 1.0,
                        -1024.0)
            write_png_l(os.path.join(g, f"liver_GT_{i:03d}.png"), 255.0 * liver)
            if case == i == 0:
                written["ct_raw"], written["ct_mask"] = raw, (255 * liver).astype(np.uint8)
    mr = os.path.join(root, "CHAOS", "MR_data_batch1", "1")
    m = CHAOS_MR["hw"]
    for series, dup in (("T1DUAL", True), ("T2SPIR", False)):
        d, g = os.path.join(mr, series, "DICOM_anon"), os.path.join(mr, series, "Ground")
        os.makedirs(d)
        os.makedirs(g)
        for i in range(CHAOS_MR["slices"]):
            field, liver = _organ(rng, m, m)
            _, kidney = _organ(rng, m, m, 0.4)
            px = np.clip(300 + 150 * field + 400 * liver + 30 * rng.randn(m, m), 0, None)
            write_dicom(os.path.join(d, f"IMG-0001-{i + 1:05d}.dcm"), px.astype(np.uint16),
                        1.0, 0.0)
            ident = "%03d" % ((i + 2) // 2) if dup else f"{i + 1:03d}"
            if not dup or i % 2 == 0:                     # in/out phase share a mask
                write_png_l(os.path.join(g, f"liver_{ident}.png"),
                            np.where(kidney, 160.0, np.where(liver, 80.0, 0.0)))
    task = os.path.join(root, "Task02_Heart")
    h = HEART["hw"]
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(task, sub))
    for v in range(HEART["volumes"]):
        vols, labs = [], []
        for _ in range(HEART["slices"]):
            field, atrium = _organ(rng, h, h, 0.7)
            vols.append(np.clip(200 + 150 * field + 500 * atrium + 40 * rng.randn(h, h),
                                0, 1600))
            labs.append(atrium)
        vol = np.stack(vols, -1).astype(np.int16)
        write_nifti_gz(os.path.join(task, "imagesTr", f"la_{v:03d}.nii.gz"), vol)
        write_nifti_gz(os.path.join(task, "labelsTr", f"la_{v:03d}.nii.gz"),
                       np.stack(labs, -1).astype(np.uint8))
        if v == 0:
            written["heart_slice0"] = vol[..., 0]
    mon = os.path.join(root, "MoNuSAC", "MoNuSAC_cleaned")
    os.makedirs(os.path.join(mon, "images"))
    os.makedirs(os.path.join(mon, "masks"))
    mh, mw = MONUSAC["hw"]
    for i in range(MONUSAC["images"]):
        field, nuclei = _organ(rng, mh, mw, 0.5)
        base = 180 + 40 * field - 90 * nuclei
        rgb = np.stack([base + 20, base - 30, base + 10], -1) + 8 * rng.randn(mh, mw, 3)
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        write_png(os.path.join(mon, "images", f"tile_{i:02d}.png"), rgb)
        write_png(os.path.join(mon, "masks", f"tile_{i:02d}.png"),
                  (255 * nuclei).astype(np.uint8))
        if i == 0:
            written["monusac_rgb"] = rgb
    return written


def _decode_ms(fn, paths) -> float:
    """Mean ms of fn(path) over up to DECODE_REPS of `paths`."""
    times = []
    for path in paths[:DECODE_REPS]:
        t0 = time.perf_counter()
        fn(path)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times))


def time_batches(dataset, bs: int, shape, labels) -> dict:
    """ms per augmented batch of `bs`, serial and with the default pool of
    threads; each batch of `shape` with labels within `labels`."""
    out = {}
    for workers in (0, None):
        loader = DataLoader(dataset, bs, shuffle=True, drop_last=True, workers=workers)
        it = iter(loader)
        times = []
        for _ in range(min(LOADER_BATCHES, len(loader))):
            t0 = time.perf_counter()
            batch = next(it)
            times.append((time.perf_counter() - t0) * 1e3)
        check(batch["image"].shape == shape and np.isfinite(batch["image"]).all()
              and set(np.unique(batch["label"])) <= set(labels),
              f"batch {batch['image'].shape} (want {shape}), labels "
              f"{np.unique(batch['label'])} (want within {labels})")
        out[f"workers{loader.workers}"] = float(np.mean(times))
    return out


def run_shipped_configs(dev, expect: dict, work: str, seed: int) -> dict:
    """The other shipped configs on phantoms in their own layouts: the
    readers checked and timed, the augmented loaders timed, search_arc on
    senas_chaos.yml for 1 epoch at full width (K1a-K1d launches held to the
    count), train_model on senas_heart.yml for 1 epoch and testing_model on
    its best checkpoint, and a batch of monusac and chaos_mr."""
    root = os.path.join(work, "data")
    t0 = time.perf_counter()
    written = write_shipped_phantoms(root, np.random.RandomState(seed + 15))
    phantom_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    extract_task(os.path.join(root, "Task02_Heart"))
    extract_s = time.perf_counter() - t0

    # the readers on this machine, against what was written
    ct_dir = os.path.join(root, "CHAOS", "CT_data_batch", "1")
    raw, slope, intercept = read_dicom_pixels(
        os.path.join(ct_dir, "DICOM_anon", "IMG-0001-00001.dcm"))
    check(np.array_equal(raw, written["ct_raw"]) and (slope, intercept) == (1.0, -1024.0),
          "the DICOM reader does not give back the written slice")
    check(np.array_equal(read_image(os.path.join(ct_dir, "Ground", "liver_GT_000.png"), "L"),
                         written["ct_mask"]), "the PNG reader does not give back the mask")
    heart_png = os.path.join(root, "Task02_Heart", "imagesTr", "la_000", "0.png")
    check(np.array_equal(read_image(heart_png, "L"),
                         float_to_l(written["heart_slice0"].astype(np.float64))),
          "the heart slice's PNG is not Pillow's F-to-L of the volume's slice")
    check(np.array_equal(read_nifti(os.path.join(root, "Task02_Heart", "imagesTr",
                                                 "la_000.nii.gz"))[..., 0],
                         written["heart_slice0"]), "the NIfTI reader does not give back "
          "the written volume")
    rgb = written["monusac_rgb"].astype(np.uint32)
    luma = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
    mon_png = os.path.join(root, "MoNuSAC", "MoNuSAC_cleaned", "images", "tile_00.png")
    check(np.array_equal(read_image(mon_png, "L"), luma), "MoNuSAC's luma is not Pillow's")

    dicoms = sorted(os.path.join(ct_dir, "DICOM_anon", f)
                    for f in os.listdir(os.path.join(ct_dir, "DICOM_anon")))
    masks = sorted(os.path.join(ct_dir, "Ground", f)
                   for f in os.listdir(os.path.join(ct_dir, "Ground")))
    heart_slices = [os.path.join(os.path.dirname(heart_png), f"{i}.png")
                    for i in range(HEART["slices"])]
    mon_dir = os.path.dirname(mon_png)
    tiles = sorted(os.path.join(mon_dir, f) for f in os.listdir(mon_dir))
    decode = {"chaos_dicom": _decode_ms(read_dicom_pixels, dicoms),
              "chaos_mask_png": _decode_ms(lambda p: read_image(p, "L"), masks),
              "heart_png": _decode_ms(lambda p: read_image(p, "L"), heart_slices),
              "monusac_rgb_png_as_l": _decode_ms(lambda p: read_image(p, "L"), tiles)}

    chaos = get_dataset("chaos", path=root, mode="train")
    heart = get_dataset("heart", path=root, mode="train")
    monusac = get_dataset("monusac", path=root, mode="train")
    chaos_mr = get_dataset("chaos_mr", path=root, mode="train")
    hh, hw = heart.spec.crop_size
    batches = {"chaos": time_batches(chaos, 8, (8, HW, HW, 1), {0, 1}),
               "heart": time_batches(heart, 12, (12, hh, hw, 1), {0, 1}),
               "monusac": time_batches(monusac, 8, (8, HW, HW, 1), {0, 1}),
               "chaos_mr": time_batches(chaos_mr, 8, (8, HW, HW, 1), {0, 1, 2, 3, 4})}
    log(f"shipped configs' phantoms written in {phantom_s:.2f} s ({CHAOS_CT}, {CHAOS_MR}, "
        f"{HEART}, {MONUSAC}); heart extraction {extract_s:.2f} s for "
        f"{HEART['volumes'] * HEART['slices']} slices; decode ms per slice {decode}; ms per "
        f"augmented batch {batches}")
    labels = np.unique(next(iter(DataLoader(chaos_mr, 8, workers=0)))["label"])
    check(len(labels) >= 2, f"the chaos_mr batch has labels {labels}")

    # search_arc on CHAOS at full width
    s = load_config(CHAOS_CONFIG)["searching"]
    same = ("init_channels", "depth", "meta_node_num", "double_down_channel",
            "deep_supervision")
    check(all(s[k] == load_config(CONFIG)["searching"][k] for k in same),
          f"senas_chaos.yml's search geometry differs from {CONFIG}'s")
    n = len(chaos)
    split = int(np.floor(s["train_portion"] * n))
    steps, val_batches = split // s["batch_size"], (n - split) // s["batch_size"]
    do_arch = s["alpha_begin"] <= 0
    want = {k: steps * per_step(expect, do_arch)[k] + val_batches * expect["eval"][k]
            for k in KERNELS}
    log_root = os.path.join(work, "logs")
    reset_counts()
    t0 = time.perf_counter()
    out = _in_process(search_arc.main, "--config", CHAOS_CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    search_s = time.perf_counter() - t0
    got = counts()
    log(f"search_arc on CHAOS CT: {steps} steps (do_arch={do_arch}) and {val_batches} eval "
        f"batches of {s['batch_size']}; launches {got}, expected {want}")
    check(got == want, f"search_arc on CHAOS launched {got}, expected {want}")
    search = _scalars(_run_dir(out))
    check(all(np.isfinite(v) for v in search.values()), f"CHAOS search scalars {search}")
    search_ms = 1e3 / search["Train/steps_per_sec"]

    # train_model and testing_model on the heart volumes
    t = load_config(HEART_CONFIG)["training"]
    reset_counts()
    out = _in_process(train_model.main, "--config", HEART_CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    train_dir = _run_dir(out)
    train = _scalars(train_dir)
    check(all(np.isfinite(v) for v in train.values()), f"heart train scalars {train}")
    train_ms = 1e3 / train["Train/steps_per_sec"]
    ckpt = os.path.join(train_dir, "ckpt")
    out = _in_process(testing_model.main, "--config", HEART_CONFIG, "--data_root", root,
                      "--resume", ckpt, "--log_root", log_root, "--batch_size",
                      str(t["batch_size"]))
    tested = ast.literal_eval(out.strip().splitlines()[-1])
    check(abs(tested["dice"] - train["Val/dice"]) <= 0.01,
          f"testing_model dice {tested['dice']} on heart, the run's {train['Val/dice']}")
    fixed_launches = counts()
    check(not any(fixed_launches.values()), f"the heart CLIs launched {fixed_launches}")
    log(f"shipped configs: CHAOS search {search_ms:.2f} ms/step, prefetch wait "
        f"{search['Train/prefetch_wait_share']:.4f}, val fetch "
        f"{search['Train/val_fetch_share']:.4f}, {search_s:.1f} s in all; heart train "
        f"{train_ms:.2f} ms/step (batch {t['batch_size']} of {hh}x{hw}), prefetch wait "
        f"{train['Train/prefetch_wait_share']:.4f}; heart test dice {tested['dice']:.4f}")
    return dict(launches=got, expected=want, phantom_s=phantom_s, extract_s=extract_s,
                decode_ms=decode, batch_ms=batches, search_ms_per_step=search_ms,
                search_prefetch_wait_share=search["Train/prefetch_wait_share"],
                search_val_fetch_share=search["Train/val_fetch_share"], search_s=search_s,
                train_ms_per_step=train_ms,
                train_prefetch_wait_share=train["Train/prefetch_wait_share"], test=tested)


# ---------------------------------------------------------------------------
# Phase 16: the baseline zoo
# ---------------------------------------------------------------------------

ZOO_MODELS = ("nasunet", "unet", "unet_plus_plus", "manet", "linknet", "fpn", "pspnet", "pan",
              "deeplab_v3_plus")
# pspnet at smp's own depth 3: at depth 5 its logits are 4x smaller than
# the labels (upsampling 8 over a stride-32 encoder). DeepLabV3+ keeps depth
# 5 whatever depth says (the factory's rule in both packages).
ZOO_DEPTH = {"pspnet": 3}
# the card-vs-CPU step, batch 2: (depth, side); PAN's pyramid attention
# pools its deepest map three times, so it needs an 8x8 one
ZOO_SMALL = {"pspnet": (3, 64), "pan": (5, 128)}
ZOO_SMALL_DEFAULT = (4, 64)
# The step on the card against the CPU in f32 (TF32 off) and in f64. f32
# carries no closer: on the CPU alone an f64 run of the same step is up to
# 5.2e-3 (manet: PAB's softmax over the whole HW x HW map) off the f32 one
# in the weight update and 1.6e-4 in the gradient norm. In f64 the two
# devices must compute the same function.
ZOO_CPU_LIMITS = {"float32": dict(loss=1e-5, grad_norm=1e-3, weights=2e-2, bn_stats=1e-4),
                  "float64": dict(loss=1e-12, grad_norm=1e-10, weights=1e-8, bn_stats=1e-12)}
SMP_LOSSES = ("smp_dice", "smp_jaccard", "smp_tversky", "smp_focal", "smp_lovasz", "smp_soft_ce")
# full-size logits on the card against the CPU (sums over 786k pixels in
# other orders)
SMP_LOSS_REL = 1e-4


def _zoo_model(name, depth, dev, gen, dtype=None):
    return get_segmentation_model(name, dataset="promise12", depth=depth, device=dev,
                                  generator=gen, dtype=dtype)


# senas_tpu's align-corners resizes keep f32 weights, so these two models
# give f32 logits from a bf16 model; the other seven bf16 ones
ZOO_F32_LOGITS = ("fpn", "pan")


# profiled: the smallest host-bound step (deeplab_v3_plus), a conv-heavy one
# (unet), and fpn, whose eval batch cost more than its train step in f32
ZOO_PROFILED = ("unet", "fpn", "deeplab_v3_plus")


def _logits_dtype(name, dtype):
    return torch.float32 if dtype is None or name in ZOO_F32_LOGITS else dtype


def run_zoo_path(dev, seed: int, dtype=None) -> dict:
    """The nine zoo models at the promise12 `training:` geometry in `dtype`
    (None: f32): 1 + 3 train steps, then the eval step on 3 batches; the
    ZOO_PROFILED models' step once more under torch.profiler. No kernel of
    the port is on this path."""
    t = load_config(CONFIG)["training"]
    bs, loss_fn = t["batch_size"], _fixed_loss(t)
    rng = np.random.RandomState(seed + 16)
    train_batches = _batches(rng, FIXED_STEPS, bs, HW, dev)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    reset_counts()
    rows, unet_state = {}, None
    tag = "zoo" if dtype is None else "bf16 zoo"
    for name in ZOO_MODELS:
        depth = ZOO_DEPTH.get(name, t["depth"])
        model = _zoo_model(name, depth, dev, torch.Generator().manual_seed(seed + 16), dtype)
        state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
        step = make_train_step(loss_fn, grad_clip=t["grad_clip"])
        evaluate = make_eval_step(model, loss_fn)
        first = {k: p.detach().clone() for k, p in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i, batch in enumerate(train_batches):
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            vals = {k: float(m[k]) for k in ("loss", "grad_norm")}
            check(all(np.isfinite(v) for v in vals.values()), f"{name} train step {i}: {vals}")
            losses.append(vals["loss"])
        # a leaf may stay: a zero-initialised bias whose ReLU unit is dead
        # on these batches gets no gradient and no decay (nasunet's SE gates)
        moved = sum(not torch.equal(first[k], p) for k, p in model.named_parameters())
        check(moved >= 0.95 * len(first), f"{name}: {len(first) - moved} of {len(first)} "
                                          "weight leaves did not move in 4 steps")
        eval_times = []
        for i, batch in enumerate(eval_batches):
            t0 = time.perf_counter()
            m = evaluate(batch)
            torch.cuda.synchronize()
            eval_times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(float(m["loss"])) and m["pred"].dtype == torch.uint8
                  and tuple(m["pred"].shape) == (bs, HW, HW),
                  f"{name} eval batch {i}: loss {float(m['loss'])}, pred "
                  f"{m['pred'].dtype} {tuple(m['pred'].shape)}")
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode():
            out = model(eval_batches[0]["image"], train=False)
        check(isinstance(out, list) and len(out) == 1, f"{name} returned {type(out)}")
        shape = tuple(out[0].shape)
        check(shape == (bs, HW, HW, NCLASS) and bool(torch.isfinite(out[0]).all()),
              f"{name} logits {shape}")
        check(out[0].dtype == _logits_dtype(name, dtype)
              and all(p.dtype == torch.float32 for p in model.parameters()),
              f"{tag} {name}: logits {out[0].dtype}, or weights not f32")
        depth = getattr(model, "encoder", model).depth   # deeplab_v3_plus: always 5
        row = dict(depth=depth, parameters=sum(p.numel() for p in model.parameters()),
                   step_ms=float(np.mean(times[1:])), first_ms=times[0],
                   eval_ms=float(np.mean(eval_times[1:])), peak_mib=peak / 2**20,
                   out_shape=list(shape), out_dtype=str(out[0].dtype), losses=losses,
                   leaves_moved=[moved, len(first)])
        log(f"{tag} {name} (depth {depth}, {row['parameters']} parameters): "
            f"{row['step_ms']:.2f} ms/step (first {times[0]:.2f}), eval "
            f"{row['eval_ms']:.2f} ms/batch, peak {row['peak_mib']:.1f} MiB, logits {shape}, "
            f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, {moved} of {len(first)} weight leaves "
            f"moved, logits {out[0].dtype}")
        if name in ZOO_PROFILED:
            row["profile"] = profile(lambda: step(state, train_batches[-1]),
                                     f"one {tag} {name} train step, batch {bs}")
        if name == "unet":
            unet_state = state
        rows[name] = row
        del model, state, step, evaluate, first
        torch.cuda.empty_cache()
    got = counts()
    check(not any(got.values()), f"the {tag} path launched {got}")
    return dict(launches=got, models=rows, unet_state=unet_state)


def _zoo_snapshot(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def zoo_card_vs_cpu(dev, seed: int) -> dict:
    """Each zoo model's train step on the card and on the CPU from one state
    and batch of 2, in f32 (TF32 off) and in f64, with one CPU dropout
    generator (the same ASPP mask on both)."""
    t = load_config(CONFIG)["training"]
    rows = {}
    for name in ZOO_MODELS:
        depth, hw = ZOO_SMALL.get(name, ZOO_SMALL_DEFAULT)
        model0 = _zoo_model(name, depth, "cpu", torch.Generator().manual_seed(seed + 17))
        state0 = model0.state_dict()
        batch = _batches(np.random.RandomState(seed + 17), 1, 2, hw, "cpu")[0]
        for dtype in (torch.float32, torch.float64):
            def run_on(d):
                model = _zoo_model(name, depth, d, None)
                model.load_state_dict({k: v.to(d) for k, v in state0.items()})
                model.to(dtype)
                state = FixedTrainState.create(model, t["model_optimizer"], seed=seed,
                                               rng=torch.Generator())
                before = _zoo_snapshot(model)
                m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                    state, {"image": batch["image"].to(d, dtype), "label": batch["label"].to(d)})
                return before, {k: m[k].cpu() for k in ("loss", "grad_norm")}, _zoo_snapshot(model)

            before, m_cpu, after_cpu = run_on("cpu")
            _, m_card, after_card = run_on(dev)
            params = [k for k in after_cpu if k.rsplit(".", 1)[-1] not in ("mean", "var")]
            stats = [k for k in after_cpu if k not in params]
            rel = dict(**_metrics_rel(m_card, m_cpu, ("loss", "grad_norm")),
                       weights=_update_rel(before, after_card, after_cpu, params),
                       bn_stats=max((float((after_card[k] - after_cpu[k]).abs().max()
                                           / after_cpu[k].abs().max().clamp_min(1.0))
                                     for k in stats), default=0.0))
            kind = str(dtype).replace("torch.", "")
            limits = ZOO_CPU_LIMITS[kind]
            rows.setdefault(name, {})[kind] = rel
            check(all(rel[k] <= limits[k] for k in limits),
                  f"{name} {kind} step, card vs CPU: {rel} (limits {limits})")
        log(f"zoo {name} step card vs CPU (depth {getattr(model0, 'encoder', model0).depth}, "
            f"{hw}x{hw}, batch 2): {rows[name]} (limits {ZOO_CPU_LIMITS})")
    return rows


def run_zoo_clis() -> dict:
    """train_model --model unet and --model nasunet on senas_synthetic.yml,
    then testing_model on each one's best checkpoint, in this process (each
    subprocess would spend ~8 s reaching the card)."""
    cfg = load_config(RUNNER_CONFIG)
    epochs, out = cfg["training"]["epoch"], {}
    with tempfile.TemporaryDirectory() as log_root:
        for name in ("unet", "nasunet"):
            stdout = _in_process(train_model.main, "--config", RUNNER_CONFIG, "--model",
                                 name, "--log_root", log_root)
            run_dir = _run_dir(stdout)
            best = ast.literal_eval(stdout.split("best: ")[1].splitlines()[0])
            check(_val_epochs(run_dir) == list(range(epochs)),
                  f"train_model --model {name} ran epochs {_val_epochs(run_dir)}")
            stdout = _in_process(testing_model.main, "--config", RUNNER_CONFIG, "--model",
                                 name, "--resume", os.path.join(run_dir, "ckpt"), "--log_root",
                                 log_root, "--batch_size", str(cfg["training"]["batch_size"]))
            result = ast.literal_eval(stdout.strip().splitlines()[-1])
            # the 0.01 points of phase 11: other cuDNN algorithms may flip a pixel
            check(abs(result["dice"] - best["best_dice"]) <= 0.01,
                  f"testing_model --model {name} dice {result['dice']}, the run's best "
                  f"{best['best_dice']}")
            out[name] = dict(best=best, test=result)
            log(f"zoo CLIs, {name}: {epochs} epochs, best {best}; testing_model {result}")
    return out


def run_zoo_serve(dev, state, seed: int, work: str) -> dict:
    """Phase 16's trained unet saved and exported by `export_model --model
    unet --check --f32`, served at batch 1 and 12 on the card."""
    model = state.model
    ckpt = CheckpointManager(os.path.join(work, "zoo_ckpt"))
    ckpt.save(state, {"epoch": 1, "model_name": "unet"}, is_best=True)
    art = os.path.join(work, "zoo_artifact")
    out = _in_process(export_model.main, "--config", CONFIG, "--model", "unet", "--resume",
                      ckpt.directory, "--out", art, "--check", "--f32")
    check("check OK" in out, "export_model --model unet --check did not pass")
    pred = Predictor(art, device=dev)
    check(pred.meta["model"] == "unet", f"artifact meta {pred.meta}")
    x_all = np.random.RandomState(seed + 18).randn(12, HW, HW, IN_CHANNELS).astype(np.float32)
    errs = {}
    for b in (1, 12):
        with deterministic_cudnn():
            got = pred.logits(x_all[:b])
            with torch.inference_mode():
                want = model(torch.from_numpy(x_all[:b]).to(dev), train=False)[-1]
        check(tuple(got.shape) == (b, HW, HW, NCLASS), f"served unet logits {tuple(got.shape)}")
        errs[b] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **SERVE_TOL)
    ms = {b: _request_ms(pred, x_all[:b]) for b in (1, 12)}
    log(f"zoo serving (unet): batch 1 {ms[1]['mean']:.3f} ms/request (p50 {ms[1]['p50']:.3f}), "
        f"batch 12 {ms[12]['mean']:.3f} ms/request (p50 {ms[12]['p50']:.3f}); served vs eager "
        f"max abs err {errs} (limit {SERVE_TOL})")
    return dict(ms=ms, errs=errs)


def run_smp_losses(dev, seed: int) -> dict:
    """The six smp_* losses on one batch of full-size logits (12 x 256 x 256
    x 2) on the card against the CPU: values, and input gradients but for
    Lovasz, whose gradient follows the order of its sorted errors, and
    a sort of 786k f32 errors computed on two devices breaks ties apart."""
    rs = np.random.RandomState(seed + 19)
    logits = rs.randn(12, HW, HW, NCLASS).astype(np.float32)
    labels = (rs.rand(12, HW, HW) > 0.7).astype(np.int64)
    out = {}
    for name in SMP_LOSSES:
        fn = build_loss(name)
        res = {}
        for d in ("cpu", dev):
            x = torch.tensor(logits, device=d, requires_grad=True)
            v = fn([x], torch.from_numpy(labels).to(d))
            v.backward()
            res[str(d)] = (float(v.detach()), x.grad.cpu())
        (v_cpu, g_cpu), (v_card, g_card) = res["cpu"], res[str(dev)]
        rel = abs(v_card - v_cpu) / max(abs(v_cpu), 1e-30)
        grad_rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
        xd, ld = torch.tensor(logits, device=dev), torch.from_numpy(labels).to(dev)
        ms = time_ms(lambda: fn([xd], ld), reps=10, warmup=2)
        check(np.isfinite(v_card) and rel <= SMP_LOSS_REL, f"{name}: card {v_card}, CPU {v_cpu}")
        if name != "smp_lovasz":
            check(grad_rel <= SMP_LOSS_REL, f"{name} input gradient, card vs CPU: {grad_rel}")
        out[name] = dict(value=v_card, rel=rel, grad_rel=grad_rel, ms=ms)
        log(f"{name} on 12x{HW}x{HW}x{NCLASS} logits: {v_card:.6f} (CPU {v_cpu:.6f}, rel "
            f"{rel:.3g}; input gradient rel {grad_rel:.3g}), {ms:.3f} ms on the card")
    return out


def run_zoo(dev, seed: int) -> dict:
    """Phase 16, timed."""
    t0 = time.perf_counter()
    path = run_zoo_path(dev, seed)
    cpu = zoo_card_vs_cpu(dev, seed)
    clis = run_zoo_clis()
    with tempfile.TemporaryDirectory() as work:
        serve = run_zoo_serve(dev, path.pop("unet_state"), seed, work)
    losses = run_smp_losses(dev, seed)
    seconds = time.perf_counter() - t0
    log(f"phase 16 (the baseline zoo): {seconds:.1f} s")
    return dict(path, card_vs_cpu=cpu, clis=clis, serve=serve, losses=losses, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 17: bf16 (`precision: bf16`)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# A bf16 kernel output against its plain twin on the same tensors: equal
# but on at most this share of the elements, each of those within one bf16
# ulp, or within 2^-21 of the sum of its terms' magnitudes where the f32
# sum cancels (the kernel fuses each multiply-add, PyTorch rounds the
# product first). The f32 sums keep phase 3's bound (1e-5 of the plane's
# sum of magnitudes).
BF16_SHARE = 1e-3
# The epilogue's bf16 gradients against autograd through the plain
# two-pass reference in f32 on the same bf16 branch tensors: the bf16
# cotangent and the bf16 branch gradients round (2^-9 each).
BF16_GRAD_REL = 2e-2


def _bf16_err(got: torch.Tensor, want: torch.Tensor, terms: torch.Tensor) -> tuple:
    """(share of differing elements, the worst difference in units of its
    allowance: max(one bf16 ulp, 2^-21 of `terms`), the largest absolute
    difference); fails over the bound."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7)
    share = (diff > 0).double().mean().item()
    worst = (diff / torch.maximum(ulp, terms.double() * 2.0 ** -21)).max().item()
    check(got.dtype == want.dtype == BF16 and share <= BF16_SHARE and worst <= 1.0,
          f"bf16 output: {share:.3g} of the elements differ, worst {worst:.3g} of the allowance")
    return share, worst, diff.max().item()


def check_kernels_bf16(dev, f32: dict) -> dict:
    """K1a-K1d on bf16 branch tensors (and a bf16 cotangent) against their
    plain twins on the card, at the supernet's group shapes in train- and
    eval-mode operands; the epilogue's gradients; times at each shape beside
    the f32 variant's (phase 3, `f32`) and the bf16 byte bound."""
    names = [name for name, _ in _TIMED]
    records = {name: {"timed": []} for name in names}
    worst = {name: 0.0 for name in names}
    worst.update(stats_rel=0.0, reduce_rel=0.0, grad_rel=0.0, share=0.0, mix_allowance=0.0,
                 dx_allowance=0.0)
    for h in KERNEL_HW:
        for n, se, none in ((6, True, False), (5, False, True)):
            b, planes = 8, 8 * GROUP_C
            for train in (True, False):
                args, kw = _group_inputs(dev, n, h, seed=h + n + 7, train=train, se=se, none=none)
                args = ([x.to(BF16) for x in args[0]], *args[1:])
                xs = args[0]
                xf = [x.float() for x in xs]
                s1, s2 = ge.branch_stats(xs)
                p1, p2 = ge.branch_stats_plain(xs)
                abs1 = torch.stack([x.abs().sum(dim=(2, 3)) for x in xf])
                rel = max(((s1 - p1).abs() / abs1).max().item(),
                          ((s2 - p2).abs() / p2).max().item())
                check(rel <= 1e-5, f"branch_stats (bf16) disagrees: rel {rel:.3g}")
                a = torch.randn(n, b, GROUP_C, device=dev)
                k = torch.randn(b, GROUP_C, device=dev)
                col = lambda t: t.abs()[:, :, None, None]
                share2, w2, err2 = _bf16_err(
                    ge.apply_mix(xs, a, k), ge.apply_mix_plain(xs, a, k),
                    col(k) + sum(x.abs() * col(a[o]) for o, x in enumerate(xf)))
                g = torch.randn(b, GROUP_C, h, h, device=dev).to(BF16)
                gf = g.float()
                da, dk = ge.bwd_reduce(xs, g)
                pa, pk = ge.bwd_reduce_plain(xs, g)
                abs_a = torch.stack([(gf * x).abs().sum(dim=(2, 3)) for x in xf])
                rel_c = max(((da - pa).abs() / abs_a).max().item(),
                            ((dk - pk).abs() / gf.abs().sum(dim=(2, 3))).max().item())
                check(rel_c <= 1e-5, f"bwd_reduce (bf16) disagrees: rel {rel_c:.3g}")
                ds1 = torch.randn(n, b, GROUP_C, device=dev)
                ds2 = torch.randn(n, b, GROUP_C, device=dev)
                share5, w5, err5 = 0.0, 0.0, 0.0
                for o, (got, want) in enumerate(zip(ge.bwd_dx(xs, g, a, ds1, ds2),
                                                    ge.bwd_dx_plain(xs, g, a, ds1, ds2))):
                    sh, w_, e_ = _bf16_err(got, want, gf.abs() * col(a[o]) + col(ds1[o])
                                           + 2 * xf[o].abs() * col(ds2[o]))
                    share5, w5, err5 = max(share5, sh), max(w5, w_), max(err5, e_)
                err6 = _epilogue_grad_err(args, kw, g.float(), ref_dtype=torch.float32)
                check(err6 <= BF16_GRAD_REL, f"bf16 epilogue gradients disagree: rel {err6:.3g}")
                torch.cuda.synchronize()
                for key, v in (("stats_rel", rel), ("branch_stats", (s1 - p1).abs().max().item()),
                               ("apply_mix", err2), ("mix_allowance", w2), ("reduce_rel", rel_c),
                               ("bwd_reduce", (da - pa).abs().max().item()), ("bwd_dx", err5),
                               ("dx_allowance", w5), ("grad_rel", err6),
                               ("share", max(share2, share5))):
                    worst[key] = max(worst[key], v)
                log(f"  bf16 h={h:3d} n={n} train={train!s:5}: stats rel {rel:.3g} | mix share "
                    f"{share2:.3g} worst {w2:.3g} | bwd_reduce rel {rel_c:.3g} | bwd_dx share "
                    f"{share5:.3g} worst {w5:.3g} | grads rel {err6:.3g}")

            args, kw = _group_inputs(dev, n, h, seed=1, train=True, se=se, none=none)
            xs = [x.to(BF16) for x in args[0]]
            a = torch.rand(n, b, GROUP_C, device=dev)
            k = torch.rand(b, GROUP_C, device=dev)
            g = torch.randn(b, GROUP_C, h, h, device=dev).to(BF16)
            ds1, ds2 = (torch.randn(n, b, GROUP_C, device=dev) for _ in range(2))
            elems = n * planes * h * h
            plane_bytes = planes * h * h * 2          # one [8,24,h,h] bf16 tensor
            nbytes = dict(
                stats=n * plane_bytes + 2 * n * planes * 4,
                mix=n * plane_bytes + (n + 1) * planes * 4 + plane_bytes,
                reduce=(n + 1) * plane_bytes + (n + 1) * planes * 4,
                dx=(2 * n + 1) * plane_bytes + 3 * n * planes * 4)
            flops = dict(stats=3 * elems, mix=2 * elems, reduce=2 * elems + elems // n,
                         dx=4 * elems)
            t = dict(
                stats=time_ms(lambda: ge.branch_stats(xs)),
                stats_plain=time_ms(lambda: ge.branch_stats_plain(xs)),
                mix=time_ms(lambda: ge.apply_mix(xs, a, k)),
                mix_plain=time_ms(lambda: ge.apply_mix_plain(xs, a, k)),
                reduce=time_ms(lambda: ge.bwd_reduce(xs, g)),
                reduce_plain=time_ms(lambda: ge.bwd_reduce_plain(xs, g)),
                dx=time_ms(lambda: ge.bwd_dx(xs, g, a, ds1, ds2)),
                dx_plain=time_ms(lambda: ge.bwd_dx_plain(xs, g, a, ds1, ds2)),
            )
            bound = {key: max(nbytes[key] / PEAK_BYTES_PER_S, flops[key] / PEAK_F32_FLOPS) * 1e3
                     for key in nbytes}
            f32_ms = {name: next(r["ms"] for r in f32[name]["timed"] if r["shape"][2] == h
                                 and r["n"] == n) for name in names}
            log(f"  bf16 times [8,{GROUP_C},{h},{h}] n={n} (ms / plain / bound / f32 ms): "
                + " | ".join(f"{name} {t[key]:.4f} / {t[key + '_plain']:.4f} / {bound[key]:.4f}"
                             f" / {f32_ms[name]:.4f}" for name, key in _TIMED))
            for name, key in _TIMED:
                rec = dict(shape=[8, GROUP_C, h, h], n=n, ms=t[key], plain_ms=t[f"{key}_plain"],
                           bound_ms=bound[key], f32_ms=f32_ms[name])
                records[name]["timed"].append(rec)
                if (h, n) == (KERNEL_HW[0], 6):
                    records[name].update(ms=rec["ms"], plain_ms=rec["plain_ms"],
                                         bound_ms=rec["bound_ms"], f32_ms=rec["f32_ms"])
    for name in names:
        records[name]["max_abs_err"] = worst[name]
    records["branch_stats"]["max_rel_err"] = worst["stats_rel"]
    records["bwd_reduce"]["max_rel_err"] = worst["reduce_rel"]
    for name, key in (("apply_mix", "mix_allowance"), ("bwd_dx", "dx_allowance")):
        records[name].update(max_share_differing=worst["share"], max_of_allowance=worst[key])
    log(f"bf16 kernels agree with their plain versions (worst: {worst}; the allowances: "
        "one bf16 ulp, or 2^-21 of the terms' magnitudes)")
    return {name + BF16_SUFFIX: r for name, r in records.items()}


def _bf16_steps(dev, label: str, step_fn, batches: list, do_arch: tuple, want_fn) -> dict:
    """Runs the steps, each with its launches checked against want_fn(i);
    host-clock ms of each and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    total = {name: 0 for name in KERNELS}
    times = []
    for i, (batch, flag) in enumerate(zip(batches, do_arch)):
        reset_counts()
        t0 = time.perf_counter()
        m = step_fn(batch, flag)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(got == want_fn(flag), f"{label} {i}: launched {got}, expected {want_fn(flag)}")
        add_counts(total, got)
        vals = {k: float(m[k]) for k in ("loss", "arch_loss", "grad_norm", "acc") if k in m}
        check(all(np.isfinite(v) for v in vals.values()), f"{label} {i}: {vals}")
        log(f"bf16 {label} {i}: {vals} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    steady = times[1:] or times
    log(f"bf16 {label}: {np.mean(steady):.2f} ms (after the first: "
        f"{[round(x, 2) for x in steady]}; first {times[0]:.2f}), peak memory "
        f"{peak / 2**20:.1f} MiB")
    return dict(launches=total, ms=float(np.mean(steady)), first_ms=times[0],
                peak_mib=peak / 2**20)


def run_bf16_search_path(dev, seed: int) -> dict:
    """The supernet in bf16 at the senas_promise12.yml `searching:`
    geometry: 1 search step with do_arch=False and 3 with, the bf16
    variants' launches held to the model's count and the f32 ones' to 0;
    one step under torch.profiler; the search-eval step on 3 batches, one
    of them profiled."""
    s = load_config(CONFIG)["searching"]
    meta, depth, bs = s["meta_node_num"], s["depth"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed + 21)
    model = _supernet(s, dev, gen, BF16)
    arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"], generator=gen, device=dev)
    state = SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])
    normalize = lambda a: normalize_arch(a, meta)
    loss = build_loss(s["loss"]["name"], s["deep_supervision"])
    step = make_search_step(normalize, loss, grad_clip=s["grad_clip"])
    expect = expected_launches(model, BF16_SUFFIX)
    rng = np.random.RandomState(seed + 21)
    pairs = [tuple(_batches(rng, 2, bs, HW, dev)) for _ in DO_ARCH]
    with torch.no_grad():
        logits = model(pairs[0][0]["image"], normalize(arch), train=False)[0]
    check(logits.dtype == BF16 and all(p.dtype == torch.float32 for p in model.parameters())
          and all(t.dtype == torch.float32 for t in arch.values()),
          f"bf16 supernet: logits {logits.dtype}, weights or arch tables not f32")
    log(f"bf16 search step: batch {bs} train + {bs} val, {HW}x{HW}; expected launches per "
        f"step: do_arch=True {per_step(expect, True)}")
    search = _bf16_steps(dev, "search step", lambda p, d: step(state, p[0], p[1], d), pairs,
                         DO_ARCH, lambda d: per_step(expect, d))
    tb, vb = pairs[-1]
    search["profile"] = profile(lambda: step(state, tb, vb, True),
                                f"one bf16 search step, do_arch, batch {bs}")
    evaluate = make_search_eval_step(model, normalize, loss)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    ev = _bf16_steps(dev, "search-eval batch", lambda b, _: evaluate(arch, b), eval_batches,
                     (None,) * N_BATCHES, lambda _: expect["eval"])
    ev["profile"] = profile(lambda: evaluate(arch, eval_batches[-1]),
                            f"one bf16 search-eval step, batch {bs}")
    return dict(search=search, eval=ev, expect=expect)


def run_bf16_fixed_path(dev, seed: int) -> dict:
    """SenasModel(senas) in bf16 at the `training:` geometry: 1 + 3 train
    steps, one under torch.profiler, and the eval step on 3 batches; the
    fixed model launches none of the kernels."""
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed + 23), BF16)
    state = FixedTrainState.create(model, t["model_optimizer"])
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    evaluate = make_eval_step(model, _fixed_loss(t))
    rng = np.random.RandomState(seed + 23)
    train_batches = _batches(rng, FIXED_STEPS, bs, HW, dev)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    none = {name: 0 for name in KERNELS}
    train = _bf16_steps(dev, "fixed train step", lambda b, _: step(state, b), train_batches,
                        (None,) * FIXED_STEPS, lambda _: none)
    train["profile"] = profile(lambda: step(state, train_batches[-1]),
                               f"one bf16 fixed train step, batch {bs}")
    with torch.no_grad():
        logits = model(eval_batches[0]["image"], train=False)[0]
    check(logits.dtype == BF16 and all(p.dtype == torch.float32 for p in model.parameters()),
          f"bf16 fixed model: logits {logits.dtype}, weights not f32")

    def eval_step(batch, _):
        m = evaluate(batch)
        check(m["pred"].dtype == torch.uint8 and tuple(m["pred"].shape) == (bs, HW, HW),
              f"bf16 eval pred {m['pred'].dtype} {tuple(m['pred'].shape)}")
        return m

    ev = _bf16_steps(dev, "fixed eval batch", eval_step, eval_batches, (None,) * N_BATCHES,
                     lambda _: none)
    return dict(train=train, eval=ev)


def _stats_l2(before: dict, a: dict, b: dict) -> float:
    """Relative L2 distance of two states' BN running stats (all of them)."""
    keys = [k for k in b["model"] if k.rsplit(".", 1)[-1] in ("mean", "var")]
    num = sum(float(((a["model"][k] - b["model"][k]).double() ** 2).sum()) for k in keys)
    den = sum(float((b["model"][k].double() ** 2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def _bf16_bound(before: dict, runs: dict, metric_keys, parts) -> dict:
    """The CPU tests' bound with the CPU as the reference: each update (and
    the running stats) of the card's bf16 step lies at most twice as far
    (relative L2) from the CPU's bf16 step as that lies from the CPU's f32
    step, plus 1e-6; each metric (a scalar that sums up the step) within
    twice the CPU's bf16 error of the weight update. The control: the card's
    bf16 step fails phase 7's f32 card-vs-CPU limits against its f32 one."""
    params = [k for k in before["model"] if k.rsplit(".", 1)[-1] not in ("mean", "var")]
    keys = dict(weights=("model", params), arch=("arch", list(before["arch"])))
    out = {}
    for part in parts:
        where, ks = keys[part]
        after = {k: runs[k][1][where] for k in runs}
        gap = _update_rel(before[where], after["card_bf16"], after["cpu_bf16"], ks)
        own = _update_rel(before[where], after["cpu_bf16"], after["cpu_f32"], ks)
        out[part] = (gap, own)
    gap = _stats_l2(before, runs["card_bf16"][1], runs["cpu_bf16"][1])
    own = _stats_l2(before, runs["cpu_bf16"][1], runs["cpu_f32"][1])
    out["bn_stats"] = (gap, own)
    for k in metric_keys:
        a, b = float(runs["card_bf16"][0][k]), float(runs["cpu_bf16"][0][k])
        out[k] = (abs(a - b) / max(abs(b), 1e-30), out["weights"][1])
    for k, (gap, own) in out.items():
        check(gap <= 2 * own + 1e-6, f"bf16 card vs CPU: {k} {gap:.3g} over twice {own:.3g}")
    control_m = _metrics_rel(runs["card_bf16"][0], runs["card_f32"][0], metric_keys)
    control_s = _state_rel(before, runs["card_bf16"][1], runs["card_f32"][1])
    if "arch" not in parts:
        control_s["arch"] = 0.0
    check(not _within(control_m, control_s),
          f"the card's bf16 step lies within phase 7's f32 limits of its f32 step: "
          f"{control_m} {control_s}")
    return dict(bound={k: dict(gap=g, own=o) for k, (g, o) in out.items()},
                control=dict(metrics=control_m, state=control_s))


def bf16_card_vs_cpu(dev, seed: int) -> dict:
    """One search step (do_arch) and one fixed train step from identical
    state at phases 7 and 10's reduced size (depth 3, c 8, 64x64, batch 2),
    in bf16 and in f32, on the card and on the CPU."""
    s = dict(load_config(CONFIG)["searching"], depth=3, init_channels=8)
    meta = s["meta_node_num"]
    gen = torch.Generator().manual_seed(seed + 25)
    model0 = _supernet(s, "cpu", gen).state_dict()
    arch0 = init_arch_params(meta, 3, use_sharing=False, generator=gen, device="cpu")
    tb, vb = _batches(np.random.RandomState(seed + 25), 2, 2, 64, "cpu")
    to_cpu = lambda snap: {k: ({kk: vv.cpu() for kk, vv in v.items()}
                               if k in ("model", "arch") else v) for k, v in snap.items()}

    def search_on(d, dtype):
        model = _supernet(s, d, None, dtype)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        state = SearchTrainState.create(model, {k: v.clone().to(d) for k, v in arch0.items()},
                                        s["model_optimizer"], s["arch_optimizer"])
        m = make_search_step(lambda a: normalize_arch(a, meta), build_loss(s["loss"]["name"]),
                             grad_clip=s["grad_clip"])(
            state, {k: v.to(d) for k, v in tb.items()}, {k: v.to(d) for k, v in vb.items()}, True)
        return {k: v.cpu() for k, v in m.items()}, to_cpu(_snapshot(state))

    t = dict(load_config(CONFIG)["training"], depth=3, init_channels=8)
    fixed0 = _fixed_model(t, "cpu", torch.Generator().manual_seed(seed + 26)).state_dict()
    batch = _batches(np.random.RandomState(seed + 26), 1, 2, 64, "cpu")[0]

    def fixed_on(d, dtype):
        model = _fixed_model(t, d, None, dtype)
        model.load_state_dict({k: v.to(d) for k, v in fixed0.items()})
        state = FixedTrainState.create(model, t["model_optimizer"])
        m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
            state, {k: v.to(d) for k, v in batch.items()})
        return ({k: v.cpu() for k, v in m.items()},
                {"model": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                 "arch": {}})

    out = {}
    for name, run, before, metric_keys, parts in (
            ("search", search_on, {"model": model0, "arch": arch0},
             ("loss", "arch_loss", "grad_norm"), ("weights", "arch")),
            ("fixed", fixed_on, {"model": fixed0, "arch": {}}, ("loss", "grad_norm"),
             ("weights",))):
        runs = {f"{where}_{tag}": run(d, dtype) for where, d in (("cpu", "cpu"), ("card", dev))
                for tag, dtype in (("bf16", BF16), ("f32", None))}
        out[name] = _bf16_bound(before, runs, metric_keys, parts)
        log(f"bf16 {name} step card vs CPU (depth 3, c 8, 64x64, batch 2): "
            + ", ".join(f"{k} {v['gap']:.3g} (twice {v['own']:.3g} allowed)"
                        for k, v in out[name]["bound"].items())
            + f"; control, card bf16 vs f32: {out[name]['control']}")
    return out


def run_bf16_clis(work: str) -> dict:
    """configs/senas/senas_synthetic.yml with `precision: bf16` in both
    sections: search_arc and train_model for one epoch each (in this
    process: the search launches the bf16 kernels and no f32 one), then
    testing_model, in f32, on the train run's best checkpoint."""
    cfg = load_config(RUNNER_CONFIG)
    for section in ("searching", "training"):
        cfg[section]["precision"] = "bf16"
    cfg["searching"]["arch_optimizer"]["betas"] = list(cfg["searching"]["arch_optimizer"]["betas"])
    config = os.path.join(work, "senas_synthetic_bf16.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    log_root = os.path.join(work, "logs")
    reset_counts()
    out = _in_process(search_arc.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    got = counts()
    bf16 = {k: v for k, v in got.items()
            if k.endswith(BF16_SUFFIX) and KERNELS[k]["source"] == EPILOGUE_SOURCE}
    check(all(bf16.values()) and not any(v for k, v in got.items() if k not in bf16),
          f"the bf16 search CLI launched {got}")
    search = _scalars(_run_dir(out))
    out = _in_process(train_model.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    train_dir = _run_dir(out)
    train = _scalars(train_dir)
    check(all(np.isfinite(v) for v in (*search.values(), *train.values())),
          f"bf16 CLI scalars {search} {train}")
    payload = CheckpointManager(os.path.join(train_dir, "ckpt")).restore_raw("best")
    check(all(v.dtype == torch.float32 for v in payload["model"].values()
              if v.is_floating_point()), "the bf16 run's checkpoint holds non-f32 tensors")
    out = _in_process(testing_model.main, "--config", config, "--resume",
                      os.path.join(train_dir, "ckpt"), "--log_root", log_root,
                      "--batch_size", str(cfg["training"]["batch_size"]))
    tested = ast.literal_eval(out.strip().splitlines()[-1])
    check(np.isfinite(tested["dice"]), f"testing_model on the bf16 checkpoint: {tested}")
    log(f"bf16 CLIs: search launches {bf16}, val dice {search['Val/dice']:.4f}; train val dice "
        f"{train['Val/dice']:.4f}; testing_model (f32) on its best checkpoint {tested}")
    return dict(search_launches=bf16, search_val_dice=search["Val/dice"],
                train_val_dice=train["Val/dice"], test=tested)


def run_bf16(dev, seed: int, f32_records: dict) -> dict:
    """Phase 17, timed."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")

    records = check_kernels_bf16(dev, f32_records)
    mark("kernels")
    search = run_bf16_search_path(dev, seed)
    mark("search path")
    fixed = run_bf16_fixed_path(dev, seed)
    mark("fixed path")
    cpu = bf16_card_vs_cpu(dev, seed)
    mark("card vs CPU")
    with tempfile.TemporaryDirectory() as work:
        clis = run_bf16_clis(work)
    mark("CLIs")
    seconds = time.perf_counter() - t0
    log(f"phase 17 (bf16): {seconds:.1f} s (done by: {', '.join(marks)})")
    return dict(records=records, search=search, fixed=fixed, card_vs_cpu=cpu, clis=clis,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 18: the zoo in bf16 and K2 in bf16
# ---------------------------------------------------------------------------

# H100 SXM dense bf16 on the tensor cores (data sheet, at a 700 W limit)
PEAK_BF16_FLOPS = 989e12
# PAN's pyramid-attention and GAU blocks batch-normalise a global pool,
# per channel over the batch: at batch 2, in bf16, two values whose
# difference is rounding noise (the CPU tests measure the JAX package's
# own bf16 step there 0.79 off its f32 one), so the card-vs-CPU step takes
# PAN at batch 4, as tests/test_torch_bf16_zoo.py does
ZOO_BF16_BATCH = {"pan": 4}


def check_norm_convs_bf16(dev, seed: int, f32: dict) -> dict:
    """K2's bf16 kernel against its bf16 twin (the f32 convolutions of the
    same bf16 values, rounded once) at each of K2_SHAPES: equal but on <=
    BF16_SHARE of the elements, each within one bf16 ulp or 2^-21 of its
    sum of |products|; at bench.py's shape timed in turns beside its twin
    and cuDNN's three bf16 convolutions and the cat (the library column),
    with the f32 kernel's time from phase 3 (`f32`) and the bf16 bound."""
    rec = {"timed": []}
    worst = dict(share=0.0, allowance=0.0, abs=0.0)
    for label, (b, c, h, w, n) in K2_SHAPES.items():
        x, ks = _norm_inputs(dev, b, c, h, w, n, seed + 30)
        x, ks = x.to(BF16), [k.to(BF16) for k in ks]
        got = nc.norm_convs(x, *ks)
        want = nc.norm_convs_plain(x, *ks)
        terms = nc.norm_convs_plain(x.float().abs(), *[k.float().abs() for k in ks])
        torch.cuda.synchronize()
        share, allowance, err = _bf16_err(got, want, terms)
        check(tuple(got.shape) == (b, 3 * n, h, w), f"norm_convs bf16 gave {tuple(got.shape)}")
        log(f"  norm_convs bf16 {label} [{b},{c},{h},{w}] N={n}: {share:.3g} of the outputs "
            f"differ from the twin, worst {allowance:.3g} of the allowance, max abs {err:.3g}")
        worst = dict(share=max(worst["share"], share), allowance=max(worst["allowance"], allowance),
                     abs=max(worst["abs"], err))
        if label != "bench":
            continue
        lib_share = float(((_library_norm_convs(x, ks) != want).double().mean()))
        del got, want, terms
        t = {"kernel": [], "plain": [], "library": []}
        calls = dict(kernel=lambda: nc.norm_convs(x, *ks),
                     plain=lambda: nc.norm_convs_plain(x, *ks),
                     library=lambda: _library_norm_convs(x, ks))
        turns = ("kernel", "plain", "library", "library", "plain", "kernel")
        for which in turns:
            t[which].append(time_ms(calls[which]))
        ms = {k: float(np.mean(v)) for k, v in t.items()}
        flops = nc.flops(x.shape, n)
        op_ms = flops / PEAK_BF16_FLOPS * 1e3
        byte_ms = nc.nbytes(x.shape, n, itemsize=2) / PEAK_BYTES_PER_S * 1e3
        bound = max(op_ms, byte_ms)
        log(f"  norm_convs bf16 times at bench.py's shape (ms, in turns {','.join(turns)}): "
            f"{t}; f32 kernel {f32['ms']:.4f} (phase 3); bound {bound:.4f} (operations "
            f"{op_ms:.4f}: {flops / 1e9:.2f} GFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16; "
            f"bytes {byte_ms:.4f}: {nc.nbytes(x.shape, n, itemsize=2) / 1e6:.1f} MB at "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s); kernel at {flops / ms['kernel'] / 1e9:.2f} "
            f"TFLOP/s, {bound / ms['kernel']:.3f} of its bound; cuDNN bf16 differs from the "
            f"twin on {lib_share:.3g} of the outputs")
        rec.update(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound, bytes_bound_ms=byte_ms, f32_ms=f32["ms"],
                   library_share_differing=lib_share, shape=[b, c, h, w], n=n,
                   tflops=flops / ms["kernel"] / 1e9)
        rec["timed"].append(dict(shape=[b, c, h, w], n=n, bound_ms=bound,
                                 **{f"{k}_in_turns": v for k, v in t.items()}))
    rec.update(max_abs_err=worst["abs"], max_share_differing=worst["share"],
               max_allowance_used=worst["allowance"])
    return rec


def zoo_bf16_card_vs_cpu(dev, seed: int) -> dict:
    """Each zoo model's train step from one state at phase 16's reduced
    sizes, in bf16 and in f32, on the card (TF32 off) and on the CPU, one
    CPU dropout generator for both: the card's bf16 step is held to the
    CPU's bf16 step as the CPU tests hold the port to the JAX package (at
    most twice the CPU's own bf16-vs-f32 distance, `_bf16_bound`'s rule);
    the control: the card's bf16 step lies outside phase 16's f32 card-vs-CPU
    limits of its own f32 step."""
    t = load_config(CONFIG)["training"]
    f32_limits = ZOO_CPU_LIMITS["float32"]
    rows = {}
    for name in ZOO_MODELS:
        depth, hw = ZOO_SMALL.get(name, ZOO_SMALL_DEFAULT)
        bs = ZOO_BF16_BATCH.get(name, 2)
        state0 = _zoo_model(name, depth, "cpu",
                            torch.Generator().manual_seed(seed + 31)).state_dict()
        batch = _batches(np.random.RandomState(seed + 31), 1, bs, hw, "cpu")[0]

        def run_on(d, dtype):
            model = _zoo_model(name, depth, d, None, dtype)
            model.load_state_dict({k: v.to(d) for k, v in state0.items()})
            state = FixedTrainState.create(model, t["model_optimizer"], seed=seed,
                                           rng=torch.Generator())
            m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                state, {k: v.to(d) for k, v in batch.items()})
            return ({k: m[k].cpu() for k in ("loss", "grad_norm")},
                    {"model": {k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()}, "arch": {}})

        runs = {f"{where}_{tag}": run_on(d, dtype) for where, d in (("cpu", "cpu"), ("card", dev))
                for tag, dtype in (("bf16", BF16), ("f32", None))}
        before = {"model": state0, "arch": {}}
        params = [k for k in state0 if k.rsplit(".", 1)[-1] not in ("mean", "var")]
        after = {k: r[1]["model"] for k, r in runs.items()}
        gap = _update_rel(state0, after["card_bf16"], after["cpu_bf16"], params)
        own = _update_rel(state0, after["cpu_bf16"], after["cpu_f32"], params)
        bound = {"weights": (gap, own),
                 "bn_stats": (_stats_l2(before, runs["card_bf16"][1], runs["cpu_bf16"][1]),
                              _stats_l2(before, runs["cpu_bf16"][1], runs["cpu_f32"][1]))}
        for k in ("loss", "grad_norm"):
            a, b = float(runs["card_bf16"][0][k]), float(runs["cpu_bf16"][0][k])
            bound[k] = (abs(a - b) / max(abs(b), 1e-30), own)
        for k, (g, o) in bound.items():
            check(g <= 2 * o + 1e-6, f"bf16 {name} step card vs CPU: {k} {g:.3g} over twice "
                                     f"{o:.3g}")
        control = dict(**_metrics_rel(runs["card_bf16"][0], runs["card_f32"][0],
                                      ("loss", "grad_norm")),
                       weights=_update_rel(state0, after["card_bf16"], after["card_f32"], params))
        check(any(control[k] > f32_limits[k] for k in ("loss", "grad_norm", "weights")),
              f"bf16 {name}: the card's bf16 step lies within phase 16's f32 limits of its f32 "
              f"step: {control}")
        rows[name] = dict(bound={k: dict(gap=g, own=o) for k, (g, o) in bound.items()},
                          control=control, batch=bs)
        log(f"bf16 zoo {name} step card vs CPU (depth {depth}, {hw}x{hw}, batch {bs}): "
            + ", ".join(f"{k} {g:.3g} (at most twice {o:.3g})" for k, (g, o) in bound.items())
            + f"; control, card bf16 vs f32: {control}")
    return rows


def run_bf16_zoo_clis(work: str) -> dict:
    """senas_synthetic.yml with `precision: bf16` under `training:`:
    train_model --model unet and --model fpn for one epoch each (their
    checkpoints hold f32 only), then testing_model --model unet (f32) on
    the unet run's checkpoint."""
    cfg = load_config(RUNNER_CONFIG)
    cfg["training"]["precision"] = "bf16"
    cfg["searching"]["arch_optimizer"]["betas"] = list(cfg["searching"]["arch_optimizer"]["betas"])
    config = os.path.join(work, "senas_synthetic_bf16.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    log_root = os.path.join(work, "logs")
    out = {}
    for name in ("unet", "fpn"):
        stdout = _in_process(train_model.main, "--config", config, "--model", name, "--epoch",
                             "1", "--log_root", log_root)
        run_dir = _run_dir(stdout)
        scalars = _scalars(run_dir)
        check(all(np.isfinite(v) for v in scalars.values()), f"bf16 {name} scalars {scalars}")
        payload = CheckpointManager(os.path.join(run_dir, "ckpt")).restore_raw("last")
        check(all(v.dtype == torch.float32 for v in payload["model"].values()
                  if v.is_floating_point()), f"the bf16 {name} checkpoint holds non-f32 tensors")
        out[name] = dict(val_dice=scalars["Val/dice"], run_dir=run_dir)
    stdout = _in_process(testing_model.main, "--config", config, "--model", "unet", "--resume",
                         os.path.join(out["unet"]["run_dir"], "ckpt"), "--log_root", log_root,
                         "--batch_size", str(cfg["training"]["batch_size"]))
    tested = ast.literal_eval(stdout.strip().splitlines()[-1])
    check(np.isfinite(tested["dice"]), f"testing_model on the bf16 unet checkpoint: {tested}")
    log(f"bf16 zoo CLIs: unet val dice {out['unet']['val_dice']:.4f}, fpn val dice "
        f"{out['fpn']['val_dice']:.4f}; testing_model --model unet (f32) on the bf16 "
        f"checkpoint {tested}")
    return dict(unet_val_dice=out["unet"]["val_dice"], fpn_val_dice=out["fpn"]["val_dice"],
                test=tested)


def run_bf16_smp_losses(dev, seed: int) -> dict:
    """The six smp_* losses on one batch of full-size bf16 logits (12 x 256
    x 256 x 2), card against CPU: each value within twice the CPU's own
    bf16-vs-f32 distance of the CPU's bf16 value; the input gradient (but
    Lovasz's, which follows the order of its sorted errors) the same, in
    relative L2."""
    rs = np.random.RandomState(seed + 32)
    logits = torch.from_numpy(rs.randn(12, HW, HW, NCLASS).astype(np.float32)).to(BF16)
    labels = torch.from_numpy((rs.rand(12, HW, HW) > 0.7).astype(np.int64))
    l2 = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))
    out = {}
    for name in SMP_LOSSES:
        fn = build_loss(name)
        res = {}
        for where, d, dt in (("cpu_bf16", "cpu", BF16), ("cpu_f32", "cpu", torch.float32),
                             ("card_bf16", dev, BF16)):
            x = logits.to(d, dt).clone().requires_grad_()
            v = fn([x], labels.to(d))
            v.backward()
            check(v.dtype == dt, f"{name} on {where}: loss {v.dtype}")
            res[where] = (v.detach().double().cpu(), x.grad.double().cpu())
        own = abs(float(res["cpu_bf16"][0] - res["cpu_f32"][0])) / abs(float(res["cpu_f32"][0]))
        gap = abs(float(res["card_bf16"][0] - res["cpu_bf16"][0])) / abs(float(res["cpu_bf16"][0]))
        check(gap <= 2 * own + 1e-6, f"bf16 {name}, card vs CPU: {gap:.3g} over twice {own:.3g}")
        grad_gap = l2(res["card_bf16"][1], res["cpu_bf16"][1])
        grad_own = l2(res["cpu_bf16"][1], res["cpu_f32"][1])
        if name != "smp_lovasz":
            check(grad_gap <= 2 * grad_own + 1e-6, f"bf16 {name} input gradient, card vs CPU: "
                                                    f"{grad_gap:.3g} over twice {grad_own:.3g}")
        xd, ld = logits.to(dev), labels.to(dev)
        ms = time_ms(lambda: fn([xd], ld), reps=10, warmup=2)
        out[name] = dict(value=float(res["card_bf16"][0]), gap=gap, own=own, grad_gap=grad_gap,
                         grad_own=grad_own, ms=ms)
        log(f"bf16 {name} on 12x{HW}x{HW}x{NCLASS} logits: {out[name]['value']:.6f} (CPU "
            f"{float(res['cpu_bf16'][0]):.6f}; card vs CPU {gap:.3g}, at most twice {own:.3g}; "
            f"input gradient {grad_gap:.3g}, at most twice {grad_own:.3g}), {ms:.3f} ms on the card")
    return out


def run_bf16_zoo(dev, seed: int, f32_records: dict, f32_zoo: dict) -> dict:
    """Phase 18, timed: K2 bf16, the nine models in bf16 at phase 16's
    geometry (beside phase 16's f32 numbers, `f32_zoo`), card against CPU,
    the CLIs and the smp losses."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")

    record = check_norm_convs_bf16(dev, seed, f32_records["norm_convs"])
    mark("K2 bf16")
    path = run_zoo_path(dev, seed, BF16)
    path.pop("unet_state")
    for name, row in path["models"].items():
        f32 = f32_zoo["models"][name]
        log(f"bf16 zoo {name} beside f32: {row['step_ms']:.2f} ms/step (f32 {f32['step_ms']:.2f}), "
            f"eval {row['eval_ms']:.2f} ms/batch (f32 {f32['eval_ms']:.2f}), peak "
            f"{row['peak_mib']:.1f} MiB (f32 {f32['peak_mib']:.1f}), logits {row['out_dtype']}")
    mark("the nine models")
    cpu = zoo_bf16_card_vs_cpu(dev, seed)
    mark("card vs CPU")
    with tempfile.TemporaryDirectory() as work:
        clis = run_bf16_zoo_clis(work)
    mark("CLIs")
    losses = run_bf16_smp_losses(dev, seed)
    mark("smp losses")
    seconds = time.perf_counter() - t0
    log(f"phase 18 (the zoo in bf16, K2 in bf16): {seconds:.1f} s (done by: {', '.join(marks)})")
    return dict(record=record, path=path, card_vs_cpu=cpu, clis=clis, losses=losses,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 19: the SENAS_PALLAS_BN path, remat and the config keys
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def pallas_bn(on: bool):
    """SENAS_PALLAS_BN at "1" (on) or "0" inside; the process's value
    restored after, so that no other phase runs with the gate."""
    kept = os.environ.get("SENAS_PALLAS_BN")
    os.environ["SENAS_PALLAS_BN"] = "1" if on else "0"
    try:
        yield
    finally:
        if kept is None:
            del os.environ["SENAS_PALLAS_BN"]
        else:
            os.environ["SENAS_PALLAS_BN"] = kept


# BatchNorm shapes held beyond the fixed model's own: the 1x1 planes of
# PSPNet's pooled pyramid and DeepLabV3+'s image pool, PSP pool sizes 3 and 6
# (9 and 36, not multiples of the vector width), the encoders' deepest stage
# and a large plane; the last is also the timed shape.
BN_EXTRA_SHAPES = ((2, 64, 1, 1), (2, 64, 3, 3), (2, 64, 6, 6), (2, 512, 8, 8),
                   (12, 32, 256, 256))
BN_TIMED_SHAPE = (12, 32, 256, 256)
BN_PROFILED = 10
BN_MODES = ("kernels", "twins", "off")


@contextlib.contextmanager
def bn_inputs(model):
    """Within it, the shapes of the 4-D inputs that `model`'s BatchNorms are
    called on, in call order, collect in the yielded list."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)) if args[0].dim() == 4 else None)
        for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def _bn_case(dev, shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * (1 + torch.rand(c, generator=g))[:, None, None]
         + 0.3 * torch.randn(c, generator=g)[:, None, None])
    state = {"scale": 0.5 + torch.rand(c, generator=g), "bias": 0.2 * torch.randn(c, generator=g),
             "mean": 0.2 * torch.randn(c, generator=g), "var": 0.5 + torch.rand(c, generator=g)}
    readout = torch.randn(shape, generator=g)
    return (x.to(dev, dtype), {k: v.to(dev) for k, v in state.items()},
            readout.to(dev, dtype))


def _bn_run(x, state, readout, train, dtype, mode):
    """One BatchNorm(dtype) forward and backward from `state` on x: the gate
    on ("kernels"), the gate on with the kernels' plain twins in their
    place ("twins"), or off ("off": F.batch_norm). Returns y and the
    gradients of x, scale and bias, and the running stats after."""
    bn = BatchNorm(x.shape[1], dtype=dtype).to(x.device)
    bn.load_state_dict(state)
    xi = x.detach().clone().requires_grad_()
    with pallas_bn(mode != "off"), (twins_swapped() if mode == "twins"
                                    else contextlib.nullcontext()):
        y = bn(xi, train=train)
        grads = torch.autograd.grad(y, (xi, bn.scale, bn.bias), readout.to(y.dtype))
    return dict(y=y.detach(), dx=grads[0], dscale=grads[1], dbias=grads[2],
                mean=bn.mean.clone(), var=bn.var.clone())


def _bn_f64(x, g, state, train, shift=0.0):
    """BatchNorm's output and the gradients of x and scale for cotangent g,
    in f64, with the batch mean and variance (train mode) moved by `shift`
    times a few f32 ulps of the channel's second moment: d_mu = 2^-20
    sqrt(E[x^2]), d_var = 2^-20 E[x^2]: what the one-sweep variance (against
    the two-pass form) or another summation order may move them by."""
    xd, gd = x.double(), g.double()
    col = lambda t: t.double()[None, :, None, None]
    dims = (0, 2, 3)
    if train:
        m2 = (xd ** 2).mean(dim=dims, keepdim=True)
        mu = xd.mean(dim=dims, keepdim=True) + shift * 2.0 ** -20 * m2.sqrt()
        var = ((xd - xd.mean(dim=dims, keepdim=True)) ** 2).mean(dim=dims, keepdim=True) \
            + shift * 2.0 ** -20 * m2
    else:
        mu, var = col(state["mean"]), col(state["var"])
    inv = (var + 1e-5).rsqrt()
    xhat = (xd - mu) * inv
    y = xhat * col(state["scale"]) + col(state["bias"])
    if train:
        dx = col(state["scale"]) * inv * (gd - gd.mean(dim=dims, keepdim=True)
                                          - xhat * (gd * xhat).mean(dim=dims, keepdim=True))
    else:
        dx = col(state["scale"]) * inv * gd
    return dict(y=y, dx=dx, dscale=(gd * xhat).sum(dim=dims), dbias=gd.sum(dim=dims))


def _bn_allowance(x, g, state, train) -> tuple:
    """Per element of y and of each gradient, how far two f32 evaluations of
    BatchNorm may lie apart: 1e-5 of |y| + 1 (each gradient: 1e-4 of its
    largest magnitude), plus, in train mode, how far the batch stats moved
    by a few f32 ulps (`_bn_f64`) move it. Returns (allowances, the f64
    values)."""
    exact = _bn_f64(x, g, state, train)
    allow = {"y": 1e-5 * (exact["y"].abs() + 1)}
    for k in ("dx", "dscale", "dbias"):
        allow[k] = 1e-4 * exact[k].abs().max().clamp_min(1e-30).expand_as(exact[k])
    if train:
        for shift in (1.0, -1.0):
            moved = _bn_f64(x, g, state, train, shift)
            for k in allow:
                allow[k] = allow[k] + (moved[k] - exact[k]).abs()
    return allow, exact


def check_bn_path(dev, seed: int, shapes) -> dict:
    """BatchNorm with the gate on held, at each shape, train and eval, f32
    and bf16, forward and backward with the running stats, against the same
    path on the kernels' plain twins and against the gate off: f32 outputs
    within `_bn_allowance` of both, and so their gradients; bf16 outputs
    against the twins at the bf16 bound (equal but on max(1, 1e-3 of the
    elements), each within one bf16 ulp or 2^-21 of |y| + 1, plus the
    allowance), bf16 gradients within 2e-2 of the largest magnitude;
    running stats within 1e-5 of their largest magnitude."""
    worst = {"y": 0.0, "y_off": 0.0, "dx": 0.0, "dx_off": 0.0, "stats": 0.0, "bf16_share": 0.0,
             "bf16_grad_rel": 0.0}
    for i, shape in enumerate(shapes):
        for dtype in (torch.float32, BF16):
            for train in (True, False):
                x, state, readout = _bn_case(dev, shape, seed + i, dtype)
                runs = {mode: _bn_run(x, state, readout, train, dtype, mode) for mode in BN_MODES}
                allow, exact = _bn_allowance(x.float(), readout.float(), state, train)
                got = runs["kernels"]
                what = f"BatchNorm {list(shape)} {dtype} train={train}"
                for ref in ("twins", "off"):
                    want = runs[ref]
                    suffix = "" if ref == "twins" else "_off"
                    if dtype == torch.float32:
                        over = {k: ((got[k].double() - want[k].double()).abs() / allow[k]).max()
                                .item() for k in ("y", "dx", "dscale", "dbias")}
                        check(max(over.values()) <= 1.0,
                              f"{what}: against {ref}, parts of the allowance {over}")
                        worst["y" + suffix] = max(worst["y" + suffix], over["y"])
                        worst["dx" + suffix] = max(worst["dx" + suffix],
                                                   over["dx"], over["dscale"], over["dbias"])
                    else:
                        grad = max(rel_err(got[k].float(), want[k].float())
                                   for k in ("dx", "dscale", "dbias"))
                        check(grad <= BF16_GRAD_REL, f"{what}: gradients against {ref} rel "
                                                     f"{grad:.3g}")
                        worst["bf16_grad_rel"] = max(worst["bf16_grad_rel"], grad)
                    stats = max(float((got[k] - want[k]).abs().max()
                                      / want[k].abs().max().clamp_min(1.0)) for k in ("mean", "var"))
                    check(stats <= 1e-5, f"{what}: running stats against {ref}: {stats:.3g}")
                    worst["stats"] = max(worst["stats"], stats)
                if dtype == BF16:
                    diff = (got["y"].double() - runs["twins"]["y"].double()).abs()
                    mag = torch.maximum(got["y"].double().abs(), runs["twins"]["y"].double().abs())
                    ulp = torch.exp2(torch.floor(torch.log2(torch.where(
                        mag > 0, mag, torch.ones_like(mag)))) - 7)
                    terms = exact["y"].abs() + 1
                    n_diff = int((diff > 0).sum())
                    check(n_diff <= max(1, int(BF16_SHARE * diff.numel()))
                          and bool((diff <= torch.maximum(ulp, terms * 2.0 ** -21)
                                    + allow["y"]).all()),
                          f"{what}: {n_diff} of {diff.numel()} bf16 outputs differ from the "
                          f"twins', worst {diff.max().item():.3g}")
                    worst["bf16_share"] = max(worst["bf16_share"], n_diff / diff.numel())
        log(f"  BatchNorm gate on at {list(shape)}: held to its twins and to the gate off "
            f"(worst so far {({k: float(f'{v:.3g}') for k, v in worst.items()})})")
        torch.cuda.empty_cache()
    return worst


def time_bn_kernels(dev, seed: int) -> dict:
    """K1a-K1d at n=1 on BN_TIMED_SHAPE in f32 and bf16, beside their plain
    twins, their byte bounds, the gated BatchNorm's forward and backward
    (glue included) and F.batch_norm's (cuDNN: the library call computing
    the same function); the kernel launches of one forward and one backward
    each way (torch.profiler)."""
    b, c, h, w = BN_TIMED_SHAPE
    out = {}
    for dtype in (torch.float32, BF16):
        e = torch.finfo(dtype).bits // 8
        x, state, g = _bn_case(dev, BN_TIMED_SHAPE, seed, dtype)
        xs = [x]
        a, k = state["scale"][None, None, :].expand(1, b, c).contiguous(), \
            state["bias"][None, :].expand(b, c).contiguous()
        ds = [0.01 * state["bias"][None, None, :].expand(1, b, c).contiguous()] * 2
        n, planes = b * c * h * w, b * c
        nbytes = dict(stats=n * e + 2 * planes * 4, mix=2 * n * e + 2 * planes * 4,
                      reduce=2 * n * e + 2 * planes * 4, dx=3 * n * e + 3 * planes * 4)
        t = dict(stats=time_ms(lambda: ge.branch_stats(xs)),
                 stats_plain=time_ms(lambda: ge.branch_stats_plain(xs)),
                 mix=time_ms(lambda: ge.apply_mix(xs, a, k)),
                 mix_plain=time_ms(lambda: ge.apply_mix_plain(xs, a, k)),
                 reduce=time_ms(lambda: ge.bwd_reduce(xs, g)),
                 reduce_plain=time_ms(lambda: ge.bwd_reduce_plain(xs, g)),
                 dx=time_ms(lambda: ge.bwd_dx(xs, g, a, *ds)),
                 dx_plain=time_ms(lambda: ge.bwd_dx_plain(xs, g, a, *ds)))
        modules, launches = {}, {}
        for on in (True, False):
            bn = BatchNorm(c, dtype=dtype).to(dev)
            bn.load_state_dict(state)
            xi = x.detach().clone().requires_grad_()
            with pallas_bn(on):
                fwd = lambda: bn(xi, train=True)
                y = fwd()
                params = (xi, bn.scale, bn.bias)
                bwd = lambda: torch.autograd.grad(y, params, g, retain_graph=True)
                key = "gate" if on else "library"
                modules[f"{key}_fwd"] = time_ms(fwd)
                modules[f"{key}_bwd"] = time_ms(bwd)
                # launches a call: the profiler over BN_PROFILED calls (it may
                # record no device time over a single short call)
                for part, fn in (("fwd", fwd), ("bwd", bwd)):
                    n = profile(lambda: [fn() for _ in range(BN_PROFILED)],
                                f"{BN_PROFILED} BatchNorm {part} calls, gate {on}, "
                                f"{dtype}").get("launches")
                    launches[f"{key}_{part}"] = None if n is None else n / BN_PROFILED
        bound = {key: nb / PEAK_BYTES_PER_S * 1e3 for key, nb in nbytes.items()}
        suffix = "" if dtype == torch.float32 else BF16_SUFFIX
        for name, key in _TIMED:
            pair = "fwd" if key in ("stats", "mix") else "bwd"
            out[name + suffix] = dict(
                shape=list(BN_TIMED_SHAPE), n=1, ms=t[key], plain_ms=t[f"{key}_plain"],
                bound_ms=bound[key], pass_=pair,
                pair_ms=t["stats"] + t["mix"] if pair == "fwd" else t["reduce"] + t["dx"],
                pair_bound_ms=(bound["stats"] + bound["mix"] if pair == "fwd"
                               else bound["reduce"] + bound["dx"]),
                gated_module_ms=modules[f"gate_{pair}"], library_ms=modules[f"library_{pair}"],
                launches_per_call=dict(gate=launches[f"gate_{pair}"],
                                       library=launches[f"library_{pair}"]))
        log(f"  BatchNorm n=1 at {list(BN_TIMED_SHAPE)} {dtype} (ms / plain / bound): "
            + " | ".join(f"{name} {t[key]:.4f} / {t[key + '_plain']:.4f} / {bound[key]:.4f}"
                         for name, key in _TIMED)
            + f" | gated module fwd {modules['gate_fwd']:.4f} bwd {modules['gate_bwd']:.4f}"
            f" | F.batch_norm fwd {modules['library_fwd']:.4f} bwd {modules['library_bwd']:.4f}"
            f" | launches {launches}")
        torch.cuda.empty_cache()
    return out


def _gate_turns(label, step_fn, bn_count, reps: int = 3) -> dict:
    """Steps with the gate on and off in turns (on, off, off, on), `reps`
    a turn after one warm-up call each way; the wrapper counts of one gated
    step held to `bn_count` (each 4-D BatchNorm: K1a and K1b forward, K1c
    and K1d backward), and the inputs it copied (to NCHW or to f32)
    (`BatchNorm.pallas_copies`); then one step each way under
    torch.profiler."""
    times = {True: [], False: []}
    for on in (True, False):
        with pallas_bn(on):
            step_fn()
    torch.cuda.synchronize()
    for on in (True, False, False, True):
        with pallas_bn(on):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                step_fn()
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) * 1e3 / reps)
    reset_counts()
    copies = BatchNorm.pallas_copies
    with pallas_bn(True):
        step_fn()
    torch.cuda.synchronize()
    copies = BatchNorm.pallas_copies - copies
    got = {k: v for k, v in counts().items() if v}
    by_kernel = {}
    for name, v in got.items():
        by_kernel[name.removesuffix(BF16_SUFFIX)] = by_kernel.get(name.removesuffix(BF16_SUFFIX),
                                                                   0) + v
    check(by_kernel == {name: bn_count for name, _ in _TIMED},
          f"{label}: a gated step launched {got}, expected {bn_count} of each K1 kernel")
    profiles = {}
    for on in (True, False):
        with pallas_bn(on):
            prof = profile(step_fn, f"{label}, gate {'on' if on else 'off'}")
        classes = prof.get("by_class_ms", {})
        prof["bn_class_ms"] = sum(v for c, v in classes.items()
                                  if c == "batch norm" or "(K1" in c)
        profiles["on" if on else "off"] = prof
    log(f"{label}: ms/step gate on {[round(t, 2) for t in times[True]]}, off "
        f"{[round(t, 2) for t in times[False]]} (in turns on, off, off, on); launches of a "
        f"gated step {got}; inputs the gated BatchNorms copied (to NCHW or to f32) {copies}")
    return dict(ms_on=float(np.mean(times[True])), ms_off=float(np.mean(times[False])),
                turns=dict(on=times[True], off=times[False]), launches=got,
                profile=profiles, nchw_copies=copies)


def run_bn_gate_steps(dev, seed: int) -> dict:
    """The promise12-fixed-train step (f32), the same in bf16 and the zoo's
    unet step in bf16, each with the gate on and off in turns."""
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    batch = _batches(np.random.RandomState(seed + 19), 1, bs, HW, dev)[0]
    out, total = {}, {name: 0 for name in KERNELS}
    for label, make in (
            ("fixed f32", lambda g: _fixed_model(t, dev, g)),
            ("fixed bf16", lambda g: _fixed_model(t, dev, g, BF16)),
            ("unet bf16", lambda g: _zoo_model("unet", t["depth"], dev, g, BF16))):
        model = make(torch.Generator().manual_seed(seed + 19))
        state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
        step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
        with bn_inputs(model) as seen, pallas_bn(False):
            step(state, batch)
        out[label] = _gate_turns(f"{label} step, batch {bs}", lambda: step(state, batch),
                                 len(seen))
        out[label]["bn_calls"] = len(seen)
        out[label]["bn_shapes"] = sorted(set(seen))
        add_counts(total, {k: out[label]["launches"].get(k, 0) for k in KERNELS})
        del model, state, step
        torch.cuda.empty_cache()
    return dict(steps=out, launches=total)


# the six optimizers of the port beyond sgd and adam, one fixed step each
OTHER_OPTIMIZERS = {
    "adamax": {"name": "adamax", "lr": 2e-3, "weight_decay": 5e-4},
    "adadelta": {"name": "adadelta", "lr": 1.0, "rho": 0.9, "weight_decay": 5e-4},
    "adagrad": {"name": "adagrad", "lr": 1e-2, "weight_decay": 5e-4},
    "rmsprop": {"name": "rmsprop", "lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-4},
    "asgd": {"name": "asgd", "lr": 6e-3, "weight_decay": 5e-4},
    "adabound": {"name": "adabound", "lr": 1e-3, "weight_decay": 5e-4},
}


@contextlib.contextmanager
def module_outputs(model, forced=None):
    """Within it, every tensor that a module of `model` returns is kept, in
    call order, in the yielded list (on the CPU); with `forced` (such a list
    from another run) each is replaced by the forced value, exactly, with
    the gradient passing through the module's own output."""
    seen, hooks = [], []

    def hook(mod, args, out):
        if not torch.is_tensor(out) or not out.is_floating_point():
            return None
        seen.append(out.detach().cpu().clone())
        if forced is None:
            return None
        want = forced[len(seen) - 1].to(out.device, out.dtype)
        return out - out.detach() + want

    hooks = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def split_step_card_vs_cpu(dev, seed: int, optimizers=None) -> dict:
    """One fixed train step (phase 7's: depth 3, c 8, 64x64, batch 2) on the
    card and on the CPU from identical state, held to CARD_CPU_LIMITS in
    three parts, since the step's gradients are discontinuous at that
    scale: an input of a ReLU or a max pool that lies within rounding of a
    kink sends a whole gradient element another way. (The gated BatchNorm's
    one-sweep variance moves the forward by ~1e-6, which at this seed flips
    such a kink: the gradients jump by 1.3e-3, as the CPU's own do when one
    BatchNorm output moves by 1e-6 noise. An adaptive optimizer's first
    step, lr g/|g| on gradients at rounding level, does the same to the
    update.)
    - forward: the loss and the running stats, card against the CPU's step;
    - gradients: their norm and their relative difference (as the weights'
      update is measured), card against the CPU's step with its forward
      forced to the card's module outputs (`module_outputs`), so that both
      take every kink the same way;
    - update: the weights after the card's step against the CPU's
      optimizer stepped from the same state on the card's gradients, for
      the config's optimizer and for each of `optimizers` (name -> config:
      the card's step once more with it; the forward and the gradients of
      a first step do not depend on it).
    Returns the parts' numbers and the plain comparison's."""
    t = dict(load_config(CONFIG)["training"], depth=3, init_channels=8)
    model0 = _fixed_model(t, "cpu", torch.Generator().manual_seed(seed + 5)).state_dict()
    batch = _batches(np.random.RandomState(seed + 5), 1, 2, 64, "cpu")[0]
    before = {"model": {k: v.clone() for k, v in model0.items()}, "arch": {}}
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}

    def run_on(d, opt_cfg, forced=None):
        model = _fixed_model(t, d, None)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        state = FixedTrainState.create(model, opt_cfg)
        names = {id(p): k for k, p in model.named_parameters()}
        grads = {}
        state.opt.register_step_pre_hook(lambda opt, args, kw: grads.update(
            {names[id(p)]: p.grad.detach().cpu().clone() for g in opt.param_groups
             for p in g["params"]}))
        with module_outputs(model, forced) as seen:
            m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                state, {k: v.to(d) for k, v in batch.items()})
        return cpu(m), {"model": cpu(model.state_dict()), "arch": {}}, grads, seen

    def update_rel(opt_cfg, after_card, g_card):
        """The card's update against the CPU's optimizer on g_card."""
        model = _fixed_model(t, "cpu", None)
        model.load_state_dict(model0)
        opt = build_optimizer(list(model.parameters()), opt_cfg)
        for k, p in model.named_parameters():
            p.grad = g_card[k]
        opt.step()
        return _state_rel(before, after_card, {"model": cpu(model.state_dict()),
                                               "arch": {}})["weights"]

    m_card, after_card, g_card, seen = run_on(dev, t["model_optimizer"])
    m_cpu, after_cpu, _, _ = run_on("cpu", t["model_optimizer"])
    m_forced, _, g_forced, _ = run_on("cpu", t["model_optimizer"], forced=seen)
    forward = _metrics_rel(m_card, m_cpu, ("loss",))
    forward["bn_stats"] = _state_rel(before, after_card, after_cpu)["bn_stats"]
    grads = _metrics_rel(m_card, m_forced, ("grad_norm",))
    grads["weights"] = _update_rel({k: torch.zeros_like(v) for k, v in g_forced.items()},
                                   g_card, g_forced, list(g_forced))
    update = {t["model_optimizer"]["name"]: update_rel(t["model_optimizer"], after_card, g_card)}
    for name, opt_cfg in (optimizers or {}).items():
        _, after, g, _ = run_on(dev, opt_cfg)
        update[name] = update_rel(opt_cfg, after, g)
    plain = dict(metrics=_metrics_rel(m_card, m_cpu, ("loss", "grad_norm")),
                 state=_state_rel(before, after_card, after_cpu))
    return dict(forward=forward, grads=grads, update=update, plain=plain)


def run_config_keys_card_vs_cpu(dev, seed: int) -> dict:
    """`split_step_card_vs_cpu` with the gate on (the kernels on the card,
    their twins on the CPU), and with it off for the updates of the six
    other optimizers, each part held to CARD_CPU_LIMITS (metrics: loss,
    grad_norm; weights: the gradients and each update; bn_stats); then the
    gated step with TF32 on, which the limits must catch."""
    lim = CARD_CPU_LIMITS
    within = lambda r: (r["forward"]["loss"] <= lim["metrics"]
                        and r["forward"]["bn_stats"] <= lim["bn_stats"]
                        and r["grads"]["grad_norm"] <= lim["metrics"]
                        and r["grads"]["weights"] <= lim["weights"]
                        and max(r["update"].values()) <= lim["weights"])
    out = {}
    with pallas_bn(True):
        out["pallas_bn"] = split_step_card_vs_cpu(dev, seed)
    out["optimizers"] = split_step_card_vs_cpu(dev, seed, OTHER_OPTIMIZERS)
    for name, r in out.items():
        log(f"  fixed step card vs CPU ({name}): forward {r['forward']}, gradients (forward "
            f"forced) {r['grads']}, updates on the card's gradients {r['update']}; the plain "
            f"comparison {r['plain']}")
        check(within(r), f"card and CPU fixed steps disagree ({name}): {r} (limits {lim})")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pallas_bn(True):
            tf32 = split_step_card_vs_cpu(dev, seed)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  the same with the gate on and TF32 on: forward {tf32['forward']}, gradients "
        f"{tf32['grads']}, update {tf32['update']}")
    check(not within(tf32), "the split card-vs-CPU limits let a step with TF32 on pass")
    out["pallas_bn_tf32"] = tf32
    return out


def _remat_pair(build, step_fn, batches, want_fn, reps: int = 2) -> dict:
    """For remat off and on: a state from `build(remat)` and its steps
    (the first a warm-up), host-clock ms/step, the peak memory, and the
    launches of the `reps` timed steps held to want_fn(state, remat)."""
    out = {}
    for remat in (False, True):
        state = build(remat)
        step_fn(state, batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times = []
        for batch in batches[1:reps + 1]:
            t0 = time.perf_counter()
            m = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(float(m["loss"])), f"remat={remat} step: loss {float(m['loss'])}")
        got, want = counts(), want_fn(state, remat)
        check(got == want, f"{reps} steps with remat={remat} launched {got}, expected {want}")
        out[remat] = dict(ms=float(np.mean(times)), peak_mib=torch.cuda.max_memory_allocated()
                          / 2**20, launches=got)
        del state
        torch.cuda.empty_cache()
    return out


def run_remat(dev, seed: int) -> dict:
    """remat at full width: the search step (do_arch) and the fixed step,
    off then on, ms/step and peak memory (the search step's kernel launches
    held to the count with the recompute: K1a and K1b twice a pass); at
    phase 7's reduced size under cuDNN's deterministic algorithms, the
    search and fixed steps with remat on against off, three runs off and
    two on in turns: the forward (loss, arch loss, running stats) equal to
    1e-6, the gradient norm, weights and arch tables within phase 7's
    limits (CARD_CPU_LIMITS), beside the spread of the runs with it off.
    The card's max-pool and bilinear-upsampling backwards add with
    atomics, so the weights differ run to run (~5e-6 of their update) with
    or without remat; on the CPU the steps are equal."""
    s = load_config(CONFIG)["searching"]
    t = load_config(CONFIG)["training"]
    rng = np.random.RandomState(seed + 21)
    sb = [(tb, vb) for tb, vb in zip(*[iter(_batches(rng, 6, s["batch_size"], HW, dev))] * 2)]
    fb = _batches(rng, 3, t["batch_size"], HW, dev)
    meta, depth = s["meta_node_num"], s["depth"]

    def build_search(remat):
        gen = torch.Generator().manual_seed(seed + 21)
        model = _supernet(s, dev, gen, remat=remat)
        arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"], generator=gen,
                                device=dev)
        return SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])

    search_step = make_search_step(lambda a: normalize_arch(a, meta),
                                   build_loss(s["loss"]["name"]), grad_clip=s["grad_clip"])
    search = _remat_pair(build_search, lambda st, b: search_step(st, *b, True), sb,
                         lambda st, remat: {name: 2 * v for name, v in per_step(
                             expected_launches(st.model), True, remat).items()})
    fixed_step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    fixed = _remat_pair(lambda remat: FixedTrainState.create(
        _fixed_model(t, dev, torch.Generator().manual_seed(seed + 22), remat=remat),
        t["model_optimizer"]), fixed_step, fb, lambda st, remat: {name: 0 for name in KERNELS})
    for label, pair in (("search step (do_arch)", search), ("fixed step", fixed)):
        log(f"remat {label} at full width: off {pair[False]['ms']:.2f} ms/step, peak "
            f"{pair[False]['peak_mib']:.1f} MiB; on {pair[True]['ms']:.2f} ms/step, peak "
            f"{pair[True]['peak_mib']:.1f} MiB")

    # reduced size: the same step with remat off and on in turns (off, on,
    # off, on, off), deterministic cuDNN
    rs = dict(s, depth=3, init_channels=8)
    rt = dict(t, depth=3, init_channels=8)
    gen = torch.Generator().manual_seed(seed + 23)
    s0 = _supernet(rs, "cpu", gen).state_dict()
    arch0 = init_arch_params(rs["meta_node_num"], 3, use_sharing=False, generator=gen, device="cpu")
    f0 = _fixed_model(rt, "cpu", gen).state_dict()
    tb, vb = _batches(np.random.RandomState(seed + 23), 2, 2, 64, dev)

    def search_run(remat):
        model = _supernet(rs, dev, None, remat=remat)
        model.load_state_dict({k: v.to(dev) for k, v in s0.items()})
        state = SearchTrainState.create(model, {k: v.clone().to(dev) for k, v in arch0.items()},
                                        rs["model_optimizer"], rs["arch_optimizer"])
        before = _snapshot(state)
        m = search_step(state, tb, vb, True)
        return before, {k: v.cpu() for k, v in m.items()}, _snapshot(state)

    def fixed_run(remat):
        model = _fixed_model(rt, dev, None, remat=remat)
        model.load_state_dict({k: v.to(dev) for k, v in f0.items()})
        state = FixedTrainState.create(model, rt["model_optimizer"])
        snap = lambda: {"model": {k: v.clone() for k, v in model.state_dict().items()}, "arch": {}}
        before = snap()
        m = fixed_step(state, tb)
        return before, {k: v.cpu() for k, v in m.items()}, snap()

    equal = {}
    with deterministic_cudnn():
        for label, run, keys in (("search", search_run, ("loss", "arch_loss", "grad_norm")),
                                 ("fixed", fixed_run, ("loss", "grad_norm"))):
            runs = [(remat, run(remat)) for remat in (False, True, False, True, False)]
            dist = lambda a, b: {**_metrics_rel(a[1], b[1], keys),
                                 **_state_rel(b[0], a[2], b[2])}
            pairs = lambda x, y: [dist(a, b) for i, (ra, a) in enumerate(runs)
                                  for j, (rb, b) in enumerate(runs)
                                  if i < j and (ra, rb) in ((x, y), (y, x))]
            worst = lambda ds: {k: max(d[k] for d in ds) for k in ds[0]}
            equal[label] = dict(on_vs_off=worst(pairs(True, False)),
                                off_vs_off=worst(pairs(False, False)))
    for label, r in equal.items():
        log(f"  {label} step, remat on vs off (depth 3, c 8, 64x64, batch 2, deterministic "
            f"cuDNN; the largest of 6 pairs): {r['on_vs_off']}; off vs off, the card's own "
            f"spread (3 pairs): {r['off_vs_off']}")
        on, lim = r["on_vs_off"], CARD_CPU_LIMITS
        check(all(on[k] <= 1e-6 for k in ("loss", "arch_loss", "bn_stats") if k in on)
              and on["grad_norm"] <= lim["metrics"] and on["weights"] <= lim["weights"]
              and on["arch"] <= lim["arch"],
              f"{label} step: remat on and off differ: {r} (the forward within 1e-6, the "
              f"rest within {lim})")
    return dict(search=search, fixed=fixed, equal=equal)


def run_config_clis(work: str) -> dict:
    """configs/senas/senas_synthetic.yml with the keys the port used to
    refuse, through the CLIs in this process: search_arc for one epoch with
    `beta_mode: grouped`, `multi_gpus: true`, `mesh_spatial: 2` and
    `arch_optimizer: adabound`, then train_model for one epoch with
    `remat: true` and `model_optimizer: rmsprop`."""
    cfg = load_config(RUNNER_CONFIG)
    cfg["searching"].update(beta_mode="grouped", multi_gpus=True, mesh_spatial=2)
    cfg["searching"]["arch_optimizer"] = dict(cfg["searching"]["arch_optimizer"],
                                              name="adabound")
    cfg["searching"]["arch_optimizer"]["betas"] = list(cfg["searching"]["arch_optimizer"]["betas"])
    cfg["training"]["remat"] = True
    cfg["training"]["model_optimizer"] = dict(cfg["training"]["model_optimizer"],
                                              name="rmsprop", lr=1e-3)
    config = os.path.join(work, "senas_synthetic_keys.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    log_root = os.path.join(work, "logs")
    out = _in_process(search_arc.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    search_dir = _run_dir(out)
    genotype = parse_genotype(out.split("best genotype: ")[1].strip())
    with open(os.path.join(search_dir, "run.log")) as f:
        text = f.read()
    check("beta_mode = grouped" in text and "only 1 device visible" in text,
          "the search run's log lacks its beta_mode or multi_gpus line")
    out = _in_process(train_model.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    train = _scalars(_run_dir(out))
    search = _scalars(search_dir)
    check(all(np.isfinite(v) for v in (*search.values(), *train.values())),
          f"config-key CLI scalars {search} {train}")
    log(f"config-key CLIs: search val dice {search['Val/dice']:.4f}, genotype {genotype!r}; "
        f"train (remat, rmsprop) val dice {train['Val/dice']:.4f}")
    return dict(search_val_dice=search["Val/dice"], train_val_dice=train["Val/dice"],
                genotype=repr(genotype))


def run_config_keys(dev, seed: int) -> dict:
    """Phase 19, timed: the gated BatchNorm path's checks and times, the
    gate on and off in three steps, card against CPU (gate, optimizers),
    remat and the CLIs."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")
        log(f"phase 19: {marks[-1]}")

    t = load_config(CONFIG)["training"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed + 18))
    batch = _batches(np.random.RandomState(seed + 18), 1, t["batch_size"], HW, dev)[0]
    with bn_inputs(model) as seen, torch.no_grad():
        model(batch["image"], train=True)
    shapes = sorted(set(seen)) + [s for s in BN_EXTRA_SHAPES if s not in seen]
    del model
    log(f"BatchNorm shapes held: {len(shapes)} ({len(set(seen))} of the fixed model's "
        f"{len(seen)} calls) + {list(BN_EXTRA_SHAPES)}")
    worst = check_bn_path(dev, seed, shapes)
    mark("BN checks")
    timed = time_bn_kernels(dev, seed)
    mark("BN times")
    steps = run_bn_gate_steps(dev, seed)
    mark("gate on/off steps")
    card_cpu = run_config_keys_card_vs_cpu(dev, seed)
    mark("card vs CPU")
    remat = run_remat(dev, seed)
    mark("remat")
    with tempfile.TemporaryDirectory() as work:
        clis = run_config_clis(work)
    mark("CLIs")
    seconds = time.perf_counter() - t0
    log(f"phase 19 (config keys, SENAS_PALLAS_BN, remat): {seconds:.1f} s ({', '.join(marks)})")
    return dict(checks=worst, timed=timed, steps=steps["steps"], launches=steps["launches"],
                card_vs_cpu=card_cpu, remat=remat, clis=clis, seconds=seconds,
                bn_shapes=[list(s) for s in shapes])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, arch tables and batches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    # TF32 off for convolutions and matmuls, so that the card computes in
    # f32 and its results can be held to the CPU's.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t_start = time.perf_counter()
    smi = environment()
    found = libraries()
    sass = build()
    records = check_kernels(dev)
    records["norm_convs"] = check_norm_convs(dev, args.seed)
    paths = {"norm_convs_call": run_norm_convs_path(dev, args.seed)}
    evald = paths["eval"] = run_eval_path(dev, args.seed)
    search = paths["search_step"] = run_search_path(dev, args.seed)
    card_cpu = train_card_vs_cpu(dev, args.seed)
    runner = run_runner()
    fixed = paths["fixed_train_eval"] = run_fixed_path(dev, args.seed)
    fixed_cpu = fixed_card_vs_cpu(dev, args.seed)
    fixed_clis = run_fixed_clis()
    with tempfile.TemporaryDirectory() as work:
        serve = paths["serve"] = run_serve_path(dev, fixed, args.seed, work)
        paths["submission"] = run_submission(dev, serve.pop("pred"), work, args.seed)
    with tempfile.TemporaryDirectory() as work:
        data = paths["promise12_data"] = run_promise12_path(dev, evald["expect"], work,
                                                            args.seed, found)
    with tempfile.TemporaryDirectory() as work:
        shipped = paths["shipped_configs"] = run_shipped_configs(dev, evald["expect"], work,
                                                                 args.seed)
    zoo = paths["zoo"] = run_zoo(dev, args.seed)
    bf16 = run_bf16(dev, args.seed, records)
    records.update(bf16["records"])
    bf16_zoo = run_bf16_zoo(dev, args.seed, records, zoo)
    records["norm_convs" + BF16_SUFFIX] = bf16_zoo["record"]
    paths["bf16_zoo"] = bf16_zoo["path"]
    paths["bf16_search_step"] = bf16["search"]["search"]
    paths["bf16_search_eval"] = bf16["search"]["eval"]
    paths["bf16_fixed_train_eval"] = dict(launches={
        k: bf16["fixed"]["train"]["launches"][k] + bf16["fixed"]["eval"]["launches"][k]
        for k in KERNELS})
    keys = run_config_keys(dev, args.seed)
    paths["pallas_bn_steps"] = dict(launches=keys["launches"])
    paths["remat_search_steps"] = dict(launches={
        k: sum(keys["remat"]["search"][r]["launches"][k] for r in (False, True)) for k in KERNELS})

    kernels = []
    for name, k in KERNELS.items():
        by_path = {p: r["launches"][name] for p, r in paths.items()}
        check(sum(by_path.values()) > 0, f"{name} was launched on no path: {by_path}")
        r = records[name]
        row = {"name": name, "route": "cuda", "source": k["source"],
               "replaces": k["replaces"], "launches": sum(by_path.values()),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "launches_by_path": by_path, "timed": r["timed"]}
        if name == "norm_convs" + BF16_SUFFIX:
            row.update(bound_by="operations", library_ms=r["library_ms"],
                       library_note="three cuDNN bf16 convolutions (F.conv2d) and torch.cat",
                       bound_note="one bf16 product per product at 989 TFLOP/s bf16",
                       bytes_bound_ms=r["bytes_bound_ms"], f32_ms=r["f32_ms"],
                       tflops=r["tflops"], dtype="bfloat16", shape=r["shape"], n=r["n"],
                       max_share_differing=r["max_share_differing"],
                       max_allowance_used=r["max_allowance_used"])
        elif name == "norm_convs":
            row.update(bound_by="operations", library_ms=r["library_ms"],
                       library_note="three cuDNN convolutions (F.conv2d) and torch.cat, "
                                    "TF32 off",
                       library_tf32_ms=r["library_tf32_ms"],
                       library_single_call_ms=r["library_single_call_ms"],
                       bound_note="3xTF32: 3 TF32 products per f32 product at 495 TFLOP/s",
                       f32_bound_ms=r["f32_bound_ms"], bytes_bound_ms=r["bytes_bound_ms"],
                       tf32_control_rel=r["tf32_control_rel"],
                       tflops_f32_equivalent=r["tflops_f32_equivalent"],
                       tensor_core_sass=sass, shape=r["shape"], n=r["n"])
        else:
            per_search_step = ({f"do_arch={d}": per_step(bf16["search"]["expect"], d)[name]
                                for d in (False, True)} if k["dtype"] == "bfloat16" else
                               {f"do_arch={d}": search["per_step"][d][name]
                                for d in ("False", "True")})
            row.update(bound_by="bytes", library_ms=None, library_note=LIBRARY_NOTE,
                       shape=[8, GROUP_C, HW, HW], n=6, dtype=k["dtype"],
                       launches_per_search_step=per_search_step)
            if "f32_ms" in r:
                row["f32_ms"] = r["f32_ms"]
            row["bn_n1"] = keys["timed"][name]
        if "max_rel_err" in r:
            row["max_rel_err"] = r["max_rel_err"]
        kernels.append(row)
    log(f"summary: eval {evald['eval_ms']:.2f} ms/batch, search {search['step_ms']:.2f} "
        f"ms/step, peak {search['peak_mib']:.1f} MiB, card vs CPU step {card_cpu}, "
        f"runner {runner}; fixed train {fixed['step_ms']:.2f} ms/step, eval "
        f"{fixed['eval_ms']:.2f} ms/batch, peak {fixed['peak_mib']:.1f} MiB, card vs CPU "
        f"{fixed_cpu}, CLIs {fixed_clis}; norm_convs {records['norm_convs']['ms']:.4f} ms "
        f"(plain {records['norm_convs']['plain_ms']:.4f}, library "
        f"{records['norm_convs']['library_ms']:.4f}, library TF32 "
        f"{records['norm_convs']['library_tf32_ms']:.4f}, bound "
        f"{records['norm_convs']['bound_ms']:.4f}, f32 bound "
        f"{records['norm_convs']['f32_bound_ms']:.4f}; SASS {sass})")
    log(f"serve summary: batch 1 {serve['ms'][1]['mean']:.3f} ms/request, batch 12 "
        f"{serve['ms'][12]['mean']:.3f} ms/request, {serve['images_per_s']:.1f} images/s, export "
        f"{serve['export_s']:.2f} s, artifact {serve['artifact_mb']:.2f} MB, load "
        f"{serve['load_s']:.2f} s, peak {serve['peak_mib']:.1f} MiB, card vs CPU "
        f"{serve['cpu_err']:.3g}, TF32 control {serve['tf32_control']}; submission "
        f"{paths['submission']['metrics']}")
    log(f"promise12 data path summary: cache {data['cache']['wall_s']:.2f} s (CLAHE "
        f"{data['cache']['clahe_s']:.2f}, resize {data['cache']['resize_s']:.2f}, curvature "
        f"flow {data['cache']['curvature_flow_s']:.2f}); loader ms/batch {data['loader_ms']}; "
        f"search {data['search_ms_per_step']:.2f} ms/step, prefetch wait "
        f"{data['search_prefetch_wait_share']:.4f}, val fetch "
        f"{data['search_val_fetch_share']:.4f}; fixed {data['train_ms_per_step']:.2f} ms/step, "
        f"prefetch wait {data['train_prefetch_wait_share']:.4f}; launches {data['launches']}; "
        f"contour grid {data['contour_grid']}; libraries that import {found}")
    log(f"shipped configs summary: decode ms/slice {shipped['decode_ms']}; ms/batch "
        f"{shipped['batch_ms']}; heart extraction {shipped['extract_s']:.2f} s; CHAOS search "
        f"{shipped['search_ms_per_step']:.2f} ms/step, prefetch wait "
        f"{shipped['search_prefetch_wait_share']:.4f}, val fetch "
        f"{shipped['search_val_fetch_share']:.4f}; heart train "
        f"{shipped['train_ms_per_step']:.2f} ms/step, prefetch wait "
        f"{shipped['train_prefetch_wait_share']:.4f}; launches {shipped['launches']}")
    log(f"zoo summary ({zoo['seconds']:.1f} s): ms/step, peak MiB "
        f"{ {n: (round(r['step_ms'], 2), round(r['peak_mib'], 1)) for n, r in zoo['models'].items()} }; "
        f"profiles (idle share, busy ms, launches) "
        f"{ {n: (round(r['profile'].get('idle_share', -1), 3), round(r['profile'].get('busy_ms', -1), 2), r['profile'].get('launches')) for n, r in zoo['models'].items() if 'profile' in r} }; "
        f"serving unet batch 1 {zoo['serve']['ms'][1]['mean']:.3f} ms, batch 12 "
        f"{zoo['serve']['ms'][12]['mean']:.3f} ms; losses ms "
        f"{ {n: round(r['ms'], 3) for n, r in zoo['losses'].items()} }")
    bs, bf, bc = bf16["search"], bf16["fixed"], bf16["card_vs_cpu"]
    share_of_bound = {n: {k: round(v["gap"] / max(2 * v["own"] + 1e-6, 1e-30), 3)
                          for k, v in r["bound"].items()} for n, r in bc.items()}
    log(f"bf16 summary ({bf16['seconds']:.1f} s), f32 beside it: search step "
        f"{bs['search']['ms']:.2f} ms/step (f32 {search['step_ms']:.2f}), peak "
        f"{bs['search']['peak_mib']:.1f} MiB (f32 {search['peak_mib']:.1f}), idle share "
        f"{bs['search']['profile'].get('idle_share', -1):.3f} (f32 "
        f"{search['profile'].get('idle_share', -1):.3f}), busy "
        f"{bs['search']['profile'].get('busy_ms', -1):.2f} ms (f32 "
        f"{search['profile'].get('busy_ms', -1):.2f}), launches "
        f"{bs['search']['profile'].get('launches')} (f32 {search['profile'].get('launches')}); "
        f"search-eval {bs['eval']['ms']:.2f} ms/batch (f32 {evald['eval_ms']:.2f}), peak "
        f"{bs['eval']['peak_mib']:.1f} MiB (f32 {evald['peak_mib']:.1f}), idle "
        f"{bs['eval']['profile'].get('idle_share', -1):.3f} (f32 "
        f"{evald['profile'].get('idle_share', -1):.3f}); fixed train "
        f"{bf['train']['ms']:.2f} ms/step (f32 {fixed['step_ms']:.2f}), peak "
        f"{bf['train']['peak_mib']:.1f} MiB (f32 {fixed['peak_mib']:.1f}), idle "
        f"{bf['train']['profile'].get('idle_share', -1):.3f} (f32 "
        f"{fixed['profile'].get('idle_share', -1):.3f}), busy "
        f"{bf['train']['profile'].get('busy_ms', -1):.2f} ms (f32 "
        f"{fixed['profile'].get('busy_ms', -1):.2f}); fixed eval {bf['eval']['ms']:.2f} "
        f"ms/batch (f32 {fixed['eval_ms']:.2f}); card vs CPU "
        f"{share_of_bound} of the bound; CLIs {bf16['clis']}")
    k2b, bz = bf16_zoo["record"], bf16_zoo["path"]["models"]
    log(f"bf16 zoo summary ({bf16_zoo['seconds']:.1f} s): ms/step bf16 (f32) "
        f"{ {n: (round(r['step_ms'], 2), round(zoo['models'][n]['step_ms'], 2)) for n, r in bz.items()} }; "
        f"peak MiB bf16 (f32) "
        f"{ {n: (round(r['peak_mib'], 1), round(zoo['models'][n]['peak_mib'], 1)) for n, r in bz.items()} }; "
        f"logits { {n: r['out_dtype'] for n, r in bz.items()} }; profiles (idle share, busy ms, "
        f"launches) { {n: (round(r['profile'].get('idle_share', -1), 3), round(r['profile'].get('busy_ms', -1), 2), r['profile'].get('launches')) for n, r in bz.items() if 'profile' in r} }; "
        f"card vs CPU share of the bound "
        f"{ {n: round(max(v['gap'] / max(2 * v['own'] + 1e-6, 1e-30) for v in r['bound'].values()), 3) for n, r in bf16_zoo['card_vs_cpu'].items()} }; "
        f"CLIs {bf16_zoo['clis']}; norm_convs bf16 {k2b['ms']:.4f} ms (f32 kernel "
        f"{k2b['f32_ms']:.4f}, plain {k2b['plain_ms']:.4f}, cuDNN bf16 {k2b['library_ms']:.4f}, "
        f"bound {k2b['bound_ms']:.4f})")
    steps = keys["steps"]
    log(f"phase 19 summary ({keys['seconds']:.1f} s): gate on/off ms/step "
        f"{ {n: (round(r['ms_on'], 2), round(r['ms_off'], 2)) for n, r in steps.items()} }; "
        f"busy ms, idle share, BN-class ms, launches on/off "
        f"{ {n: [(round(p.get('busy_ms', -1), 2), round(p.get('idle_share', -1), 3), round(p.get('bn_class_ms', -1), 2), p.get('launches')) for p in r['profile'].values()] for n, r in steps.items()} }; "
        f"BatchNorm calls a step { {n: r['bn_calls'] for n, r in steps.items()} }; checks "
        f"{keys['checks']}; remat ms/step, peak MiB off/on "
        f"{ {n: [(round(r['ms'], 2), round(r['peak_mib'], 1)) for r in keys['remat'][n].values()] for n in ('search', 'fixed')} }; "
        f"remat equal {keys['remat']['equal']}; card vs CPU {keys['card_vs_cpu']}; "
        f"CLIs {keys['clis']}")
    log(f"card: {smi}; total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
