"""Drive the PyTorch port (senas_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: the CUDA kernels of senas_torch/csrc with nvcc (sm_90a);
  3. kernels: each of the four epilogue kernels against its plain PyTorch
     version on the same tensors on the card, at the shapes the supernet
     gives it (train- and eval-mode operands), timed; the epilogue's
     autograd gradients against autograd through the plain reference;
  4. the eval path: the supernet's inference path at the
     configs/senas/senas_promise12.yml `searching:` geometry (batch 8 of
     256x256x1, init_channels 32, depth 5, meta_node_num 3, f32): one
     train-mode forward (running stats move), then the search-eval step on
     3 batches, with the kernels' launch counts checked; the card's logits
     held to the plain CPU path on the first 2 images; one eval step under
     torch.profiler, the eval step with the kernels against the plain
     epilogue in turns;
  5. the search path at the same geometry (batch 8 train + 8 val, the
     yml's SGD and Adam): one bilevel step with do_arch=False, then 3 with
     do_arch=True, with launch counts checked per step; one step under
     torch.profiler; the same step from one saved state with the kernels
     (twice: the card's own spread), with the kernels' plain twins and with
     the plain epilogue, compared leaf by leaf, and timed in turns;
  6. a training step on the card held to the same step on the CPU, at a
     reduced size (depth 3, c 8, 64x64, batch 2) from identical state, with
     TF32 off; the same step with TF32 on must fail the same limits;
  7. the runner: `python -m senas_torch.search_arc` on
     configs/senas/senas_synthetic.yml for its 3 epochs, then resumed from
     its checkpoint for one more.
The line before the last is a JSON list of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

from senas_torch.core.config import load_config
from senas_torch.core.genotype import parse_genotype
from senas_torch.ops import _build
from senas_torch.ops import grouped_epilogue as ge
from senas_torch.search.fused_cell import GroupedMixedOp
from senas_torch.search.supernet import (SenasSearch, derive_genotype,
                                         init_arch_params, normalize_arch)
from senas_torch.train.loss import build_loss
from senas_torch.train.trainer import (SearchTrainState, make_search_eval_step,
                                       make_search_step)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_promise12.yml")
RUNNER_CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
IN_CHANNELS, NCLASS, HW = 1, 2, 256     # promise12: 1-channel MR slices, 2 classes
N_BATCHES = 3
DO_ARCH = (False, True, True, True)     # the search path's steps
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores (data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Group geometry of the flagship supernet: E=3 edges x c_part=8 channels,
# and the sides of its largest and a middle-sized group output.
GROUP_C = 24
KERNEL_HW = (256, 64)
LIBRARY_NOTE = "no one PyTorch call reduces or writes over n separate tensors"
KERNELS = {
    "branch_stats": dict(
        wrapper=ge.branch_stats,
        replaces="senas_tpu/ops/grouped_epilogue.py:114 (_branch_stats -> _stats_kernel :86)"),
    "apply_mix": dict(
        wrapper=ge.apply_mix,
        replaces="senas_tpu/ops/grouped_epilogue.py:157 (_apply_mix -> _apply_kernel :143)"),
    "bwd_reduce": dict(
        wrapper=ge.bwd_reduce,
        replaces="senas_tpu/ops/grouped_epilogue.py:206 (_bwd_reduce -> _bwd_reduce_kernel :189)"),
    "bwd_dx": dict(
        wrapper=ge.bwd_dx,
        replaces="senas_tpu/ops/grouped_epilogue.py:251 (_bwd_dx -> _bwd_dx_kernel :237)"),
}


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
        k["wrapper"].launches = 0


def counts():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


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


def build() -> None:
    t0 = time.perf_counter()
    seconds = _build.build(["grouped_epilogue"])
    log(f"build: {seconds} (wall {time.perf_counter() - t0:.2f} s)")
    for line in _build.build_log("grouped_epilogue").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version on the card
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


def _epilogue_grad_err(args, kw, readout) -> float:
    """The autograd Function's gradients for every differentiable input
    against torch autograd through the plain two-pass reference, on the
    same tensors: the worst max|got - want| / max|want| over the inputs."""
    leaves = [t.detach().clone().requires_grad_() for part in args for t in part]
    n = len(args[0])
    split = [leaves[i * n:(i + 1) * n] for i in range(4)]
    extra = {k: kw[k].detach().clone().requires_grad_() for k in _DIFF if k in kw}
    rest = {k: v for k, v in kw.items() if k not in _DIFF}
    inputs = leaves + list(extra.values())
    got = torch.autograd.grad(
        (ge.fused_group_epilogue(*split, **rest, **extra)[0] * readout).sum(), inputs)
    want = torch.autograd.grad(
        (ge.group_epilogue_reference(*split, **rest, **extra) * readout).sum(), inputs)
    return max(rel_err(a, b) for a, b in zip(got, want))


def check_kernels(dev) -> dict:
    """Returns per-kernel records: the worst errors over every case, times at
    each shape in `timed`, and those of the heaviest main-path shape
    ([8,24,256,256], n=6) as `ms`, `plain_ms`, `bound_ms`."""
    records = {name: {} for name in KERNELS}
    worst = {name: 0.0 for name in KERNELS}
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
    for name in KERNELS:
        records[name]["max_abs_err"] = worst[name]
    records["branch_stats"]["max_rel_err"] = worst["stats_rel"]
    records["bwd_reduce"]["max_rel_err"] = worst["reduce_rel"]
    log(f"kernels agree with their plain versions (worst: {worst})")
    return records


_TIMED = (("branch_stats", "stats"), ("apply_mix", "mix"), ("bwd_reduce", "reduce"),
          ("bwd_dx", "dx"))


# ---------------------------------------------------------------------------
# Profiles and the plain epilogue swapped in
# ---------------------------------------------------------------------------

_KERNEL_CLASSES = (
    ("branch_stats (K1a)", ("branch_stats_kernel",)),
    ("apply_mix (K1b)", ("apply_mix_kernel",)),
    ("bwd_reduce (K1c)", ("bwd_reduce_partial_kernel", "bwd_reduce_finish_kernel")),
    ("bwd_dx (K1d)", ("bwd_dx_kernel",)),
    ("matmul", ("xmma_gemm", "sgemm", "gemv")),
    ("convolution", ("conv", "cudnn", "implicit", "gemm", "xmma", "sm90", "fprop",
                     "dgrad", "wgrad", "depthwise", "winograd", "cutlass")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "bn_")),
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
    # the heaviest operators with the shapes they were called on
    ops = [a for a in prof.key_averages(group_by_input_shape=True)
           if a.key.startswith("aten::")]
    for a in sorted(ops, key=lambda a: -a.device_time_total)[:6]:
        log(f"  by shape: {a.device_time_total / 1e3:8.3f} ms  x{a.count:<4d} {a.key} "
            f"{str(a.input_shapes)[:160]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle_share=idle,
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
# Phase 4: the eval path
# ---------------------------------------------------------------------------

def expected_launches(model) -> dict:
    """Launches per forward and per backward, from the model: every
    GroupedMixedOp applies its mix; in eval mode only the groups with an SE
    branch (DOWN, UP) need the stats sweep. A backward runs bwd_reduce for
    every group and bwd_dx for every group whose branch tensors need a
    gradient: all of them, since every branch comes out of a convolution,
    pooling or resampling of a tensor that depends on the weights."""
    groups = [m for m in model.modules() if isinstance(m, GroupedMixedOp)]
    with_se = sum("se_conv_3" in g.ops for g in groups)
    zero = {name: 0 for name in KERNELS}
    g = len(groups)
    return {"train": {**zero, "branch_stats": g, "apply_mix": g},
            "eval": {**zero, "branch_stats": with_se, "apply_mix": g},
            "backward": {**zero, "bwd_reduce": g, "bwd_dx": g}}


def per_step(expect: dict, do_arch: bool) -> dict:
    """A search step: one train-mode forward and backward, two with do_arch."""
    k = 2 if do_arch else 1
    return {name: k * (expect["train"][name] + expect["backward"][name]) for name in KERNELS}


def _supernet(s, dev, gen):
    return SenasSearch(IN_CHANNELS, s["init_channels"], NCLASS, s["depth"], s["meta_node_num"],
                       double_down_channel=s["double_down_channel"],
                       supervision=s["deep_supervision"], device=dev, generator=gen)


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
# Phase 5: the search path
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


def _metrics_rel(a: dict, b: dict) -> dict:
    return {k: abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-30)
            for k in ("loss", "arch_loss", "grad_norm")}


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
# Phase 6: a training step on the card against the CPU
# ---------------------------------------------------------------------------

# Limits of the card-vs-CPU step, from its readings on an H100 (loss, arch
# loss and grad norm within 2.7e-7, weight update 1.5e-5, arch update
# 1.2e-6, running stats 4.6e-7), with room on both sides: the same step
# with TF32 on must fail them.
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
# Phase 7: the runner and its resume
# ---------------------------------------------------------------------------

def _search_cli(config: str, *args: str) -> str:
    cmd = [sys.executable, "-m", "senas_torch.search_arc", "--config", config, *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"  {' '.join(cmd[1:])}: rc {out.returncode}, {time.perf_counter() - t0:.1f} s")
    check(out.returncode == 0, f"search CLI failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout


def _val_epochs(run_dir: str) -> list:
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if r["tag"] == "Val/dice"]


def run_runner() -> dict:
    cfg = load_config(RUNNER_CONFIG)
    epochs = cfg["searching"]["epoch"]
    with tempfile.TemporaryDirectory() as log_root:
        first = _search_cli(RUNNER_CONFIG, "--log_root", log_root)
        run_dir = first.split("run dir: ")[1].splitlines()[0].strip()
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
        resumed = _search_cli(resume_config, "--log_root", os.path.join(log_root, "resumed"))
        check(f"at epoch {epochs}" in resumed, "the resumed run did not start at the "
              f"checkpoint's epoch {epochs}")
        run_dir2 = resumed.split("run dir: ")[1].splitlines()[0].strip()
        check(_val_epochs(run_dir2) == [epochs],
              f"the resumed run ran epochs {_val_epochs(run_dir2)}, expected [{epochs}]")
        log(f"runner: {epochs} epochs then 1 resumed; genotype {best!r}")
    return dict(epochs=epochs, resumed_epochs=1)


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
    build()
    records = check_kernels(dev)
    evald = run_eval_path(dev, args.seed)
    search = run_search_path(dev, args.seed)
    card_cpu = train_card_vs_cpu(dev, args.seed)
    runner = run_runner()

    for name in KERNELS:
        launched = evald["launches"][name] + search["launches"][name]
        check(launched > 0, f"{name} was not launched on the main path")
    kernels = []
    for name, k in KERNELS.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "senas_torch/csrc/grouped_epilogue.cu",
            "replaces": k["replaces"],
            "launches": evald["launches"][name] + search["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "library_note": LIBRARY_NOTE, "shape": [8, GROUP_C, HW, HW], "n": 6,
            "launches_by_path": {"eval": evald["launches"][name],
                                 "search_step": search["launches"][name]},
            "launches_per_search_step": {f"do_arch={d}": search["per_step"][d][name]
                                         for d in ("False", "True")},
            "timed": r["timed"],
        })
        if "max_rel_err" in r:
            kernels[-1]["max_rel_err"] = r["max_rel_err"]
    log(f"summary: eval {evald['eval_ms']:.2f} ms/batch, search {search['step_ms']:.2f} "
        f"ms/step, peak {search['peak_mib']:.1f} MiB, card vs CPU step {card_cpu}, "
        f"runner {runner}")
    log(f"card: {smi}; total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
