"""Drive the PyTorch port (senas_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: the CUDA kernels of senas_torch/csrc with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the same
     tensors on the card, at the shapes the supernet gives it, and timed;
  4. the slice: the supernet's inference path at the
     configs/senas/senas_promise12.yml `searching:` geometry (batch 8 of
     256x256x1, init_channels 32, depth 5, meta_node_num 3, f32): one
     train-mode forward (running stats move), then the search-eval step on
     3 batches, with the kernels' launch counts checked; the card's logits
     are held to the plain CPU path on the first 2 images; one eval step
     under torch.profiler (device idle share, kernel time by class), the
     eval step with the kernels against the plain epilogue in turns; then
     the derived genotype.
The line before the last is a JSON list of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from senas_torch.core.config import load_config
from senas_torch.ops import _build
from senas_torch.ops import grouped_epilogue as ge
from senas_torch.search.fused_cell import GroupedMixedOp
from senas_torch.search.supernet import (SenasSearch, derive_genotype,
                                         init_arch_params, normalize_arch)
from senas_torch.train.loss import build_loss
from senas_torch.train.trainer import make_search_eval_step

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_promise12.yml")
IN_CHANNELS, NCLASS, HW = 1, 2, 256     # promise12: 1-channel MR slices, 2 classes
N_BATCHES = 3
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores (data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Group geometry of the flagship supernet: E=3 edges x c_part=8 channels.
GROUP_C = 24
KERNELS = {
    "branch_stats": dict(
        wrapper=ge.branch_stats,
        replaces="senas_tpu/ops/grouped_epilogue.py:114 (_branch_stats -> _stats_kernel :86)"),
    "apply_mix": dict(
        wrapper=ge.apply_mix,
        replaces="senas_tpu/ops/grouped_epilogue.py:157 (_apply_mix -> _apply_kernel :143)"),
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


def check_kernels(dev) -> dict:
    """Returns per-kernel records: the worst errors over every case, times at
    each shape in `timed`, and those of the heaviest main-path shape
    ([8,24,256,256], n=6) as `ms`, `plain_ms`, `bound_ms`."""
    records = {name: {} for name in KERNELS}
    worst = {"branch_stats": 0.0, "apply_mix": 0.0, "epilogue": 0.0, "stats_rel": 0.0}
    for h in (256, 64):
        for n, se, none in ((6, True, False), (5, False, True)):
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
                a = torch.randn(n, 8, GROUP_C, device=dev)
                k = torch.randn(8, GROUP_C, device=dev)
                err2 = (ge.apply_mix(xs, a, k) - ge.apply_mix_plain(xs, a, k)).abs().max().item()
                check(err2 <= 1e-4, f"apply_mix disagrees: {err2:.3g} (h={h} n={n})")
                # the whole epilogue against the port's two-pass reference
                got, _ = ge.fused_group_epilogue(*args, **kw)
                want = ge.group_epilogue_reference(*args, **kw)
                err3 = (got - want).abs().max().item()
                check(err3 <= 1e-4, f"fused_group_epilogue disagrees: {err3:.3g}")
                torch.cuda.synchronize()
                worst["stats_rel"] = max(worst["stats_rel"], rel)
                worst["branch_stats"] = max(worst["branch_stats"], err1)
                worst["apply_mix"] = max(worst["apply_mix"], err2)
                worst["epilogue"] = max(worst["epilogue"], err3)
                log(f"  h={h:3d} n={n} train={train!s:5} se={se!s:5} none={none!s:5}: "
                    f"stats abs {err1:.3g} rel {rel:.3g} | mix {err2:.3g} | epilogue {err3:.3g}")

            # times at this shape (n branches, train mode)
            args, kw = _group_inputs(dev, n, h, seed=1, train=True, se=se, none=none)
            xs = args[0]
            a = torch.rand(n, 8, GROUP_C, device=dev)
            k = torch.rand(8, GROUP_C, device=dev)
            elems = n * 8 * GROUP_C * h * h
            stats_bytes = elems * 4 + 2 * n * 8 * GROUP_C * 4
            mix_bytes = elems * 4 + (n + 1) * 8 * GROUP_C * 4 + 8 * GROUP_C * h * h * 4
            t = dict(
                stats=time_ms(lambda: ge.branch_stats(xs)),
                stats_plain=time_ms(lambda: ge.branch_stats_plain(xs)),
                mix=time_ms(lambda: ge.apply_mix(xs, a, k)),
                mix_plain=time_ms(lambda: ge.apply_mix_plain(xs, a, k)),
                epi=time_ms(lambda: ge.fused_group_epilogue(*args, **kw)),
                epi_plain=time_ms(lambda: ge.group_epilogue_reference(*args, **kw)),
            )
            bound = dict(
                stats=max(stats_bytes / PEAK_BYTES_PER_S, 3 * elems / PEAK_F32_FLOPS) * 1e3,
                mix=max(mix_bytes / PEAK_BYTES_PER_S, 2 * elems / PEAK_F32_FLOPS) * 1e3,
            )
            log(f"  times [8,{GROUP_C},{h},{h}] n={n}: branch_stats {t['stats']:.4f} ms "
                f"(plain {t['stats_plain']:.4f}, bound {bound['stats']:.4f}) | apply_mix "
                f"{t['mix']:.4f} ms (plain {t['mix_plain']:.4f}, bound {bound['mix']:.4f}) | "
                f"fused_group_epilogue {t['epi']:.4f} ms (plain reference {t['epi_plain']:.4f})")
            for name, key in (("branch_stats", "stats"), ("apply_mix", "mix")):
                records[name].setdefault("timed", []).append(dict(
                    shape=[8, GROUP_C, h, h], n=n, ms=t[key], plain_ms=t[f"{key}_plain"],
                    bound_ms=bound[key]))
            if (h, n) == (256, 6):
                for name, key in (("branch_stats", "stats"), ("apply_mix", "mix")):
                    records[name].update(ms=t[key], plain_ms=t[f"{key}_plain"],
                                         bound_ms=bound[key])
    for name in KERNELS:
        records[name]["max_abs_err"] = worst[name]
    records["branch_stats"]["max_rel_err"] = worst["stats_rel"]
    log(f"kernels agree with their plain versions (worst: {worst})")
    return records


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def expected_launches(model) -> dict:
    """Per forward: every GroupedMixedOp applies its mix; in eval mode only
    the groups with an SE branch (DOWN, UP) need the stats sweep."""
    groups = [m for m in model.modules() if isinstance(m, GroupedMixedOp)]
    with_se = sum("se_conv_3" in g.ops for g in groups)
    return {"train": {"branch_stats": len(groups), "apply_mix": len(groups)},
            "eval": {"branch_stats": with_se, "apply_mix": len(groups)}}


_KERNEL_CLASSES = (
    ("branch_stats (K1a)", ("branch_stats_kernel",)),
    ("apply_mix (K1b)", ("apply_mix_kernel",)),
    ("convolution", ("conv", "cudnn", "implicit", "gemm", "xmma", "sm90", "fprop",
                     "dgrad", "depthwise", "winograd", "cutlass")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_")),
    ("pool / upsample", ("pool", "upsample", "interp")),
    ("copy / cat", ("copy", "memcpy", "memset", "cat", "Cat")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_eval(step, arch, batch) -> None:
    """One eval step under torch.profiler: device busy and idle share over
    the step's wall time, and kernel time by class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(arch, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(arch, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler recorded no device time (not measured)")
        return
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
    log(f"profile (one eval step, batch {batch['image'].shape[0]}): wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}, {len(kernels)} kernel launches")
    for cls, (t, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        log(f"  {cls:20s} {t / 1e3:8.3f} ms  {n:5d} launches  {t / busy:.3f} of busy")
    top = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)[:8]
    for a in top:
        log(f"  top: {a.self_device_time_total / 1e3:8.3f} ms  x{a.count:<4d} {a.key[:100]}")

    # End to end: the same eval step with the epilogue's plain reference in
    # place of the kernels (a measurement-only swap), in turns.
    from senas_torch.search import fused_cell
    kernel_fn = fused_cell.fused_group_epilogue

    def plain_fn(xs, *args, **kw):   # eval mode: the caller reads no stats
        return ge.group_epilogue_reference(xs, *args, **kw), (None, None)

    def timed(reps=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step(arch, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    times = {"kernels": [], "plain": []}
    for mode in ("kernels", "plain", "plain", "kernels"):
        fused_cell.fused_group_epilogue = kernel_fn if mode == "kernels" else plain_fn
        try:
            times[mode].append(timed())
        finally:
            fused_cell.fused_group_epilogue = kernel_fn
    log(f"eval step ms/batch, kernels vs plain epilogue (in turns k,p,p,k): "
        f"kernels {[round(t, 3) for t in times['kernels']]}, "
        f"plain {[round(t, 3) for t in times['plain']]}")


def run_slice(dev, seed: int, n_batches: int = N_BATCHES) -> dict:
    s = load_config(CONFIG)["searching"]
    meta, depth, bs = s["meta_node_num"], s["depth"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed)
    model = SenasSearch(IN_CHANNELS, s["init_channels"], NCLASS, depth, meta,
                        double_down_channel=s["double_down_channel"],
                        supervision=s["deep_supervision"], device=dev, generator=gen)
    arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"],
                            generator=gen, device=dev)
    normalize = lambda a: normalize_arch(a, meta)
    step = make_search_eval_step(model, normalize, build_loss(s["loss"]["name"],
                                                              s["deep_supervision"]))
    expect = expected_launches(model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"supernet: init_channels {s['init_channels']} depth {depth} meta {meta} "
        f"batch {bs} {HW}x{HW}x{IN_CHANNELS}, {n_params} parameters, "
        f"expected launches per forward {expect}")

    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n_batches):
        img = rng.randn(bs, HW, HW, IN_CHANNELS).astype(np.float32)
        label = (rng.rand(bs, HW, HW) > 0.7).astype(np.int64)
        batches.append({"image": torch.from_numpy(img).to(dev),
                        "label": torch.from_numpy(label).to(dev)})

    reset_counts()
    total = {name: 0 for name in KERNELS}
    # train-mode forward (no grad: the backward is the next slice's work)
    with torch.no_grad():
        out = model(batches[0]["image"], normalize(arch), train=True)
    torch.cuda.synchronize()
    got = counts()
    log(f"train-mode forward launches {got}")
    check(got == expect["train"], f"train forward launched {got}, expected {expect['train']}")
    check(bool(torch.isfinite(out[0]).all()), "train forward gave non-finite logits")
    for k in total:
        total[k] += got[k]

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
        for k in total:
            total[k] += got[k]
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
    cpu_model = SenasSearch(IN_CHANNELS, s["init_channels"], NCLASS, depth, meta,
                            double_down_channel=s["double_down_channel"],
                            supervision=s["deep_supervision"], device="cpu")
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
    rel_err = ((card - ref).abs() / (ref.abs() + 1e-3)).max().item()
    scale = ref.abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"card vs CPU plain path (2 images): max |logit| {scale:.4g}, max abs err "
        f"{abs_err:.3g}, max rel err {rel_err:.3g}, argmax agreement {agree:.6f} "
        f"(CPU forward {cpu_s:.1f} s)")
    torch.testing.assert_close(card, ref, rtol=1e-3, atol=1e-3)
    check(agree >= 0.999, f"argmax agreement {agree:.6f} < 0.999")

    profile_eval(step, arch, batches[-1])

    geno = derive_genotype(arch, meta, depth)
    log(f"genotype: {geno!r}")
    return dict(total_launches=total, expect=expect, eval_ms=float(np.mean(steady)),
                peak_mib=peak / 2**20, cpu_abs_err=abs_err, argmax_agreement=agree)


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
    result = run_slice(dev, args.seed)

    kernels = []
    for name, k in KERNELS.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "senas_torch/csrc/grouped_epilogue.cu",
            "replaces": k["replaces"], "launches": result["total_launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "shape": [8, GROUP_C, HW, HW], "n": 6,
            "launches_per_forward": {m: result["expect"][m][name] for m in ("train", "eval")},
            "timed": r["timed"],
        })
        if "max_rel_err" in r:
            kernels[-1]["max_rel_err"] = r["max_rel_err"]
    log(f"card: {smi}; total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
