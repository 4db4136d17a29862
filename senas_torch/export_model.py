"""Export a trained checkpoint of the port as a `torch.export` serving
artifact (`senas_torch/serve.py`).

    python -m senas_torch.export_model --config configs/senas/senas_promise12.yml \
        --resume <ckpt dir> --out <artifact dir> [--model senas] [--genotype "..."]
        [--name best|last] [--check] [--f32] [--device cuda|cpu]

The flags of tools/export_model.py, plus --device (default cuda). It reads
the port's checkpoint (`CheckpointManager.restore_raw(name)["model"]`;
default: "best" if present, else "last"), builds the model from the
config's `training:` section and exports it at the dataset's crop size on
that device. --f32 records "float32" as the artifact's matmul precision:
its `Predictor` turns TF32 off around each call. --check reloads the
artifact and holds its logits on a random batch of 2 to the in-process
model (rtol = atol = 1e-4).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from senas_torch.core.config import load_config
from senas_torch.core.device import resolve_device
from senas_torch.data import get_dataset_spec
from senas_torch.models.factory import get_segmentation_model
from senas_torch.runner.train import resolve_genotype
from senas_torch.serve import (PROGRAM_FILE, Predictor, export_predict_fn, save_artifact,
                               serving_precision)
from senas_torch.train.checkpoint import CheckpointManager


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="export a checkpoint as a torch.export artifact")
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", required=True, help="checkpoint directory (CheckpointManager)")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--model", default="senas")
    ap.add_argument("--genotype", default="")
    ap.add_argument("--name", default="", choices=["", "best", "last"],
                    help="which checkpoint to export (default: best if present, else last)")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and verify logits match the in-process "
                         "model on a random batch")
    ap.add_argument("--f32", action="store_true",
                    help="serve at float32 matmul precision: TF32 off for cuDNN and cuBLAS "
                         "around each call (torch's default for cuDNN is TF32 on)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    t = cfg["training"]
    spec = get_dataset_spec(cfg["data"]["dataset"])
    hw = spec.crop_size
    if not os.path.isdir(args.resume):
        raise SystemExit(f"no checkpoint directory {args.resume}")
    mgr = CheckpointManager(args.resume)
    name = args.name or ("best" if mgr.exists("best") else "last")
    restored = mgr.restore_raw(name)
    if restored is None:
        raise SystemExit(f"checkpoint {name!r} not found in {args.resume}")
    model = get_segmentation_model(
        args.model, dataset=cfg["data"]["dataset"], c=t.get("init_channels", 32),
        depth=t.get("depth", 5), supervision=False,
        genotype=resolve_genotype(cfg, args.genotype, args.model),
        double_down_channel=t.get("double_down_channel", False), device=device)
    model.load_state_dict(restored["model"])
    model.eval()

    precision = "float32" if args.f32 else "backend-default"
    in_shape = (hw[0], hw[1], spec.in_channels)
    t0 = time.perf_counter()
    exported = export_predict_fn(model, in_shape, matmul_precision=precision)
    export_s = time.perf_counter() - t0
    meta = {
        "model": args.model,
        "dataset": cfg["data"]["dataset"],
        "input_hw": list(hw),
        "in_channels": spec.in_channels,
        "num_classes": spec.num_class,
        "checkpoint": os.path.abspath(args.resume),
        "checkpoint_name": name,
        "checkpoint_meta": restored.get("meta", {}),
        "matmul_precision": precision,
        "exported_on": str(device),
        "export_seconds": export_s,
    }
    save_artifact(exported, meta, args.out)
    size = os.path.getsize(os.path.join(args.out, PROGRAM_FILE))
    print(f"exported {args.model} ({name}) -> {args.out} ({size / 1e6:.1f} MB, input "
          f"[b,{hw[0]},{hw[1]},{spec.in_channels}], {precision}) in {export_s:.2f} s")

    if args.check:
        pred = Predictor(args.out, device=device)
        rs = np.random.RandomState(0)
        x = rs.randn(2, hw[0], hw[1], spec.in_channels).astype(np.float32)
        got = pred.logits(x).cpu().numpy()
        with torch.inference_mode(), serving_precision(precision):
            want = model(torch.from_numpy(x).to(device), train=False)[-1].cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        masks = pred.predict_masks(x)
        if masks.shape != (2, hw[0], hw[1]) or masks.dtype != np.uint8:
            raise SystemExit(f"masks are {masks.dtype} {masks.shape}")
        print(f"check OK: artifact logits match in-process model "
              f"(max |err| {np.abs(got - want).max():.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
