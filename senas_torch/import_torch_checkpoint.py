"""Convert a PyTorch reference checkpoint into a checkpoint directory of the
port that the runners resume from.

    python -m senas_torch.import_torch_checkpoint CKPT --config configs/senas/senas_promise12.yml \
        --out <ckpt dir> [--kind auto|train|search] [--genotype "..."] [--depth N]
        [--meta_node_num N] [--device cuda|cpu]

The flags of tools/import_torch_checkpoint.py, plus --device (default
cuda): the device the port's model is built on to check and hold the
weights. The reference's train CLI (experiments/train_model.py:220-233) and
search CLI (experiments/search_arc.py:227-238) save `checkpint.pth.tar` /
`model_best.pth.tar` (utils/utils.py:138-143). The output holds "last" and
"best" (`CheckpointManager`): a fixed model's `FixedTrainState` or the
supernet's `SearchTrainState` with its arch tables. Optimizer slot state is
not translated: the optimizers are fresh, built from the config, and the
run meta (epoch, best metrics, patience, geno_type) is carried over, so
`train_model` (`training.resume`), `search_arc` (`searching.resume`) and
`testing_model --resume` continue at the right epoch with fresh momentum.
The translated tree is checked against the port's model first: missing or
extra leaves and shape mismatches stop the import.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

import numpy as np
import torch

from senas_torch.compat import (classify_checkpoint, import_fixed_checkpoint,
                                import_search_checkpoint, load_torch_checkpoint)
from senas_torch.convert import (arch_to_numpy, arch_to_torch, load_variables,
                                 state_dict_to_variables)
from senas_torch.core.config import load_config
from senas_torch.core.device import resolve_device
from senas_torch.data import get_dataset_spec
from senas_torch.models.factory import ZOO, get_segmentation_model
from senas_torch.runner.train import resolve_genotype
from senas_torch.search.supernet import SenasSearch, init_arch_params
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.trainer import FixedTrainState, SearchTrainState


def _shapes(tree: Dict[str, Any], prefix: str = "") -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(np.shape(v))
    return out


def check_structure(template: Dict[str, Any], built: Dict[str, Any], what: str) -> None:
    """Raise SystemExit unless `built` has the leaves of `template`, each of
    its shape."""
    t_paths, b_paths = _shapes(template), _shapes(built)
    missing = sorted(set(t_paths) - set(b_paths))
    extra = sorted(set(b_paths) - set(t_paths))
    if missing or extra:
        raise SystemExit(
            f"{what}: translated tree does not match the model "
            f"(missing {missing[:5]}{'...' if len(missing) > 5 else ''}, "
            f"extra {extra[:5]}{'...' if len(extra) > 5 else ''}) — check "
            f"--depth/--meta_node_num/--genotype against the torch run")
    bad = [k for k in t_paths if t_paths[k] != b_paths[k]]
    if bad:
        k = bad[0]
        raise SystemExit(f"{what}: shape mismatch at {k}: model "
                         f"{t_paths[k]} vs checkpoint {b_paths[k]} "
                         f"(+{len(bad) - 1} more)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="import a reference torch checkpoint")
    ap.add_argument("checkpoint", help="torch .pth.tar checkpoint path")
    ap.add_argument("--config", required=True, help="the run's YAML config")
    ap.add_argument("--out", required=True, help="output checkpoint directory")
    ap.add_argument("--kind", default="auto", choices=["auto", "train", "search"])
    ap.add_argument("--model", default="senas",
                    help="model the checkpoint was trained with (train kind); only "
                         "senas is ported")
    ap.add_argument("--genotype", default="",
                    help="genotype string (train kind; default: the config's "
                         "training.geno_type)")
    ap.add_argument("--depth", type=int, default=-1)
    ap.add_argument("--meta_node_num", type=int, default=-1)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    ckpt = load_torch_checkpoint(args.checkpoint)
    kind = classify_checkpoint(ckpt) if args.kind == "auto" else args.kind
    if kind == "state_dict":
        kind = "train"  # bare SenasModel state_dict
    spec = get_dataset_spec(cfg["data"]["dataset"])

    if kind == "train":
        if args.model != "senas":
            raise SystemExit(
                f"--model {args.model!r} has no translator in the port: only senas is "
                f"ported; the baseline zoo ({', '.join(ZOO)}) waits for ROADMAP.md "
                "Queue 1, M15")
        t = cfg["training"]
        depth = args.depth if args.depth > 0 else t.get("depth", 5)
        genotype = resolve_genotype(cfg, args.genotype)
        model = get_segmentation_model(
            "senas", dataset=cfg["data"]["dataset"], c=t.get("init_channels", 32),
            depth=depth, supervision=t.get("deep_supervision", False), genotype=genotype,
            double_down_channel=t.get("double_down_channel", False), device=device)
        variables, meta = import_fixed_checkpoint(ckpt, genotype, depth)
        check_structure(state_dict_to_variables(model), variables, args.model)
        load_variables(model, variables)
        state = FixedTrainState.create(model, t.get("model_optimizer"))
    else:
        s = cfg["searching"]
        depth = args.depth if args.depth > 0 else s.get("depth", 5)
        meta_nodes = args.meta_node_num if args.meta_node_num > 0 else s.get("meta_node_num", 3)
        use_sharing = s.get("sharing_normal", True)
        net = SenasSearch(spec.in_channels, s.get("init_channels", 32), spec.num_class,
                          depth, meta_nodes,
                          double_down_channel=s.get("double_down_channel", False),
                          supervision=s.get("deep_supervision", False), device=device)
        arch0 = init_arch_params(meta_nodes, depth, use_sharing=use_sharing,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
        variables, arch, meta = import_search_checkpoint(
            ckpt, depth, meta_nodes, use_sharing=use_sharing, fused=True)
        check_structure(state_dict_to_variables(net), variables, "supernet")
        check_structure(arch_to_numpy(arch0), arch, "arch params")
        load_variables(net, variables)
        state = SearchTrainState.create(
            net, arch_to_torch(arch, device), s.get("model_optimizer"),
            s.get("arch_optimizer"),
            arch_in_weight_step=bool(s.get("arch_in_weight_step", True)))

    mgr = CheckpointManager(args.out)
    mgr.save(state, meta, is_best=True, name="last")
    print(f"imported {kind} checkpoint -> {mgr.directory} (epoch {meta.get('epoch', 0)}); "
          f"resume with {'training' if kind == 'train' else 'searching'}.resume: "
          f"{mgr.directory}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
