"""Fixed-model training CLI of the PyTorch port.

    python -m senas_torch.train_model --config configs/senas/senas_synthetic.yml [--device cpu]

The flag surface of experiments/train_model.py (the reference's
experiments/train_model.py:41-60): --config / --model / --ft / --genotype /
--loss / --depth / --batch_size / --epoch / --data_root / --log_root, whose
overrides go onto the `training:` section of the YAML config, plus --device
(default cuda; `cpu` runs the kernels' plain versions). A run resumes from
the checkpoint directory that `training.resume` names; --ft then restarts
the epoch and best-metric counters. Run directories go under the checkout's
logs/ unless --log_root names another place; the default config is the
checkout's configs/senas/senas_promise12.yml.

With `multi_gpus: true` in `training:` on a host with N >= 2 visible cards,
the CLI starts N processes, one a card, which run data-parallel over the
global batch (`senas_torch.parallel.launch`); with SENAS_COORDINATOR,
SENAS_NUM_PROCESSES and SENAS_PROCESS_ID set it joins that process group
as that rank instead (several hosts). Rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import sys

from senas_torch.core.config import load_config
from senas_torch.models.factory import check_model_name
from senas_torch.parallel.launch import launch, ranks_to_spawn
from senas_torch.runner.common import DEFAULT_CONFIG, DEFAULT_LOG_ROOT, is_main
from senas_torch.runner.train import TrainRunner


def override_loss_depth(cfg, args) -> None:
    """--loss and --depth onto the `training:` section."""
    if args.loss:
        cfg["training"].setdefault("loss", {})
        cfg["training"]["loss"]["name"] = args.loss
    if args.depth > 0:
        cfg["training"]["depth"] = args.depth


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="senas_torch model training")
    parser.add_argument("--config", nargs="?", type=str, default=DEFAULT_CONFIG,
                        help="Configuration file to use")
    parser.add_argument("--model", nargs="?", type=str, default="senas",
                        help="Model to train and evaluation")
    parser.add_argument("--ft", action="store_true", default=False,
                        help="fine tuning on a different dataset")
    parser.add_argument("--genotype", nargs="?", type=str, default="",
                        help="Model architecture (genotype string)")
    parser.add_argument("--loss", nargs="?", type=str, default="", help="Loss function")
    parser.add_argument("--depth", nargs="?", type=int, default=-1)
    parser.add_argument("--batch_size", nargs="?", type=int, default=-1)
    parser.add_argument("--epoch", nargs="?", type=int, default=-1)
    parser.add_argument("--data_root", nargs="?", type=str, default=None,
                        help="dataset directory (the synthetic dataset needs none)")
    parser.add_argument("--log_root", nargs="?", type=str, default=DEFAULT_LOG_ROOT,
                        help="where run directories go (default: logs/ of the checkout)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    override_loss_depth(cfg, args)
    if args.batch_size > 0:
        cfg["training"]["batch_size"] = args.batch_size
    if args.epoch > 0:
        cfg["training"]["epoch"] = args.epoch
    ranks = ranks_to_spawn(cfg["training"], args.device)
    if ranks:
        check_model_name(args.model)
        return launch("senas_torch.train_model", sys.argv[1:] if argv is None else argv, ranks)

    runner = TrainRunner(cfg, model_name=args.model, genotype_str=args.genotype,
                         config_path=args.config, data_root=args.data_root,
                         log_root=args.log_root, ft=args.ft, device=args.device)
    result = runner.run()
    if is_main(runner.mesh):
        print("run dir:", runner.run_dir)
        print("best:", result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
