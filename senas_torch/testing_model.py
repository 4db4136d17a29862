"""Evaluation CLI of the PyTorch port.

    python -m senas_torch.testing_model --config configs/senas/senas_synthetic.yml \
        --resume <train run dir>/ckpt [--device cpu]

The flag surface of experiments/testing_model.py (the reference's
experiments/testing_model.py:37-50): --config / --model / --genotype /
--loss / --depth / --batch_size / --resume / --data_root / --log_root, plus
--device (default cuda). It evaluates the "best" checkpoint of the
directory --resume names (else its "last") on the val split and writes the
predicted masks and grids under <run dir>/images/. Run directories go under
the checkout's logs/ unless --log_root names another place.

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
from senas_torch.models import geno_searched
from senas_torch.models.factory import check_model_name
from senas_torch.parallel.launch import launch, ranks_to_spawn
from senas_torch.runner.common import DEFAULT_CONFIG, DEFAULT_LOG_ROOT, is_main
from senas_torch.runner.test import TestRunner
from senas_torch.train_model import override_loss_depth

DEFAULT_GENOTYPE = repr(geno_searched.senas_node_4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="senas_torch model evaluation")
    parser.add_argument("--config", nargs="?", type=str, default=DEFAULT_CONFIG)
    parser.add_argument("--model", nargs="?", type=str, default="senas")
    parser.add_argument("--genotype", nargs="?", type=str, default=DEFAULT_GENOTYPE)
    parser.add_argument("--loss", nargs="?", type=str, default="")
    parser.add_argument("--depth", nargs="?", type=int, default=-1)
    parser.add_argument("--batch_size", nargs="?", type=int, default=6)
    parser.add_argument("--resume", nargs="?", type=str, default=None,
                        help="checkpoint directory to evaluate")
    parser.add_argument("--data_root", nargs="?", type=str, default=None,
                        help="dataset directory (the synthetic dataset needs none)")
    parser.add_argument("--log_root", nargs="?", type=str, default=DEFAULT_LOG_ROOT,
                        help="where run directories go (default: logs/ of the checkout)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    override_loss_depth(cfg, args)
    ranks = ranks_to_spawn(cfg["training"], args.device)
    if ranks:
        check_model_name(args.model)
        return launch("senas_torch.testing_model", sys.argv[1:] if argv is None else argv, ranks)
    runner = TestRunner(cfg, model_name=args.model, genotype_str=args.genotype,
                        resume=args.resume, config_path=args.config,
                        data_root=args.data_root, log_root=args.log_root,
                        batch_size=args.batch_size, device=args.device)
    if is_main(runner.mesh):
        print("run dir:", runner.run_dir)
    result = runner.run()
    if is_main(runner.mesh):
        print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
