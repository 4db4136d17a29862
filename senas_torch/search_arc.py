"""Supernet architecture search CLI of the PyTorch port.

    python -m senas_torch.search_arc --config configs/senas/senas_synthetic.yml [--device cpu]

The flag surface of experiments/search_arc.py (the reference's
experiments/search_arc.py:37-48): --config / --batch_size /
--meta_node_num / --data_root / --log_root / --epoch, whose overrides go
onto the `searching:` section of the YAML config, plus --device (default
cuda; `cpu` runs the kernels' plain versions). A run resumes from the
checkpoint directory that `searching.resume` names. Run directories go under
the checkout's logs/ unless --log_root names another place; the default
config is the checkout's configs/senas/senas_promise12.yml.

With `multi_gpus: true` in `searching:` on a host with N >= 2 visible cards,
the CLI starts N processes, one a card, which run data-parallel over the
global batch (`senas_torch.parallel.launch`); with SENAS_COORDINATOR,
SENAS_NUM_PROCESSES and SENAS_PROCESS_ID set it joins that process group
as that rank instead (several hosts). Rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import sys

from senas_torch.core.config import load_config
from senas_torch.parallel.launch import launch, ranks_to_spawn
from senas_torch.runner.common import DEFAULT_CONFIG, DEFAULT_LOG_ROOT, is_main
from senas_torch.runner.search import SearchRunner


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="senas_torch supernet search")
    parser.add_argument("--config", nargs="?", type=str,
                        default=DEFAULT_CONFIG,
                        help="Configuration file to use")
    parser.add_argument("--batch_size", nargs="?", type=int, default=-1,
                        help="Batch size")
    parser.add_argument("--meta_node_num", nargs="?", type=int, default=-1,
                        help="Meta node number")
    parser.add_argument("--data_root", nargs="?", type=str, default=None,
                        help="dataset directory (the synthetic dataset needs none)")
    parser.add_argument("--log_root", nargs="?", type=str, default=DEFAULT_LOG_ROOT,
                        help="where run directories go (default: logs/ of the checkout)")
    parser.add_argument("--epoch", nargs="?", type=int, default=-1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.batch_size > 0:
        cfg["searching"]["batch_size"] = args.batch_size
    if args.meta_node_num > 0:
        cfg["searching"]["meta_node_num"] = args.meta_node_num
    if args.epoch > 0:
        cfg["searching"]["epoch"] = args.epoch
    ranks = ranks_to_spawn(cfg["searching"], args.device)
    if ranks:
        return launch("senas_torch.search_arc", sys.argv[1:] if argv is None else argv, ranks)

    runner = SearchRunner(cfg, config_path=args.config, data_root=args.data_root,
                          log_root=args.log_root, device=args.device)
    best = runner.run()
    if is_main(runner.mesh):
        print("run dir:", runner.run_dir)
        print("best genotype:", best)
    return 0


if __name__ == "__main__":
    sys.exit(main())
