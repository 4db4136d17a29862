"""Render the down and up cell DAGs of a genotype.

    python -m senas_torch.cell_visualize [--geno-name senas_node_4 | --genotype "..."] \
        [--format pdf] [--directory ./cell_visualize]

The flags and artifacts of tools/cell_visualize.py (the reference's
tools/cell_visualize.py:10-25): `<directory>/DownC-<stamp>.dot` and
`UpC-<stamp>.dot`, the DOT text byte for byte the JAX tool's, each
rendered to `--format` where the `graphviz` package and a dot executable
are available. The genotype is a built-in name of `geno_searched` or a
string read by the safe parser (never eval'd). No device.
"""

from __future__ import annotations

import argparse
import datetime

from senas_torch.core.genotype import parse_genotype
from senas_torch.models import geno_searched
from senas_torch.utils.visualize import plot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="render a genotype's cell DAGs")
    ap.add_argument("--genotype", type=str, default="",
                    help="genotype string (parsed safely, not eval'd)")
    ap.add_argument("--geno-name", type=str, default="senas_node_4",
                    help="built-in genotype name from geno_searched")
    ap.add_argument("--format", type=str, default="pdf",
                    choices=["jpeg", "png", "pdf", "svg", "bmp", "tif", "tiff"])
    ap.add_argument("--directory", type=str, default="./cell_visualize")
    args = ap.parse_args(argv)

    genotype = (parse_genotype(args.genotype) if args.genotype
                else getattr(geno_searched, args.geno_name))
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    for tag, gene in [("DownC", genotype.down), ("UpC", genotype.up)]:
        out = plot(gene, f"{tag}-{stamp}", format=args.format, directory=args.directory)
        print(f"{tag}: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
