"""Genotype cell-DAG visualization.

Copy of `senas_tpu/utils/visualize.py` (the reference's
utils/visualize.py:4-40: a Graphviz DAG with c_{k-2}/c_{k-1} input nodes,
op-labelled edges and a concat output node). It writes Graphviz DOT text
itself, byte for byte the JAX package's, and renders it through the
`graphviz` Python package where that (and a dot executable) is available.
No torch.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

Gene = Sequence[Tuple[str, int]]

_NODE_STYLE = ('style=filled shape=rect align=center fontsize=30 '
               'height=0.5 width=0.5 penwidth=2')


def genotype_to_dot(gene: Gene) -> str:
    """Render one cell gene ([(op, input_idx)] pairs, 2 per meta-node) to a
    DOT digraph string. Input index 0/1 map to the two cell inputs, >=2 to
    the (j-2)-th meta node."""
    assert len(gene) % 2 == 0, "gene must hold 2 (op, idx) pairs per node"
    steps = len(gene) // 2

    lines: List[str] = [
        "digraph cell {",
        "  rankdir=LR;",
        "  dpi=800;",
        f"  node [{_NODE_STYLE}];",
        "  edge [fontsize=30];",
        '  "c_{k-2}" [fillcolor=darkseagreen2];',
        '  "c_{k-1}" [fillcolor=darkseagreen2];',
    ]
    for i in range(steps):
        lines.append(f'  "{i}" [fillcolor=lightblue];')
    for i in range(steps):
        for k in (2 * i, 2 * i + 1):
            op, j = gene[k]
            if j == 0:
                src = "c_{k-2}"
            elif j == 1:
                src = "c_{k-1}"
            else:
                src = str(j - 2)
            lines.append(f'  "{src}" -> "{i}" [label="{op}"];')
    lines.append('  "c_{k}" [fillcolor=palegoldenrod];')
    for i in range(steps):
        lines.append(f'  "{i}" -> "c_{{k}}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


def plot(gene: Gene, filename: str, format: str = "pdf",
         directory: str = "./cell_visualize", view: bool = False) -> str:
    """Write <directory>/<filename>.dot, and render to `format` when a dot
    engine is available. Returns the path of the artifact written."""
    os.makedirs(directory, exist_ok=True)
    dot_text = genotype_to_dot(gene)
    dot_path = os.path.join(directory, filename + ".dot")
    with open(dot_path, "w") as f:
        f.write(dot_text)
    try:
        import graphviz
        src = graphviz.Source(dot_text, filename=filename, directory=directory,
                              format=format)
        return src.render(view=view, cleanup=False)
    except Exception:
        # no dot binary — the .dot text artifact is the deliverable
        return dot_path
