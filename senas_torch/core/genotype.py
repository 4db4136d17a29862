"""Genotype codec: the serialized architecture format.

A copy of `senas_tpu/core/genotype.py`, kept here so that the PyTorch port
imports nothing of the JAX package. Both copies must stay identical in
behaviour; tests/test_torch_supernet.py holds them to equal reprs.

Parity notes (vs the reference's utils/genotype.py):
  * `Genotype` is the same 5-field namedtuple (down, down_concat, up,
    up_concat, gamma); its `repr` round-trips byte-identically with the
    reference strings (README genotype strings, geno_searched.py), because
    namedtuple/list/tuple/range reprs are stable across both codebases.
  * `GenoParser.parse` reproduces the reference discretization
    (utils/genotype.py:13-90) exactly, including weight-rescaling when the
    normal/change op-set sizes differ and the final global top-2 selection.
  * `parse_genotype` replaces the reference's `eval()` of user-supplied
    genotype strings (experiments/train_model.py:117-120) with a restricted
    AST interpreter: only Genotype(...), range(...), tuples, lists, strings
    and numbers are accepted.
"""

from __future__ import annotations

import ast
from collections import namedtuple

import numpy as np

Genotype = namedtuple("Genotype", ["down", "down_concat", "up", "up_concat", "gamma"])

# Candidate-op vocabularies. Order is load-bearing: alpha columns index into
# these lists (reference utils/operations.py:23-48).
DownOps = [
    "avg_pool",
    "se_conv_3",
    "dil_3_conv_5",
    "dil_2_conv_5",
    "dep_sep_conv_3",
    "dep_sep_conv_5",
]

UpOps = [
    "up_sample",
    "se_conv_3",
    "dil_3_conv_5",
    "dil_2_conv_5",
    "dep_sep_conv_3",
    "dep_sep_conv_5",
]

NormOps = [
    "identity",
    "none",
    "dil_3_conv_5",
    "dil_2_conv_5",
    "dep_sep_conv_3",
    "dep_sep_conv_5",
]


class GenoParser:
    """Discretizes continuous architecture weights into a gene list.

    ``parse(weights1, weights2, cell_type)`` consumes the (beta-scaled,
    softmaxed) alpha tables — weights1 for NORM edges, weights2 for the
    DOWN/UP (resolution-changing) edges — and emits, per meta-node, the two
    strongest (op_name, input_index) pairs.
    """

    def __init__(self, meta_node_num: int = 4):
        self._meta_node_num = meta_node_num

    @staticmethod
    def _strongest_per_edge(table: np.ndarray, op_names):
        """Vectorized per-edge pick: best non-'none' op and its weight.

        Returns (weights[e], op_idx[e]) over the edge axis, plus the edge
        ranking by strength (stable argsort, strongest first) — the same
        ordering a stable sort on -weight produces.
        """
        usable = np.array([name != "none" for name in op_names])
        masked = np.where(usable[None, :], table, -np.inf)
        op_idx = masked.argmax(axis=1)
        strength = masked.max(axis=1)
        ranking = np.argsort(-strength, kind="stable")
        return strength, op_idx, ranking

    def parse(self, weights1, weights2, cell_type: str):
        """Discretize one cell's (beta-scaled) alpha tables into gene pairs.

        Semantics match the reference discretization
        (the reference's utils/genotype.py:13-90) exactly — verified by the
        golden round-trip tests — but the edge bookkeeping here is
        vectorized: per node, split the edge group into the
        resolution-changing family (first 2 edges in a down cell; edge 1 in
        an up cell) and the normal family (the rest), pick each edge's
        strongest non-'none' op, keep at most the 2 strongest edges per
        family, rescale the wider op-set family when the vocabularies
        differ in size, then keep the global top-2 by (weight, op, input)
        tuple order.
        """
        weights1 = np.asarray(weights1)  # NORM-edge table [k, |NormOps|]
        weights2 = np.asarray(weights2)  # DOWN/UP-edge table [k, |chg ops|]
        chg_ops = DownOps if cell_type == "down" else UpOps
        n_chg = 2 if cell_type == "down" else 1

        gene = []
        group_start = 0
        for node in range(self._meta_node_num):
            group = np.arange(group_start, group_start + 2 + node)
            if cell_type == "down":
                chg_rows, norm_rows = group[:2], group[2:]
                chg_inputs = np.arange(len(chg_rows))           # inputs 0, 1
                norm_inputs = np.arange(2, 2 + len(norm_rows))  # inner nodes
            else:
                chg_rows, norm_rows = group[1:2], np.concatenate(
                    [group[:1], group[2:]])
                chg_inputs = np.array([1])                      # vertical input
                norm_inputs = np.concatenate(
                    [[0], np.arange(2, 1 + len(norm_rows))])    # 0 then inner

            candidates = []  # (weight, op_name, input_idx) per family pick
            for rows, inputs, ops in [(chg_rows, chg_inputs, chg_ops),
                                      (norm_rows, norm_inputs, NormOps)]:
                if len(rows) == 0:
                    candidates.append([])
                    continue
                table = (weights2 if ops is chg_ops else weights1)[rows]
                strength, op_idx, ranking = self._strongest_per_edge(table, ops)
                picks = ranking[:2]
                candidates.append([
                    (strength[e], ops[op_idx[e]], int(inputs[e])) for e in picks
                ])
            chg_items, norm_items = candidates

            # comparable strengths across unequally-sized vocabularies:
            # scale the larger-vocabulary family down by |small|/|large|
            n1, n2 = len(NormOps), len(chg_ops)
            if norm_items and chg_items and n1 != n2:
                scale = min(n1, n2) / max(n1, n2)
                if n1 > n2:
                    norm_items = [(w * scale, op, i) for w, op, i in norm_items]
                else:
                    chg_items = [(w * scale, op, i) for w, op, i in chg_items]

            top2 = sorted(norm_items + chg_items)[-2:]
            gene += [(op, inp) for _, op, inp in top2]
            group_start += 2 + node
        return gene


# ---------------------------------------------------------------------------
# Safe genotype-string parsing (replacement for the reference's eval()).
# ---------------------------------------------------------------------------

def _eval_node(node):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body)
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name):
            raise ValueError(f"unsupported call in genotype string: {ast.dump(node)}")
        name = node.func.id
        if name == "Genotype":
            kwargs = {kw.arg: _eval_node(kw.value) for kw in node.keywords}
            args = [_eval_node(a) for a in node.args]
            return Genotype(*args, **kwargs)
        if name == "range":
            args = [_eval_node(a) for a in node.args]
            return range(*args)
        raise ValueError(f"unsupported function {name!r} in genotype string")
    if isinstance(node, ast.List):
        return [_eval_node(e) for e in node.elts]
    if isinstance(node, ast.Tuple):
        return tuple(_eval_node(e) for e in node.elts)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (str, int, float)):
            return node.value
        raise ValueError(f"unsupported constant {node.value!r}")
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _eval_node(node.operand)
        if isinstance(v, (int, float)):
            return -v
        raise ValueError("unsupported unary operand")
    raise ValueError(f"unsupported syntax in genotype string: {ast.dump(node)}")


def parse_genotype(text: str) -> Genotype:
    """Parse a genotype repr string (e.g. from geno_searched or a CLI flag).

    Accepts exactly the format produced by ``repr(Genotype(...))``:
    Genotype(down=[('op', idx), ...], down_concat=range(2, 6), ...).
    """
    tree = ast.parse(text.strip(), mode="eval")
    result = _eval_node(tree)
    if not isinstance(result, Genotype):
        raise ValueError("genotype string did not evaluate to a Genotype")
    return result
