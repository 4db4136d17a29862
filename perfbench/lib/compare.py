"""The numbers that decide `correct`, each held to its limit.

Training (a step cell): the program's first three steps, which set-up
drives through the window's own call and feed, against the plain
reference's three steps from the same weights, tables and batches.

  loss_gap    the largest |loss - reference| / |reference| over the three
              steps' losses (and, in a search step, its arch losses)
  grad_gap    the first gradient as each optimizer got it, worked out from
              the program's optimizer state after one step; by the worst
              leaf, |norm - reference norm| / max(reference norm, the median
              leaf's reference norm)
  change_gap  the change of every parameter, arch table and running
              statistic after three steps, by the worst leaf as above.
              Leaves whose reference gradient is under a thousandth of the
              median leaf's move by round-off alone and are left out.

A configuration's `limits` name, for each loop kind, the numbers its
cells compare.

Serving: `mask_gap`, over a seed-drawn sample of the requests served in
the window, the widest gap by which the reference logit of a served mask's
class lies below the reference's best logit at that pixel, over the
request's mean margin between its best and second logit.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

EXCLUDE_BELOW = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _median(values: Iterable[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def worst_leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   keep: Iterable[str] = None) -> Dict[str, object]:
    """max over the kept leaves of |norm(prog) - norm(ref)| / max(norm(ref),
    the median kept leaf's norm(ref)), the leaf that reads it, and (to see
    where a gap comes from) the median leaf's gap and the three worst."""
    keys = list(ref if keep is None else keep)
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    floor = _median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in keys}
    worst = sorted(gaps, key=gaps.get, reverse=True)
    return {"value": gaps[worst[0]] if worst else 0.0, "leaf": worst[0] if worst else None,
            "median": _median(gaps.values()), "top": [[k, gaps[k]] for k in worst[:3]]}


def moved_leaves(ref_grads: Dict[str, torch.Tensor], leaves: Iterable[str]) -> List[str]:
    """The leaves of `leaves` to compare the change of: those without a
    gradient (running statistics) and those whose reference gradient norm
    is at least EXCLUDE_BELOW of the median leaf's."""
    norms = _norms(ref_grads)
    floor = EXCLUDE_BELOW * _median(norms.values())
    return [k for k in leaves if k not in norms or norms[k] >= floor]


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def training_gaps(prog: dict, ref: dict) -> Dict[str, dict]:
    """prog and ref: {"losses": [...], "grads": {leaf: tensor}, "change":
    {leaf: tensor}} of the first three steps. Each number, by the worst
    leaf, with the leaf that reads it."""
    keep = moved_leaves(ref["grads"], ref["change"])
    return {"loss_gap": {"value": loss_gap(prog["losses"], ref["losses"]), "leaf": None},
            "grad_gap": worst_leaf_gap(prog["grads"], ref["grads"]),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"], keep)}


def mask_gap(ref_logits: torch.Tensor, masks: torch.Tensor) -> float:
    """ref_logits [N, H, W, K] and the served masks [N, H, W]: the widest gap
    of a served class below the best, over the mean best-to-second margin."""
    top2 = ref_logits.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).mean())
    served = ref_logits.gather(-1, masks.long()[..., None])[..., 0]
    return float((top2[..., 0] - served).max()) / max(margin, 1e-30)
