"""The reference's training steps, in plain PyTorch.

A search step (first-order DARTS, as the reference's search loop runs it):
with `do_arch`, a train-mode forward on the val batch, the gradients of its
loss w.r.t. the arch tables and Adam's step on them; then a train-mode
forward on the train batch, the gradients w.r.t. every weight and (with
`arch_in_weight_step`) the arch tables, zeros where the loss does not
reach one, clipped by their joint norm (scale min(1, clip / (norm +
1e-6))), and SGD's step. A fixed-model step is the second half alone.
Weight decay is coupled (torch.optim.SGD and Adam). Batch norms run in
train mode and move their running statistics.

It reads the program's outputs nowhere: it starts from the weights, tables
and batches the benchmark made.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


def _grads(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def _to(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def steps(ref, cfg: dict, state: Dict[str, torch.Tensor],
          arch: Optional[Dict[str, torch.Tensor]], units: List[tuple], device) -> dict:
    """Runs one step per unit ((train batch,) or (train batch, val batch),
    host numpy) from `state` (a state dict) and `arch`. Returns the losses
    in order (a search step's arch loss before its loss), the gradients
    each optimizer took in the first step ("<param>", "arch.<table>" for
    SGD; "adam.<table>" for Adam), and the change of every parameter,
    buffer and table ("arch.<table>") after the last."""
    model = ref.build(cfg, device)
    model.load_state_dict(state)
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    tables = {k: v.detach().clone().requires_grad_(True) for k, v in (arch or {}).items()}
    w_names, w_params = list(names), list(params)
    if tables and cfg["arch_in_weight_step"]:
        w_names += [f"arch.{k}" for k in tables]
        w_params += list(tables.values())
    wo = cfg["model_optimizer"]
    w_opt = torch.optim.SGD(w_params, lr=wo["lr"], momentum=wo["momentum"],
                            weight_decay=wo["weight_decay"])
    if tables:
        ao = cfg["arch_optimizer"]
        a_opt = torch.optim.Adam(list(tables.values()), lr=ao["lr"], betas=tuple(ao["betas"]),
                                 weight_decay=ao["weight_decay"])
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}

    def apply(opt, ps, gs):
        for p, g in zip(ps, gs):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    for i, unit in enumerate(units):
        tb = _to(unit[0], device)
        if tables and cfg["do_arch"]:
            vb = _to(unit[1], device)
            a_loss = ref.loss(ref.forward(model, cfg, tables, vb["image"], True), vb["label"])
            ga = _grads(a_loss, list(tables.values()))
            if i == 0:
                first.update({f"adam.{k}": g.detach().clone() for k, g in zip(tables, ga)})
            apply(a_opt, list(tables.values()), ga)
            losses.append(float(a_loss.detach()))
        loss = ref.loss(ref.forward(model, cfg, tables, tb["image"], True), tb["label"])
        gw = _grads(loss, w_params)
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in gw]))
        coef = torch.clamp(cfg["grad_clip"] / (norm + 1e-6), max=1.0)
        gw = [g * coef for g in gw]
        if i == 0:
            first.update({k: g.detach().clone() for k, g in zip(w_names, gw)})
        apply(w_opt, w_params, gw)
        losses.append(float(loss.detach()))

    after = model.state_dict()
    change = {k: (after[k] - state[k].to(device)).detach() for k in after}
    change.update({f"arch.{k}": (t.detach() - arch[k].to(device)) for k, t in tables.items()})
    return {"losses": losses, "grads": first, "change": change}
