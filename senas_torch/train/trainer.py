"""Supernet search steps: the bilevel search step and the search-eval step.

Port of the search half of `senas_tpu/train/trainer.py`. The model holds
its weights and BN statistics (updated in place), and the optimizers their
own state, so a step takes a `SearchTrainState` (or only the architecture
tables, for evaluation) and the batches. Batches are dicts with 'image'
[B,H,W,C_in] and 'label' [B,H,W] int tensors on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from senas_torch.train.metrics import confusion_counts, mean_pix_accuracy
from senas_torch.train.optim import build_optimizer


@dataclasses.dataclass
class SearchTrainState:
    """What the bilevel search carries from step to step.

    model:  the supernet; its parameters are the weights and its buffers
            the BN running stats.
    arch:   the architecture tables, leaf tensors that require grad.
    w_opt:  the weight optimizer. With `arch_in_weight_step` it also holds
            the arch tables, as the reference's model_optimizer, built over
            model.parameters(), does (search_arc.py:135): every weight step
            then applies SGD with momentum and weight decay to the tables too.
    a_opt:  the arch optimizer, over the arch tables only.
    step:   the count of steps taken."""

    model: nn.Module
    arch: Dict[str, torch.Tensor]
    w_opt: torch.optim.Optimizer
    a_opt: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, arch: Dict[str, torch.Tensor],
               w_opt_cfg: Optional[Dict[str, Any]], a_opt_cfg: Optional[Dict[str, Any]],
               arch_in_weight_step: bool = True) -> "SearchTrainState":
        for t in arch.values():
            t.requires_grad_(True)
        tables = list(arch.values())
        w_params = list(model.parameters()) + (tables if arch_in_weight_step else [])
        return cls(model=model, arch=arch, w_opt=build_optimizer(w_params, w_opt_cfg),
                   a_opt=build_optimizer(tables, a_opt_cfg))


def _optimizer_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, with zeros where loss does not depend on a
    parameter (JAX's grad gives zeros there). Weight decay and momentum then
    still apply to it, as optax does: torch's optimizers skip a parameter
    whose .grad is None."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _apply(opt: torch.optim.Optimizer, params: List[torch.Tensor],
           grads: List[torch.Tensor]) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_search_step(normalize_fn: Callable, loss_fn: Callable, grad_clip: float = 5.0):
    """Returns step(state, train_batch, val_batch, do_arch) -> metrics
    {loss, arch_loss, grad_norm, tp, fp, fn, acc}; it updates `state` in
    place. The order is that of the reference's hot loop
    (senas_tpu/train/trainer.py:202-250, search_arc.py:252-293):

      1. If do_arch: a train-mode forward on the val batch (the BN running
         stats advance), gradients of its loss w.r.t. the arch tables only,
         and the arch optimizer's step (first-order DARTS).
      2. A train-mode forward on the train batch with the updated tables;
         gradients w.r.t. every parameter of the weight optimizer (the
         weights, and the arch tables with arch_in_weight_step).
      3. Clipping by their joint global norm: scale min(1, grad_clip /
         (norm + 1e-6)), torch's clip_grad_norm_; grad_norm is the norm
         before clipping. grad_clip <= 0 only measures it.
      4. The weight optimizer's step.

    The JAX step splits a dropout key per step; nothing on the supernet's
    path draws from it, so this step takes no generator."""

    def forward(state: SearchTrainState, batch):
        outputs = state.model(batch["image"], normalize_fn(state.arch), train=True)
        return loss_fn(outputs, batch["label"]), outputs

    def step(state: SearchTrainState, train_batch, val_batch, do_arch: bool):
        tables = list(state.arch.values())
        if do_arch:
            a_loss, _ = forward(state, val_batch)
            _apply(state.a_opt, tables, _grads(a_loss, tables))
            a_loss = a_loss.detach()
        else:
            a_loss = torch.zeros((), device=train_batch["image"].device)

        w_params = _optimizer_params(state.w_opt)
        loss, outputs = forward(state, train_batch)
        grads = _grads(loss, w_params)
        for p, g in zip(w_params, grads):
            p.grad = g
        if grad_clip and grad_clip > 0:
            gnorm = torch.nn.utils.clip_grad_norm_(w_params, grad_clip)
        else:
            gnorm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
        state.w_opt.step()
        state.w_opt.zero_grad(set_to_none=True)
        state.step += 1

        with torch.no_grad():
            last = outputs[-1] if isinstance(outputs, (list, tuple)) else outputs
            label = train_batch["label"]
            tp, fp, fn = confusion_counts(last, label)
            return {"loss": loss.detach(), "arch_loss": a_loss, "grad_norm": gnorm.detach(),
                    "tp": tp, "fp": fp, "fn": fn, "acc": mean_pix_accuracy(last, label)}

    return step


def make_search_eval_step(model: nn.Module, normalize_fn: Callable, loss_fn: Callable):
    """Returns step(arch, batch) -> {loss, tp, fp, fn, acc}: an eval-mode
    forward (running BN stats) under torch.inference_mode()."""

    @torch.inference_mode()
    def step(arch: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        aw = normalize_fn(arch)
        outputs = model(batch["image"], aw, train=False)
        loss = loss_fn(outputs, batch["label"])
        last = outputs[-1] if isinstance(outputs, (list, tuple)) else outputs
        tp, fp, fn = confusion_counts(last, batch["label"])
        return {"loss": loss, "tp": tp, "fp": fp, "fn": fn,
                "acc": mean_pix_accuracy(last, batch["label"])}

    return step
