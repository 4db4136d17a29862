"""Train and eval steps: the fixed model's and the supernet's.

Port of `senas_tpu/train/trainer.py`. The model holds its weights and BN
statistics (updated in place), and the optimizers their own state, so a
step takes a state (`FixedTrainState`, `SearchTrainState`, or only the
architecture tables for a search evaluation) and the batches. Batches are
dicts with 'image' [B,H,W,C_in] and 'label' [B,H,W] int tensors on the
model's device. A state's `state_dict()` is what a checkpoint holds.

A bf16 model (`dtype=torch.bfloat16`) gives bf16 logits, and the loss
takes them as they are, as in the JAX package (no cast before loss_fn).
The gradients land on the f32 parameters through the casts at use, so
their joint norm, the clip and the optimizers' steps are f32.

Under an active mesh (`senas_torch.parallel`, a step wrapped by
`shard_train_step`) each rank holds its rows of the global batch and,
under a row split, its block of the image rows. A step then computes the
loss and the metrics on the logits and labels gathered over both axes
(`gather_batch`), which gives every rank the single-device step's loss,
and sums the ranks' partial gradients in one collective before the clip,
so that the clip norm is the global one. BatchNorm and the epilogue's
statistics span the global batch on their own (they ask `active_mesh()`).

A step records its phases as spans while a profiler runs
(`utils/spans.py`): `train_step` holds `forward`, `backward` and `update`;
`search_step` holds `arch_forward`, `arch_backward` and `arch_update`,
then `weight_forward`, `weight_backward` and `weight_update`. A forward
runs `normalize_fn`, the model and the loss; a backward
`torch.autograd.grad`; an update the clip, the optimizer's step and
`zero_grad`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from senas_torch.parallel.collectives import all_reduce_flat_, gather_batch, gather_outputs
from senas_torch.train.metrics import confusion_counts, mean_pix_accuracy
from senas_torch.train.optim import build_optimizer
from senas_torch.utils.spans import span


def _last(outputs):
    return outputs[-1] if isinstance(outputs, (list, tuple)) else outputs


def _reported(loss: torch.Tensor) -> torch.Tensor:
    """A loss to report: a bf16 model's bf16 loss in f32 (numpy has no
    bf16), any other as it is."""
    return loss.detach().to(torch.promote_types(loss.dtype, torch.float32))


def _step_metrics(loss, outputs, label) -> Dict[str, torch.Tensor]:
    """loss and the last head's tp/fp/fn (per foreground class) and pixel
    accuracy, on the device."""
    last = _last(outputs)
    tp, fp, fn = confusion_counts(last, label)
    return {"loss": _reported(loss), "tp": tp, "fp": fp, "fn": fn,
            "acc": mean_pix_accuracy(last, label)}


def _global(outputs, label):
    """The model's outputs and the labels of the global batch: every rank's
    rows under an active mesh, the step's own otherwise."""
    return gather_outputs(outputs), gather_batch(label)


def _optimizer_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def _grads(loss: torch.Tensor, params: List[torch.Tensor],
           phase: str) -> List[torch.Tensor]:
    """d loss / d params, with zeros where loss does not depend on a
    parameter (JAX's grad gives zeros there). Weight decay and momentum then
    still apply to it, as optax does: torch's optimizers skip a parameter
    whose .grad is None. Under an active mesh, summed over the ranks. The
    span `<phase>backward`."""
    with span(phase + "backward"):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        all_reduce_flat_(grads)
    return grads


def _apply(opt: torch.optim.Optimizer, params: List[torch.Tensor],
           grads: List[torch.Tensor], phase: str) -> None:
    """The span `<phase>update`: `opt`'s step on `grads`."""
    with span(phase + "update"):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)


def _clipped_step(opt: torch.optim.Optimizer, loss: torch.Tensor,
                  grad_clip: float, phase: str) -> torch.Tensor:
    """One step of `opt` on the gradients of `loss` w.r.t. all its
    parameters, clipped by their joint global norm when grad_clip > 0
    (torch's clip_grad_norm_: scale min(1, grad_clip / (norm + 1e-6))).
    Returns the norm before clipping. The spans `<phase>backward` and
    `<phase>update`."""
    params = _optimizer_params(opt)
    grads = _grads(loss, params, phase)
    with span(phase + "update"):
        for p, g in zip(params, grads):
            p.grad = g
        if grad_clip and grad_clip > 0:
            gnorm = torch.nn.utils.clip_grad_norm_(params, grad_clip)
        else:
            gnorm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
        opt.step()
        opt.zero_grad(set_to_none=True)
    return gnorm.detach()


# ---------------------------------------------------------------------------
# Fixed-model training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FixedTrainState:
    """What fixed-model training carries from step to step: the model (its
    parameters are the weights, its buffers the BN running stats), the
    optimizer over its parameters, the count of steps taken, and the
    dropout generator with its seed.

    The JAX state carries a dropout key and splits it each step
    (senas_tpu/train/trainer.py:83-89). Here each step reseeds `rng` from
    (`seed`, `step`) before the forward, so a step's masks follow from the
    state alone: a resumed run draws the masks the uninterrupted one would
    have, and a checkpoint needs no generator state (a CPU and a CUDA
    generator's states do not load into each other). `rng` lies on the
    model's device unless the caller gives another; the masks move to the
    activations' device, so one CPU generator gives the card and the CPU
    the same masks."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0
    seed: int = 0
    rng: Optional[torch.Generator] = None

    @classmethod
    def create(cls, model: nn.Module, opt_cfg: Optional[Dict[str, Any]], seed: int = 0,
               rng: Optional[torch.Generator] = None) -> "FixedTrainState":
        if rng is None:
            rng = torch.Generator(device=next(model.parameters()).device)
        return cls(model=model, opt=build_optimizer(list(model.parameters()), opt_cfg),
                   seed=seed, rng=rng)

    def step_generator(self) -> torch.Generator:
        """`rng` seeded for the step about to be taken."""
        self.rng.manual_seed((self.seed << 32) + self.step)
        return self.rng

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "opt": self.opt.state_dict(),
                "step": self.step, "seed": self.seed}

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        self.model.load_state_dict(payload["model"])
        self.opt.load_state_dict(payload["opt"])
        self.step = int(payload["step"])
        self.seed = int(payload.get("seed", self.seed))


def make_train_step(loss_fn: Callable, grad_clip: float = 0.0):
    """Returns step(state, batch) -> metrics {loss, grad_norm, tp, fp, fn,
    acc}; it updates `state` in place (senas_tpu/train/trainer.py:72-115):
    a train-mode forward (the BN running stats advance; dropout draws from
    the state's generator, seeded for this step), the gradients of
    the loss w.r.t. every parameter (zeros where the loss does not reach
    one, as JAX's grad gives), their global norm before clipping as
    grad_norm, the clip to `grad_clip` when it is > 0, and the optimizer's
    step."""

    def step(state: FixedTrainState, batch):
        with span("train_step", unit=True):
            with span("forward"):
                outputs = state.model(batch["image"], train=True, rng=state.step_generator())
                outputs, label = _global(outputs, batch["label"])
                loss = loss_fn(outputs, label)
            gnorm = _clipped_step(state.opt, loss, grad_clip, "")
            state.step += 1
            with torch.no_grad():
                return {**_step_metrics(loss, outputs, label), "grad_norm": gnorm}

    return step


def make_eval_step(model: nn.Module, loss_fn: Callable):
    """Returns step(batch) -> {loss, tp, fp, fn, acc, pred}: an eval-mode
    forward (running BN stats) under torch.inference_mode(). `pred` is the
    last head's argmax over classes as uint8 [B,H,W] (the JAX package packs
    it so on the device: a quarter of the int32 transfer)."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]):
        outputs, label = _global(model(batch["image"], train=False), batch["label"])
        loss = loss_fn(outputs, label)
        return {**_step_metrics(loss, outputs, label),
                "pred": _last(outputs).argmax(dim=-1).to(torch.uint8)}

    return step


# ---------------------------------------------------------------------------
# Supernet bilevel search
# ---------------------------------------------------------------------------

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

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "arch": {k: v.detach() for k, v in self.arch.items()},
                "w_opt": self.w_opt.state_dict(), "a_opt": self.a_opt.state_dict(),
                "step": self.step}

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        """In place: the arch tables are copied into the tensors the
        optimizers hold."""
        self.model.load_state_dict(payload["model"])
        if payload["arch"].keys() != self.arch.keys():
            raise ValueError(f"checkpoint arch tables {sorted(payload['arch'])} do not "
                             f"match the run's {sorted(self.arch)}")
        with torch.no_grad():
            for k, t in self.arch.items():
                t.copy_(payload["arch"][k])
        self.w_opt.load_state_dict(payload["w_opt"])
        self.a_opt.load_state_dict(payload["a_opt"])
        self.step = int(payload["step"])


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

    def forward(state: SearchTrainState, batch, phase: str):
        with span(phase + "forward"):
            outputs, label = _global(state.model(batch["image"], normalize_fn(state.arch),
                                                 train=True), batch["label"])
            return loss_fn(outputs, label), outputs, label

    def step(state: SearchTrainState, train_batch, val_batch, do_arch: bool):
        with span("search_step", unit=True):
            tables = list(state.arch.values())
            if do_arch:
                a_loss, _, _ = forward(state, val_batch, "arch_")
                _apply(state.a_opt, tables, _grads(a_loss, tables, "arch_"), "arch_")
                a_loss = _reported(a_loss)
            else:
                a_loss = torch.zeros((), device=train_batch["image"].device)

            loss, outputs, label = forward(state, train_batch, "weight_")
            gnorm = _clipped_step(state.w_opt, loss, grad_clip, "weight_")
            state.step += 1

            with torch.no_grad():
                return {**_step_metrics(loss, outputs, label),
                        "arch_loss": a_loss, "grad_norm": gnorm}

    return step


def make_search_eval_step(model: nn.Module, normalize_fn: Callable, loss_fn: Callable):
    """Returns step(arch, batch) -> {loss, tp, fp, fn, acc}: an eval-mode
    forward (running BN stats) under torch.inference_mode()."""

    @torch.inference_mode()
    def step(arch: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        outputs, label = _global(model(batch["image"], normalize_fn(arch), train=False),
                                 batch["label"])
        return _step_metrics(loss_fn(outputs, label), outputs, label)

    return step
