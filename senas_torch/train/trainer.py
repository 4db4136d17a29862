"""Search-eval step of the supernet (the search-eval half of
`senas_tpu/train/trainer.py`; the bilevel training step belongs to the
training slice of the port).

The model holds its weights and BN statistics, so the step takes only the
architecture parameters and the batch.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from senas_torch.train.metrics import confusion_counts, mean_pix_accuracy


def make_search_eval_step(model: torch.nn.Module, normalize_fn: Callable,
                          loss_fn: Callable):
    """Returns step(arch, batch) -> {loss, tp, fp, fn, acc}: an eval-mode
    forward (running BN stats) under torch.inference_mode(). batch: dict
    with 'image' [B,H,W,C_in] and 'label' [B,H,W] int."""

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
