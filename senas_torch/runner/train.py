"""Fixed-model training runner.

Port of `senas_tpu/runner/train.py` (the host loop of the reference's
experiments/train_model.py:186-381): genotype resolution (a safe parser
instead of eval()), the model from the factory, an epoch loop of train
steps with the cosine learning rate set once per epoch (T_max = the number
of epochs), a val epoch with best-dice/mIoU tracking, patience early stop,
the "best" checkpoint copy, scalars and an input|pred|gt grid of the first
val batch each epoch. A run resumes from the "last" checkpoint of its run
dir or of `training.resume`; `ft` keeps the weights and optimizer state
but restarts the epoch and best-metric counters.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import torch

from senas_torch.core.device import resolve_device
from senas_torch.core.genotype import parse_genotype
from senas_torch.data import DataLoader, PrefetchLoader, get_dataset, get_dataset_spec
from senas_torch.models import geno_searched
from senas_torch.models.factory import get_segmentation_model
from senas_torch.runner.common import (DEFAULT_LOG_ROOT, DeferredMetrics, multi_gpus_note,
                                       make_batch_placer, resolve_dataset_kwargs,
                                       resolve_precision, run_eval_loop)
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.loss import build_loss
from senas_torch.train.metrics import AverageMeter, SegmentationMetric
from senas_torch.train.optim import build_scheduler, set_learning_rate
from senas_torch.train.trainer import FixedTrainState, make_eval_step, make_train_step
from senas_torch.utils.logging import (ScalarWriter, calc_time, close_logger, get_logger,
                                       make_run_dir, store_images)
from senas_torch.utils.misc import StepTimer, calc_parameters_count, set_seed, steady_share


def resolve_genotype(cfg: Dict[str, Any], cli_genotype: str = "", model_name: str = "senas"):
    """--genotype string > cfg training.geno_type name (train_model.py:117-120).
    Only `senas` is built from a genotype: None for the zoo's models."""
    if model_name.lower() != "senas":
        return None
    if cli_genotype:
        return parse_genotype(cli_genotype)
    return getattr(geno_searched, cfg["training"].get("geno_type", "senas"))


def loss_name(t: Dict[str, Any]) -> str:
    loss_cfg = t.get("loss") or {}
    return loss_cfg.get("name", "dice_ce") if isinstance(loss_cfg, dict) else "dice_ce"


class TrainRunner:
    def __init__(self, cfg: Dict[str, Any], model_name: str = "senas",
                 genotype_str: str = "", config_path: Optional[str] = None,
                 data_root: Optional[str] = None, log_root: str = DEFAULT_LOG_ROOT,
                 ft: bool = False, device=None, dtype=None):
        self.cfg = cfg
        t = cfg["training"]
        self.device = resolve_device(device)
        device_note = multi_gpus_note(t, self.device)
        # the compute dtype: the caller's, else `precision:` (None: f32)
        precision = resolve_precision(t.get("precision"))
        self.dtype = dtype if dtype is not None else precision
        seed = cfg.get("seed", 0)
        set_seed(seed)
        ds_name = cfg["data"]["dataset"]
        dkw = resolve_dataset_kwargs(cfg)
        trainset = get_dataset(ds_name, path=data_root,
                               split=cfg["data"].get("train_split", "train"),
                               mode="train", **dkw)
        valset = get_dataset(ds_name, path=data_root, split=cfg["data"].get("split", "val"),
                             mode="val", **dkw)

        self.model_name = model_name
        self.run_dir = make_run_dir(log_root, model_name, "train", ds_name, config_path)
        self.logger = get_logger(self.run_dir)
        if device_note:
            self.logger.info(device_note)
        self.writer = ScalarWriter(self.run_dir)
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "ckpt"))
        self.n_classes = get_dataset_spec(ds_name).num_class
        bs = t["batch_size"]
        self.train_queue = DataLoader(trainset, bs, shuffle=True, drop_last=True, seed=seed)
        self.valid_queue = DataLoader(valset, bs, shuffle=False)
        self._place = make_batch_placer(self.device)

        self.model = get_segmentation_model(
            model_name, dataset=ds_name, c=t.get("init_channels", 32),
            depth=t.get("depth", 5), supervision=t.get("deep_supervision", False),
            genotype=resolve_genotype(cfg, genotype_str, model_name),
            double_down_channel=t.get("double_down_channel", False),
            remat=t.get("remat", False), dtype=self.dtype,
            device=self.device, generator=torch.Generator().manual_seed(seed))
        self.logger.info("param size = %.3f MB", calc_parameters_count(self.model))

        loss_fn = build_loss(loss_name(t), supervision=t.get("deep_supervision", False))
        base_lr = float((t.get("model_optimizer") or {}).get("lr", 1e-2))
        sched_cfg = dict(t.get("lr_schedule") or {"name": "cos"})
        if sched_cfg.get("name") == "cos":
            sched_cfg["T_max"] = t["epoch"]  # the CLI rewires T_max := epochs
        self.scheduler = build_scheduler(base_lr, sched_cfg)
        self.state = FixedTrainState.create(self.model, t.get("model_optimizer"), seed=seed)
        self.train_step = make_train_step(loss_fn, grad_clip=t.get("grad_clip", 0.0))
        self.eval_step = make_eval_step(self.model, loss_fn)

        self.start_epoch = 0
        self.best_dice = 0.0
        self.best_miou = 0.0
        self.patience = 0
        self.dur_time = 0.0
        self._maybe_resume(t.get("resume"), ft)

    def _maybe_resume(self, resume: Optional[str], ft: bool):
        mgr = CheckpointManager(resume) if resume else self.ckpt
        meta = mgr.restore(self.state, "last")
        if meta is None:
            return
        if not ft:  # --ft restarts the counters (train_model.py:154-174)
            self.start_epoch = int(meta.get("epoch", 0))
            self.best_dice = float(meta.get("best_dice", 0.0))
            self.best_miou = float(meta.get("best_miou", 0.0))
            self.dur_time = float(meta.get("dur_time", 0.0))
        self.logger.info("resumed from %s at epoch %d", mgr.directory, self.start_epoch)

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        t = self.cfg["training"]
        epochs = t["epoch"]
        report_freq = t.get("report_freq", 10)
        max_patience = t.get("max_patience", 1 << 30)
        run_start = time.time()

        for epoch in range(self.start_epoch, epochs):
            lr = self.scheduler(epoch)
            set_learning_rate(self.state.opt, lr)
            self.logger.info("Epoch %d / %d lr %e", epoch, epochs, lr)

            metric = SegmentationMetric(self.n_classes)
            loss_meter = AverageMeter()
            acc = DeferredMetrics(metric, loss_meter)
            timer = StepTimer(self.device)
            prefetch = PrefetchLoader(self.train_queue)
            walls = []
            t_end = time.perf_counter()
            for step, batch in enumerate(prefetch):
                with timer:
                    m = self.train_step(self.state, self._place(batch))
                acc.push(m)
                if step % report_freq == 0:
                    acc.drain()
                    _, _, dice = metric.get()
                    self.logger.info("Train %03d loss %e dice %.5f", step + 1,
                                     loss_meter.avg, dice)
                now = time.perf_counter()
                walls.append(now - t_end)
                t_end = now
            acc.drain()
            _, _, train_dice = metric.get()
            self.writer.add_scalar("Train/Loss", loss_meter.avg, epoch)
            self.writer.add_scalar("Train/dice", train_dice, epoch)
            self.writer.add_scalar("Train/steps_per_sec", timer.steps_per_sec, epoch)
            # over the steps that steps_per_sec counts, as in SearchRunner
            self.writer.add_scalar("Train/prefetch_wait_share",
                                   steady_share(prefetch.waits, walls), epoch)

            # ---- validation ----
            vmetric, vloss = run_eval_loop(self.eval_step, self.valid_queue,
                                           self.n_classes, self._place)
            # input|pred|gt grid of the first val batch (train_model.py:331)
            try:
                first = next(iter(self.valid_queue))
                pred = self.eval_step(self._place(first))["pred"].cpu().numpy()
                self.writer.add_image_grid("Val/images", store_images(
                    first["image"], pred, first["label"], self.n_classes), epoch)
            except Exception as e:  # image logging must never end the run
                self.logger.warning("val image grid failed: %s", e, exc_info=True)
            pixacc, miou, dice = vmetric.get()
            self.logger.info("Epoch %d Val loss: %f pixAcc: %s mIoU: %s dice: %s",
                             epoch, vloss.avg, pixacc, miou, dice)
            for tag, v in [("Val/Acc", pixacc), ("Val/mIoU", miou),
                           ("Val/dice", dice), ("Val/loss", vloss.avg)]:
                self.writer.add_scalar(tag, v, epoch)

            # best tracking + patience (train_model.py:344-353)
            is_best = False
            if dice > self.best_dice:
                self.best_dice = dice
                self.best_miou = max(self.best_miou, miou)
                is_best = True
                self.patience = 0
            elif miou > self.best_miou:
                self.best_miou = miou
                is_best = True
                self.patience = 0
            else:
                self.patience += 1

            self.ckpt.save(self.state, {
                "epoch": epoch + 1,
                "dur_time": self.dur_time + time.time() - run_start,
                "best_dice": self.best_dice,
                "best_miou": self.best_miou,
                "model_name": self.model_name,
            }, is_best=is_best)

            if self.patience >= max_patience:
                self.logger.info("Early stopping! patience %d", self.patience)
                break

        self.logger.info("End! best dice %.3f best mIoU %.3f dur %s",
                         self.best_dice, self.best_miou,
                         calc_time(self.dur_time + time.time() - run_start))
        self.writer.close()
        close_logger(self.logger)
        return {"best_dice": self.best_dice, "best_miou": self.best_miou}
