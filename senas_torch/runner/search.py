"""Supernet architecture search runner.

Port of `senas_tpu/runner/search.py` (host loop of the reference's
experiments/search_arc.py:177-330). Per epoch: set the cosine learning
rate of the weight optimizer; derive and log the genotype; once arch
updates begin (`alpha_begin`), count the epochs the genotype stays the same
and stop at `max_patience`; the bilevel train loop (arch step on a val
batch, weight step on a train batch); the eval epoch; a checkpoint. A run
resumes from the "last" checkpoint of its run dir or of
`searching.resume`.

With `multi_gpus: true` over a process group of two or more ranks
(`runner/common.py` `setup_mesh`) the bilevel steps run data-parallel on
each rank's rows of the global batch (the JAX runner's mesh,
senas_tpu/runner/search.py:122-131, 148-150): every rank restores a
resumed run, the state is then broadcast from rank 0, and rank 0 alone
writes the run's log, scalars and checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from senas_torch.core.device import resolve_device
from senas_torch.data import DataLoader, PrefetchLoader, get_dataset, get_dataset_spec
from senas_torch.parallel.mesh import place_state, shard_train_step
from senas_torch.runner.common import (DEFAULT_LOG_ROOT, DeferredMetrics, NullWriter,
                                       check_global_batch, is_main, make_batch_placer,
                                       resolve_dataset_kwargs, resolve_precision,
                                       run_eval_loop, run_outputs, setup_mesh)
from senas_torch.search.supernet import (SenasSearch, beta_group_start, derive_genotype,
                                         init_arch_params, normalize_arch)
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.loss import build_loss
from senas_torch.train.metrics import AverageMeter, SegmentationMetric
from senas_torch.train.optim import build_scheduler, set_learning_rate
from senas_torch.train.trainer import (SearchTrainState, make_search_eval_step,
                                       make_search_step)
from senas_torch.utils.logging import ScalarWriter, calc_time, close_logger, make_run_dir
from senas_torch.utils.misc import StepTimer, calc_parameters_count, set_seed, steady_share


class SearchRunner:
    def __init__(self, cfg: Dict[str, Any], config_path: Optional[str] = None,
                 data_root: Optional[str] = None, log_root: str = DEFAULT_LOG_ROOT,
                 device=None, dtype=None):
        self.cfg = cfg
        s = cfg["searching"]
        dev = resolve_device(device)
        self.mesh, device_note = setup_mesh(s, dev)
        self.device = self.mesh.device if self.mesh else dev
        check_global_batch(self.mesh, s["batch_size"], "searching.batch_size")
        # beta grouping: "reference" reproduces the reference's overlapping
        # softmax groups, "grouped" is the disjoint variant (an unknown mode
        # raises ValueError here)
        self.beta_mode = s.get("beta_mode", "reference")
        beta_group_start(0, self.beta_mode)
        # the compute dtype: the caller's, else `precision:` (None: f32)
        precision = resolve_precision(s.get("precision"))
        self.dtype = dtype if dtype is not None else precision
        seed = cfg.get("seed", 0)
        set_seed(seed)

        # dataset: ONE trainset split (train_portion) into train/val index
        # sets (search_arc.py:78-94)
        ds_name = cfg["data"]["dataset"]
        dataset = get_dataset(ds_name, path=data_root, split=cfg["data"].get(
            "train_split", "train"), mode="train", **resolve_dataset_kwargs(cfg))

        self.run_dir, self.logger = run_outputs(self.mesh, lambda: make_run_dir(
            log_root, cfg["model"]["arch"], "search", ds_name, config_path))
        if device_note:
            self.logger.info(device_note)
        self.writer = ScalarWriter(self.run_dir) if is_main(self.mesh) else NullWriter()
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "ckpt"))
        spec = get_dataset_spec(ds_name)
        self.n_classes = spec.num_class
        indices = list(range(len(dataset)))
        split = int(np.floor(s.get("train_portion", 0.5) * len(dataset)))
        bs = s["batch_size"]
        self.train_queue = DataLoader(dataset, bs, shuffle=True, drop_last=True,
                                      indices=indices[:split], seed=seed)
        self.valid_queue = DataLoader(dataset, bs, shuffle=True, drop_last=True,
                                      indices=indices[split:], seed=seed + 1)
        self._place = make_batch_placer(self.device, self.mesh,
                                        spatial=s.get("mesh_spatial", 1) > 1)

        # model + arch params, drawn from the seed
        self.meta_node_num = s["meta_node_num"]
        self.depth = s["depth"]
        gen = torch.Generator().manual_seed(seed)
        net = SenasSearch(spec.in_channels, s["init_channels"], self.n_classes,
                          self.depth, self.meta_node_num,
                          double_down_channel=s.get("double_down_channel", False),
                          supervision=s.get("deep_supervision", False),
                          remat=s.get("remat", False), dtype=self.dtype, device=self.device,
                          generator=gen)
        arch = init_arch_params(self.meta_node_num, self.depth,
                                use_sharing=s.get("sharing_normal", True),
                                generator=gen, device=self.device)
        self.logger.info("param size = %.3f MB", calc_parameters_count(net))

        loss_name = s["loss"]["name"] if isinstance(s.get("loss"), dict) else "dice_ce"
        loss_fn = build_loss(loss_name, supervision=s.get("deep_supervision", False))
        self.logger.info("beta_mode = %s", self.beta_mode)
        normalize = lambda a: normalize_arch(a, self.meta_node_num, self.beta_mode)
        base_lr = float(s.get("model_optimizer", {}).get("lr", 1e-2))
        self.scheduler = build_scheduler(base_lr, {"name": "cos", "T_max": s["epoch"]})
        # reference mode (default): the weight SGD also updates the arch
        # tables and the clip norm spans weight+arch grads, because the
        # reference's model_optimizer is built over model.parameters()
        # (search_arc.py:135). searching.arch_in_weight_step: false is the
        # "pure" DARTS variant.
        self.state = SearchTrainState.create(
            net, arch, s.get("model_optimizer"), s.get("arch_optimizer"),
            arch_in_weight_step=bool(s.get("arch_in_weight_step", True)))
        self.search_step = shard_train_step(
            make_search_step(normalize, loss_fn, grad_clip=s.get("grad_clip", 5.0)), self.mesh)
        self._eval = shard_train_step(make_search_eval_step(net, normalize, loss_fn), self.mesh)

        self.start_epoch = 0
        self.patience = 0
        self.geno_type = None
        self.dur_time = 0.0
        self._maybe_resume(s.get("resume"))
        if self.mesh is not None:
            place_state(self.mesh, self.state)

    # ------------------------------------------------------------------
    def _maybe_resume(self, resume: Optional[str]):
        mgr = CheckpointManager(resume) if resume else self.ckpt
        meta = mgr.restore(self.state, "last")
        if meta is None:
            return
        self.start_epoch = int(meta.get("epoch", 0))
        self.patience = int(meta.get("cur_patience", 0))
        self.dur_time = float(meta.get("dur_time", 0.0))
        self.geno_type = meta.get("geno_type")
        self.logger.info("resumed from %s at epoch %d", mgr.directory, self.start_epoch)

    def eval_step(self, batch):
        return self._eval(self.state.arch, batch)

    def derive(self):
        return derive_genotype(self.state.arch, self.meta_node_num, self.depth,
                               beta_mode=self.beta_mode)

    # ------------------------------------------------------------------
    def run(self) -> str:
        cfg_s = self.cfg["searching"]
        run_start = time.time()
        epochs = cfg_s["epoch"]
        alpha_begin = cfg_s.get("alpha_begin", 0)
        max_patience = cfg_s.get("max_patience", 1 << 30)
        report_freq = cfg_s.get("report_freq", 10)

        for epoch in range(self.start_epoch, epochs):
            lr = self.scheduler(epoch)
            set_learning_rate(self.state.w_opt, lr)
            self.logger.info("Epoch %d / %d lr %e", epoch, epochs, lr)

            genotype = self.derive()
            self.logger.info("genotype = %s", genotype)

            if epoch >= alpha_begin:
                if self.geno_type == repr(genotype):
                    self.patience += 1
                else:
                    self.patience = 0
                    self.geno_type = repr(genotype)
                self.logger.info("Current patience :%d", self.patience)
                if self.patience >= max_patience:
                    self.logger.info("Reach the max patience! best genotype %s",
                                     self.geno_type)
                    break

            # ---- train epoch (bilevel) ----
            train_metric = SegmentationMetric(self.n_classes)
            loss_meter = AverageMeter()
            acc = DeferredMetrics(train_metric, loss_meter)
            timer = StepTimer(self.device, trace_dir=os.environ.get("SENAS_TRACE_DIR"),
                              trace=is_main(self.mesh))
            do_arch = epoch >= alpha_begin
            val_iter = iter(self.valid_queue)
            prefetch = PrefetchLoader(self.train_queue)
            walls, val_waits = [], []
            t_end = time.perf_counter()
            for step, batch in enumerate(prefetch):
                t0 = time.perf_counter()
                try:
                    val_batch = next(val_iter)
                except StopIteration:
                    val_iter = iter(self.valid_queue)
                    val_batch = next(val_iter)
                val_waits.append(time.perf_counter() - t0)
                with timer:
                    m = self.search_step(self.state, self._place(batch),
                                         self._place(val_batch), do_arch)
                acc.push(m)
                if step % report_freq == 0:
                    acc.drain()
                    _, _, dice = train_metric.get()
                    self.logger.info("Train %03d loss %e dice %.5f", step + 1,
                                     loss_meter.avg, dice)
                now = time.perf_counter()
                walls.append(now - t_end)
                t_end = now
            timer.close()
            acc.drain()
            _, _, train_dice = train_metric.get()
            self.writer.add_scalar("Train/Loss", loss_meter.avg, epoch)
            self.writer.add_scalar("Train/dice", train_dice, epoch)
            self.writer.add_scalar("Train/steps_per_sec", timer.steps_per_sec, epoch)
            # the share of a step's wall time (its wait for the batch
            # included) spent waiting on the prefetched train batch, and on
            # the val batch, which is assembled in the loop; over the steps
            # that steps_per_sec counts
            self.writer.add_scalar("Train/prefetch_wait_share",
                                   steady_share(prefetch.waits, walls), epoch)
            self.writer.add_scalar("Train/val_fetch_share", steady_share(val_waits, walls), epoch)

            # ---- eval epoch ----
            metric, vloss = run_eval_loop(self.eval_step, self.valid_queue,
                                          self.n_classes, self._place)
            pixacc, miou, dice = metric.get()
            self.logger.info("Epoch %d Val loss: %f, pixAcc: %s, mIoU: %s, dice: %s",
                             epoch, vloss.avg, pixacc, miou, dice)
            self.writer.add_scalar("Val/pixAcc", pixacc, epoch)
            self.writer.add_scalar("Val/mIoU", miou, epoch)
            self.writer.add_scalar("Val/dice", dice, epoch)
            self.writer.add_scalar("Val/loss", vloss.avg, epoch)

            if is_main(self.mesh):
                self.ckpt.save(self.state, {
                    "epoch": epoch + 1,
                    "dur_time": self.dur_time + time.time() - run_start,
                    "cur_patience": self.patience,
                    "geno_type": self.geno_type,
                })
            self.logger.info("save checkpoint (epoch %d) in %s dur_time: %s", epoch,
                             self.ckpt.directory,
                             calc_time(self.dur_time + time.time() - run_start))

        final = self.geno_type or repr(self.derive())
        self.writer.export_scalars_to_json(os.path.join(self.run_dir, "all_scalars.json"))
        self.writer.close()
        self.logger.info("End! best genotype %s", final)
        close_logger(self.logger)
        return final
