"""Evaluation runner: load a checkpoint, evaluate on the val split, save the
per-image predicted masks and the input|pred|gt grid PNGs.

Port of `senas_tpu/runner/test.py` (the reference's
experiments/testing_model.py). The checkpoint is read without a target
state (`CheckpointManager.restore_raw`): evaluation takes only the model's
weights and running stats, whatever optimizer the training run had. It
runs on one device in `dtype` (None: f32; the config's `precision:` is not
read, as in the JAX package's TestRunner), so a bf16 run's checkpoint,
which holds f32 weights, evaluates in f32 by default. The PNGs
are written as each batch comes back. `run_promise12_submission` writes
the PROMISE12 challenge volumes from the slice masks.

With `training.multi_gpus: true` over a process group of two or more
ranks (`runner/common.py` `setup_mesh`) each rank evaluates its rows of
every batch (a trailing batch the ranks do not divide runs whole on each),
the metrics and masks are the global batch's, and rank 0 alone writes the
log and the PNGs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from senas_torch.challenge import predict_test, volumetric_metrics
from senas_torch.core.device import resolve_device
from senas_torch.data import DataLoader, get_dataset, get_dataset_spec
from senas_torch.models.factory import get_segmentation_model
from senas_torch.parallel.mesh import replicate, shard_train_step
from senas_torch.runner.common import (DEFAULT_LOG_ROOT, is_main, make_batch_placer,
                                       resolve_dataset_kwargs, run_outputs, setup_mesh)
from senas_torch.runner.train import loss_name, resolve_genotype
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.loss import build_loss
from senas_torch.train.metrics import AverageMeter, SegmentationMetric
from senas_torch.train.trainer import make_eval_step
from senas_torch.utils.logging import (close_logger, get_logger, make_run_dir, store_images,
                                       write_png)


class TestRunner:
    __test__ = False  # not a pytest class, despite the name

    def __init__(self, cfg: Dict[str, Any], model_name: str = "senas",
                 genotype_str: str = "", resume: Optional[str] = None,
                 config_path: Optional[str] = None, data_root: Optional[str] = None,
                 log_root: str = DEFAULT_LOG_ROOT, batch_size: int = 6, device=None,
                 dtype=None):
        if resume is None:
            raise ValueError("resume: the checkpoint directory to evaluate is required")
        mgr = CheckpointManager(resume)
        name = "best" if mgr.exists("best") else "last"
        if not mgr.exists(name):
            raise FileNotFoundError(f"no checkpoint in {resume}")
        self.cfg = cfg
        t = cfg["training"]
        dev = resolve_device(device)
        # `multi_gpus` as the train runner reads it (the JAX runner's mesh
        # evaluation, senas_tpu/runner/test.py:93-100)
        self.mesh, device_note = setup_mesh(t, dev, model_name)
        self.device = self.mesh.device if self.mesh else dev
        ds_name = cfg["data"]["dataset"]
        valset = get_dataset(ds_name, path=data_root, split=cfg["data"].get("split", "val"),
                             mode="val", **resolve_dataset_kwargs(cfg))
        self.n_classes = get_dataset_spec(ds_name).num_class
        self.valid_queue = DataLoader(valset, batch_size, shuffle=False)
        self._place = make_batch_placer(self.device, self.mesh,
                                        spatial=t.get("mesh_spatial", 1) > 1)

        self.run_dir, self.logger = run_outputs(self.mesh, lambda: make_run_dir(
            log_root, model_name, "testing", ds_name, config_path))
        if device_note:
            self.logger.info(device_note)
        self.image_dir = os.path.join(self.run_dir, "images")
        if is_main(self.mesh):
            os.makedirs(self.image_dir, exist_ok=True)

        genotype = resolve_genotype(cfg, genotype_str, model_name)
        self.model = get_segmentation_model(
            model_name, dataset=ds_name, c=t.get("init_channels", 32),
            depth=t.get("depth", 5), supervision=False, genotype=genotype,
            double_down_channel=t.get("double_down_channel", False), dtype=dtype,
            device=self.device)
        self.model.load_state_dict(mgr.restore_raw(name)["model"])
        if self.mesh is not None:
            replicate(self.mesh, [*self.model.parameters(), *self.model.buffers()])
        self.logger.info("loaded checkpoint %s (%s)", resume, name)
        self.eval_step = shard_train_step(make_eval_step(self.model, build_loss(loss_name(t))),
                                          self.mesh)

    def run(self, save_images: bool = True) -> Dict[str, float]:
        metric = SegmentationMetric(self.n_classes)
        loss_meter = AverageMeter()
        img_idx = 0
        # class ids spread over 0..255 in the saved masks
        scale = 255 // max(1, self.n_classes - 1)
        for batch in self.valid_queue:
            out = self.eval_step(self._place(batch))
            host = {k: v.cpu().numpy() for k, v in out.items()}
            metric.update_counts(host["tp"], host["fp"], host["fn"], float(host["acc"]))
            loss_meter.update(float(host["loss"]), n=batch["image"].shape[0])
            if save_images and is_main(self.mesh):
                preds = host["pred"]
                for i in range(preds.shape[0]):
                    write_png(os.path.join(self.image_dir, f"{img_idx + i:05d}.png"),
                              preds[i] * scale)
                img_idx += preds.shape[0]
                write_png(os.path.join(self.image_dir, f"grid_{img_idx:05d}.png"),
                          store_images(batch["image"], preds, batch["label"], self.n_classes))
        pixacc, miou, dice = metric.get()
        self.logger.info("val loss %f pixAcc %s mIoU %s dice %s",
                         loss_meter.avg, pixacc, miou, dice)
        close_logger(self.logger)
        return {"loss": loss_meter.avg, "pixAcc": pixacc, "mIoU": miou, "dice": dice}

    def run_promise12_submission(self, case_dir: str, dest: Optional[str] = None,
                                 queue: Optional[DataLoader] = None):
        """The PROMISE12 challenge path (the reference's train_model.py:355-381
        test() and store_test_seg.py): infer over `queue` (default: the val
        queue) in case order on the runner's device, stitch the uint8 slice
        masks back into volumes with each source case's origin, direction and
        spacing, and write <case>_segmentation.mhd under `dest` (default
        <run dir>/predictions). With ground truth (*_segmentation.mhd) in
        `case_dir`, also score the volumes. Returns (written paths, the
        volumetric summary or None); under a mesh every rank infers and rank
        0 alone writes and scores (the others return ([], None))."""
        slices = []
        for batch in (self.valid_queue if queue is None else queue):
            preds = self.eval_step(self._place(batch))["pred"].cpu().numpy()
            slices.extend(preds)
        if not is_main(self.mesh):
            return [], None
        logger = get_logger(self.run_dir)
        dest = dest or os.path.join(self.run_dir, "predictions")
        names = sorted(os.listdir(case_dir))
        case_paths = [os.path.join(case_dir, f) for f in names
                      if f.endswith(".mhd") and "segm" not in f.lower()]
        written = predict_test(slices, case_paths, dest=dest)
        summary = None
        if any("segm" in f.lower() for f in names):
            summary = volumetric_metrics(slices, case_dir, logger=logger)
        logger.info("submission: %d volumes -> %s", len(written), dest)
        close_logger(logger)
        return written, summary
