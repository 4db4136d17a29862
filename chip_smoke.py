"""Drive the PyTorch port (senas_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run:
  1. environment: the card's name and power limit (nvidia-smi), versions,
     and which of cv2, PIL, matplotlib and scipy import;
  2. build: the CUDA kernels of senas_torch/csrc (grouped_epilogue.cu and
     norm_convs.cu) with nvcc (sm_90a), one nvcc per source, together;
     the SASS of norm_convs_kernel (cuobjdump) must hold tensor-core
     instructions (HGMMA: wgmma), and that of norm_convs_bf16_kernel bf16
     HGMMA only; ptxas's report of norm_convs_bf16_kernel<1..4> must show
     0 bytes spilled and no wgmma serialized (its registers are logged), and
     that of K1a's eight kernels 0 bytes spilled;
  3. kernels: each of the four epilogue kernels against its plain PyTorch
     version on the same tensors on the card, at the shapes the supernet
     gives it (train- and eval-mode operands), timed in turns with the
     plain version (the call, and the device time of calls queued behind a
     spin kernel, with the operands rotated over copies of more than 150 MB
     so that the L2 holds none of a call's inputs); K1a on each path of its
     launch plan (a warp a plane, a CTA a plane; 16-byte and scalar
     loads, a misaligned slice), two calls bit-equal; the
     epilogue's autograd gradients against autograd through the plain
     reference;
     K2 (norm_convs, 3xTF32 on the tensor cores) against its plain version
     at bench.py's shape (B 64, 128x128, C 32, N 24) and at an edge-tile
     shape, timed beside its plain version and the library convolutions
     with TF32 off and on; the library with TF32 on (the control) must
     fail K2's limit, which the kernel meets;
  4. the norm_convs path: one call of `norm_convs` at bench.py's shape on
     f32 operands and one on bf16 operands, as a user (and bench.py) calls
     it, with each dtype's launch counted: no model path of either package
     calls K2;
  5. the eval path: the supernet's inference path at the
     configs/senas/senas_promise12.yml `searching:` geometry (batch 8 of
     256x256x1, init_channels 32, depth 5, meta_node_num 3, f32): one
     train-mode forward (running stats move), then the search-eval step on
     3 batches, with the kernels' launch counts checked; the card's logits
     held to the plain CPU path on the first 2 images; one eval step under
     torch.profiler, the eval step with the kernels against the plain
     epilogue in turns;
  6. the search path at the same geometry (batch 8 train + 8 val, the
     yml's SGD and Adam): one bilevel step with do_arch=False, then 3 with
     do_arch=True, with launch counts checked per step; one step under
     torch.profiler; the same step from one saved state with the kernels
     (twice), with the kernels' plain twins and with the plain epilogue,
     compared leaf by leaf: with the default algorithms from the main
     path's state (the card's spread, logged), and under deterministic
     algorithms from the four steps replayed from the initial state (the
     kernels twice must agree exactly; twins and plain within limits);
     timed in turns;
  7. a search training step on the card held to the same step on the CPU,
     at a reduced size (depth 3, c 8, 64x64, batch 2) from identical state,
     with TF32 off; the same step with TF32 on must fail the same limits;
  8. the search runner: `senas_torch.search_arc`'s main in this process on
     configs/senas/senas_synthetic.yml for its 3 epochs, then resumed from
     its checkpoint for one more;
  9. the fixed path: SenasModel(senas) at the senas_promise12.yml
     `training:` geometry (batch 12 of 256x256x1, init_channels 32, depth
     5, SGD 6e-3/0.9/5e-4, clip 5, dice_ce): 1 + 3 train steps, one under
     torch.profiler, the eval step on 3 batches with its uint8 `pred`, the
     card's logits held to the CPU path on 2 images;
 10. a fixed training step on the card held to the same step on the CPU
     (depth 3, c 8, 64x64, batch 2), TF32 off; with TF32 on it must fail;
 11. the fixed CLIs in this process: `senas_torch.train_model` on
     senas_synthetic.yml for one epoch (8 steps) with SENAS_TRACE_DIR set,
     which must write one torch.profiler trace (steps [5, 8); its size is
     logged), then `senas_torch.testing_model` on its best checkpoint;
 12. serving: phase 9's trained model saved with CheckpointManager and
     exported by `senas_torch.export_model --check --f32` (in this process)
     on the card; the artifact's Predictor answers batches of 1, 3 and 12 with the
     eager model's logits (1e-4) and their argmax as uint8 masks (the
     compared calls with cuDNN's deterministic algorithms, which must give
     the same bits call after call; the call-to-call spread with its
     default ones is logged), timed per request at batch 1 and 12; the same artifact on the CPU within
     phase 9's card-vs-CPU limit; two replicas on the card at batch 5 (the
     pad path); the TF32 control (a backend-default artifact with TF32 on
     strays from the CPU, the --f32 one does not);
 13. the PROMISE12 submission path: three cases at 320-pixel native
     resolution written with the port's write_mhd, their slices predicted
     at 256x256 through the Predictor, `predict_test` and
     `volumetric_metrics`, and the same through
     `TestRunner.run_promise12_submission` on the card; the written
     volumes keep their sources' shape, origin, spacing and direction;
 14. the PROMISE12 data path: a phantom in PROMISE12's layout (10 training
     cases of 10-16 slices at 320x320, 2 test cases) written with
     write_mhd; the cache built through get_dataset("promise12"), timed as
     CLAHE, resize and the native curvature flow (which must run, and
     agree exactly with its numpy twin); the augmented loader timed at
     batch 8 and 12, serial and pooled; then the CLIs in this process on
     configs/senas/senas_promise12.yml with --data_root the phantom:
     search_arc for 1 epoch at full width (K1a-K1d launches held to the
     count the epoch's steps and eval batches need; ms/step and the
     loop's wait on the loader), train_model for 1 epoch, testing_model on
     its best checkpoint, the submission from the test split through
     `TestRunner.run_promise12_submission` (each volume with its source's
     geometry), and `best_worst_contour_grid` where matplotlib imports;
 15. the other shipped configs' data paths, on phantoms written here (no
     Pillow) in each dataset's layout: CHAOS CT (4 cases of 24 DICOM slices
     at 512x512 with RescaleSlope/Intercept, Ground/liver_GT_*.png), CHAOS
     MR (T1DUAL and T2SPIR at 256x256), MSD Task02_Heart (3 volumes of
     320x320x16 as .nii.gz, extracted once by the port's extract_task) and
     MoNuSAC (RGB tiles); the port's DICOM, NIfTI and PNG readers held to
     the written arrays; decode ms per slice, ms per augmented batch
     (serial and pooled) and the extraction's seconds; search_arc on
     configs/senas/senas_chaos.yml for 1 epoch at full width (K1a-K1d
     launches held to the count; ms/step and the loop's waits),
     train_model on configs/senas/senas_heart.yml for 1 epoch (batch 12 of
     256x320) and testing_model on its best checkpoint; a monusac and a
     chaos_mr batch through get_dataset;
 16. the baseline zoo: the factory's nine models (nasunet, unet,
     unet_plus_plus, manet, linknet, fpn, pspnet at depth 3, pan,
     deeplab_v3_plus) at the senas_promise12.yml `training:` geometry, each
     1 + 3 train steps and the eval step on 3 batches (ms/step, peak memory,
     the logits' shape, finite losses, every weight moved), a unet, an fpn
     and a deeplab_v3_plus step under torch.profiler; each model's train step on
     the card against the CPU (batch 2, depth 3-5, 64x64 or PAN's 128x128)
     in f32 (TF32 off) and in f64, one CPU generator giving both devices the
     same dropout mask; `train_model` and `testing_model` with --model unet
     and --model nasunet on senas_synthetic.yml; the trained unet exported by
     `export_model --model unet --check --f32` and served at batch 1 and 12;
     the six smp_* losses on full-size logits, card against CPU.
 17. bf16 (`precision: bf16`): the bf16 variants of K1a-K1d against their
     plain twins on bf16 tensors at the supernet's group shapes (train and
     eval operands; f32 sums within 1e-5, bf16 outputs equal but on <= 1e-3
     of the elements, each within one bf16 ulp or the f32 cancellation of
     its terms), timed beside the f32 variants and the bf16 byte bound, and
     the epilogue's bf16 gradients; the supernet in bf16 at phase 6's
     geometry, 1 + 3 search steps (the bf16 variants' launches held to the
     count, the f32 ones' to 0) and the search-eval step on 3 batches, each
     with one step under torch.profiler and the peak memory; the fixed
     model in bf16 at phase 9's geometry, 1 + 3 train steps (one profiled)
     and the eval step on 3 batches; a search and a fixed step in bf16 on
     the card against the CPU at phases 7 and 10's size (held as the CPU
     tests hold the port to the JAX package: at most twice the CPU's own
     bf16-vs-f32 distance) with the control that the card's bf16 step
     fails phase 7's f32 limits against its f32 step; senas_synthetic.yml
     with `precision: bf16` through search_arc and train_model (1 epoch)
     and testing_model (f32) on the bf16 run's best checkpoint.
 18. the zoo in bf16 and K2 in bf16: K2's bf16 kernel (one bf16 wgmma per
     product, f32 sums, one rounding) against its twin (the f32
     convolutions of the bf16 values, rounded once) at bench.py's shape and
     the edge shape (equal but on <= 1e-3 of the outputs, each within one
     bf16 ulp or 2^-21 of its sum of |products|), timed beside the f32
     kernel, its bf16 bound and cuDNN's three bf16 convolutions; the nine
     zoo models with `dtype=torch.bfloat16` at phase 16's geometry (1 + 3
     train steps, the eval step on 3 batches, ms/step, peak memory, the
     logits' dtype: fpn and pan f32, the rest bf16; a unet, an fpn and a
     deeplab_v3_plus step under torch.profiler), beside phase 16's f32
     numbers; each model's bf16 train step on the card against the CPU at
     phase 16's reduced sizes (PAN at batch 4), at most twice the CPU's own
     bf16-vs-f32 distance, with the control that the card's bf16 step
     leaves phase 16's f32 limits of its f32 step; `train_model --model
     unet` and `--model fpn` on senas_synthetic.yml with `precision: bf16`,
     then `testing_model --model unet` (f32) on the bf16 checkpoint; the six
     smp_* losses on full-size bf16 logits, card against CPU.
 19. the config keys and SENAS_PALLAS_BN (the environment variable set and
     restored inside the phase): BatchNorm with the gate on (K1a-K1d at
     n=1) against the same path on the kernels' plain twins and against
     the gate off, at every BatchNorm shape of the fixed model and at
     [2,64,1,1], [2,64,3,3], [2,64,6,6], [2,512,8,8] and [12,32,256,256],
     train and eval, f32 and bf16, forward, backward and running stats;
     K1a-K1d at n=1 on [12,32,256,256] timed L2-cold as phase 3 times them,
     each in turns with its twin and with the library call that computes
     it (torch.batch_norm_stats, _elemt, _backward_reduce, _backward_elemt:
     SyncBatchNorm's CUDA steps), beside their byte bounds and
     F.batch_norm's forward and backward, with the launches of one
     BatchNorm forward and backward each way; the promise12-fixed-train
     step, the fixed step in bf16 and the zoo's unet step in bf16 with the
     gate on and off in turns (each gated step's K1 launches held to its
     BatchNorm calls), one step each way under torch.profiler; one fixed
     step card against CPU at phase 10's size with the gate on and with
     each of adamax, adadelta, adagrad, rmsprop, asgd and adabound, within
     phase 7's limits; remat at full width (the search step with do_arch
     and the fixed step, off and on: ms/step, peak memory, the recompute's
     launches) and at phase 7's size under cuDNN's deterministic algorithms
     (the same metrics and state on and off); senas_synthetic.yml through
     search_arc (beta_mode grouped, multi_gpus, mesh_spatial 2, adabound)
     and train_model (remat, rmsprop) for one epoch each.
 20. the encoder families: a Unet on each of vgg13_bn, densenet121,
     mobilenet_v2, efficientnet-b0, se_resnext50_32x4d, xception,
     inceptionv4, inceptionresnetv2, dpn68, timm-mobilenetv3_large_100 and
     timm-resnest14d at the promise12 `training:` geometry, 1 + 3 train
     steps in f32 and in bf16 (ms/step, peak memory, device launches a
     step); each one's but the Inceptions' and Xception's train step on the
     card against the CPU at depth 5, batch 2, 64x64: in f64 whole (phase 16's f64 limits), in f32 split
     into the forward, the gradients (the CPU's forward forced to the
     card's module outputs) and the update; DeepLabV3+ on efficientnet-b0
     at output stride 16, one f32 step; SENAS_PALLAS_BN on timm-resnest14d
     and dpn68: K1a-K1d held to their twins at every shape their encoders'
     BatchNorms see (the 1x1 attention planes included), K1a and K1c timed
     at the largest and the smallest plane and at phase 19's shape (the
     call back to back, and the device time of calls queued behind a
     spin kernel),
     each Unet's f32 step with the gate on and off in turns.
 21. the timm residual variants: a Unet on each of timm-res2net50_26w_4s,
     timm-regnety_016, timm-skresnet18 and timm-gernet_s at the promise12
     `training:` geometry, 1 + 3 train steps in f32 and in bf16 (ms/step,
     peak memory, device launches a step); every one of the 37 names
     (Res2Net, RegNet X/Y, SK-Net, GERNet) built on the card, one eval-mode
     Unet forward (depth 4) at batch 2 of 64x64x1 in f32 and in bf16 (finite logits,
     the pyramid's channels those of `encoder_out_channels`); card against
     CPU as phase 20 holds it for the four, timm-res2next50 and
     timm-skresnext50_32x4d, and DeepLabV3+ on timm-regnetx_002 at output
     stride 8; DeepLabV3+ on timm-skresnet18 at output stride 16 at full
     width; SENAS_PALLAS_BN on timm-regnety_016 and timm-skresnet18:
     K1a-K1d held to their twins at every shape their encoders'
     BatchNorms see, K1a and K1c timed at the largest plane phase 20 did
     not see, each Unet's f32 step with the gate on and off in turns, its
     BatchNorm calls equal to its `BatchNorm` modules (SK-Net's attention
     BatchNorm, flax's rules, is not one and never reaches K1).
 22. data parallelism (senas_torch/parallel): the promise12 search step
     (do_arch, global batch 8) and fixed step (global batch 12) at full
     width over two gloo ranks sharing the card (this script started
     twice with --dp-rank), first as MeshSpec(data=2) (4 and 6 batch rows
     each), then as MeshSpec(data=1, spatial=2) (every batch row, 128 of
     the 256 image rows each, halo exchanges around every convolution,
     pooling and resize), and over one NCCL rank in this process, each held
     to the single-process step on the global batch from one state (both
     under deterministic algorithms, `DP_LIMITS`); K1a-K1d launched on
     every rank; ms/step of each, the share of a step inside the
     collectives' calls (timed around each), their number, and the bytes
     of the halo exchanges. NCCL refuses two ranks on one device, so the
     split rows run over gloo only. Then promise12-zoo-rows: each of the
     nine factory models' fixed train step at the `training:` geometry
     (global batch 12 of 256x256, depth 5, pspnet 3; f32, TF32 off,
     cuDNN's deterministic algorithms) over the same two gloo ranks as
     MeshSpec(1, 2), and unet once in bf16 and once with SENAS_PALLAS_BN=1
     (K1a-K1d on the zoo's row blocks), each held to one process from one
     state (`DP_LIMITS`; unet bf16 by ROADMAP's bf16 bound; manet, whose
     own f32 step lies beyond `DP_LIMITS` of its f64 one, as at most twice
     as far from the f64 step as one process; every f32 model's distances
     to its f64 step logged); ms/step of each rank and of one process, the
     collective calls a step, the halo exchanges and the whole-level
     gathers with their bytes, the share of a step inside the calls. Then
     promise12-encoder-rows: the same for a Unet (depth 5, full width) on
     timm-mobilenetv3_large_100, timm-resnest14d (also with
     SENAS_PALLAS_BN=1: K1a-K1d launched alike in one process and on each
     rank), timm-skresnet18, inceptionv4, se_resnext50_32x4d and
     efficientnet-b0 (also in bf16, by the bf16 bound against its f32
     step), each held to one process (`DP_LIMITS`).
 23. the generic loaders (senas_torch/data/generic.py): two phantom
     trees written here in the layouts the loaders walk, JPEGs by this
     script's own baseline encoder (`encode_jpeg`; 4:2:0 and 4:4:4) and
     PNG masks by zlib: VOCdevkit/VOC2012 (24 train and 12 val images of
     500x375, palette masks with a 255 border) and ADEChallengeData2016
     (the same counts at 683x512, gray masks with void 0), a few distinct
     images under many names; the port's decode held near the written
     pixels and its masks equal to them; ms per sample of the JPEG decode,
     the bilinear resize and the train-mode __getitem__; `train_model` in
     this process for one epoch of senas_promise12.yml's `training:` with
     `data.dataset` set (480x480 crops, batch 12), --model unet (resnet10)
     and senas, each at full width and depth 5 (remat on where the peak
     passes 70 GB): ms/step, the loop's prefetch wait share, peak memory;
     one decoded ADE20K batch (void labels -1 included; depth 3, c 8,
     64x64, batch 2) stepped on the card against the CPU; SenasModel at
     dropout_prob 0.2 at full width (batch 2 of 64x64x3): a step on the
     card against the CPU from one CPU generator and remat on against off,
     in f64 (the full-width f32 step at this size is ill-conditioned on
     the CPU already; the f32 distance is logged), all within
     `CARD_CPU_LIMITS`; ms/step and peak at batch 12 of 256x256x3 with and
     without dropout and with remat.
 24. the long tail (M17): every legacy block class (senas_torch/utils/
     legacy_blocks.py) and customize's PyramidPooling and ConcurrentModule
     in f64, train mode, batch 2 of 64x64, on the card against the CPU
     under deterministic algorithms (outputs, gradients, running stats);
     legacy-segnet-train: pytorch-semseg's SegNet from the legacy blocks
     (SegnetDown x 5 at 64, 128, 256, 512, 512 with 2, 2, 3, 3, 3
     convolutions, the mirrored SegnetUps, a 1x1 head) at the
     senas_promise12.yml `training:` geometry (batch 12 of 256x256x1, SGD
     6e-3/0.9/5e-4, dice_ce, f32), 1 + 3 steps with SENAS_PALLAS_BN=1
     (K1a-K1d once each a BatchNorm a step, counted), the gated BatchNorm
     held at each of its shapes to the kernels' plain twins and to the
     gate off (check_bn_path), then the gate on and off in turns with a
     profile each way; KohonenSOM.fit on the card (20x20 grid, 1000x16
     samples, 20 iterations) against the CPU: the f32 loop traced on
     both, its best-matching units equal up to the first near-tie (the
     two nearest nodes within 4 ulps) and the weights before it within
     1e-5; the whole 20 iterations in f64 within 1e-9;
     RunScore on CUDA label maps against numpy; get_gpus_memory_info,
     device_memory_log, flops_params_info of SenasModel at `training:`;
     the two user tools (calc_mean_std, cell_visualize) in this process.
Each phase's seconds are logged as it ends, and all of them at the end.
Phases 12-13, 16, 18's zoo, 20's and 21's ungated steps and 23 launch none
of the kernels (neither the fixed model nor the zoo has any, unless
SENAS_PALLAS_BN=1).
Every kernel variant must be launched on at least one path (phases 4-6, 9,
14, 15, 17, 19-22, 24; K2's bf16 variant in phase 4). The line before the last is a
JSON list of the kernels, the bf16 variants as `<name>_bf16`; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits 1 and prints no result.

    python3 chip_smoke.py --k1

builds the kernels and runs only phase 3's and 17's K1a-K1d checks and
times, phase 19's n=1 times beside the library calls, and K1a and K1c at
K1_SHAPES (~2 min, not the whole script's ~13): the loop for work on the
K1 kernels, such as one launch for K1c (ROADMAP.md, the speed notes). It
prints no result line.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import copy
import datetime
import functools
import gzip
import importlib
import io
import itertools
import json
import os
import random
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from senas_torch import (calc_mean_std, cell_visualize, export_model, search_arc, testing_model,
                         train_model)
from senas_torch.challenge import predict_test, volumetric_metrics
from senas_torch.challenge.promise12 import best_worst_contour_grid
from senas_torch.core.config import load_config
from senas_torch.core.genotype import parse_genotype
from senas_torch.data import (DataLoader, augment, get_dataset, imgproc, native,
                               pilresample, promise12)
from senas_torch.data.dicom import read_dicom_pixels
from senas_torch.data.imfile import float_to_l, read_image, write_png_l
from senas_torch.data.io import MetaImage, read_mhd, read_nifti, write_mhd
from senas_torch.data.msd import extract_task
from senas_torch.utils.logging import write_png
from senas_torch.models import geno_searched, zoo
from senas_torch.models.encoders import encoder_out_channels
from senas_torch.models.encoders_timm2 import TIMM2_ENCODERS
from senas_torch.models.factory import get_segmentation_model
from senas_torch.models.senas_model import SenasModel
from senas_torch.ops import _build
from senas_torch.ops import grouped_epilogue as ge
from senas_torch.ops import norm_convs as nc
from senas_torch.ops.primitives import BatchNorm, init_params_
from senas_torch.runner.test import TestRunner
from senas_torch.search.fused_cell import GroupedMixedOp
from senas_torch.search.supernet import (SenasSearch, derive_genotype,
                                         init_arch_params, normalize_arch)
from senas_torch.serve import Predictor, export_predict_fn, save_artifact
from senas_torch.som import KohonenSOM, train_som
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.loss import build_loss
from senas_torch.train.metrics import RunScore
from senas_torch.train.optim import build_optimizer
from senas_torch.train.trainer import (FixedTrainState, SearchTrainState,
                                       make_eval_step, make_search_eval_step,
                                       make_search_step, make_train_step)
from senas_torch.utils import customize
from senas_torch.utils import legacy_blocks as lb
from senas_torch.utils.misc import device_memory_log, flops_params_info, get_gpus_memory_info
from senas_torch.utils.visualize import genotype_to_dot

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_promise12.yml")
RUNNER_CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
IN_CHANNELS, NCLASS, HW = 1, 2, 256     # promise12: 1-channel MR slices, 2 classes
N_BATCHES = 3
DO_ARCH = (False, True, True, True)     # the search path's steps
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores, 495
# TFLOP/s TF32 on them, dense (data sheet, at a 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# Group geometry of the flagship supernet: E=3 edges x c_part=8 channels,
# and the sides of its largest and a middle-sized group output.
GROUP_C = 24
KERNEL_HW = (256, 64)
LIBRARY_NOTE = "no one PyTorch call reduces or writes over n separate tensors"
EPILOGUE_SOURCE = "senas_torch/csrc/grouped_epilogue.cu"
EPILOGUE_REPLACES = {
    "branch_stats": "senas_tpu/ops/grouped_epilogue.py:114 (_branch_stats -> _stats_kernel :86)",
    "apply_mix": "senas_tpu/ops/grouped_epilogue.py:157 (_apply_mix -> _apply_kernel :143)",
    "bwd_reduce": "senas_tpu/ops/grouped_epilogue.py:206 (_bwd_reduce -> _bwd_reduce_kernel :189)",
    "bwd_dx": "senas_tpu/ops/grouped_epilogue.py:251 (_bwd_dx -> _bwd_dx_kernel :237)",
}
# Each kernel variant: its wrapper, and the dtype whose launches it counts
# (`launches_by_dtype`); the bf16 variants of K1a-K1d are `<name>_bf16`.
BF16_SUFFIX = "_bf16"
KERNELS = {
    **{name: dict(wrapper=getattr(ge, name), dtype="float32", source=EPILOGUE_SOURCE,
                  replaces=replaces) for name, replaces in EPILOGUE_REPLACES.items()},
    "norm_convs": dict(
        wrapper=nc.norm_convs, dtype="float32", source="senas_torch/csrc/norm_convs.cu",
        replaces="senas_tpu/ops/pallas_kernels.py:65 (fused_norm_convs -> "
                 "_norm_convs_kernel :37)"),
    **{name + BF16_SUFFIX: dict(wrapper=getattr(ge, name), dtype="bfloat16",
                                source=EPILOGUE_SOURCE, replaces=replaces)
       for name, replaces in EPILOGUE_REPLACES.items()},
    "norm_convs" + BF16_SUFFIX: dict(
        wrapper=nc.norm_convs, dtype="bfloat16", source="senas_torch/csrc/norm_convs.cu",
        replaces="senas_tpu/ops/pallas_kernels.py:65 (fused_norm_convs -> "
                 "_norm_convs_kernel :37), bf16 operands"),
}
SOURCES = ("grouped_epilogue", "norm_convs")


def log(msg: str):
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A failed check ends the run (and survives `python -O`, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ~10 ms of GPU time at the H100's 1.98 GHz boost clock: long enough for
# the host to queue the timed calls behind it
QUEUE_SLEEP_CYCLES = 20_000_000


def queued_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of fn(), from CUDA events around `reps`
    calls queued behind a spin kernel (`torch.cuda._sleep`): the host
    enqueues them all while the card spins, so the events read the calls'
    device work back to back, where `time_ms` reads the wrapper's host cost
    once that exceeds the kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# A timed call's operands rotate over copies that hold more than this
# together, so that no call finds its inputs in the 50 MB L2 that the
# previous calls filled; at most COLD_MAX_SETS copies (one for each call of
# a timing: 3 warm-up and 20 timed), so that inputs under ~6.5 MB a set
# stay L2-warm.
COLD_BYTES = 150e6
COLD_MAX_SETS = 24


def cold_sets(tensors) -> list:
    """`tensors` and copies of them (clones: the same values at other
    addresses), at least two sets, enough for COLD_BYTES in all."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    count = min(COLD_MAX_SETS, max(2, int(COLD_BYTES // max(size, 1)) + 1))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(count - 1)]


def rotating(fn, sets):
    """A call of fn(*set) on the next set of `sets` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def cold_ms(fn, sets) -> dict:
    """fn over the rotated operand sets: the call's time (`time_ms`) and
    the device time (`queued_ms`)."""
    return dict(ms=time_ms(rotating(fn, sets)), device_ms=queued_ms(rotating(fn, sets)))


def in_turns_ms(fns: dict, sets) -> dict:
    """`cold_ms` of each of the two callables of `fns` in turns, a, b, b,
    a: for each, the mean call and device ms, the device readings and
    their spread (largest less smallest)."""
    first, second = fns
    got = {name: [] for name in fns}
    for name in (first, second, second, first):
        got[name].append(cold_ms(fns[name], sets))
    out = {}
    for name, runs in got.items():
        dev_ms = [r["device_ms"] for r in runs]
        out[name] = dict(ms=sum(r["ms"] for r in runs) / len(runs),
                         device_ms=sum(dev_ms) / len(runs), device_readings=dev_ms,
                         device_spread=max(dev_ms) - min(dev_ms))
    return out


def reset_counts():
    for k in KERNELS.values():
        wrapper = k["wrapper"]
        wrapper.launches = 0
        for dtype in getattr(wrapper, "launches_by_dtype", {}):
            wrapper.launches_by_dtype[dtype] = 0


def counts():
    """Launches per kernel variant, each read from its wrapper's count of
    the variant's dtype."""
    out = {}
    for name, k in KERNELS.items():
        by_dtype = getattr(k["wrapper"], "launches_by_dtype", None)
        out[name] = by_dtype[k["dtype"]] if by_dtype is not None else k["wrapper"].launches
    return out


def add_counts(total: dict, got: dict) -> None:
    for k in total:
        total[k] += got[k]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# ---------------------------------------------------------------------------
# Phase 1-2: environment and build
# ---------------------------------------------------------------------------

def environment() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"python {sys.version.split()[0]}")
    return smi


def build() -> str:
    """Build every source; print ptxas's registers and spills. Returns the
    tensor-core instruction that norm_convs_kernel's SASS holds; that of
    norm_convs_bf16_kernel must be bf16 HGMMA."""
    t0 = time.perf_counter()
    seconds = _build.build(SOURCES)
    log(f"build: {seconds} (wall {time.perf_counter() - t0:.2f} s)")
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "error", "warning", "Function")):
                log(f"  ptxas {name}: {line.strip()}")
    bf16 = tensor_core_sass("norm_convs", "norm_convs_bf16_kernel", operands="BF16")
    check(bf16 == "HGMMA", f"norm_convs_bf16_kernel holds {bf16}, not HGMMA")
    ptxas_report("norm_convs", "norm_convs_bf16_kernel", 4)
    stats_ptxas()
    return tensor_core_sass("norm_convs", "norm_convs_kernel")


def ptxas_table(source: str, kernel: str) -> dict:
    """Registers and spilled bytes of each function whose mangled name
    holds `kernel`, from ptxas's -v log of `source`."""
    found, name = {}, None
    for line in _build.build_log(source).splitlines():
        entry = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?(?: for|$)",
                          line)
        if entry:
            name = entry.group(1)
            continue
        if name is None or kernel not in name:
            continue
        row = found.setdefault(name, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            row["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            row["registers"] = int(used.group(1))
    return found


def stats_ptxas() -> dict:
    """K1a's eight kernels (the warp path's and the CTA path's, vector and
    scalar loads, f32 and bf16) are in ptxas's log, and none spills."""
    found = {n: r for n, r in ptxas_table("grouped_epilogue", "branch_stats_").items()
             if "_warp_kernel" in n or "_cta_kernel" in n}
    short = {re.search(r"branch_stats_\w+?_kernelI\w+?Lb[01]E", n).group(0): r
             for n, r in found.items()}
    log(f"  ptxas branch_stats kernels: {short}")
    check(len(found) == 8 and all(r.get("spill_bytes") == 0 for r in found.values()),
          f"branch_stats kernels: missing or spilling: {found}")
    return found


def ptxas_report(source: str, kernel: str, instances: int) -> dict:
    """Registers and spilled bytes of each instantiation of `kernel` (the
    mangled names of kernel<1..instances>) in ptxas's -v log of `source`.
    Fails unless every one is there, spills 0 bytes and has no wgmma
    serialized (ptxas's "Potential Performance Loss" notes)."""
    found = ptxas_table(source, kernel)
    serialized = [line.strip() for line in _build.build_log(source).splitlines()
                  if "serialized" in line and kernel in line]
    by_nt = {re.search(r"ILi(\d+)E", n).group(1): r for n, r in found.items()}
    log(f"  ptxas {kernel}<NT>: {by_nt}")
    check(sorted(by_nt) == [str(i) for i in range(1, instances + 1)]
          and all("spill_bytes" in r and "registers" in r for r in by_nt.values()),
          f"ptxas's log lacks {kernel}<1..{instances}>: {by_nt}")
    check(all(r["spill_bytes"] == 0 for r in by_nt.values()), f"{kernel} spills: {by_nt}")
    check(not serialized, f"ptxas serialized {kernel}'s wgmmas: {serialized[:2]}")
    return by_nt


def tensor_core_sass(source: str, kernel: str, operands: str = "") -> str:
    """cuobjdump --dump-sass of the built library: the tensor-core
    instructions of each function whose name holds `kernel`. Fails unless
    every such function holds HGMMA (wgmma) or HMMA (mma.sync), and, with
    `operands` (e.g. "BF16"), unless every one of them names that type."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        if kernel in name:
            lines = [ln for ln in body.splitlines() if "HGMMA" in ln or "HMMA" in ln]
            found[name.strip()] = {op: body.count(op) for op in ("HGMMA", "HMMA")}
            if operands:
                found[name.strip()][operands] = sum(f".{operands}" in ln for ln in lines)
                check(found[name.strip()][operands] == len(lines),
                      f"{kernel}: tensor-core instructions without {operands}: {lines[:3]}")
    log(f"  SASS of {kernel}: {found}")
    check(bool(found), f"no function {kernel} in the SASS of {source}")
    kinds = {"HGMMA" if c["HGMMA"] else ("HMMA" if c["HMMA"] else None) for c in found.values()}
    check(None not in kinds, f"{kernel} holds no tensor-core instruction: {found}")
    return "HGMMA" if kinds == {"HGMMA"} else "HMMA"


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version on the card (K1a-K1d)
# ---------------------------------------------------------------------------

_DIFF = ("se_w1", "se_w2", "none_alpha_col", "none_bias")


def _group_inputs(dev, n, h, seed, train, se, none):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    E, P, C = 3, 8, GROUP_C
    xs = [r(8, C, h, h) * (1 + 0.5 * o) + 0.1 * o for o in range(n)]
    kw = dict(train=train)
    if not train:
        kw.update(run_means=[0.1 * r(C) for _ in range(n)],
                  run_vars=[r(C).abs() + 0.5 for _ in range(n)])
    if se:
        kw.update(se_index=1, se_w1=0.5 * r(E, P, 1), se_w2=0.5 * r(E, 1, P), E=E, P=P)
    if none:
        kw.update(none_alpha_col=r(C).abs() / n, none_bias=0.1 * r(C))
    args = (xs, [1 + 0.1 * r(C) for _ in range(n)], [0.1 * r(C) for _ in range(n)],
            [r(C).abs() / n for _ in range(n)])
    return args, kw


def _epilogue_grad_err(args, kw, readout, ref_dtype=None) -> float:
    """The autograd Function's gradients for every differentiable input
    against torch autograd through the plain two-pass reference, on the
    same tensors: the worst max|got - want| / max|want| over the inputs.
    `ref_dtype` is the reference's output dtype (None: the branches')."""
    leaves = [t.detach().clone().requires_grad_() for part in args for t in part]
    n = len(args[0])
    split = [leaves[i * n:(i + 1) * n] for i in range(4)]
    extra = {k: kw[k].detach().clone().requires_grad_() for k in _DIFF if k in kw}
    rest = {k: v for k, v in kw.items() if k not in _DIFF}
    inputs = leaves + list(extra.values())
    got = torch.autograd.grad(
        (ge.fused_group_epilogue(*split, **rest, **extra)[0] * readout).sum(), inputs)
    want = torch.autograd.grad(
        (ge.group_epilogue_reference(*split, **rest, **extra, out_dtype=ref_dtype)
         * readout).sum(), inputs)
    return max(rel_err(a.float(), b.float()) for a, b in zip(got, want))


def check_kernels(dev) -> dict:
    """Returns per-kernel records: the worst errors over every case, times at
    each shape in `timed`, and those of the heaviest main-path shape
    ([8,24,256,256], n=6) as `ms`, `plain_ms`, `bound_ms`."""
    names = [name for name, _ in _TIMED]
    records = {name: {} for name in names}
    worst = {name: 0.0 for name in names}
    worst.update(stats_rel=0.0, reduce_rel=0.0, epilogue=0.0, grad_rel=0.0)
    for h in KERNEL_HW:
        for n, se, none in ((6, True, False), (5, False, True)):
            b, planes = 8, 8 * GROUP_C
            for train in (True, False):
                args, kw = _group_inputs(dev, n, h, seed=h + n, train=train, se=se, none=none)
                xs = args[0]
                # K1a: sums within 1e-5 of the plane's sum of |x| (resp. x^2):
                # the kernel sums in another order than torch.sum.
                s1, s2 = ge.branch_stats(xs)
                p1, p2 = ge.branch_stats_plain(xs)
                abs1 = torch.stack([x.abs().sum(dim=(2, 3)) for x in xs])
                rel = max(((s1 - p1).abs() / abs1).max().item(),
                          ((s2 - p2).abs() / p2).max().item())
                err1 = max((s1 - p1).abs().max().item(), (s2 - p2).abs().max().item())
                check(rel <= 1e-5, f"branch_stats disagrees: rel {rel:.3g} (h={h} n={n})")
                # K1b: outputs within atol 1e-4 (values of scale ~1-10).
                a = torch.randn(n, b, GROUP_C, device=dev)
                k = torch.randn(b, GROUP_C, device=dev)
                err2 = (ge.apply_mix(xs, a, k) - ge.apply_mix_plain(xs, a, k)).abs().max().item()
                check(err2 <= 1e-4, f"apply_mix disagrees: {err2:.3g} (h={h} n={n})")
                # the whole epilogue against the port's two-pass reference
                got, _ = ge.fused_group_epilogue(*args, **kw)
                want = ge.group_epilogue_reference(*args, **kw)
                err3 = (got - want).abs().max().item()
                check(err3 <= 1e-4, f"fused_group_epilogue disagrees: {err3:.3g}")
                # K1c on a cotangent g: sums within 1e-5 of the plane's
                # sum of |g*x| (resp. |g|).
                g = torch.randn(b, GROUP_C, h, h, device=dev)
                da, dk = ge.bwd_reduce(xs, g)
                pa, pk = ge.bwd_reduce_plain(xs, g)
                abs_a = torch.stack([(g * x).abs().sum(dim=(2, 3)) for x in xs])
                rel_c = max(((da - pa).abs() / abs_a).max().item(),
                            ((dk - pk).abs() / g.abs().sum(dim=(2, 3))).max().item())
                err4 = max((da - pa).abs().max().item(), (dk - pk).abs().max().item())
                check(rel_c <= 1e-5, f"bwd_reduce disagrees: rel {rel_c:.3g} (h={h} n={n})")
                # K1d with the per-plane terms of this mode: in eval mode ds2
                # is 0 and ds1 lives on the SE branch only.
                ds1 = torch.randn(n, b, GROUP_C, device=dev)
                ds2 = torch.randn(n, b, GROUP_C, device=dev)
                if not train:
                    ds2.zero_()
                    ds1 = ds1 * torch.tensor([float(o == kw.get("se_index")) for o in range(n)],
                                             device=dev)[:, None, None]
                err5 = max((o1 - o2).abs().max().item() for o1, o2 in zip(
                    ge.bwd_dx(xs, g, a, ds1, ds2), ge.bwd_dx_plain(xs, g, a, ds1, ds2)))
                check(err5 <= 1e-4, f"bwd_dx disagrees: {err5:.3g} (h={h} n={n})")
                # the Function's gradients against autograd through the reference
                err6 = _epilogue_grad_err(args, kw, g)
                check(err6 <= 1e-4, f"epilogue gradients disagree: rel {err6:.3g}")
                torch.cuda.synchronize()
                for key, v in (("stats_rel", rel), ("branch_stats", err1), ("apply_mix", err2),
                               ("epilogue", err3), ("reduce_rel", rel_c), ("bwd_reduce", err4),
                               ("bwd_dx", err5), ("grad_rel", err6)):
                    worst[key] = max(worst[key], v)
                log(f"  h={h:3d} n={n} train={train!s:5} se={se!s:5} none={none!s:5}: "
                    f"stats abs {err1:.3g} rel {rel:.3g} | mix {err2:.3g} | epilogue {err3:.3g}"
                    f" | bwd_reduce abs {err4:.3g} rel {rel_c:.3g} | bwd_dx {err5:.3g}"
                    f" | grads rel {err6:.3g}")

            # times at this shape (n branches, train mode)
            args, kw = _group_inputs(dev, n, h, seed=1, train=True, se=se, none=none)
            xs = args[0]
            a = torch.rand(n, b, GROUP_C, device=dev)
            k = torch.rand(b, GROUP_C, device=dev)
            g = torch.randn(b, GROUP_C, h, h, device=dev)
            ds1, ds2 = torch.randn(n, b, GROUP_C, device=dev), torch.randn(n, b, GROUP_C, device=dev)
            elems = n * planes * h * h
            plane_bytes = planes * h * h * 4          # one [8,24,h,h] f32 tensor
            nbytes = dict(
                stats=n * plane_bytes + 2 * n * planes * 4,
                mix=n * plane_bytes + (n + 1) * planes * 4 + plane_bytes,
                reduce=(n + 1) * plane_bytes + (n + 1) * planes * 4,
                dx=(2 * n + 1) * plane_bytes + 3 * n * planes * 4)
            flops = dict(stats=3 * elems, mix=2 * elems, reduce=2 * elems + elems // n,
                         dx=4 * elems)
            t = k1_times(xs, a, k, g, ds1, ds2)
            t.update(epi=time_ms(lambda: ge.fused_group_epilogue(*args, **kw)),
                     epi_plain=time_ms(lambda: ge.group_epilogue_reference(*args, **kw)))
            bound = {key: max(nbytes[key] / PEAK_BYTES_PER_S, flops[key] / PEAK_F32_FLOPS) * 1e3
                     for key in nbytes}
            log(f"  times [8,{GROUP_C},{h},{h}] n={n}, L2-cold (call ms / device ms / spread / "
                "plain ms / bound ms): "
                + " | ".join(f"{name} {t[key]['ms']:.4f} / {t[key]['device_ms']:.4f} / "
                             f"{t[key]['device_spread']:.4f} / {t[key + '_plain']['ms']:.4f} / "
                             f"{bound[key]:.4f}" for name, key in _TIMED)
                + f" | fused_group_epilogue {t['epi']:.4f} (plain reference {t['epi_plain']:.4f})")
            for name, key in _TIMED:
                rec = k1_record([8, GROUP_C, h, h], n, t[key], t[f"{key}_plain"], bound[key])
                records[name].setdefault("timed", []).append(rec)
                if (h, n) == (KERNEL_HW[0], 6):
                    records[name].update({f: rec[f] for f in K1_ROW_KEYS})
    worst["stats_rel"] = max(worst["stats_rel"], check_stats_paths(dev, torch.float32)["paths_rel"])
    for name in names:
        records[name]["max_abs_err"] = worst[name]
    records["branch_stats"]["max_rel_err"] = worst["stats_rel"]
    records["bwd_reduce"]["max_rel_err"] = worst["reduce_rel"]
    log(f"kernels agree with their plain versions (worst: {worst})")
    return records


# K1a's paths on the card (`ge.branch_stats_plan`): (label, shape, n,
# element offset of the data, the path, 16-byte loads)
STATS_PATH_CASES = (
    ("a CTA a plane, n=1 [12,32,256,256]", (12, 32, 256, 256), 1, 0, "cta", True),
    ("a CTA a plane, n=6 main path", (8, GROUP_C, 256, 256), 6, 0, "cta", True),
    ("warp, 1x1 squeeze", (12, 32, 1, 1), 1, 0, "warp", False),
    ("warp, 16x16 maps", (12, 512, 16, 16), 1, 0, "warp", True),
    ("warp, scalar: 3x3 (9 elements)", (2, 64, 3, 3), 1, 0, "warp", False),
    ("a CTA a plane, scalar: misaligned slice", (12, 32, 256, 256), 1, 1, "cta", False),
    ("a CTA a plane, scalar: odd plane 255x255", (2, 8, 255, 255), 3, 0, "cta", False),
)


def check_stats_paths(dev, dtype) -> dict:
    """K1a on each path of its plan (STATS_PATH_CASES) in `dtype`: the plan
    takes the path named, the sums lie within 1e-5 of the plain twin's
    (s1 of the plane's sum of |x|, s2 of itself), a second call on the
    same input is bit-equal to the first, and the warp path's sums are
    those of a CTA a plane, bit for bit. A misaligned slice is a view
    one element into a buffer (contiguous, its data off 16 bytes)."""
    worst = 0.0
    for i, (label, shape, n, offset, path, vec) in enumerate(STATS_PATH_CASES):
        g = torch.Generator().manual_seed(100 + i)
        size = int(np.prod(shape))
        xs = []
        for o in range(n):
            buf = (torch.randn(size + offset, generator=g) * (1 + o) + 0.5).to(dev, dtype)
            xs.append(buf[offset:].view(shape))
        plan = ge.branch_stats_plan(n, shape[0] * shape[1], shape[2] * shape[3], dtype,
                                    aligned=all(x.data_ptr() % 16 == 0 for x in xs))
        check((plan.path, plan.vec) == (path, vec),
              f"branch_stats plan for {label}: {plan}, not {path} vec={vec}")
        s1, s2 = ge.branch_stats(xs)
        t1, t2 = ge.branch_stats(xs)
        p1, p2 = ge.branch_stats_plain(xs)
        abs1 = torch.stack([x.float().abs().sum(dim=(2, 3)) for x in xs])
        rel = max(((s1 - p1).abs() / abs1).max().item(), ((s2 - p2).abs() / p2).max().item())
        same = torch.equal(s1, t1) and torch.equal(s2, t2)
        if path == "warp" and dev.type == "cuda":
            # the warp path adds in the CTA path's order: the same bits
            c1, c2 = ge._launch_branch_stats(xs, ge.StatsPlan("cta", vec,
                                                              n * shape[0] * shape[1]))
            check(torch.equal(s1, c1) and torch.equal(s2, c2),
                  f"branch_stats ({dtype}, {label}): the warp path's sums differ from a CTA's")
        log(f"  branch_stats {dtype} {label}: plan {tuple(plan)}, rel {rel:.3g}, "
            f"two calls bit-equal {same}")
        check(rel <= 1e-5, f"branch_stats ({dtype}, {label}) disagrees: rel {rel:.3g}")
        check(same, f"branch_stats ({dtype}, {label}): two calls differ")
        worst = max(worst, rel)
    torch.cuda.synchronize()
    return dict(paths_rel=worst)


_TIMED = (("branch_stats", "stats"), ("apply_mix", "mix"), ("bwd_reduce", "reduce"),
          ("bwd_dx", "dx"))
# what a K1 row of the `kernels` line takes from its main shape's record
K1_ROW_KEYS = ("ms", "device_ms", "device_spread", "plain_ms", "bound_ms", "share_of_bound")


def k1_times(xs, a, k, g, ds1, ds2) -> dict:
    """K1a-K1d on these operands, each in turns with its plain twin (kernel,
    plain, plain, kernel; `in_turns_ms`), the branch tensors and g rotated
    over L2-cold copies (`cold_sets`); keys "stats", "stats_plain", ..."""
    calls = {"stats": (lambda xs, g: ge.branch_stats(xs), lambda xs, g: ge.branch_stats_plain(xs)),
             "mix": (lambda xs, g: ge.apply_mix(xs, a, k),
                     lambda xs, g: ge.apply_mix_plain(xs, a, k)),
             "reduce": (lambda xs, g: ge.bwd_reduce(xs, g),
                        lambda xs, g: ge.bwd_reduce_plain(xs, g)),
             "dx": (lambda xs, g: ge.bwd_dx(xs, g, a, ds1, ds2),
                    lambda xs, g: ge.bwd_dx_plain(xs, g, a, ds1, ds2))}
    sets = [(list(s[:-1]), s[-1]) for s in cold_sets((*xs, g))]
    out = {}
    for key, (kernel, plain) in calls.items():
        got = in_turns_ms({key: kernel, key + "_plain": plain}, sets)
        out.update(got)
    return out


def k1_record(shape, n: int, kernel: dict, plain: dict, bound: float, **extra) -> dict:
    """One timed shape of a K1 kernel: the call ms and L2-cold device ms
    (mean of two readings, their spread), the plain twin's call ms, the
    bound and the device time's share of it."""
    return dict(shape=list(shape), n=n, ms=kernel["ms"], device_ms=kernel["device_ms"],
                device_readings=kernel["device_readings"], device_spread=kernel["device_spread"],
                plain_ms=plain["ms"], plain_device_ms=plain["device_ms"], bound_ms=bound,
                share_of_bound=bound / kernel["device_ms"], **extra)


# K2 shapes (B, C, H, W, N): bench.py's (bench_pallas_norm_convs), edge
# tiles in both directions (100 = 12*8 + 4 rows, 70 = 2*32 + 6 columns), and
# C 20 (a 16-channel chunk whose second K half is partial) with N 32 (one
# slice at NT 4, the widest wgmma) at W 70 (not a multiple of 8).
K2_SHAPES = {"bench": (64, 32, 128, 128, 24), "edge": (5, 32, 100, 70, 24),
             "nt4": (2, 20, 30, 70, 32)}
# K2 against its plain version: within this share of each output's sum of
# |products| (the same convolutions of |x| and |w|): both sum the 59*C
# products in f32, in other orders, the kernel each product as three TF32
# ones (3xTF32, ~2^-21 of it). One TF32 product (~2^-11) fails it.
K2_REL_TOL = 1e-5


def _norm_inputs(dev, b, c, h, w, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g).to(dev)
    ks = [(0.1 * torch.randn(n, c, k, k, generator=g)).to(dev) for k in (3, 5, 5)]
    return x, ks


def _library_norm_convs(x, ks):
    """The library's yardstick: the three cuDNN convolutions and the cat."""
    return torch.cat([F.conv2d(x, w, padding=(k // 2) * d, dilation=d)
                      for (k, d), w in zip(nc.BRANCHES, ks)], dim=1)


def _embedded_13x13(ks):
    """The three kernels placed in one [3N,C,13,13] kernel (dilation 1,
    padding 6): one F.conv2d call computes the same function, with 3N*169
    taps per input channel where the three branches need N*59 (8.6x)."""
    n, c = ks[0].shape[:2]
    big = ks[0].new_zeros(3 * n, c, 13, 13)
    for i, ((k, d), w) in enumerate(zip(nc.BRANCHES, ks)):
        off = 6 - (k // 2) * d
        big[i * n:(i + 1) * n, :, off:off + (k - 1) * d + 1:d, off:off + (k - 1) * d + 1:d] = w
    return big


@contextlib.contextmanager
def tf32_convolutions():
    """cuDNN's convolutions in TF32 within it (off again after)."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def check_norm_convs(dev, seed: int) -> dict:
    """K2 against its plain version (and both against an f64 reference) at
    each of K2_SHAPES; at bench.py's shape, the TF32 control (the library
    convolutions with TF32 on must fail K2_REL_TOL), times of the kernel,
    its plain version and the library calls in turns, and its bounds: the
    3xTF32 one on the tensor cores, the f32 one on the CUDA cores, bytes."""
    rec = {"timed": []}
    worst_rel = worst_abs = 0.0
    for label, (b, c, h, w, n) in K2_SHAPES.items():
        x, ks = _norm_inputs(dev, b, c, h, w, n, seed)
        got = nc.norm_convs(x, *ks)
        want = nc.norm_convs_plain(x, *ks)
        abs_sum = nc.norm_convs_plain(x.abs(), *[k.abs() for k in ks]).clamp_min(1e-30)
        exact = nc.norm_convs_plain(x.double(), *[k.double() for k in ks])
        torch.cuda.synchronize()
        rel = ((got - want).abs() / abs_sum).max().item()
        err = (got - want).abs().max().item()
        rel_exact = ((got.double() - exact).abs() / abs_sum).max().item()
        plain_exact = ((want.double() - exact).abs() / abs_sum).max().item()
        del exact
        log(f"  norm_convs {label} [{b},{c},{h},{w}] N={n}: max abs err {err:.3g}, "
            f"rel (of the sum of |products|) {rel:.3g}; against f64: kernel {rel_exact:.3g}, "
            f"plain {plain_exact:.3g}")
        check(rel <= K2_REL_TOL, f"norm_convs disagrees with its plain version at {label}: "
              f"rel {rel:.3g} > {K2_REL_TOL}")
        check(tuple(got.shape) == (b, 3 * n, h, w), f"norm_convs gave {tuple(got.shape)}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        if label != "bench":
            continue
        big = _embedded_13x13(ks)
        single = lambda: F.conv2d(x, big, padding=6)
        single_rel = ((single() - want).abs() / abs_sum).max().item()
        # a library call, not a kernel of the port: cuDNN may take an FFT or
        # Winograd algorithm for 13x13, so it is held to a looser 1e-4
        check(single_rel <= 1e-4, f"the 13x13 embedding disagrees: {single_rel:.3g}")
        # the TF32 control: the same library convolutions in TF32 must fail
        # the limit that the kernel's 3xTF32 meets
        with tf32_convolutions():
            tf32_rel = ((_library_norm_convs(x, ks) - want).abs() / abs_sum).max().item()
        log(f"  TF32 control: the library convolutions with TF32 on are {tf32_rel:.3g} of "
            f"the sum of |products| off the plain version (limit {K2_REL_TOL})")
        check(tf32_rel > K2_REL_TOL, f"K2's limit let the TF32 library pass: {tf32_rel:.3g}")
        del got, want, abs_sum
        t = {"kernel": [], "plain": [], "library": [], "library_tf32": [], "single": []}
        calls = dict(kernel=lambda: nc.norm_convs(x, *ks),
                     plain=lambda: nc.norm_convs_plain(x, *ks),
                     library=lambda: _library_norm_convs(x, ks),
                     library_tf32=lambda: _library_norm_convs(x, ks), single=single)
        turns = ("kernel", "plain", "library", "library_tf32", "single",
                 "single", "library_tf32", "library", "plain", "kernel")
        for which in turns:
            with tf32_convolutions() if which == "library_tf32" else contextlib.nullcontext():
                t[which].append(time_ms(calls[which]))
        ms = {k: float(np.mean(v)) for k, v in t.items()}
        flops = nc.flops(x.shape, n)
        tf32_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
        f32_ms = flops / PEAK_F32_FLOPS * 1e3
        byte_ms = nc.nbytes(x.shape, n) / PEAK_BYTES_PER_S * 1e3
        log(f"  norm_convs times at bench.py's shape (ms, in turns {','.join(turns)}): {t}; "
            f"bounds: 3xTF32 operations {tf32_ms:.4f} (3 x {flops / 1e9:.2f} GFLOP at "
            f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), f32 operations {f32_ms:.4f} (at "
            f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), bytes {byte_ms:.4f} "
            f"({nc.nbytes(x.shape, n) / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s); "
            f"kernel at {flops / ms['kernel'] / 1e9:.2f} TFLOP/s of f32-equivalent work "
            f"({3 * flops / ms['kernel'] / 1e9:.2f} TFLOP/s TF32), "
            f"{max(tf32_ms, byte_ms) / ms['kernel']:.3f} of its bound")
        rec.update(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   library_tf32_ms=ms["library_tf32"], library_single_call_ms=ms["single"],
                   bound_ms=max(tf32_ms, byte_ms), f32_bound_ms=f32_ms, bytes_bound_ms=byte_ms,
                   tf32_control_rel=tf32_rel, tflops_f32_equivalent=flops / ms["kernel"] / 1e9,
                   shape=[b, c, h, w], n=n)
        rec["timed"].append(dict(shape=[b, c, h, w], n=n, bound_ms=rec["bound_ms"],
                                 **{f"{k}_in_turns": v for k, v in t.items()}))
    rec.update(max_abs_err=worst_abs, max_rel_err=worst_rel)
    return rec


def run_norm_convs_path(dev, seed: int) -> dict:
    """One call of norm_convs at bench.py's shape on f32 operands and one on
    bf16 operands, as a user calls it; the launches read from the counters
    (each dtype its own kernel)."""
    b, c, h, w, n = K2_SHAPES["bench"]
    x, ks = _norm_inputs(dev, b, c, h, w, n, seed + 4)
    xb, kb = x.to(BF16), [k.to(BF16) for k in ks]
    reset_counts()
    out = nc.norm_convs(x, *ks)
    out_bf16 = nc.norm_convs(xb, *kb)
    torch.cuda.synchronize()
    got = counts()
    want = {**{name: 0 for name in KERNELS}, "norm_convs": 1, "norm_convs" + BF16_SUFFIX: 1}
    check(got == want, f"the norm_convs calls launched {got}, expected {want}")
    for o, dt in ((out, torch.float32), (out_bf16, BF16)):
        check(tuple(o.shape) == (b, 3 * n, h, w) and o.dtype == dt
              and bool(torch.isfinite(o).all()),
              f"norm_convs gave non-finite values or a wrong shape or dtype ({o.dtype})")
    log(f"norm_convs call [{b},{c},{h},{w}] N={n}: launches {got}")
    return dict(launches=got)


# ---------------------------------------------------------------------------
# Profiles and the plain epilogue swapped in
# ---------------------------------------------------------------------------

_KERNEL_CLASSES = (
    ("branch_stats (K1a)", ("branch_stats_kernel",)),
    ("apply_mix (K1b)", ("apply_mix_kernel",)),
    ("bwd_reduce (K1c)", ("bwd_reduce_partial_kernel", "bwd_reduce_finish_kernel")),
    ("bwd_dx (K1d)", ("bwd_dx_kernel",)),
    ("norm_convs (K2)", ("norm_convs_kernel",)),
    ("norm_convs bf16 (K2)", ("norm_convs_bf16_kernel",)),
    ("matmul", ("xmma_gemm", "sgemm", "gemv")),
    # before "convolution": cuDNN's BN kernels carry "cudnn" in their names
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("convolution", ("conv", "cudnn", "implicit", "gemm", "xmma", "sm90", "fprop",
                     "dgrad", "wgrad", "depthwise", "winograd", "cutlass")),
    ("pool / upsample", ("pool", "upsample", "interp")),
    ("copy / cat", ("copy", "memcpy", "memset", "cat", "Cat")),
    ("optimizer", ("foreach", "multi_tensor", "sgd", "adam")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile(fn, label: str) -> dict:
    """fn() under torch.profiler after one warm-up call: device busy and
    idle share over its wall time, kernel time by class, the kernels that
    take the most device time and the most launches. Device activity only:
    the host's operators (with their shapes) made the analysis of a
    search step's profile take 38-57 s, the profiled call itself 3 s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile ({label}): the profiler recorded no device time (not measured)")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    by_class: dict = {}
    by_kernel: dict = {}
    for e in kernels:
        name, dur = e.name, e.time_range.end - e.time_range.start
        cls = next((c for c, keys in _KERNEL_CLASSES
                    if any(k.lower() in name.lower() for k in keys)), "other")
        for table, key in ((by_class, cls), (by_kernel, name)):
            t, n = table.get(key, (0.0, 0))
            table[key] = (t + dur, n + 1)
    idle = 1 - busy / wall_us
    log(f"profile ({label}): wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
        f"idle share {idle:.3f}, {len(kernels)} kernel launches")
    for cls, (t, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        log(f"  {cls:20s} {t / 1e3:8.3f} ms  {n:5d} launches  {t / busy:.3f} of busy")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  top: {t / 1e3:8.3f} ms  x{n:<4d} {name[:100]}")
    # the kernels launched most often, which the host pays for
    for name, (_, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:6]:
        log(f"  most launched: x{n:<5d} {name[:100]}")
    log(f"  (the profiled call and its analysis took {time.perf_counter() - t_start:.1f} s)")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle_share=idle, launches=len(kernels),
                by_class_ms={c: t / 1e3 for c, (t, _) in by_class.items()})


def plain_epilogue(xs, scales, biases, alphas_cols, *, train=True, **kw):
    """The epilogue's plain two-pass reference in the place of the kernels
    (a measurement-only swap), with the biased batch stats that
    GroupedMixedOp advances its running stats with in train mode."""
    out = ge.group_epilogue_reference(xs, scales, biases, alphas_cols, train=train, **kw)
    if not train:
        return out, (None, None)
    with torch.no_grad():
        mu = torch.stack([x.float().mean(dim=(0, 2, 3)) for x in xs])
        var = torch.stack([x.float().var(dim=(0, 2, 3), unbiased=False) for x in xs])
    return out, (mu, var)


@contextlib.contextmanager
def twins_swapped():
    """Within it the epilogue's Function calls the kernels' plain twins in
    their place: the same glue, only the sums and streams in PyTorch."""
    names = [name for name, _ in _TIMED]
    kernels = {name: getattr(ge, name) for name in names}
    for name in names:
        setattr(ge, name, getattr(ge, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(ge, name, fn)


@contextlib.contextmanager
def plain_epilogue_swapped():
    """Within it GroupedMixedOp runs `plain_epilogue`."""
    from senas_torch.search import fused_cell
    kernel_fn = fused_cell.fused_group_epilogue
    fused_cell.fused_group_epilogue = plain_epilogue
    try:
        yield
    finally:
        fused_cell.fused_group_epilogue = kernel_fn


def in_turns(fn, label: str, reps: int) -> dict:
    """Host-clock ms per call of fn() with the kernels and with the plain
    epilogue, in turns k, p, p, k."""
    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    times = {"kernels": [], "plain": []}
    for mode in ("kernels", "plain", "plain", "kernels"):
        if mode == "plain":
            with plain_epilogue_swapped():
                times[mode].append(timed())
        else:
            times[mode].append(timed())
    log(f"{label} ms, kernels vs plain epilogue (in turns k,p,p,k): "
        f"kernels {[round(t, 3) for t in times['kernels']]}, "
        f"plain {[round(t, 3) for t in times['plain']]}")
    return times


# ---------------------------------------------------------------------------
# Phase 5: the eval path
# ---------------------------------------------------------------------------

def expected_launches(model, suffix: str = "") -> dict:
    """Launches per forward and per backward, from the model: every
    GroupedMixedOp applies its mix; in eval mode only the groups with an SE
    branch (DOWN, UP) need the stats sweep. A backward runs bwd_reduce for
    every group and bwd_dx for every group whose branch tensors need a
    gradient: all of them, since every branch comes out of a convolution,
    pooling or resampling of a tensor that depends on the weights. The
    counts land on the variants named `<kernel><suffix>` (BF16_SUFFIX for a
    bf16 model); every other variant expects 0."""
    groups = [m for m in model.modules() if isinstance(m, GroupedMixedOp)]
    with_se = sum("se_conv_3" in g.ops for g in groups)
    zero = {name: 0 for name in KERNELS}
    g = len(groups)
    return {"train": {**zero, "branch_stats" + suffix: g, "apply_mix" + suffix: g},
            "eval": {**zero, "branch_stats" + suffix: with_se, "apply_mix" + suffix: g},
            "backward": {**zero, "bwd_reduce" + suffix: g, "bwd_dx" + suffix: g}}


def per_step(expect: dict, do_arch: bool, remat: bool = False) -> dict:
    """A search step: one train-mode forward and backward, two with do_arch;
    with remat each backward runs every cell's forward once more."""
    k, forwards = (2 if do_arch else 1), (2 if remat else 1)
    return {name: k * (forwards * expect["train"][name] + expect["backward"][name])
            for name in KERNELS}


def _supernet(s, dev, gen, dtype=None, remat=False):
    return SenasSearch(IN_CHANNELS, s["init_channels"], NCLASS, s["depth"], s["meta_node_num"],
                       double_down_channel=s["double_down_channel"],
                       supervision=s["deep_supervision"], dtype=dtype, remat=remat, device=dev,
                       generator=gen)


def _batches(rng, n, bs, hw, dev):
    out = []
    for _ in range(n):
        img = rng.randn(bs, hw, hw, IN_CHANNELS).astype(np.float32)
        label = (rng.rand(bs, hw, hw) > 0.7).astype(np.int64)
        out.append({"image": torch.from_numpy(img).to(dev),
                    "label": torch.from_numpy(label).to(dev)})
    return out


def run_eval_path(dev, seed: int, n_batches: int = N_BATCHES) -> dict:
    s = load_config(CONFIG)["searching"]
    meta, depth, bs = s["meta_node_num"], s["depth"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed)
    model = _supernet(s, dev, gen)
    arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"],
                            generator=gen, device=dev)
    normalize = lambda a: normalize_arch(a, meta)
    step = make_search_eval_step(model, normalize, build_loss(s["loss"]["name"],
                                                              s["deep_supervision"]))
    expect = expected_launches(model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"supernet: init_channels {s['init_channels']} depth {depth} meta {meta} "
        f"batch {bs} {HW}x{HW}x{IN_CHANNELS}, {n_params} parameters, "
        f"expected launches {expect}")
    batches = _batches(np.random.RandomState(seed), n_batches, bs, HW, dev)

    reset_counts()
    total = {name: 0 for name in KERNELS}
    # a train-mode forward first, so that the running stats are the batch's
    with torch.no_grad():
        out = model(batches[0]["image"], normalize(arch), train=True)
    torch.cuda.synchronize()
    got = counts()
    log(f"train-mode forward launches {got}")
    check(got == expect["train"], f"train forward launched {got}, expected {expect['train']}")
    check(bool(torch.isfinite(out[0]).all()), "train forward gave non-finite logits")
    add_counts(total, got)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, batch in enumerate(batches):
        reset_counts()
        t0 = time.perf_counter()
        m = step(arch, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(got == expect["eval"], f"eval batch {i} launched {got}, expected {expect['eval']}")
        add_counts(total, got)
        tp, fp, fn = (m[k].cpu().numpy() for k in ("tp", "fp", "fn"))
        positives = int((batch["label"] == 1).sum())
        check(np.isfinite(float(m["loss"])) and tp[0] + fn[0] == positives,
              f"eval batch {i}: loss {float(m['loss'])}, tp+fn {tp[0] + fn[0]} "
              f"for {positives} positive pixels")
        log(f"eval batch {i}: loss {float(m['loss']):.6f} tp {tp} fp {fp} fn {fn} "
            f"acc {float(m['acc']):.6f} launches {got} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    steady = times[1:] or times
    log(f"eval step: {np.mean(steady):.2f} ms/batch of {bs} (batches after the first; "
        f"all: {[round(t, 2) for t in times]}), peak memory {peak / 2**20:.1f} MiB")

    # hold the card to the plain CPU path: eval-mode BN is per sample, so the
    # first 2 images alone give the same logits as in the batch of 8
    state = model.state_dict()
    with torch.inference_mode():
        card = model(batches[0]["image"], normalize(arch), train=False)[0][:2].cpu()
    cpu_model = _supernet(s, "cpu", None)
    cpu_model.load_state_dict({k: v.cpu() for k, v in state.items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_model(batches[0]["image"][:2].cpu(),
                        normalize({k: v.cpu() for k, v in arch.items()}), train=False)[0]
    cpu_s = time.perf_counter() - t0
    check(card.shape == ref.shape == (2, HW, HW, NCLASS),
          f"logits {tuple(card.shape)} (card), {tuple(ref.shape)} (CPU)")
    check(bool(torch.isfinite(card).all() and torch.isfinite(ref).all()),
          "non-finite logits")
    abs_err = (card - ref).abs().max().item()
    rel = ((card - ref).abs() / (ref.abs() + 1e-3)).max().item()
    scale = ref.abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"card vs CPU plain path (2 images): max |logit| {scale:.4g}, max abs err "
        f"{abs_err:.3g}, max rel err {rel:.3g}, argmax agreement {agree:.6f} "
        f"(CPU forward {cpu_s:.1f} s)")
    torch.testing.assert_close(card, ref, rtol=1e-3, atol=1e-3)
    check(agree >= 0.999, f"argmax agreement {agree:.6f} < 0.999")

    prof = profile(lambda: step(arch, batches[-1]), f"one eval step, batch {bs}")
    turns = in_turns(lambda: step(arch, batches[-1]), "eval step", reps=5)

    geno = derive_genotype(arch, meta, depth)
    log(f"genotype: {geno!r}")
    return dict(launches=total, expect=expect, eval_ms=float(np.mean(steady)),
                peak_mib=peak / 2**20, cpu_abs_err=abs_err, argmax_agreement=agree,
                profile=prof, turns=turns)


# ---------------------------------------------------------------------------
# Phase 6: the search path
# ---------------------------------------------------------------------------

def _snapshot(state: SearchTrainState) -> dict:
    return {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "arch": {k: v.detach().clone() for k, v in state.arch.items()},
            "w_opt": copy.deepcopy(state.w_opt.state_dict()),
            "a_opt": copy.deepcopy(state.a_opt.state_dict()), "step": state.step}


def _restore(state: SearchTrainState, snap: dict) -> None:
    state.model.load_state_dict(snap["model"])
    with torch.no_grad():
        for k, t in state.arch.items():
            t.copy_(snap["arch"][k])
    state.w_opt.load_state_dict(copy.deepcopy(snap["w_opt"]))
    state.a_opt.load_state_dict(copy.deepcopy(snap["a_opt"]))
    state.step = snap["step"]


def _update_rel(before: dict, a: dict, b: dict, keys) -> float:
    """||(a - before) - (b - before)|| / ||b - before|| over `keys`."""
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in keys)
    den = sum(float(((b[k] - before[k]).double() ** 2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def _leaf_rel(before: dict, a: dict, b: dict, top: int) -> list:
    """The `top` leaves (weights and arch tables) that carry most of the
    squared difference of two updates: (name, share of it, the leaf's own
    relative update difference, the leaf's share of the update's norm²)."""
    rows, num_all, den_all = [], 0.0, 0.0
    for part in ("model", "arch"):
        for k in b[part]:
            if part == "model" and k.rsplit(".", 1)[-1] in ("mean", "var"):
                continue
            upd = (b[part][k] - before[part][k]).double()
            num = float(((a[part][k] - b[part][k]).double() ** 2).sum())
            den = float((upd ** 2).sum())
            rows.append((f"{part}:{k}", num, den))
            num_all, den_all = num_all + num, den_all + den
    rows.sort(key=lambda r: -r[1])
    return [(k, num / max(num_all, 1e-300), (num / max(den, 1e-300)) ** 0.5,
             den / max(den_all, 1e-300)) for k, num, den in rows[:top]]


def _state_rel(before: dict, a: dict, b: dict) -> dict:
    """How far two runs of a step from `before` moved the state apart: the
    relative difference of the updates of the weights and of the arch
    tables, and the largest difference of a BN running stat, relative to
    the largest magnitude of its vector (at least 1)."""
    params = [k for k in b["model"] if k.rsplit(".", 1)[-1] not in ("mean", "var")]
    stats = [k for k in b["model"] if k not in params]
    return dict(
        weights=_update_rel(before["model"], a["model"], b["model"], params),
        arch=_update_rel(before["arch"], a["arch"], b["arch"], list(b["arch"])),
        bn_stats=max((float((a["model"][k] - b["model"][k]).abs().max()
                            / b["model"][k].abs().max().clamp_min(1.0)) for k in stats),
                     default=0.0))


def _metrics_rel(a: dict, b: dict, keys=("loss", "arch_loss", "grad_norm")) -> dict:
    return {k: abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-30) for k in keys}


# Limits of the full-width step with the kernels against the same step with
# their plain twins or the plain epilogue, from one state, both under
# deterministic algorithms (`deterministic_algorithms`). The full-width
# backward amplifies a change of sum order (~1e-7) to ~1e-3 of every
# leaf's update, evenly: the twins and the plain epilogue read 1.2e-3 to
# 3.0e-3 (arch update) from the main path's state on an H100, the kernels'
# step run twice 0.9e-3 to 1.7e-3 with the default algorithms (the
# library's atomics). Compared from a state that deterministic steps
# reached, the distance is one number for a seed, and the kernels' step
# run twice must read exactly 0.
STEP_LIMITS = dict(metrics=1e-3, weights=5e-3, arch=5e-3, bn_stats=1e-5)


def run_search_path(dev, seed: int) -> dict:
    cfg = load_config(CONFIG)
    s = cfg["searching"]
    meta, depth, bs = s["meta_node_num"], s["depth"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed + 1)
    model = _supernet(s, dev, gen)
    arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"],
                            generator=gen, device=dev)
    state = SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])
    step = make_search_step(lambda a: normalize_arch(a, meta),
                            build_loss(s["loss"]["name"], s["deep_supervision"]),
                            grad_clip=s["grad_clip"])
    expect = expected_launches(model)
    rng = np.random.RandomState(seed + 1)
    pairs = [tuple(_batches(rng, 2, bs, HW, dev)) for _ in DO_ARCH]
    arch0 = {k: v.detach().clone() for k, v in arch.items()}
    initial = _snapshot(state)
    log(f"search step: batch {bs} train + {bs} val, {HW}x{HW}x{IN_CHANNELS}, SGD "
        f"{s['model_optimizer']} over weights and arch tables, Adam {s['arch_optimizer']}, "
        f"clip {s['grad_clip']}; expected launches per step: do_arch=False "
        f"{per_step(expect, False)}, do_arch=True {per_step(expect, True)}")

    torch.cuda.reset_peak_memory_stats()
    total = {name: 0 for name in KERNELS}
    read = {}   # the counters of the first step of each kind
    times = []
    for i, ((tb, vb), do_arch) in enumerate(zip(pairs, DO_ARCH)):
        reset_counts()
        t0 = time.perf_counter()
        m = step(state, tb, vb, do_arch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        want = per_step(expect, do_arch)
        check(got == want, f"search step {i} (do_arch={do_arch}) launched {got}, expected {want}")
        read.setdefault(str(do_arch), got)
        add_counts(total, got)
        vals = {k: float(m[k]) for k in ("loss", "arch_loss", "grad_norm", "acc")}
        check(all(np.isfinite(v) for v in vals.values()), f"search step {i}: {vals}")
        check((vals["arch_loss"] > 0) == do_arch, f"search step {i}: arch_loss {vals}")
        log(f"search step {i} do_arch={do_arch}: {vals} tp {m['tp'].cpu().numpy()} "
            f"launches {got} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    moved = max(float((arch[k].detach() - arch0[k]).abs().max()) for k in arch if arch[k].numel())
    check(moved > 0, "the arch tables did not move")
    steady = times[1:]
    log(f"search step: {np.mean(steady):.2f} ms/step (steps after the first: "
        f"{[round(t, 2) for t in steady]}; first {times[0]:.2f} ms), peak memory "
        f"{peak / 2**20:.1f} MiB, arch tables moved by up to {moved:.3g}")

    tb, vb = pairs[-1]
    prof = profile(lambda: step(state, tb, vb, True), f"one search step, do_arch, batch {bs}")

    # the same step from one saved state: with the kernels twice, with the
    # kernels' plain twins in the same Function (the order of the kernels'
    # sums alone), and with the plain two-pass epilogue (that and the
    # one-sweep variance); first with the default algorithms from the main
    # path's state (the card's spread from run to run, logged), then under
    # deterministic algorithms from the main path's steps replayed from
    # its initial state (held to STEP_LIMITS)
    before = _snapshot(state)
    variants = (("kernels", contextlib.nullcontext), ("kernels_again", contextlib.nullcontext),
                ("twins", twins_swapped), ("plain", plain_epilogue_swapped))

    def from_state(snap):
        out = {}
        for name, ctx in variants:
            _restore(state, snap)
            with ctx():
                m = step(state, tb, vb, True)
            out[name] = (m, _snapshot(state))
        return out

    def spread_of(runs, snap):
        m_k, after_k = runs["kernels"]
        return {name: (_metrics_rel(m_k, m), _state_rel(snap, after_k, after))
                for name, (m, after) in runs.items() if name != "kernels"}

    default = spread_of(from_state(before), before)
    with deterministic_algorithms():
        _restore(state, initial)
        for (b_t, b_v), do_arch in zip(pairs, DO_ARCH):
            step(state, b_t, b_v, do_arch)
        replayed = _snapshot(state)
        runs = from_state(replayed)
    spread = spread_of(runs, replayed)
    _restore(state, before)
    for label, rows in (("default algorithms, the main path's state", default),
                        ("deterministic algorithms, the replayed state", spread)):
        for name, (rm, rs) in rows.items():
            log(f"search step from one state ({label}), kernels vs {name}: metrics rel {rm}, "
                f"state {rs}")
    m_k, after_k = runs["kernels"]
    for name in ("twins", "plain"):
        log(f"  kernels vs {name} (deterministic), leaves that carry the weight and arch update "
            "difference (share of it, the leaf's own rel, the leaf's share of the update):")
        for k, share, rel, upd in _leaf_rel(replayed, after_k, runs[name][1], top=8):
            log(f"    {share:.3f}  rel {rel:.3g}  update share {upd:.3g}  {k}")
    rel_m, rel_s = spread["kernels_again"]
    check(not any(rel_m.values()) and not any(rel_s.values()),
          f"the kernels' step run twice under deterministic algorithms differs: {rel_m} {rel_s}")
    for name in ("twins", "plain"):
        rel_m, rel_s = spread[name]
        check(max(rel_m.values()) <= STEP_LIMITS["metrics"],
              f"the steps with the kernels and with {name} disagree: {rel_m}")
        check(all(rel_s[k] <= STEP_LIMITS[k] for k in ("weights", "arch", "bn_stats")),
              f"the steps with the kernels and with {name} moved the state apart: {rel_s}")
    turns = in_turns(lambda: step(state, tb, vb, True), "search step (do_arch)", reps=1)
    return dict(launches=total, per_step=read, step_ms=float(np.mean(steady)),
                peak_mib=peak / 2**20, profile=prof, turns=turns, spread=spread,
                default_spread=default)


# ---------------------------------------------------------------------------
# Phase 7: a search training step on the card against the CPU
# ---------------------------------------------------------------------------

# Limits of the card-vs-CPU steps, from their readings on an H100, with
# room on both sides: the same steps with TF32 on must fail them. The
# search step read loss, arch loss and grad norm within 2.7e-7, weight
# update 1.5e-5, arch update 1.2e-6, running stats 4.6e-7; the fixed step
# loss and grad norm within 6.9e-8, weight update 1.6e-5, running stats
# 1.7e-7 (with TF32 on: grad norm 2.7e-4, weight update 1.6e-2).
CARD_CPU_LIMITS = dict(metrics=1e-5, weights=1e-4, arch=1e-5, bn_stats=1e-5)


def _within(rel_m: dict, rel_s: dict) -> bool:
    return (max(rel_m.values()) <= CARD_CPU_LIMITS["metrics"]
            and all(rel_s[k] <= CARD_CPU_LIMITS[k] for k in ("weights", "arch", "bn_stats")))


def train_card_vs_cpu(dev, seed: int) -> dict:
    """One do_arch step from identical state on the CPU and on the card,
    with TF32 off (held to CARD_CPU_LIMITS) and once more with TF32 on (which
    the limits must catch)."""
    s = dict(load_config(CONFIG)["searching"], depth=3, init_channels=8)
    meta, depth, bs, hw = s["meta_node_num"], s["depth"], 2, 64
    gen = torch.Generator().manual_seed(seed + 2)
    model0 = _supernet(s, "cpu", gen).state_dict()
    arch0 = init_arch_params(meta, depth, use_sharing=False, generator=gen, device="cpu")
    tb, vb = _batches(np.random.RandomState(seed + 2), 2, bs, hw, "cpu")
    to_cpu = lambda snap: {k: ({kk: vv.cpu() for kk, vv in v.items()}
                               if k in ("model", "arch") else v) for k, v in snap.items()}

    def run_on(d):
        model = _supernet(s, d, None)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        arch = {k: v.clone().to(d) for k, v in arch0.items()}
        state = SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])
        step = make_search_step(lambda a: normalize_arch(a, meta),
                                build_loss(s["loss"]["name"]), grad_clip=s["grad_clip"])
        before = to_cpu(_snapshot(state))
        m = step(state, {k: v.to(d) for k, v in tb.items()},
                 {k: v.to(d) for k, v in vb.items()}, True)
        return before, {k: v.cpu() for k, v in m.items()}, to_cpu(_snapshot(state))

    before, m_cpu, after_cpu = run_on("cpu")
    _, m_card, after_card = run_on(dev)
    rel_m, rel_s = _metrics_rel(m_card, m_cpu), _state_rel(before, after_card, after_cpu)
    log(f"training step card vs CPU (depth {depth}, c {s['init_channels']}, {hw}x{hw}, "
        f"batch {bs}, do_arch): metrics {({k: float(v) for k, v in m_card.items() if v.numel() == 1})} "
        f"rel {rel_m}, state {rel_s} (limits {CARD_CPU_LIMITS})")
    check(_within(rel_m, rel_s), f"card and CPU steps disagree: metrics {rel_m}, state {rel_s}")

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, m_tf32, after_tf32 = run_on(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    tf32_m, tf32_s = _metrics_rel(m_tf32, m_cpu), _state_rel(before, after_tf32, after_cpu)
    log(f"the same step with TF32 on, card vs CPU: metrics rel {tf32_m}, state {tf32_s}")
    check(not _within(tf32_m, tf32_s), "the card-vs-CPU limits let a step with TF32 on pass")
    return dict(metrics=rel_m, state=rel_s, tf32=dict(metrics=tf32_m, state=tf32_s))


# ---------------------------------------------------------------------------
# Phase 8: the search runner and its resume
# ---------------------------------------------------------------------------

def _run_dir(stdout: str) -> str:
    return stdout.split("run dir: ")[1].splitlines()[0].strip()


def _val_epochs(run_dir: str) -> list:
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if r["tag"] == "Val/dice"]


def run_runner() -> dict:
    cfg = load_config(RUNNER_CONFIG)
    epochs = cfg["searching"]["epoch"]
    with tempfile.TemporaryDirectory() as log_root:
        first = _in_process(search_arc.main, "--config", RUNNER_CONFIG, "--log_root", log_root)
        run_dir = _run_dir(first)
        check(_val_epochs(run_dir) == list(range(epochs)),
              f"runner ran epochs {_val_epochs(run_dir)}, expected {epochs}")
        best = parse_genotype(first.split("best genotype: ")[1].strip())
        # the same config with `searching.resume` naming the checkpoint
        cfg["searching"].update(resume=os.path.join(run_dir, "ckpt"), epoch=epochs + 1)
        cfg["searching"]["arch_optimizer"]["betas"] = list(
            cfg["searching"]["arch_optimizer"]["betas"])
        resume_config = os.path.join(log_root, "resume.yml")
        with open(resume_config, "w") as f:
            yaml.safe_dump(cfg, f)
        resumed = _in_process(search_arc.main, "--config", resume_config, "--log_root",
                              os.path.join(log_root, "resumed"))
        check(f"at epoch {epochs}" in resumed, "the resumed run did not start at the "
              f"checkpoint's epoch {epochs}")
        run_dir2 = _run_dir(resumed)
        check(_val_epochs(run_dir2) == [epochs],
              f"the resumed run ran epochs {_val_epochs(run_dir2)}, expected [{epochs}]")
        log(f"runner: {epochs} epochs then 1 resumed; genotype {best!r}")
    return dict(epochs=epochs, resumed_epochs=1)


# ---------------------------------------------------------------------------
# Phase 9: the fixed model's train and eval steps at full width
# ---------------------------------------------------------------------------

FIXED_STEPS = 4      # 1 + 3 train steps
# the fixed model's logits on the card against the CPU path (phase 9; the
# serving artifact loaded on the CPU is held to it in phase 12)
CARD_CPU_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def _fixed_model(t, dev, gen, dtype=None, remat=False):
    return SenasModel(NCLASS, IN_CHANNELS, c=t["init_channels"], depth=t["depth"],
                      supervision=t["deep_supervision"],
                      genotype=getattr(geno_searched, t["geno_type"]),
                      double_down_channel=t["double_down_channel"], dtype=dtype, remat=remat,
                      device=dev, generator=gen)


def _fixed_loss(t):
    return build_loss(t["loss"]["name"], t["deep_supervision"])


def run_fixed_path(dev, seed: int) -> dict:
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed + 3))
    state = FixedTrainState.create(model, t["model_optimizer"])
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    evaluate = make_eval_step(model, _fixed_loss(t))
    rng = np.random.RandomState(seed + 3)
    train_batches = _batches(rng, FIXED_STEPS, bs, HW, dev)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"fixed model: {t['geno_type']} init_channels {t['init_channels']} depth "
        f"{t['depth']}, {n_params} parameters; batch {bs} {HW}x{HW}x{IN_CHANNELS}, SGD "
        f"{t['model_optimizer']}, clip {t['grad_clip']}, {t['loss']['name']}")

    reset_counts()
    total = {name: 0 for name in KERNELS}
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, batch in enumerate(train_batches):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(m[k]) for k in ("loss", "grad_norm", "acc")}
        check(all(np.isfinite(v) for v in vals.values()), f"fixed train step {i}: {vals}")
        log(f"fixed train step {i}: {vals} tp {m['tp'].cpu().numpy()} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    steady = times[1:]
    log(f"fixed train step: {np.mean(steady):.2f} ms/step (steps after the first: "
        f"{[round(x, 2) for x in steady]}; first {times[0]:.2f} ms), peak memory "
        f"{peak / 2**20:.1f} MiB")
    add_counts(total, counts())

    reset_counts()
    eval_times = []
    for i, batch in enumerate(eval_batches):
        t0 = time.perf_counter()
        m = evaluate(batch)
        torch.cuda.synchronize()
        eval_times.append((time.perf_counter() - t0) * 1e3)
        pred, label = m["pred"], batch["label"]
        check(pred.dtype == torch.uint8 and tuple(pred.shape) == (bs, HW, HW),
              f"eval pred is {pred.dtype} {tuple(pred.shape)}")
        tp = int(((pred == 1) & (label == 1)).sum())
        check(np.isfinite(float(m["loss"])) and tp == int(m["tp"][0])
              and int(m["tp"][0] + m["fn"][0]) == int((label == 1).sum()),
              f"eval batch {i}: loss {float(m['loss'])}, tp {m['tp']} (pred gives {tp})")
        log(f"fixed eval batch {i}: loss {float(m['loss']):.6f} tp {m['tp'].cpu().numpy()} "
            f"fp {m['fp'].cpu().numpy()} fn {m['fn'].cpu().numpy()} {eval_times[-1]:.2f} ms")
    add_counts(total, counts())
    # the fixed model has no GroupedMixedOp and does not call K2
    check(not any(total.values()), f"the fixed path launched {total}")

    # the card's logits against the CPU path on 2 images (eval-mode BN is
    # per sample), within CARD_CPU_LOGIT_TOL
    with torch.inference_mode():
        card = model(eval_batches[0]["image"][:2], train=False)[0].cpu()
    cpu_model = _fixed_model(t, "cpu", None)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        ref = cpu_model(eval_batches[0]["image"][:2].cpu(), train=False)[0]
    abs_err = (card - ref).abs().max().item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"fixed model card vs CPU (2 images): max |logit| {ref.abs().max().item():.4g}, "
        f"max abs err {abs_err:.3g}, argmax agreement {agree:.6f}")
    check(bool(torch.isfinite(card).all()), "non-finite fixed-model logits")
    torch.testing.assert_close(card, ref, **CARD_CPU_LOGIT_TOL)
    check(agree >= 0.999, f"argmax agreement {agree:.6f} < 0.999")

    prof = profile(lambda: step(state, train_batches[-1]), f"one fixed train step, batch {bs}")
    return dict(launches=total, step_ms=float(np.mean(steady)), first_ms=times[0],
                eval_ms=float(np.mean(eval_times[1:])), peak_mib=peak / 2**20,
                cpu_abs_err=abs_err, argmax_agreement=agree, profile=prof, state=state)


# ---------------------------------------------------------------------------
# Phase 10: a fixed training step on the card against the CPU
# ---------------------------------------------------------------------------

def fixed_card_vs_cpu(dev, seed: int) -> dict:
    """`fixed_step_card_vs_cpu` with TF32 off (held to CARD_CPU_LIMITS) and
    once more with TF32 on (which the limits must catch)."""
    rel_m, rel_s = fixed_step_card_vs_cpu(dev, seed)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_m, tf32_s = fixed_step_card_vs_cpu(dev, seed)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    log(f"fixed training step card vs CPU (depth 3, c 8, 64x64, batch 2): metrics rel "
        f"{rel_m}, state {rel_s}; with TF32 on: metrics rel {tf32_m}, state {tf32_s} "
        f"(limits {CARD_CPU_LIMITS})")
    check(_within(rel_m, rel_s),
          f"card and CPU fixed steps disagree: metrics {rel_m}, state {rel_s}")
    check(not _within(tf32_m, tf32_s),
          "the fixed card-vs-CPU limits let a step with TF32 on pass")
    return dict(metrics=rel_m, state=rel_s, tf32=dict(metrics=tf32_m, state=tf32_s))


def fixed_step_card_vs_cpu(dev, seed: int, **training) -> tuple:
    """One fixed train step (depth 3, c 8, 64x64, batch 2, the `training:`
    section updated by `training`) from identical state on the CPU and on
    the card: (metrics rel, state rel)."""
    t = dict(load_config(CONFIG)["training"], depth=3, init_channels=8, **training)
    batch = _batches(np.random.RandomState(seed + 5), 1, 2, 64, "cpu")[0]
    rel_m, rel_s, _ = _step_card_vs_cpu(
        lambda d: _fixed_model(t, d, torch.Generator().manual_seed(seed + 5)), batch, t, dev)
    return rel_m, rel_s


# ---------------------------------------------------------------------------
# Phase 11: the fixed CLIs
# ---------------------------------------------------------------------------

def run_fixed_clis() -> dict:
    """train_model (one epoch of the synthetic config: 8 steps) with
    SENAS_TRACE_DIR set, which must write one torch.profiler trace (steps
    [5, 8)); testing_model on its best checkpoint."""
    cfg = load_config(RUNNER_CONFIG)
    epochs = 1
    with tempfile.TemporaryDirectory() as log_root:
        trace_dir = os.path.join(log_root, "trace")
        os.environ["SENAS_TRACE_DIR"] = trace_dir
        try:
            out = _in_process(train_model.main, "--config", RUNNER_CONFIG, "--epoch",
                              str(epochs), "--log_root", log_root)
        finally:
            del os.environ["SENAS_TRACE_DIR"]
        traces = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
        check(len(traces) == 1, f"train_model with SENAS_TRACE_DIR wrote {traces}, not one trace")
        trace_bytes = os.path.getsize(os.path.join(trace_dir, traces[0]))
        with open(os.path.join(trace_dir, traces[0])) as f:
            trace_events = len(json.load(f)["traceEvents"])
        log(f"SENAS_TRACE_DIR: one trace of steps [5, 8), {traces[0]}, {trace_bytes} bytes, "
            f"{trace_events} events")
        run_dir = _run_dir(out)
        best = ast.literal_eval(out.split("best: ")[1].splitlines()[0])
        check(_val_epochs(run_dir) == list(range(epochs)),
              f"train_model ran epochs {_val_epochs(run_dir)}, expected {epochs}")
        grids = [f for f in os.listdir(run_dir) if f.startswith("Val_images_")]
        check(len(grids) == epochs and os.path.exists(os.path.join(run_dir, "ckpt", "best.pt")),
              f"train_model wrote {grids} and no best checkpoint")
        # at the training run's batch, so that cuDNN takes the same algorithms
        out = _in_process(testing_model.main, "--config", RUNNER_CONFIG, "--resume",
                          os.path.join(run_dir, "ckpt"), "--log_root", log_root,
                          "--batch_size", str(cfg["training"]["batch_size"]))
        result = ast.literal_eval(out.strip().splitlines()[-1])
        image_dir = os.path.join(_run_dir(out), "images")
        pngs = sorted(os.listdir(image_dir))
        for name in pngs:
            with open(os.path.join(image_dir, name), "rb") as f:
                check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name} is not a PNG")
        # eval-mode BN is per sample, so the best epoch's val dice comes back;
        # a batch of 6 against the run's 4 gave 90.298 against 90.301 on an
        # H100 (other cuDNN algorithms flip a pixel or two), hence 0.01 points
        check(abs(result["dice"] - best["best_dice"]) <= 0.01,
              f"testing_model dice {result['dice']} on the best checkpoint, the run's best "
              f"{best['best_dice']}")
        log(f"fixed CLIs: {epochs} epochs, best {best}; testing_model {result}, "
            f"{len(pngs)} PNGs")
    return dict(epochs=epochs, best=best, test=result, pngs=len(pngs),
                trace=dict(file=traces[0], bytes=trace_bytes, events=trace_events))


# ---------------------------------------------------------------------------
# Phase 12: serving the trained fixed model from an exported artifact
# ---------------------------------------------------------------------------

SERVE_BATCHES = (1, 3, 12)
# the artifact against the eager model on the card, both in f32
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
# the TF32 control: a backend-default artifact run with TF32 on must stray
# from the CPU at least this many times further than the --f32 one does
TF32_CONTROL_FACTOR = 10.0


@contextlib.contextmanager
def deterministic_algorithms(warn_only: bool = False):
    """PyTorch's deterministic algorithms inside (cuDNN's and cuBLAS's among
    them; an op that has none raises, or with `warn_only` warns and runs
    its own), the process's choice restored. cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG, which `main` sets."""
    kept = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(kept[0], warn_only=kept[1])
        torch.backends.cudnn.deterministic = kept[2]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, the process's choice restored."""
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = kept


REPEAT_CALLS = 8


def call_to_call(pred, x) -> dict:
    """REPEAT_CALLS calls of the served program on one input, with cuDNN's
    default algorithms and with its deterministic ones: the largest logit
    difference from the first call, the mask pixels that differ from its
    argmax, and the largest gap between the two best logits at such a
    pixel. The default algorithms may sum in a different order each call
    (e.g. with atomics), which the deterministic ones do not."""
    out = {}
    for name, ctx in (("default", contextlib.nullcontext), ("deterministic", deterministic_cudnn)):
        with ctx():
            first = pred.logits(x)
            rest = [pred.logits(x) for _ in range(REPEAT_CALLS - 1)]
        top2 = first.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        flipped = torch.zeros_like(gap, dtype=torch.bool)
        for r in rest:
            flipped |= r.argmax(-1) != first.argmax(-1)
        out[name] = dict(max_abs=max((r - first).abs().max().item() for r in rest),
                         flipped=int(flipped.sum()),
                         max_gap_flipped=gap[flipped].max().item() if flipped.any() else None)
    log(f"call to call ({REPEAT_CALLS} calls at batch {len(x)}, against the first): {out}")
    return out


def _request_ms(pred, x, reps: int = 20, warmup: int = 3) -> dict:
    """Host-clock ms per request (numpy in, logits on the card), each one
    ended by a synchronise: warm-up, then `reps` timed."""
    for _ in range(warmup):
        pred.logits(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred.logits(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(mean=float(np.mean(times)), p50=float(np.median(times)),
                min=float(np.min(times)), max=float(np.max(times)))


def run_serve_path(dev, fixed: dict, seed: int, work: str) -> dict:
    """Phase 9's trained model saved, exported by the CLI (--check --f32),
    served by a Predictor on the card, the CPU and two replicas, timed; the
    TF32 control. Returns the Predictor on the card with the numbers."""
    state = fixed["state"]
    model = state.model
    reset_counts()
    ckpt = CheckpointManager(os.path.join(work, "ckpt"))
    ckpt.save(state, {"epoch": 1, "model_name": "senas"}, is_best=True)
    art = os.path.join(work, "artifact")
    t0 = time.perf_counter()
    out = _in_process(export_model.main, "--config", CONFIG, "--resume", ckpt.directory,
                      "--out", art, "--check", "--f32")
    cli_s = time.perf_counter() - t0
    check("check OK" in out, "export_model --check did not pass")
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    size_mb = os.path.getsize(os.path.join(art, "model.pt2")) / 1e6
    check(meta["matmul_precision"] == "float32" and meta["input_hw"] == [HW, HW],
          f"artifact meta {meta}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = Predictor(art, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x_all = np.random.RandomState(seed + 6).randn(12, HW, HW, IN_CHANNELS).astype(np.float32)
    errs = {}
    for b in SERVE_BATCHES:
        x = x_all[:b]
        # the masks are the argmax of the logits, exactly: the two calls run
        # cuDNN's deterministic algorithms, so that they compute the same bits
        with deterministic_cudnn():
            got = pred.logits(x)
            masks = pred.predict_masks(x)
        with torch.inference_mode():
            want = model(torch.from_numpy(x).to(dev), train=False)[-1]
        check(tuple(got.shape) == (b, HW, HW, NCLASS) and got.device == want.device,
              f"served logits {tuple(got.shape)} on {got.device}")
        errs[b] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **SERVE_TOL)
        check(masks.dtype == np.uint8 and masks.shape == (b, HW, HW)
              and np.array_equal(masks, got.argmax(-1).to(torch.uint8).cpu().numpy()),
              f"masks at batch {b}: {masks.dtype} {masks.shape}, or not the argmax")
    log(f"served vs eager on the card (batches {SERVE_BATCHES}; the program's batch range "
        f"{pred.batch_range}, a smaller request is zero-padded): max abs err {errs} "
        f"(limit {SERVE_TOL})")
    repeat = call_to_call(pred, x_all)
    check(repeat["deterministic"]["max_abs"] == 0,
          f"two calls with deterministic cuDNN differ: {repeat['deterministic']}")

    torch.cuda.reset_peak_memory_stats()
    ms = {b: _request_ms(pred, x_all[:b]) for b in (1, 12)}
    peak = torch.cuda.max_memory_allocated()
    images_s = 12 / (ms[12]["mean"] / 1e3)
    prof = {b: profile(lambda: pred.logits(x_all[:b]), f"one served request, batch {b}")
            for b in (1, 12)}
    log(f"serving: batch 1 {ms[1]['mean']:.3f} ms/request (p50 {ms[1]['p50']:.3f}), batch 12 "
        f"{ms[12]['mean']:.3f} ms/request (p50 {ms[12]['p50']:.3f}), {images_s:.1f} images/s; "
        f"export {meta['export_seconds']:.2f} s (CLI with its check {cli_s:.1f} s), artifact "
        f"{size_mb:.2f} MB, load {load_s:.2f} s, peak memory {peak / 2**20:.1f} MiB")

    # the same artifact on the CPU, held to phase 9's card-vs-CPU limit
    t0 = time.perf_counter()
    cpu_pred = Predictor(art, device="cpu")
    cpu_load_s = time.perf_counter() - t0
    x2 = x_all[:2]
    cpu = cpu_pred.logits(x2)
    card = pred.logits(x2).cpu()
    cpu_err = (card - cpu).abs().max().item()
    torch.testing.assert_close(card, cpu, **CARD_CPU_LOGIT_TOL)

    # two replicas on the one card, at batch 5 (padded to 6, split 3 + 3)
    dp = Predictor(art, data_parallel=True, devices=[dev, dev])
    x5 = x_all[:5]
    with deterministic_cudnn():
        got = dp.logits(x5)
        dp_masks = dp.predict_masks(x5)
    padded = np.concatenate([x5, np.zeros((1,) + x5.shape[1:], np.float32)])
    halves = torch.cat([pred.logits(padded[:3]), pred.logits(padded[3:])])[:5]
    dp_err = dict(halves=(got - halves).abs().max().item(),
                  single=(got - pred.logits(x5)).abs().max().item())
    torch.testing.assert_close(got, halves, **SERVE_TOL)
    torch.testing.assert_close(got, pred.logits(x5), **SERVE_TOL)
    check(np.array_equal(dp_masks, got.argmax(-1).to(torch.uint8).cpu().numpy()),
          "data-parallel masks are not the argmax")
    log(f"served on the CPU (load {cpu_load_s:.2f} s): card vs CPU max abs err {cpu_err:.3g} "
        f"(limit {CARD_CPU_LOGIT_TOL}); two replicas at batch 5 vs their halves / vs the "
        f"single Predictor: {dp_err}")

    # the TF32 control: the process's TF32 on; a backend-default artifact
    # keeps it, the --f32 one turns it off around each call
    default_art = os.path.join(work, "artifact_default")
    save_artifact(export_predict_fn(model, (HW, HW, IN_CHANNELS)), {}, default_art)
    default_pred = Predictor(default_art, device=dev)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_err = (default_pred.logits(x2).cpu() - cpu).abs().max().item()
        f32_err = (pred.logits(x2).cpu() - cpu).abs().max().item()
        kept = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    log(f"TF32 control, the process's TF32 on: backend-default artifact vs CPU {tf32_err:.3g}, "
        f"--f32 artifact vs CPU {f32_err:.3g} (ratio {tf32_err / max(f32_err, 1e-30):.3g}, "
        f"must be > {TF32_CONTROL_FACTOR})")
    check(kept == (True, True), f"the --f32 Predictor did not restore the TF32 flags: {kept}")
    check(f32_err <= CARD_CPU_LOGIT_TOL["atol"], f"--f32 artifact with TF32 on: {f32_err:.3g}")
    check(tf32_err > TF32_CONTROL_FACTOR * f32_err,
          f"the TF32 control did not stray: {tf32_err:.3g} against {f32_err:.3g}")

    got_counts = counts()
    check(not any(got_counts.values()), f"the serve path launched {got_counts}")
    return dict(pred=pred, launches=got_counts, ms=ms, images_per_s=images_s,
                export_s=meta["export_seconds"], export_cli_s=cli_s, artifact_mb=size_mb,
                load_s=load_s, cpu_load_s=cpu_load_s, peak_mib=peak / 2**20, errs=errs,
                profile=prof, batch_range=pred.batch_range,
                cpu_err=cpu_err, dp_err=dp_err, tf32_control=dict(tf32=tf32_err, f32=f32_err),
                call_to_call=repeat)


# ---------------------------------------------------------------------------
# Phase 13: the PROMISE12 submission path
# ---------------------------------------------------------------------------

# native case geometry (slices, rows, cols): 320x320 as many PROMISE12 MR
# volumes are, and one narrower; non-unit spacing
SUBMISSION_CASES = ((14, 320, 320), (12, 320, 288), (18, 320, 320))


def _write_cases(case_dir: str, rng) -> list:
    """Case volumes (int16 MR-like intensities) and their segmentations
    (uint8 ellipsoids), written with the port's write_mhd."""
    os.makedirs(case_dir, exist_ok=True)
    paths = []
    for i, (n, h, w) in enumerate(SUBMISSION_CASES):
        zz, yy, xx = np.mgrid[0:n, 0:h, 0:w]
        seg = (((yy - h / 2) / (h / 5)) ** 2 + ((xx - w / 2) / (w / 6)) ** 2
               + ((zz - n / 2) / (n / 3)) ** 2 < 1).astype(np.uint8)
        vol = (400.0 * seg + 100 + 60 * rng.randn(n, h, w)).astype(np.int16)
        geometry = dict(spacing=(0.625, 0.625, 3.6 - 0.4 * i), origin=(-100.0 + i, -80.5, 12.25),
                        direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
        path = os.path.join(case_dir, f"Case{i:02d}.mhd")
        write_mhd(path, MetaImage(vol, **geometry))
        write_mhd(os.path.join(case_dir, f"Case{i:02d}_segmentation.mhd"),
                  MetaImage(seg, **geometry))
        paths.append(path)
    return paths


def _case_slices(paths) -> np.ndarray:
    """Each case's slices, z-scored per volume and resized to HW x HW:
    [N, HW, HW, 1] f32 in case order."""
    out = []
    for path in paths:
        vol = read_mhd(path).array.astype(np.float32)
        vol = (vol - vol.mean()) / vol.std()
        out.append(F.interpolate(torch.from_numpy(vol)[:, None], size=(HW, HW),
                                 mode="bilinear", align_corners=False)[:, 0, ..., None].numpy())
    return np.concatenate(out)


class _SliceSet:
    """The case slices as a dataset for TestRunner's queue (labels unused)."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], np.zeros(self.images.shape[1:3], np.int32)


def _geometry_kept(written, sources) -> None:
    """Each written mask volume has its source's shape and geometry."""
    for w, src in zip(written, sources):
        back, source = read_mhd(w), read_mhd(src)
        check(back.array.shape == source.array.shape and back.array.dtype == np.uint8
              and back.origin == source.origin and back.spacing == source.spacing
              and back.direction == source.direction,
              f"{w}: {back.array.shape} {back.array.dtype} origin {back.origin} spacing "
              f"{back.spacing}, source {source.array.shape} {source.origin} {source.spacing}")


def run_submission(dev, pred, work: str, seed: int) -> dict:
    """Three cases at their native resolution, their slices predicted at
    HW x HW by the serving Predictor, stitched back with predict_test and
    scored with volumetric_metrics; then the same through
    TestRunner.run_promise12_submission on phase 9's checkpoint."""
    reset_counts()
    case_dir = os.path.join(work, "cases")
    paths = _write_cases(case_dir, np.random.RandomState(seed + 7))
    images = _case_slices(paths)
    t0 = time.perf_counter()
    slices = [m for start in range(0, len(images), 12)
              for m in pred.predict_masks(images[start:start + 12])]
    predict_s = time.perf_counter() - t0
    written = predict_test(slices, paths, dest=os.path.join(work, "predictions"))
    metrics = volumetric_metrics(slices, case_dir)
    _geometry_kept(written, paths)
    check(metrics["n_cases"] == len(SUBMISSION_CASES)
          and all(np.isfinite(v) for v in metrics.values()), f"metrics {metrics}")
    log(f"submission through the Predictor: {len(slices)} slices of {len(paths)} cases "
        f"{[c[1:] for c in SUBMISSION_CASES]} predicted at {HW}x{HW} in {predict_s:.2f} s, "
        f"{len(written)} volumes written with their source geometry; metrics {metrics}")

    # TestRunner on the card: the fixed `training:` geometry over the
    # synthetic data config (the promise12 loader is not ported: M9)
    cfg = load_config(RUNNER_CONFIG)
    cfg["training"] = load_config(CONFIG)["training"]
    runner = TestRunner(cfg, resume=os.path.join(work, "ckpt"), log_root=work,
                        batch_size=12, device=dev)
    written_r, metrics_r = runner.run_promise12_submission(
        case_dir, dest=os.path.join(work, "predictions_runner"),
        queue=DataLoader(_SliceSet(images), 12))
    _geometry_kept(written_r, paths)
    same = np.mean([float((read_mhd(a).array == read_mhd(b).array).mean())
                    for a, b in zip(written, written_r)])
    log(f"submission through TestRunner on the card: {len(written_r)} volumes, metrics "
        f"{metrics_r}; voxels equal to the Predictor's {same:.6f}")
    check(metrics_r is not None and abs(metrics_r["mean_volumetric_dsc"]
                                        - metrics["mean_volumetric_dsc"]) <= 1e-3
          and same >= 0.999, f"TestRunner's submission differs: {metrics_r}, agreement {same}")
    got_counts = counts()
    check(not any(got_counts.values()), f"the submission path launched {got_counts}")
    return dict(launches=got_counts, metrics=metrics, runner_metrics=metrics_r,
                agreement=same, predict_s=predict_s, slices=len(slices))


# ---------------------------------------------------------------------------
# Phase 14: the PROMISE12 data path
# ---------------------------------------------------------------------------

# the phantom in PROMISE12's layout: training cases of 10-16 slices at 320 x
# 320 (case 05, the val split, among them) and test cases at 320 x 320 and
# 320 x 288, int16 volumes with uint8 masks, PROMISE12-like spacing
PHANTOM_TRAIN_CASES = 10
PHANTOM_TEST_SHAPES = ((12, 320, 320), (14, 320, 288))
LOADER_BATCHES = 4        # batches timed per loader setting
LIBRARIES = ("cv2", "PIL", "matplotlib", "scipy")


def libraries() -> dict:
    """Which of LIBRARIES import in this interpreter (the port needs only
    scipy; the JAX package's data path needs cv2)."""
    found = {}
    for name in LIBRARIES:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    log("libraries: " + ", ".join(f"{k} {'imports' if v else 'missing'}"
                                  for k, v in found.items()))
    return found


def _phantom_case(rng, n, h, w):
    """An MR-like int16 volume and its uint8 ellipsoid mask."""
    zz, yy, xx = np.mgrid[0:n, 0:h, 0:w]
    cy, cx = h * rng.uniform(0.4, 0.6), w * rng.uniform(0.4, 0.6)
    seg = (((yy - cy) / (h * rng.uniform(0.12, 0.2))) ** 2
           + ((xx - cx) / (w * rng.uniform(0.12, 0.2))) ** 2
           + ((zz - n / 2) / (n / 2.5)) ** 2 < 1).astype(np.uint8)
    shade = 300 + 80 * np.sin(yy / rng.uniform(20, 40)) * np.cos(xx / rng.uniform(20, 40))
    vol = np.clip(shade + 260.0 * seg + 45 * rng.randn(n, h, w), 0, 2000).astype(np.int16)
    return vol, seg


def write_phantom(root: str, rng) -> list:
    """PROMISE2012/TrainingData and TestData under `root`, written with the
    port's write_mhd. Returns the test volumes' paths in case order."""
    base = os.path.join(root, "PROMISE2012")
    for sub in ("TrainingData", "TestData"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for i in range(PHANTOM_TRAIN_CASES):
        vol, seg = _phantom_case(rng, int(rng.randint(10, 17)), 320, 320)
        geometry = dict(spacing=(0.625, 0.625, float(rng.uniform(2.2, 4.0))),
                        origin=(-100.0 + i, -90.0, 10.0 * i))
        path = os.path.join(base, "TrainingData", f"Case{i:02d}")
        write_mhd(path + ".mhd", MetaImage(vol, **geometry))
        write_mhd(path + "_segmentation.mhd", MetaImage(seg, **geometry))
    tests = []
    for i, (n, h, w) in enumerate(PHANTOM_TEST_SHAPES):
        vol, _ = _phantom_case(rng, n, h, w)
        path = os.path.join(base, "TestData", f"Case{i:02d}.mhd")
        write_mhd(path, MetaImage(vol, spacing=(0.6 + 0.05 * i, 0.625, 3.6),
                                  origin=(-80.5, 12.25 - i, 3.0),
                                  direction=(1, 0, 0, 0, -1, 0, 0, 0, 1)))
        tests.append(path)
    return tests


@contextlib.contextmanager
def _timed(module, name: str, seconds: dict):
    """module.name timed into seconds[name] (and its calls counted) while
    the block runs."""
    fn = getattr(module, name)
    seconds.setdefault(name, 0.0)
    seconds.setdefault(name + "_calls", 0)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] += time.perf_counter() - t0
            seconds[name + "_calls"] += 1

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def build_promise12_cache(root: str) -> dict:
    """The cache built through get_dataset, its time split into CLAHE,
    resize and curvature flow; the native curvature flow must have run, and
    agree with its numpy twin exactly on 3 slices."""
    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    split: dict = {}
    t0 = time.perf_counter()
    with _timed(augment, "equalize_adapthist", split), \
            _timed(imgproc, "resize_nearest", split), \
            _timed(native, "curvature_flow", split):
        trainset = get_dataset("promise12", path=root, mode="train")
    wall = time.perf_counter() - t0
    store = os.path.join(root, "PROMISE2012", f"npy_image_{HW}")
    sizes = {f: np.load(os.path.join(store, f), mmap_mode="r").shape
             for f in sorted(os.listdir(store))}
    log(f"promise12 cache: native curvature flow built with g++ in {build_s:.2f} s; "
        f"cache {wall:.2f} s wall; CLAHE {split['equalize_adapthist']:.2f} s "
        f"({split['equalize_adapthist_calls']} slices), resize "
        f"{split['resize_nearest']:.2f} s ({split['resize_nearest_calls']}), curvature flow "
        f"{split['curvature_flow']:.2f} s ({split['curvature_flow_calls']} native calls); "
        f"files {sizes}")
    check(split["curvature_flow_calls"] == sizes["X_train.npy"][0] + sizes["X_val.npy"][0]
          + sizes["X_test.npy"][0],
          f"the native curvature flow ran {split['curvature_flow_calls']} times for {sizes}")
    vol = read_mhd(os.path.join(root, "PROMISE2012", "TrainingData", "Case00.mhd")).array
    slices = promise12._img_resize(vol[:3], HW, HW, equalize=True)
    for s_ in slices:
        check(np.array_equal(native.curvature_flow(s_, 0.125, 5),
                             augment._curvature_flow(s_, 0.125, 5)),
              "the native curvature flow and its numpy twin disagree")
    x = np.load(os.path.join(store, "X_train.npy"))
    check(np.isfinite(x).all() and abs(float(x.mean())) < 1e-3
          and abs(float(x.std()) - 1) < 1e-3, f"X_train mean {x.mean()}, std {x.std()}")
    return dict(build_s=build_s, wall_s=wall, clahe_s=split["equalize_adapthist"],
                resize_s=split["resize_nearest"], curvature_flow_s=split["curvature_flow"],
                native_calls=split["curvature_flow_calls"], files=sizes, trainset=trainset)


def time_loader(trainset) -> dict:
    """ms per augmented batch at 8 and 12, serial and with the default
    pool of threads."""
    out = {}
    for bs in (8, 12):
        for workers in (0, None):
            loader = DataLoader(trainset, bs, shuffle=True, drop_last=True, workers=workers)
            it = iter(loader)
            times = []
            for _ in range(min(LOADER_BATCHES, len(loader))):
                t0 = time.perf_counter()
                batch = next(it)
                times.append((time.perf_counter() - t0) * 1e3)
            check(batch["image"].shape == (bs, HW, HW, IN_CHANNELS)
                  and np.isfinite(batch["image"]).all()
                  and set(np.unique(batch["label"])) <= {0, 1},
                  f"loader batch {batch['image'].shape} labels {np.unique(batch['label'])}")
            key = f"batch{bs}_workers{loader.workers}"
            out[key] = float(np.mean(times))
            log(f"loader {key}: {out[key]:.1f} ms/batch ({[round(t, 1) for t in times]})")
    return out


def _in_process(main_fn, *argv: str) -> str:
    """A CLI's main(argv) in this process (so that the kernels' counters
    see its launches); its stdout, also logged."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(list(argv))
    out = buf.getvalue()
    log(f"  {main_fn.__module__} {' '.join(argv)}: rc {rc}, {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        log(f"    {line}")
    check(rc == 0, f"{main_fn.__module__} returned {rc}")
    return out


def _scalars(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return {r["tag"]: r["value"] for r in map(json.loads, f)}


def run_promise12_path(dev, expect: dict, work: str, seed: int, found: dict) -> dict:
    """The PROMISE12 files through the port's CLIs at the flagship config:
    search_arc (1 epoch, full width), train_model (1 epoch, the default
    genotype), testing_model on its best checkpoint, and the submission from
    the test split through TestRunner.run_promise12_submission."""
    root = os.path.join(work, "data")
    tests = write_phantom(root, np.random.RandomState(seed + 11))
    cache = build_promise12_cache(root)
    trainset = cache.pop("trainset")
    loader = time_loader(trainset)

    s = load_config(CONFIG)["searching"]
    n = len(trainset)
    split = int(np.floor(s["train_portion"] * n))
    steps, val_batches = split // s["batch_size"], (n - split) // s["batch_size"]
    do_arch = s["alpha_begin"] <= 0
    want = {k: steps * per_step(expect, do_arch)[k] + val_batches * expect["eval"][k]
            for k in KERNELS}
    log_root = os.path.join(work, "logs")
    reset_counts()
    t0 = time.perf_counter()
    out = _in_process(search_arc.main, "--config", CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    search_s = time.perf_counter() - t0
    got = counts()
    log(f"search_arc on the phantom: {steps} steps (do_arch={do_arch}) and {val_batches} "
        f"eval batches of {s['batch_size']}; launches {got}, expected {want}")
    check(got == want, f"search_arc launched {got}, expected {want}")
    search = _scalars(_run_dir(out))
    search_ms = 1e3 / search["Train/steps_per_sec"]
    log(f"search_arc: {search_ms:.2f} ms/step (steps' second half), prefetch wait "
        f"{search['Train/prefetch_wait_share']:.4f} of a step's wall, val batch fetch "
        f"{search['Train/val_fetch_share']:.4f}; {search_s:.1f} s in all; val dice "
        f"{search['Val/dice']:.4f}")
    check(all(np.isfinite(v) for v in search.values()), f"search scalars {search}")

    reset_counts()
    out = _in_process(train_model.main, "--config", CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    train_dir = _run_dir(out)
    train = _scalars(train_dir)
    train_ms = 1e3 / train["Train/steps_per_sec"]
    log(f"train_model: {train_ms:.2f} ms/step, prefetch wait "
        f"{train['Train/prefetch_wait_share']:.4f} of a step's wall; val dice "
        f"{train['Val/dice']:.4f}")
    check(all(np.isfinite(v) for v in train.values()), f"train scalars {train}")
    ckpt = os.path.join(train_dir, "ckpt")
    check(os.path.exists(os.path.join(ckpt, "best.pt")), "train_model wrote no best checkpoint")

    out = _in_process(testing_model.main, "--config", CONFIG, "--data_root", root,
                      "--resume", ckpt, "--log_root", log_root, "--batch_size",
                      str(load_config(CONFIG)["training"]["batch_size"]))
    tested = ast.literal_eval(out.strip().splitlines()[-1])
    check(abs(tested["dice"] - train["Val/dice"]) <= 0.01,
          f"testing_model dice {tested['dice']}, the run's {train['Val/dice']}")
    fixed_launches = counts()
    check(not any(fixed_launches.values()), f"the fixed CLIs launched {fixed_launches}")

    # the submission from the test split, in case order
    cfg = load_config(CONFIG)
    runner = TestRunner(cfg, resume=ckpt, data_root=root, log_root=log_root,
                        batch_size=12, device=dev)
    testset = promise12.Promise12(root, mode="test")
    check([os.path.basename(p) for p in testset.test_file_list]
          == [os.path.basename(p) for p in tests]
          and list(testset.n_imgs) == [c[0] for c in PHANTOM_TEST_SHAPES],
          f"test split {testset.test_file_list} {testset.n_imgs}")
    t0 = time.perf_counter()
    written, summary = runner.run_promise12_submission(
        os.path.dirname(tests[0]), dest=os.path.join(work, "submission"),
        queue=DataLoader(testset, 12))
    submit_s = time.perf_counter() - t0
    _geometry_kept(written, tests)
    check(summary is None and len(written) == len(tests), f"submission {written} {summary}")
    log(f"submission from the test split: {len(written)} volumes "
        f"{[read_mhd(w).array.shape for w in written]} in {submit_s:.2f} s, each with its "
        "source's shape, origin, spacing and direction")

    # the contour grid draws with matplotlib, where the machine has it
    if found["matplotlib"]:
        val = DataLoader(promise12.Promise12(root, mode="val"), 12)
        images, labels, preds = [], [], []
        for batch in val:
            preds.append(runner.eval_step(runner._place(batch))["pred"].cpu().numpy())
            images.append(batch["image"][..., 0])
            labels.append(batch["label"])
        grid = best_worst_contour_grid(np.concatenate(images), np.concatenate(labels),
                                       np.concatenate(preds), os.path.join(work, "grid.png"))
        with open(grid, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "the contour grid is not a PNG")
        contour = f"drawn ({os.path.getsize(grid)} bytes)"
    else:
        contour = "not drawn: matplotlib does not import on this machine"
    log(f"best_worst_contour_grid: {contour}")
    return dict(launches=got, expected=want, cache={k: v for k, v in cache.items()},
                loader_ms=loader, search_ms_per_step=search_ms,
                search_prefetch_wait_share=search["Train/prefetch_wait_share"],
                search_val_fetch_share=search["Train/val_fetch_share"], search_s=search_s,
                train_ms_per_step=train_ms,
                train_prefetch_wait_share=train["Train/prefetch_wait_share"],
                test=tested, submission_s=submit_s, contour_grid=contour)


# ---------------------------------------------------------------------------
# Phase 15: the other shipped configs' data paths
# ---------------------------------------------------------------------------

CHAOS_CONFIG = os.path.join(ROOT, "configs", "senas", "senas_chaos.yml")
HEART_CONFIG = os.path.join(ROOT, "configs", "senas", "senas_heart.yml")
# the phantoms: each dataset's own slice size, few cases. CHAOS CT: 512 x
# 512 int16 slices; CHAOS MR: 256 x 256 uint16 slices (T1DUAL in and out
# phase, T2SPIR); MSD heart: 320 x 320 MR volumes; MoNuSAC: RGB tiles
CHAOS_CT = dict(cases=4, slices=24, hw=512)
CHAOS_MR = dict(slices=8, hw=256)
HEART = dict(volumes=3, slices=16, hw=320)
MONUSAC = dict(images=12, hw=(300, 340))
DECODE_REPS = 10           # slices timed per reader


def _dicom_element(group, elem, vr, value: bytes) -> bytes:
    """An explicit-VR little-endian data element."""
    if len(value) % 2:
        value += b"\x00" if vr == b"UI" else b" "
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"UN", b"SQ", b"UT"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def write_dicom(path: str, pixels: np.ndarray, slope: float, intercept: float) -> None:
    """A CHAOS-like DICOM slice: preamble, file meta group (explicit VR
    little endian), SOP UIDs, the image pixel module with
    RescaleSlope/Intercept, and the 16-bit pixel data."""
    meta = _dicom_element(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    data = (_dicom_element(0x0008, 0x0016, b"UI", b"1.2.840.10008.5.1.4.1.1.2")
            + _dicom_element(0x0008, 0x0018, b"UI", b"1.2.826.0.1.3680043.2.1125.1")
            + _dicom_element(0x0028, 0x0002, b"US", struct.pack("<H", 1))
            + _dicom_element(0x0028, 0x0010, b"US", struct.pack("<H", pixels.shape[0]))
            + _dicom_element(0x0028, 0x0011, b"US", struct.pack("<H", pixels.shape[1]))
            + _dicom_element(0x0028, 0x0100, b"US", struct.pack("<H", 16))
            + _dicom_element(0x0028, 0x0103, b"US",
                             struct.pack("<H", int(pixels.dtype == np.int16)))
            + _dicom_element(0x0028, 0x1052, b"DS", repr(float(intercept)).encode())
            + _dicom_element(0x0028, 0x1053, b"DS", repr(float(slope)).encode())
            + _dicom_element(0x7FE0, 0x0010, b"OW", pixels.astype(pixels.dtype.newbyteorder("<"))
                             .tobytes()))
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM"
                + _dicom_element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)))
                + meta + data)


def write_nifti_gz(path: str, vol: np.ndarray) -> None:
    """A gzipped NIfTI-1 volume of int16 or uint8 `vol` [X, Y, Z]."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *vol.shape, 1, 1, 1, 1)
    struct.pack_into("<hh", hdr, 70, {np.dtype(np.int16): 4, np.dtype(np.uint8): 2}[vol.dtype],
                     8 * vol.itemsize)
    struct.pack_into("<4f", hdr, 76, 1.0, 1.25, 1.25, 1.37)
    struct.pack_into("<fff", hdr, 108, 352.0, 0.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4 + vol.astype(vol.dtype.newbyteorder("<"))
                .tobytes(order="F"))


def _organ(rng, h, w, scale=1.0):
    """A smooth field (-1..1) and an ellipse mask inside it."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * rng.uniform(0.4, 0.6), w * rng.uniform(0.35, 0.55)
    inside = (((yy - cy) / (h * rng.uniform(0.12, 0.2) * scale)) ** 2
              + ((xx - cx) / (w * rng.uniform(0.15, 0.25) * scale)) ** 2) < 1
    field = np.sin(yy / rng.uniform(15, 40)) * np.cos(xx / rng.uniform(15, 40))
    return field, inside


def write_shipped_phantoms(root: str, rng) -> dict:
    """CHAOS CT and MR, MSD Task02_Heart volumes and MoNuSAC tiles under
    `root`, in each dataset's layout; returns a few written arrays to check
    the readers against."""
    written = {}
    ct = os.path.join(root, "CHAOS", "CT_data_batch")
    n = CHAOS_CT["hw"]
    for case in range(CHAOS_CT["cases"]):
        d = os.path.join(ct, str(case + 1), "DICOM_anon")
        g = os.path.join(ct, str(case + 1), "Ground")
        os.makedirs(d)
        os.makedirs(g)
        for i in range(CHAOS_CT["slices"]):
            field, liver = _organ(rng, n, n, 0.6 + 0.5 * np.sin(np.pi * i / CHAOS_CT["slices"]))
            _, body = _organ(rng, n, n, 2.3)
            hu = np.where(body, 40 + 30 * field + 60 * liver, -1000) + 20 * rng.randn(n, n)
            raw = (hu + 1024).astype(np.int16)            # stored = HU - intercept
            write_dicom(os.path.join(d, f"IMG-{case + 1:04d}-{i + 1:05d}.dcm"), raw, 1.0,
                        -1024.0)
            write_png_l(os.path.join(g, f"liver_GT_{i:03d}.png"), 255.0 * liver)
            if case == i == 0:
                written["ct_raw"], written["ct_mask"] = raw, (255 * liver).astype(np.uint8)
    mr = os.path.join(root, "CHAOS", "MR_data_batch1", "1")
    m = CHAOS_MR["hw"]
    for series, dup in (("T1DUAL", True), ("T2SPIR", False)):
        d, g = os.path.join(mr, series, "DICOM_anon"), os.path.join(mr, series, "Ground")
        os.makedirs(d)
        os.makedirs(g)
        for i in range(CHAOS_MR["slices"]):
            field, liver = _organ(rng, m, m)
            _, kidney = _organ(rng, m, m, 0.4)
            px = np.clip(300 + 150 * field + 400 * liver + 30 * rng.randn(m, m), 0, None)
            write_dicom(os.path.join(d, f"IMG-0001-{i + 1:05d}.dcm"), px.astype(np.uint16),
                        1.0, 0.0)
            ident = "%03d" % ((i + 2) // 2) if dup else f"{i + 1:03d}"
            if not dup or i % 2 == 0:                     # in/out phase share a mask
                write_png_l(os.path.join(g, f"liver_{ident}.png"),
                            np.where(kidney, 160.0, np.where(liver, 80.0, 0.0)))
    task = os.path.join(root, "Task02_Heart")
    h = HEART["hw"]
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(task, sub))
    for v in range(HEART["volumes"]):
        vols, labs = [], []
        for _ in range(HEART["slices"]):
            field, atrium = _organ(rng, h, h, 0.7)
            vols.append(np.clip(200 + 150 * field + 500 * atrium + 40 * rng.randn(h, h),
                                0, 1600))
            labs.append(atrium)
        vol = np.stack(vols, -1).astype(np.int16)
        write_nifti_gz(os.path.join(task, "imagesTr", f"la_{v:03d}.nii.gz"), vol)
        write_nifti_gz(os.path.join(task, "labelsTr", f"la_{v:03d}.nii.gz"),
                       np.stack(labs, -1).astype(np.uint8))
        if v == 0:
            written["heart_slice0"] = vol[..., 0]
    mon = os.path.join(root, "MoNuSAC", "MoNuSAC_cleaned")
    os.makedirs(os.path.join(mon, "images"))
    os.makedirs(os.path.join(mon, "masks"))
    mh, mw = MONUSAC["hw"]
    for i in range(MONUSAC["images"]):
        field, nuclei = _organ(rng, mh, mw, 0.5)
        base = 180 + 40 * field - 90 * nuclei
        rgb = np.stack([base + 20, base - 30, base + 10], -1) + 8 * rng.randn(mh, mw, 3)
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        write_png(os.path.join(mon, "images", f"tile_{i:02d}.png"), rgb)
        write_png(os.path.join(mon, "masks", f"tile_{i:02d}.png"),
                  (255 * nuclei).astype(np.uint8))
        if i == 0:
            written["monusac_rgb"] = rgb
    return written


def _decode_ms(fn, paths) -> float:
    """Mean ms of fn(path) over up to DECODE_REPS of `paths`."""
    times = []
    for path in paths[:DECODE_REPS]:
        t0 = time.perf_counter()
        fn(path)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times))


def time_batches(dataset, bs: int, shape, labels) -> dict:
    """ms per augmented batch of `bs`, serial and with the default pool of
    threads; each batch of `shape` with labels within `labels`."""
    out = {}
    for workers in (0, None):
        loader = DataLoader(dataset, bs, shuffle=True, drop_last=True, workers=workers)
        it = iter(loader)
        times = []
        for _ in range(min(LOADER_BATCHES, len(loader))):
            t0 = time.perf_counter()
            batch = next(it)
            times.append((time.perf_counter() - t0) * 1e3)
        check(batch["image"].shape == shape and np.isfinite(batch["image"]).all()
              and set(np.unique(batch["label"])) <= set(labels),
              f"batch {batch['image'].shape} (want {shape}), labels "
              f"{np.unique(batch['label'])} (want within {labels})")
        out[f"workers{loader.workers}"] = float(np.mean(times))
    return out


def run_shipped_configs(dev, expect: dict, work: str, seed: int) -> dict:
    """The other shipped configs on phantoms in their own layouts: the
    readers checked and timed, the augmented loaders timed, search_arc on
    senas_chaos.yml for 1 epoch at full width (K1a-K1d launches held to the
    count), train_model on senas_heart.yml for 1 epoch and testing_model on
    its best checkpoint, and a batch of monusac and chaos_mr."""
    root = os.path.join(work, "data")
    t0 = time.perf_counter()
    written = write_shipped_phantoms(root, np.random.RandomState(seed + 15))
    phantom_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    extract_task(os.path.join(root, "Task02_Heart"))
    extract_s = time.perf_counter() - t0

    # the readers on this machine, against what was written
    ct_dir = os.path.join(root, "CHAOS", "CT_data_batch", "1")
    raw, slope, intercept = read_dicom_pixels(
        os.path.join(ct_dir, "DICOM_anon", "IMG-0001-00001.dcm"))
    check(np.array_equal(raw, written["ct_raw"]) and (slope, intercept) == (1.0, -1024.0),
          "the DICOM reader does not give back the written slice")
    check(np.array_equal(read_image(os.path.join(ct_dir, "Ground", "liver_GT_000.png"), "L"),
                         written["ct_mask"]), "the PNG reader does not give back the mask")
    heart_png = os.path.join(root, "Task02_Heart", "imagesTr", "la_000", "0.png")
    check(np.array_equal(read_image(heart_png, "L"),
                         float_to_l(written["heart_slice0"].astype(np.float64))),
          "the heart slice's PNG is not Pillow's F-to-L of the volume's slice")
    check(np.array_equal(read_nifti(os.path.join(root, "Task02_Heart", "imagesTr",
                                                 "la_000.nii.gz"))[..., 0],
                         written["heart_slice0"]), "the NIfTI reader does not give back "
          "the written volume")
    rgb = written["monusac_rgb"].astype(np.uint32)
    luma = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
    mon_png = os.path.join(root, "MoNuSAC", "MoNuSAC_cleaned", "images", "tile_00.png")
    check(np.array_equal(read_image(mon_png, "L"), luma), "MoNuSAC's luma is not Pillow's")

    dicoms = sorted(os.path.join(ct_dir, "DICOM_anon", f)
                    for f in os.listdir(os.path.join(ct_dir, "DICOM_anon")))
    masks = sorted(os.path.join(ct_dir, "Ground", f)
                   for f in os.listdir(os.path.join(ct_dir, "Ground")))
    heart_slices = [os.path.join(os.path.dirname(heart_png), f"{i}.png")
                    for i in range(HEART["slices"])]
    mon_dir = os.path.dirname(mon_png)
    tiles = sorted(os.path.join(mon_dir, f) for f in os.listdir(mon_dir))
    decode = {"chaos_dicom": _decode_ms(read_dicom_pixels, dicoms),
              "chaos_mask_png": _decode_ms(lambda p: read_image(p, "L"), masks),
              "heart_png": _decode_ms(lambda p: read_image(p, "L"), heart_slices),
              "monusac_rgb_png_as_l": _decode_ms(lambda p: read_image(p, "L"), tiles)}

    chaos = get_dataset("chaos", path=root, mode="train")
    heart = get_dataset("heart", path=root, mode="train")
    monusac = get_dataset("monusac", path=root, mode="train")
    chaos_mr = get_dataset("chaos_mr", path=root, mode="train")
    hh, hw = heart.spec.crop_size
    batches = {"chaos": time_batches(chaos, 8, (8, HW, HW, 1), {0, 1}),
               "heart": time_batches(heart, 12, (12, hh, hw, 1), {0, 1}),
               "monusac": time_batches(monusac, 8, (8, HW, HW, 1), {0, 1}),
               "chaos_mr": time_batches(chaos_mr, 8, (8, HW, HW, 1), {0, 1, 2, 3, 4})}
    log(f"shipped configs' phantoms written in {phantom_s:.2f} s ({CHAOS_CT}, {CHAOS_MR}, "
        f"{HEART}, {MONUSAC}); heart extraction {extract_s:.2f} s for "
        f"{HEART['volumes'] * HEART['slices']} slices; decode ms per slice {decode}; ms per "
        f"augmented batch {batches}")
    labels = np.unique(next(iter(DataLoader(chaos_mr, 8, workers=0)))["label"])
    check(len(labels) >= 2, f"the chaos_mr batch has labels {labels}")

    # search_arc on CHAOS at full width
    s = load_config(CHAOS_CONFIG)["searching"]
    same = ("init_channels", "depth", "meta_node_num", "double_down_channel",
            "deep_supervision")
    check(all(s[k] == load_config(CONFIG)["searching"][k] for k in same),
          f"senas_chaos.yml's search geometry differs from {CONFIG}'s")
    n = len(chaos)
    split = int(np.floor(s["train_portion"] * n))
    steps, val_batches = split // s["batch_size"], (n - split) // s["batch_size"]
    do_arch = s["alpha_begin"] <= 0
    want = {k: steps * per_step(expect, do_arch)[k] + val_batches * expect["eval"][k]
            for k in KERNELS}
    log_root = os.path.join(work, "logs")
    reset_counts()
    t0 = time.perf_counter()
    out = _in_process(search_arc.main, "--config", CHAOS_CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    search_s = time.perf_counter() - t0
    got = counts()
    log(f"search_arc on CHAOS CT: {steps} steps (do_arch={do_arch}) and {val_batches} eval "
        f"batches of {s['batch_size']}; launches {got}, expected {want}")
    check(got == want, f"search_arc on CHAOS launched {got}, expected {want}")
    search = _scalars(_run_dir(out))
    check(all(np.isfinite(v) for v in search.values()), f"CHAOS search scalars {search}")
    search_ms = 1e3 / search["Train/steps_per_sec"]

    # train_model and testing_model on the heart volumes
    t = load_config(HEART_CONFIG)["training"]
    reset_counts()
    out = _in_process(train_model.main, "--config", HEART_CONFIG, "--data_root", root,
                      "--epoch", "1", "--log_root", log_root)
    train_dir = _run_dir(out)
    train = _scalars(train_dir)
    check(all(np.isfinite(v) for v in train.values()), f"heart train scalars {train}")
    train_ms = 1e3 / train["Train/steps_per_sec"]
    ckpt = os.path.join(train_dir, "ckpt")
    out = _in_process(testing_model.main, "--config", HEART_CONFIG, "--data_root", root,
                      "--resume", ckpt, "--log_root", log_root, "--batch_size",
                      str(t["batch_size"]))
    tested = ast.literal_eval(out.strip().splitlines()[-1])
    check(abs(tested["dice"] - train["Val/dice"]) <= 0.01,
          f"testing_model dice {tested['dice']} on heart, the run's {train['Val/dice']}")
    fixed_launches = counts()
    check(not any(fixed_launches.values()), f"the heart CLIs launched {fixed_launches}")
    log(f"shipped configs: CHAOS search {search_ms:.2f} ms/step, prefetch wait "
        f"{search['Train/prefetch_wait_share']:.4f}, val fetch "
        f"{search['Train/val_fetch_share']:.4f}, {search_s:.1f} s in all; heart train "
        f"{train_ms:.2f} ms/step (batch {t['batch_size']} of {hh}x{hw}), prefetch wait "
        f"{train['Train/prefetch_wait_share']:.4f}; heart test dice {tested['dice']:.4f}")
    return dict(launches=got, expected=want, phantom_s=phantom_s, extract_s=extract_s,
                decode_ms=decode, batch_ms=batches, search_ms_per_step=search_ms,
                search_prefetch_wait_share=search["Train/prefetch_wait_share"],
                search_val_fetch_share=search["Train/val_fetch_share"], search_s=search_s,
                train_ms_per_step=train_ms,
                train_prefetch_wait_share=train["Train/prefetch_wait_share"], test=tested)


# ---------------------------------------------------------------------------
# Phase 16: the baseline zoo
# ---------------------------------------------------------------------------

ZOO_MODELS = ("nasunet", "unet", "unet_plus_plus", "manet", "linknet", "fpn", "pspnet", "pan",
              "deeplab_v3_plus")
# pspnet at smp's own depth 3: at depth 5 its logits are 4x smaller than
# the labels (upsampling 8 over a stride-32 encoder). DeepLabV3+ keeps depth
# 5 whatever depth says (the factory's rule in both packages).
ZOO_DEPTH = {"pspnet": 3}
# the card-vs-CPU step, batch 2: (depth, side); PAN's pyramid attention
# pools its deepest map three times, so it needs an 8x8 one
ZOO_SMALL = {"pspnet": (3, 64), "pan": (5, 128)}
ZOO_SMALL_DEFAULT = (4, 64)
# The step on the card against the CPU in f32 (TF32 off) and in f64. f32
# carries no closer: on the CPU alone an f64 run of the same step is up to
# 5.2e-3 (manet: PAB's softmax over the whole HW x HW map) off the f32 one
# in the weight update and 1.6e-4 in the gradient norm. In f64 the two
# devices must compute the same function.
ZOO_CPU_LIMITS = {"float32": dict(loss=1e-5, grad_norm=1e-3, weights=2e-2, bn_stats=1e-4),
                  "float64": dict(loss=1e-12, grad_norm=1e-10, weights=1e-8, bn_stats=1e-12)}
SMP_LOSSES = ("smp_dice", "smp_jaccard", "smp_tversky", "smp_focal", "smp_lovasz", "smp_soft_ce")
# full-size logits on the card against the CPU (sums over 786k pixels in
# other orders)
SMP_LOSS_REL = 1e-4


def _zoo_model(name, depth, dev, gen, dtype=None):
    return get_segmentation_model(name, dataset="promise12", depth=depth, device=dev,
                                  generator=gen, dtype=dtype)


# senas_tpu's align-corners resizes keep f32 weights, so these two models
# give f32 logits from a bf16 model; the other seven bf16 ones
ZOO_F32_LOGITS = ("fpn", "pan")


# profiled: the smallest host-bound step (deeplab_v3_plus), a conv-heavy one
# (unet), and fpn, whose eval batch cost more than its train step in f32
ZOO_PROFILED = ("unet", "fpn", "deeplab_v3_plus")


def _logits_dtype(name, dtype):
    return torch.float32 if dtype is None or name in ZOO_F32_LOGITS else dtype


def run_zoo_path(dev, seed: int, dtype=None) -> dict:
    """The nine zoo models at the promise12 `training:` geometry in `dtype`
    (None: f32): 1 + 3 train steps, then the eval step on 3 batches; the
    ZOO_PROFILED models' step once more under torch.profiler. No kernel of
    the port is on this path."""
    t = load_config(CONFIG)["training"]
    bs, loss_fn = t["batch_size"], _fixed_loss(t)
    rng = np.random.RandomState(seed + 16)
    train_batches = _batches(rng, FIXED_STEPS, bs, HW, dev)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    reset_counts()
    rows, unet_state = {}, None
    tag = "zoo" if dtype is None else "bf16 zoo"
    for name in ZOO_MODELS:
        depth = ZOO_DEPTH.get(name, t["depth"])
        model = _zoo_model(name, depth, dev, torch.Generator().manual_seed(seed + 16), dtype)
        state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
        step = make_train_step(loss_fn, grad_clip=t["grad_clip"])
        evaluate = make_eval_step(model, loss_fn)
        first = {k: p.detach().clone() for k, p in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i, batch in enumerate(train_batches):
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            vals = {k: float(m[k]) for k in ("loss", "grad_norm")}
            check(all(np.isfinite(v) for v in vals.values()), f"{name} train step {i}: {vals}")
            losses.append(vals["loss"])
        # a leaf may stay: a zero-initialised bias whose ReLU unit is dead
        # on these batches gets no gradient and no decay (nasunet's SE gates)
        moved = sum(not torch.equal(first[k], p) for k, p in model.named_parameters())
        check(moved >= 0.95 * len(first), f"{name}: {len(first) - moved} of {len(first)} "
                                          "weight leaves did not move in 4 steps")
        eval_times = []
        for i, batch in enumerate(eval_batches):
            t0 = time.perf_counter()
            m = evaluate(batch)
            torch.cuda.synchronize()
            eval_times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(float(m["loss"])) and m["pred"].dtype == torch.uint8
                  and tuple(m["pred"].shape) == (bs, HW, HW),
                  f"{name} eval batch {i}: loss {float(m['loss'])}, pred "
                  f"{m['pred'].dtype} {tuple(m['pred'].shape)}")
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode():
            out = model(eval_batches[0]["image"], train=False)
        check(isinstance(out, list) and len(out) == 1, f"{name} returned {type(out)}")
        shape = tuple(out[0].shape)
        check(shape == (bs, HW, HW, NCLASS) and bool(torch.isfinite(out[0]).all()),
              f"{name} logits {shape}")
        check(out[0].dtype == _logits_dtype(name, dtype)
              and all(p.dtype == torch.float32 for p in model.parameters()),
              f"{tag} {name}: logits {out[0].dtype}, or weights not f32")
        depth = getattr(model, "encoder", model).depth   # deeplab_v3_plus: always 5
        row = dict(depth=depth, parameters=sum(p.numel() for p in model.parameters()),
                   step_ms=float(np.mean(times[1:])), first_ms=times[0],
                   eval_ms=float(np.mean(eval_times[1:])), peak_mib=peak / 2**20,
                   out_shape=list(shape), out_dtype=str(out[0].dtype), losses=losses,
                   leaves_moved=[moved, len(first)])
        log(f"{tag} {name} (depth {depth}, {row['parameters']} parameters): "
            f"{row['step_ms']:.2f} ms/step (first {times[0]:.2f}), eval "
            f"{row['eval_ms']:.2f} ms/batch, peak {row['peak_mib']:.1f} MiB, logits {shape}, "
            f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, {moved} of {len(first)} weight leaves "
            f"moved, logits {out[0].dtype}")
        if name in ZOO_PROFILED:
            row["profile"] = profile(lambda: step(state, train_batches[-1]),
                                     f"one {tag} {name} train step, batch {bs}")
        if name == "unet":
            unet_state = state
        rows[name] = row
        del model, state, step, evaluate, first
        torch.cuda.empty_cache()
    got = counts()
    check(not any(got.values()), f"the {tag} path launched {got}")
    return dict(launches=got, models=rows, unet_state=unet_state)


def _zoo_snapshot(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def zoo_card_vs_cpu(dev, seed: int) -> dict:
    """Each zoo model's train step on the card and on the CPU from one state
    and batch of 2, in f32 (TF32 off) and in f64, with one CPU dropout
    generator (the same ASPP mask on both)."""
    t = load_config(CONFIG)["training"]
    rows = {}
    for name in ZOO_MODELS:
        depth, hw = ZOO_SMALL.get(name, ZOO_SMALL_DEFAULT)
        model0 = _zoo_model(name, depth, "cpu", torch.Generator().manual_seed(seed + 17))
        state0 = model0.state_dict()
        batch = _batches(np.random.RandomState(seed + 17), 1, 2, hw, "cpu")[0]
        for dtype in (torch.float32, torch.float64):
            def run_on(d):
                model = _zoo_model(name, depth, d, None)
                model.load_state_dict({k: v.to(d) for k, v in state0.items()})
                model.to(dtype)
                state = FixedTrainState.create(model, t["model_optimizer"], seed=seed,
                                               rng=torch.Generator())
                before = _zoo_snapshot(model)
                m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                    state, {"image": batch["image"].to(d, dtype), "label": batch["label"].to(d)})
                return before, {k: m[k].cpu() for k in ("loss", "grad_norm")}, _zoo_snapshot(model)

            before, m_cpu, after_cpu = run_on("cpu")
            _, m_card, after_card = run_on(dev)
            params = [k for k in after_cpu if k.rsplit(".", 1)[-1] not in ("mean", "var")]
            stats = [k for k in after_cpu if k not in params]
            rel = dict(**_metrics_rel(m_card, m_cpu, ("loss", "grad_norm")),
                       weights=_update_rel(before, after_card, after_cpu, params),
                       bn_stats=max((float((after_card[k] - after_cpu[k]).abs().max()
                                           / after_cpu[k].abs().max().clamp_min(1.0))
                                     for k in stats), default=0.0))
            kind = str(dtype).replace("torch.", "")
            limits = ZOO_CPU_LIMITS[kind]
            rows.setdefault(name, {})[kind] = rel
            check(all(rel[k] <= limits[k] for k in limits),
                  f"{name} {kind} step, card vs CPU: {rel} (limits {limits})")
        log(f"zoo {name} step card vs CPU (depth {getattr(model0, 'encoder', model0).depth}, "
            f"{hw}x{hw}, batch 2): {rows[name]} (limits {ZOO_CPU_LIMITS})")
    return rows


def run_zoo_clis() -> dict:
    """train_model --model unet and --model nasunet on senas_synthetic.yml,
    then testing_model on each one's best checkpoint, in this process (each
    subprocess would spend ~8 s reaching the card)."""
    cfg = load_config(RUNNER_CONFIG)
    epochs, out = cfg["training"]["epoch"], {}
    with tempfile.TemporaryDirectory() as log_root:
        for name in ("unet", "nasunet"):
            stdout = _in_process(train_model.main, "--config", RUNNER_CONFIG, "--model",
                                 name, "--log_root", log_root)
            run_dir = _run_dir(stdout)
            best = ast.literal_eval(stdout.split("best: ")[1].splitlines()[0])
            check(_val_epochs(run_dir) == list(range(epochs)),
                  f"train_model --model {name} ran epochs {_val_epochs(run_dir)}")
            stdout = _in_process(testing_model.main, "--config", RUNNER_CONFIG, "--model",
                                 name, "--resume", os.path.join(run_dir, "ckpt"), "--log_root",
                                 log_root, "--batch_size", str(cfg["training"]["batch_size"]))
            result = ast.literal_eval(stdout.strip().splitlines()[-1])
            # the 0.01 points of phase 11: other cuDNN algorithms may flip a pixel
            check(abs(result["dice"] - best["best_dice"]) <= 0.01,
                  f"testing_model --model {name} dice {result['dice']}, the run's best "
                  f"{best['best_dice']}")
            out[name] = dict(best=best, test=result)
            log(f"zoo CLIs, {name}: {epochs} epochs, best {best}; testing_model {result}")
    return out


def run_zoo_serve(dev, state, seed: int, work: str) -> dict:
    """Phase 16's trained unet saved and exported by `export_model --model
    unet --check --f32`, served at batch 1 and 12 on the card."""
    model = state.model
    ckpt = CheckpointManager(os.path.join(work, "zoo_ckpt"))
    ckpt.save(state, {"epoch": 1, "model_name": "unet"}, is_best=True)
    art = os.path.join(work, "zoo_artifact")
    out = _in_process(export_model.main, "--config", CONFIG, "--model", "unet", "--resume",
                      ckpt.directory, "--out", art, "--check", "--f32")
    check("check OK" in out, "export_model --model unet --check did not pass")
    pred = Predictor(art, device=dev)
    check(pred.meta["model"] == "unet", f"artifact meta {pred.meta}")
    x_all = np.random.RandomState(seed + 18).randn(12, HW, HW, IN_CHANNELS).astype(np.float32)
    errs = {}
    for b in (1, 12):
        with deterministic_cudnn():
            got = pred.logits(x_all[:b])
            with torch.inference_mode():
                want = model(torch.from_numpy(x_all[:b]).to(dev), train=False)[-1]
        check(tuple(got.shape) == (b, HW, HW, NCLASS), f"served unet logits {tuple(got.shape)}")
        errs[b] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **SERVE_TOL)
    ms = {b: _request_ms(pred, x_all[:b]) for b in (1, 12)}
    log(f"zoo serving (unet): batch 1 {ms[1]['mean']:.3f} ms/request (p50 {ms[1]['p50']:.3f}), "
        f"batch 12 {ms[12]['mean']:.3f} ms/request (p50 {ms[12]['p50']:.3f}); served vs eager "
        f"max abs err {errs} (limit {SERVE_TOL})")
    return dict(ms=ms, errs=errs)


def run_smp_losses(dev, seed: int) -> dict:
    """The six smp_* losses on one batch of full-size logits (12 x 256 x 256
    x 2) on the card against the CPU: values, and input gradients but for
    Lovasz, whose gradient follows the order of its sorted errors, and
    a sort of 786k f32 errors computed on two devices breaks ties apart."""
    rs = np.random.RandomState(seed + 19)
    logits = rs.randn(12, HW, HW, NCLASS).astype(np.float32)
    labels = (rs.rand(12, HW, HW) > 0.7).astype(np.int64)
    out = {}
    for name in SMP_LOSSES:
        fn = build_loss(name)
        res = {}
        for d in ("cpu", dev):
            x = torch.tensor(logits, device=d, requires_grad=True)
            v = fn([x], torch.from_numpy(labels).to(d))
            v.backward()
            res[str(d)] = (float(v.detach()), x.grad.cpu())
        (v_cpu, g_cpu), (v_card, g_card) = res["cpu"], res[str(dev)]
        rel = abs(v_card - v_cpu) / max(abs(v_cpu), 1e-30)
        grad_rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
        xd, ld = torch.tensor(logits, device=dev), torch.from_numpy(labels).to(dev)
        ms = time_ms(lambda: fn([xd], ld), reps=10, warmup=2)
        check(np.isfinite(v_card) and rel <= SMP_LOSS_REL, f"{name}: card {v_card}, CPU {v_cpu}")
        if name != "smp_lovasz":
            check(grad_rel <= SMP_LOSS_REL, f"{name} input gradient, card vs CPU: {grad_rel}")
        out[name] = dict(value=v_card, rel=rel, grad_rel=grad_rel, ms=ms)
        log(f"{name} on 12x{HW}x{HW}x{NCLASS} logits: {v_card:.6f} (CPU {v_cpu:.6f}, rel "
            f"{rel:.3g}; input gradient rel {grad_rel:.3g}), {ms:.3f} ms on the card")
    return out


def run_zoo(dev, seed: int) -> dict:
    """Phase 16, timed."""
    t0 = time.perf_counter()
    path = run_zoo_path(dev, seed)
    cpu = zoo_card_vs_cpu(dev, seed)
    clis = run_zoo_clis()
    with tempfile.TemporaryDirectory() as work:
        serve = run_zoo_serve(dev, path.pop("unet_state"), seed, work)
    losses = run_smp_losses(dev, seed)
    seconds = time.perf_counter() - t0
    log(f"phase 16 (the baseline zoo): {seconds:.1f} s")
    return dict(path, card_vs_cpu=cpu, clis=clis, serve=serve, losses=losses, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 17: bf16 (`precision: bf16`)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# A bf16 kernel output against its plain twin on the same tensors: equal
# but on at most this share of the elements, each of those within one bf16
# ulp, or within 2^-21 of the sum of its terms' magnitudes where the f32
# sum cancels (the kernel fuses each multiply-add, PyTorch rounds the
# product first). The f32 sums keep phase 3's bound (1e-5 of the plane's
# sum of magnitudes).
BF16_SHARE = 1e-3
# The epilogue's bf16 gradients against autograd through the plain
# two-pass reference in f32 on the same bf16 branch tensors: the bf16
# cotangent and the bf16 branch gradients round (2^-9 each).
BF16_GRAD_REL = 2e-2


def _bf16_err(got: torch.Tensor, want: torch.Tensor, terms: torch.Tensor) -> tuple:
    """(share of differing elements, the worst difference in units of its
    allowance: max(one bf16 ulp, 2^-21 of `terms`), the largest absolute
    difference); fails over the bound."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7)
    share = (diff > 0).double().mean().item()
    worst = (diff / torch.maximum(ulp, terms.double() * 2.0 ** -21)).max().item()
    check(got.dtype == want.dtype == BF16 and share <= BF16_SHARE and worst <= 1.0,
          f"bf16 output: {share:.3g} of the elements differ, worst {worst:.3g} of the allowance")
    return share, worst, diff.max().item()


def check_kernels_bf16(dev, f32: dict) -> dict:
    """K1a-K1d on bf16 branch tensors (and a bf16 cotangent) against their
    plain twins on the card, at the supernet's group shapes in train- and
    eval-mode operands; the epilogue's gradients; times at each shape beside
    the f32 variant's (phase 3, `f32`) and the bf16 byte bound."""
    names = [name for name, _ in _TIMED]
    records = {name: {"timed": []} for name in names}
    worst = {name: 0.0 for name in names}
    worst.update(stats_rel=0.0, reduce_rel=0.0, grad_rel=0.0, share=0.0, mix_allowance=0.0,
                 dx_allowance=0.0)
    for h in KERNEL_HW:
        for n, se, none in ((6, True, False), (5, False, True)):
            b, planes = 8, 8 * GROUP_C
            for train in (True, False):
                args, kw = _group_inputs(dev, n, h, seed=h + n + 7, train=train, se=se, none=none)
                args = ([x.to(BF16) for x in args[0]], *args[1:])
                xs = args[0]
                xf = [x.float() for x in xs]
                s1, s2 = ge.branch_stats(xs)
                p1, p2 = ge.branch_stats_plain(xs)
                abs1 = torch.stack([x.abs().sum(dim=(2, 3)) for x in xf])
                rel = max(((s1 - p1).abs() / abs1).max().item(),
                          ((s2 - p2).abs() / p2).max().item())
                check(rel <= 1e-5, f"branch_stats (bf16) disagrees: rel {rel:.3g}")
                a = torch.randn(n, b, GROUP_C, device=dev)
                k = torch.randn(b, GROUP_C, device=dev)
                col = lambda t: t.abs()[:, :, None, None]
                share2, w2, err2 = _bf16_err(
                    ge.apply_mix(xs, a, k), ge.apply_mix_plain(xs, a, k),
                    col(k) + sum(x.abs() * col(a[o]) for o, x in enumerate(xf)))
                g = torch.randn(b, GROUP_C, h, h, device=dev).to(BF16)
                gf = g.float()
                da, dk = ge.bwd_reduce(xs, g)
                pa, pk = ge.bwd_reduce_plain(xs, g)
                abs_a = torch.stack([(gf * x).abs().sum(dim=(2, 3)) for x in xf])
                rel_c = max(((da - pa).abs() / abs_a).max().item(),
                            ((dk - pk).abs() / gf.abs().sum(dim=(2, 3))).max().item())
                check(rel_c <= 1e-5, f"bwd_reduce (bf16) disagrees: rel {rel_c:.3g}")
                ds1 = torch.randn(n, b, GROUP_C, device=dev)
                ds2 = torch.randn(n, b, GROUP_C, device=dev)
                share5, w5, err5 = 0.0, 0.0, 0.0
                for o, (got, want) in enumerate(zip(ge.bwd_dx(xs, g, a, ds1, ds2),
                                                    ge.bwd_dx_plain(xs, g, a, ds1, ds2))):
                    sh, w_, e_ = _bf16_err(got, want, gf.abs() * col(a[o]) + col(ds1[o])
                                           + 2 * xf[o].abs() * col(ds2[o]))
                    share5, w5, err5 = max(share5, sh), max(w5, w_), max(err5, e_)
                err6 = _epilogue_grad_err(args, kw, g.float(), ref_dtype=torch.float32)
                check(err6 <= BF16_GRAD_REL, f"bf16 epilogue gradients disagree: rel {err6:.3g}")
                torch.cuda.synchronize()
                for key, v in (("stats_rel", rel), ("branch_stats", (s1 - p1).abs().max().item()),
                               ("apply_mix", err2), ("mix_allowance", w2), ("reduce_rel", rel_c),
                               ("bwd_reduce", (da - pa).abs().max().item()), ("bwd_dx", err5),
                               ("dx_allowance", w5), ("grad_rel", err6),
                               ("share", max(share2, share5))):
                    worst[key] = max(worst[key], v)
                log(f"  bf16 h={h:3d} n={n} train={train!s:5}: stats rel {rel:.3g} | mix share "
                    f"{share2:.3g} worst {w2:.3g} | bwd_reduce rel {rel_c:.3g} | bwd_dx share "
                    f"{share5:.3g} worst {w5:.3g} | grads rel {err6:.3g}")

            args, kw = _group_inputs(dev, n, h, seed=1, train=True, se=se, none=none)
            xs = [x.to(BF16) for x in args[0]]
            a = torch.rand(n, b, GROUP_C, device=dev)
            k = torch.rand(b, GROUP_C, device=dev)
            g = torch.randn(b, GROUP_C, h, h, device=dev).to(BF16)
            ds1, ds2 = (torch.randn(n, b, GROUP_C, device=dev) for _ in range(2))
            elems = n * planes * h * h
            plane_bytes = planes * h * h * 2          # one [8,24,h,h] bf16 tensor
            nbytes = dict(
                stats=n * plane_bytes + 2 * n * planes * 4,
                mix=n * plane_bytes + (n + 1) * planes * 4 + plane_bytes,
                reduce=(n + 1) * plane_bytes + (n + 1) * planes * 4,
                dx=(2 * n + 1) * plane_bytes + 3 * n * planes * 4)
            flops = dict(stats=3 * elems, mix=2 * elems, reduce=2 * elems + elems // n,
                         dx=4 * elems)
            t = k1_times(xs, a, k, g, ds1, ds2)
            bound = {key: max(nbytes[key] / PEAK_BYTES_PER_S, flops[key] / PEAK_F32_FLOPS) * 1e3
                     for key in nbytes}
            f32_ms = {name: next(r["device_ms"] for r in f32[name]["timed"]
                                 if r["shape"][2] == h and r["n"] == n) for name in names}
            log(f"  bf16 times [8,{GROUP_C},{h},{h}] n={n}, L2-cold (call ms / device ms / "
                "spread / plain ms / bound ms / f32 device ms): "
                + " | ".join(f"{name} {t[key]['ms']:.4f} / {t[key]['device_ms']:.4f} / "
                             f"{t[key]['device_spread']:.4f} / {t[key + '_plain']['ms']:.4f} / "
                             f"{bound[key]:.4f} / {f32_ms[name]:.4f}" for name, key in _TIMED))
            for name, key in _TIMED:
                rec = k1_record([8, GROUP_C, h, h], n, t[key], t[f"{key}_plain"], bound[key])
                rec["f32_device_ms"] = f32_ms[name]
                records[name]["timed"].append(rec)
                if (h, n) == (KERNEL_HW[0], 6):
                    records[name].update({f: rec[f] for f in K1_ROW_KEYS + ("f32_device_ms",)})
    worst["stats_rel"] = max(worst["stats_rel"], check_stats_paths(dev, BF16)["paths_rel"])
    for name in names:
        records[name]["max_abs_err"] = worst[name]
    records["branch_stats"]["max_rel_err"] = worst["stats_rel"]
    records["bwd_reduce"]["max_rel_err"] = worst["reduce_rel"]
    for name, key in (("apply_mix", "mix_allowance"), ("bwd_dx", "dx_allowance")):
        records[name].update(max_share_differing=worst["share"], max_of_allowance=worst[key])
    log(f"bf16 kernels agree with their plain versions (worst: {worst}; the allowances: "
        "one bf16 ulp, or 2^-21 of the terms' magnitudes)")
    return {name + BF16_SUFFIX: r for name, r in records.items()}


def _bf16_steps(dev, label: str, step_fn, batches: list, do_arch: tuple, want_fn) -> dict:
    """Runs the steps, each with its launches checked against want_fn(i);
    host-clock ms of each and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    total = {name: 0 for name in KERNELS}
    times = []
    for i, (batch, flag) in enumerate(zip(batches, do_arch)):
        reset_counts()
        t0 = time.perf_counter()
        m = step_fn(batch, flag)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(got == want_fn(flag), f"{label} {i}: launched {got}, expected {want_fn(flag)}")
        add_counts(total, got)
        vals = {k: float(m[k]) for k in ("loss", "arch_loss", "grad_norm", "acc") if k in m}
        check(all(np.isfinite(v) for v in vals.values()), f"{label} {i}: {vals}")
        log(f"bf16 {label} {i}: {vals} {times[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    steady = times[1:] or times
    log(f"bf16 {label}: {np.mean(steady):.2f} ms (after the first: "
        f"{[round(x, 2) for x in steady]}; first {times[0]:.2f}), peak memory "
        f"{peak / 2**20:.1f} MiB")
    return dict(launches=total, ms=float(np.mean(steady)), first_ms=times[0],
                peak_mib=peak / 2**20)


def run_bf16_search_path(dev, seed: int) -> dict:
    """The supernet in bf16 at the senas_promise12.yml `searching:`
    geometry: 1 search step with do_arch=False and 3 with, the bf16
    variants' launches held to the model's count and the f32 ones' to 0;
    one step under torch.profiler; the search-eval step on 3 batches, one
    of them profiled."""
    s = load_config(CONFIG)["searching"]
    meta, depth, bs = s["meta_node_num"], s["depth"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed + 21)
    model = _supernet(s, dev, gen, BF16)
    arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"], generator=gen, device=dev)
    state = SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])
    normalize = lambda a: normalize_arch(a, meta)
    loss = build_loss(s["loss"]["name"], s["deep_supervision"])
    step = make_search_step(normalize, loss, grad_clip=s["grad_clip"])
    expect = expected_launches(model, BF16_SUFFIX)
    rng = np.random.RandomState(seed + 21)
    pairs = [tuple(_batches(rng, 2, bs, HW, dev)) for _ in DO_ARCH]
    with torch.no_grad():
        logits = model(pairs[0][0]["image"], normalize(arch), train=False)[0]
    check(logits.dtype == BF16 and all(p.dtype == torch.float32 for p in model.parameters())
          and all(t.dtype == torch.float32 for t in arch.values()),
          f"bf16 supernet: logits {logits.dtype}, weights or arch tables not f32")
    log(f"bf16 search step: batch {bs} train + {bs} val, {HW}x{HW}; expected launches per "
        f"step: do_arch=True {per_step(expect, True)}")
    search = _bf16_steps(dev, "search step", lambda p, d: step(state, p[0], p[1], d), pairs,
                         DO_ARCH, lambda d: per_step(expect, d))
    tb, vb = pairs[-1]
    search["profile"] = profile(lambda: step(state, tb, vb, True),
                                f"one bf16 search step, do_arch, batch {bs}")
    evaluate = make_search_eval_step(model, normalize, loss)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    ev = _bf16_steps(dev, "search-eval batch", lambda b, _: evaluate(arch, b), eval_batches,
                     (None,) * N_BATCHES, lambda _: expect["eval"])
    ev["profile"] = profile(lambda: evaluate(arch, eval_batches[-1]),
                            f"one bf16 search-eval step, batch {bs}")
    return dict(search=search, eval=ev, expect=expect)


def run_bf16_fixed_path(dev, seed: int) -> dict:
    """SenasModel(senas) in bf16 at the `training:` geometry: 1 + 3 train
    steps, one under torch.profiler, and the eval step on 3 batches; the
    fixed model launches none of the kernels."""
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed + 23), BF16)
    state = FixedTrainState.create(model, t["model_optimizer"])
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    evaluate = make_eval_step(model, _fixed_loss(t))
    rng = np.random.RandomState(seed + 23)
    train_batches = _batches(rng, FIXED_STEPS, bs, HW, dev)
    eval_batches = _batches(rng, N_BATCHES, bs, HW, dev)
    none = {name: 0 for name in KERNELS}
    train = _bf16_steps(dev, "fixed train step", lambda b, _: step(state, b), train_batches,
                        (None,) * FIXED_STEPS, lambda _: none)
    train["profile"] = profile(lambda: step(state, train_batches[-1]),
                               f"one bf16 fixed train step, batch {bs}")
    with torch.no_grad():
        logits = model(eval_batches[0]["image"], train=False)[0]
    check(logits.dtype == BF16 and all(p.dtype == torch.float32 for p in model.parameters()),
          f"bf16 fixed model: logits {logits.dtype}, weights not f32")

    def eval_step(batch, _):
        m = evaluate(batch)
        check(m["pred"].dtype == torch.uint8 and tuple(m["pred"].shape) == (bs, HW, HW),
              f"bf16 eval pred {m['pred'].dtype} {tuple(m['pred'].shape)}")
        return m

    ev = _bf16_steps(dev, "fixed eval batch", eval_step, eval_batches, (None,) * N_BATCHES,
                     lambda _: none)
    return dict(train=train, eval=ev)


def _stats_l2(before: dict, a: dict, b: dict) -> float:
    """Relative L2 distance of two states' BN running stats (all of them)."""
    keys = [k for k in b["model"] if k.rsplit(".", 1)[-1] in ("mean", "var")]
    num = sum(float(((a["model"][k] - b["model"][k]).double() ** 2).sum()) for k in keys)
    den = sum(float((b["model"][k].double() ** 2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def _bf16_bound(before: dict, runs: dict, metric_keys, parts) -> dict:
    """The CPU tests' bound with the CPU as the reference: each update (and
    the running stats) of the card's bf16 step lies at most twice as far
    (relative L2) from the CPU's bf16 step as that lies from the CPU's f32
    step, plus 1e-6; each metric (a scalar that sums up the step) within
    twice the CPU's bf16 error of the weight update. The control: the card's
    bf16 step fails phase 7's f32 card-vs-CPU limits against its f32 one."""
    params = [k for k in before["model"] if k.rsplit(".", 1)[-1] not in ("mean", "var")]
    keys = dict(weights=("model", params), arch=("arch", list(before["arch"])))
    out = {}
    for part in parts:
        where, ks = keys[part]
        after = {k: runs[k][1][where] for k in runs}
        gap = _update_rel(before[where], after["card_bf16"], after["cpu_bf16"], ks)
        own = _update_rel(before[where], after["cpu_bf16"], after["cpu_f32"], ks)
        out[part] = (gap, own)
    gap = _stats_l2(before, runs["card_bf16"][1], runs["cpu_bf16"][1])
    own = _stats_l2(before, runs["cpu_bf16"][1], runs["cpu_f32"][1])
    out["bn_stats"] = (gap, own)
    for k in metric_keys:
        a, b = float(runs["card_bf16"][0][k]), float(runs["cpu_bf16"][0][k])
        out[k] = (abs(a - b) / max(abs(b), 1e-30), out["weights"][1])
    for k, (gap, own) in out.items():
        check(gap <= 2 * own + 1e-6, f"bf16 card vs CPU: {k} {gap:.3g} over twice {own:.3g}")
    control_m = _metrics_rel(runs["card_bf16"][0], runs["card_f32"][0], metric_keys)
    control_s = _state_rel(before, runs["card_bf16"][1], runs["card_f32"][1])
    if "arch" not in parts:
        control_s["arch"] = 0.0
    check(not _within(control_m, control_s),
          f"the card's bf16 step lies within phase 7's f32 limits of its f32 step: "
          f"{control_m} {control_s}")
    return dict(bound={k: dict(gap=g, own=o) for k, (g, o) in out.items()},
                control=dict(metrics=control_m, state=control_s))


def bf16_card_vs_cpu(dev, seed: int) -> dict:
    """One search step (do_arch) and one fixed train step from identical
    state at phases 7 and 10's reduced size (depth 3, c 8, 64x64, batch 2),
    in bf16 and in f32, on the card and on the CPU."""
    s = dict(load_config(CONFIG)["searching"], depth=3, init_channels=8)
    meta = s["meta_node_num"]
    gen = torch.Generator().manual_seed(seed + 25)
    model0 = _supernet(s, "cpu", gen).state_dict()
    arch0 = init_arch_params(meta, 3, use_sharing=False, generator=gen, device="cpu")
    tb, vb = _batches(np.random.RandomState(seed + 25), 2, 2, 64, "cpu")
    to_cpu = lambda snap: {k: ({kk: vv.cpu() for kk, vv in v.items()}
                               if k in ("model", "arch") else v) for k, v in snap.items()}

    def search_on(d, dtype):
        model = _supernet(s, d, None, dtype)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        state = SearchTrainState.create(model, {k: v.clone().to(d) for k, v in arch0.items()},
                                        s["model_optimizer"], s["arch_optimizer"])
        m = make_search_step(lambda a: normalize_arch(a, meta), build_loss(s["loss"]["name"]),
                             grad_clip=s["grad_clip"])(
            state, {k: v.to(d) for k, v in tb.items()}, {k: v.to(d) for k, v in vb.items()}, True)
        return {k: v.cpu() for k, v in m.items()}, to_cpu(_snapshot(state))

    t = dict(load_config(CONFIG)["training"], depth=3, init_channels=8)
    fixed0 = _fixed_model(t, "cpu", torch.Generator().manual_seed(seed + 26)).state_dict()
    batch = _batches(np.random.RandomState(seed + 26), 1, 2, 64, "cpu")[0]

    def fixed_on(d, dtype):
        model = _fixed_model(t, d, None, dtype)
        model.load_state_dict({k: v.to(d) for k, v in fixed0.items()})
        state = FixedTrainState.create(model, t["model_optimizer"])
        m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
            state, {k: v.to(d) for k, v in batch.items()})
        return ({k: v.cpu() for k, v in m.items()},
                {"model": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                 "arch": {}})

    out = {}
    for name, run, before, metric_keys, parts in (
            ("search", search_on, {"model": model0, "arch": arch0},
             ("loss", "arch_loss", "grad_norm"), ("weights", "arch")),
            ("fixed", fixed_on, {"model": fixed0, "arch": {}}, ("loss", "grad_norm"),
             ("weights",))):
        runs = {f"{where}_{tag}": run(d, dtype) for where, d in (("cpu", "cpu"), ("card", dev))
                for tag, dtype in (("bf16", BF16), ("f32", None))}
        out[name] = _bf16_bound(before, runs, metric_keys, parts)
        log(f"bf16 {name} step card vs CPU (depth 3, c 8, 64x64, batch 2): "
            + ", ".join(f"{k} {v['gap']:.3g} (twice {v['own']:.3g} allowed)"
                        for k, v in out[name]["bound"].items())
            + f"; control, card bf16 vs f32: {out[name]['control']}")
    return out


def run_bf16_clis(work: str) -> dict:
    """configs/senas/senas_synthetic.yml with `precision: bf16` in both
    sections: search_arc and train_model for one epoch each (in this
    process: the search launches the bf16 kernels and no f32 one), then
    testing_model, in f32, on the train run's best checkpoint."""
    cfg = load_config(RUNNER_CONFIG)
    for section in ("searching", "training"):
        cfg[section]["precision"] = "bf16"
    cfg["searching"]["arch_optimizer"]["betas"] = list(cfg["searching"]["arch_optimizer"]["betas"])
    config = os.path.join(work, "senas_synthetic_bf16.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    log_root = os.path.join(work, "logs")
    reset_counts()
    out = _in_process(search_arc.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    got = counts()
    bf16 = {k: v for k, v in got.items()
            if k.endswith(BF16_SUFFIX) and KERNELS[k]["source"] == EPILOGUE_SOURCE}
    check(all(bf16.values()) and not any(v for k, v in got.items() if k not in bf16),
          f"the bf16 search CLI launched {got}")
    search = _scalars(_run_dir(out))
    out = _in_process(train_model.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    train_dir = _run_dir(out)
    train = _scalars(train_dir)
    check(all(np.isfinite(v) for v in (*search.values(), *train.values())),
          f"bf16 CLI scalars {search} {train}")
    payload = CheckpointManager(os.path.join(train_dir, "ckpt")).restore_raw("best")
    check(all(v.dtype == torch.float32 for v in payload["model"].values()
              if v.is_floating_point()), "the bf16 run's checkpoint holds non-f32 tensors")
    out = _in_process(testing_model.main, "--config", config, "--resume",
                      os.path.join(train_dir, "ckpt"), "--log_root", log_root,
                      "--batch_size", str(cfg["training"]["batch_size"]))
    tested = ast.literal_eval(out.strip().splitlines()[-1])
    check(np.isfinite(tested["dice"]), f"testing_model on the bf16 checkpoint: {tested}")
    log(f"bf16 CLIs: search launches {bf16}, val dice {search['Val/dice']:.4f}; train val dice "
        f"{train['Val/dice']:.4f}; testing_model (f32) on its best checkpoint {tested}")
    return dict(search_launches=bf16, search_val_dice=search["Val/dice"],
                train_val_dice=train["Val/dice"], test=tested)


def run_bf16(dev, seed: int, f32_records: dict) -> dict:
    """Phase 17, timed."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")

    records = check_kernels_bf16(dev, f32_records)
    mark("kernels")
    search = run_bf16_search_path(dev, seed)
    mark("search path")
    fixed = run_bf16_fixed_path(dev, seed)
    mark("fixed path")
    cpu = bf16_card_vs_cpu(dev, seed)
    mark("card vs CPU")
    with tempfile.TemporaryDirectory() as work:
        clis = run_bf16_clis(work)
    mark("CLIs")
    seconds = time.perf_counter() - t0
    log(f"phase 17 (bf16): {seconds:.1f} s (done by: {', '.join(marks)})")
    return dict(records=records, search=search, fixed=fixed, card_vs_cpu=cpu, clis=clis,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 18: the zoo in bf16 and K2 in bf16
# ---------------------------------------------------------------------------

# H100 SXM dense bf16 on the tensor cores (data sheet, at a 700 W limit)
PEAK_BF16_FLOPS = 989e12
# PAN's pyramid-attention and GAU blocks batch-normalise a global pool,
# per channel over the batch: at batch 2, in bf16, two values whose
# difference is rounding noise (the CPU tests measure the JAX package's
# own bf16 step there 0.79 off its f32 one), so the card-vs-CPU step takes
# PAN at batch 4, as tests/test_torch_bf16_zoo.py does
ZOO_BF16_BATCH = {"pan": 4}


def check_norm_convs_bf16(dev, seed: int, f32: dict) -> dict:
    """K2's bf16 kernel against its bf16 twin (the f32 convolutions of the
    same bf16 values, rounded once) at each of K2_SHAPES: equal but on <=
    BF16_SHARE of the elements, each within one bf16 ulp or 2^-21 of its
    sum of |products|; at bench.py's shape timed in turns beside its twin
    and cuDNN's three bf16 convolutions and the cat (the library column),
    with the f32 kernel's time from phase 3 (`f32`) and the bf16 bound."""
    rec = {"timed": []}
    worst = dict(share=0.0, allowance=0.0, abs=0.0)
    for label, (b, c, h, w, n) in K2_SHAPES.items():
        x, ks = _norm_inputs(dev, b, c, h, w, n, seed + 30)
        x, ks = x.to(BF16), [k.to(BF16) for k in ks]
        got = nc.norm_convs(x, *ks)
        want = nc.norm_convs_plain(x, *ks)
        terms = nc.norm_convs_plain(x.float().abs(), *[k.float().abs() for k in ks])
        torch.cuda.synchronize()
        share, allowance, err = _bf16_err(got, want, terms)
        check(tuple(got.shape) == (b, 3 * n, h, w), f"norm_convs bf16 gave {tuple(got.shape)}")
        log(f"  norm_convs bf16 {label} [{b},{c},{h},{w}] N={n}: {share:.3g} of the outputs "
            f"differ from the twin, worst {allowance:.3g} of the allowance, max abs {err:.3g}")
        worst = dict(share=max(worst["share"], share), allowance=max(worst["allowance"], allowance),
                     abs=max(worst["abs"], err))
        if label != "bench":
            continue
        lib_share = float(((_library_norm_convs(x, ks) != want).double().mean()))
        del got, want, terms
        t = {"kernel": [], "plain": [], "library": []}
        calls = dict(kernel=lambda: nc.norm_convs(x, *ks),
                     plain=lambda: nc.norm_convs_plain(x, *ks),
                     library=lambda: _library_norm_convs(x, ks))
        turns = ("kernel", "plain", "library", "library", "plain", "kernel")
        for which in turns:
            t[which].append(time_ms(calls[which]))
        ms = {k: float(np.mean(v)) for k, v in t.items()}
        flops = nc.flops(x.shape, n)
        op_ms = flops / PEAK_BF16_FLOPS * 1e3
        byte_ms = nc.nbytes(x.shape, n, itemsize=2) / PEAK_BYTES_PER_S * 1e3
        bound = max(op_ms, byte_ms)
        log(f"  norm_convs bf16 times at bench.py's shape (ms, in turns {','.join(turns)}): "
            f"{t}; f32 kernel {f32['ms']:.4f} (phase 3); bound {bound:.4f} (operations "
            f"{op_ms:.4f}: {flops / 1e9:.2f} GFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16; "
            f"bytes {byte_ms:.4f}: {nc.nbytes(x.shape, n, itemsize=2) / 1e6:.1f} MB at "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s); kernel at {flops / ms['kernel'] / 1e9:.2f} "
            f"TFLOP/s, {bound / ms['kernel']:.3f} of its bound; cuDNN bf16 differs from the "
            f"twin on {lib_share:.3g} of the outputs")
        rec.update(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound, bytes_bound_ms=byte_ms, f32_ms=f32["ms"],
                   library_share_differing=lib_share, shape=[b, c, h, w], n=n,
                   tflops=flops / ms["kernel"] / 1e9)
        rec["timed"].append(dict(shape=[b, c, h, w], n=n, bound_ms=bound,
                                 **{f"{k}_in_turns": v for k, v in t.items()}))
    rec.update(max_abs_err=worst["abs"], max_share_differing=worst["share"],
               max_allowance_used=worst["allowance"])
    return rec


def zoo_bf16_card_vs_cpu(dev, seed: int) -> dict:
    """Each zoo model's train step from one state at phase 16's reduced
    sizes, in bf16 and in f32, on the card (TF32 off) and on the CPU, one
    CPU dropout generator for both: the card's bf16 step is held to the
    CPU's bf16 step as the CPU tests hold the port to the JAX package (at
    most twice the CPU's own bf16-vs-f32 distance, `_bf16_bound`'s rule);
    the control: the card's bf16 step lies outside phase 16's f32 card-vs-CPU
    limits of its own f32 step."""
    t = load_config(CONFIG)["training"]
    f32_limits = ZOO_CPU_LIMITS["float32"]
    rows = {}
    for name in ZOO_MODELS:
        depth, hw = ZOO_SMALL.get(name, ZOO_SMALL_DEFAULT)
        bs = ZOO_BF16_BATCH.get(name, 2)
        state0 = _zoo_model(name, depth, "cpu",
                            torch.Generator().manual_seed(seed + 31)).state_dict()
        batch = _batches(np.random.RandomState(seed + 31), 1, bs, hw, "cpu")[0]

        def run_on(d, dtype):
            model = _zoo_model(name, depth, d, None, dtype)
            model.load_state_dict({k: v.to(d) for k, v in state0.items()})
            state = FixedTrainState.create(model, t["model_optimizer"], seed=seed,
                                           rng=torch.Generator())
            m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                state, {k: v.to(d) for k, v in batch.items()})
            return ({k: m[k].cpu() for k in ("loss", "grad_norm")},
                    {"model": {k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()}, "arch": {}})

        runs = {f"{where}_{tag}": run_on(d, dtype) for where, d in (("cpu", "cpu"), ("card", dev))
                for tag, dtype in (("bf16", BF16), ("f32", None))}
        before = {"model": state0, "arch": {}}
        params = [k for k in state0 if k.rsplit(".", 1)[-1] not in ("mean", "var")]
        after = {k: r[1]["model"] for k, r in runs.items()}
        gap = _update_rel(state0, after["card_bf16"], after["cpu_bf16"], params)
        own = _update_rel(state0, after["cpu_bf16"], after["cpu_f32"], params)
        bound = {"weights": (gap, own),
                 "bn_stats": (_stats_l2(before, runs["card_bf16"][1], runs["cpu_bf16"][1]),
                              _stats_l2(before, runs["cpu_bf16"][1], runs["cpu_f32"][1]))}
        for k in ("loss", "grad_norm"):
            a, b = float(runs["card_bf16"][0][k]), float(runs["cpu_bf16"][0][k])
            bound[k] = (abs(a - b) / max(abs(b), 1e-30), own)
        for k, (g, o) in bound.items():
            check(g <= 2 * o + 1e-6, f"bf16 {name} step card vs CPU: {k} {g:.3g} over twice "
                                     f"{o:.3g}")
        control = dict(**_metrics_rel(runs["card_bf16"][0], runs["card_f32"][0],
                                      ("loss", "grad_norm")),
                       weights=_update_rel(state0, after["card_bf16"], after["card_f32"], params))
        check(any(control[k] > f32_limits[k] for k in ("loss", "grad_norm", "weights")),
              f"bf16 {name}: the card's bf16 step lies within phase 16's f32 limits of its f32 "
              f"step: {control}")
        rows[name] = dict(bound={k: dict(gap=g, own=o) for k, (g, o) in bound.items()},
                          control=control, batch=bs)
        log(f"bf16 zoo {name} step card vs CPU (depth {depth}, {hw}x{hw}, batch {bs}): "
            + ", ".join(f"{k} {g:.3g} (at most twice {o:.3g})" for k, (g, o) in bound.items())
            + f"; control, card bf16 vs f32: {control}")
    return rows


def run_bf16_zoo_clis(work: str) -> dict:
    """senas_synthetic.yml with `precision: bf16` under `training:`:
    train_model --model unet and --model fpn for one epoch each (their
    checkpoints hold f32 only), then testing_model --model unet (f32) on
    the unet run's checkpoint."""
    cfg = load_config(RUNNER_CONFIG)
    cfg["training"]["precision"] = "bf16"
    cfg["searching"]["arch_optimizer"]["betas"] = list(cfg["searching"]["arch_optimizer"]["betas"])
    config = os.path.join(work, "senas_synthetic_bf16.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    log_root = os.path.join(work, "logs")
    out = {}
    for name in ("unet", "fpn"):
        stdout = _in_process(train_model.main, "--config", config, "--model", name, "--epoch",
                             "1", "--log_root", log_root)
        run_dir = _run_dir(stdout)
        scalars = _scalars(run_dir)
        check(all(np.isfinite(v) for v in scalars.values()), f"bf16 {name} scalars {scalars}")
        payload = CheckpointManager(os.path.join(run_dir, "ckpt")).restore_raw("last")
        check(all(v.dtype == torch.float32 for v in payload["model"].values()
                  if v.is_floating_point()), f"the bf16 {name} checkpoint holds non-f32 tensors")
        out[name] = dict(val_dice=scalars["Val/dice"], run_dir=run_dir)
    stdout = _in_process(testing_model.main, "--config", config, "--model", "unet", "--resume",
                         os.path.join(out["unet"]["run_dir"], "ckpt"), "--log_root", log_root,
                         "--batch_size", str(cfg["training"]["batch_size"]))
    tested = ast.literal_eval(stdout.strip().splitlines()[-1])
    check(np.isfinite(tested["dice"]), f"testing_model on the bf16 unet checkpoint: {tested}")
    log(f"bf16 zoo CLIs: unet val dice {out['unet']['val_dice']:.4f}, fpn val dice "
        f"{out['fpn']['val_dice']:.4f}; testing_model --model unet (f32) on the bf16 "
        f"checkpoint {tested}")
    return dict(unet_val_dice=out["unet"]["val_dice"], fpn_val_dice=out["fpn"]["val_dice"],
                test=tested)


def run_bf16_smp_losses(dev, seed: int) -> dict:
    """The six smp_* losses on one batch of full-size bf16 logits (12 x 256
    x 256 x 2), card against CPU: each value within twice the CPU's own
    bf16-vs-f32 distance of the CPU's bf16 value; the input gradient (but
    Lovasz's, which follows the order of its sorted errors) the same, in
    relative L2."""
    rs = np.random.RandomState(seed + 32)
    logits = torch.from_numpy(rs.randn(12, HW, HW, NCLASS).astype(np.float32)).to(BF16)
    labels = torch.from_numpy((rs.rand(12, HW, HW) > 0.7).astype(np.int64))
    l2 = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))
    out = {}
    for name in SMP_LOSSES:
        fn = build_loss(name)
        res = {}
        for where, d, dt in (("cpu_bf16", "cpu", BF16), ("cpu_f32", "cpu", torch.float32),
                             ("card_bf16", dev, BF16)):
            x = logits.to(d, dt).clone().requires_grad_()
            v = fn([x], labels.to(d))
            v.backward()
            check(v.dtype == dt, f"{name} on {where}: loss {v.dtype}")
            res[where] = (v.detach().double().cpu(), x.grad.double().cpu())
        own = abs(float(res["cpu_bf16"][0] - res["cpu_f32"][0])) / abs(float(res["cpu_f32"][0]))
        gap = abs(float(res["card_bf16"][0] - res["cpu_bf16"][0])) / abs(float(res["cpu_bf16"][0]))
        check(gap <= 2 * own + 1e-6, f"bf16 {name}, card vs CPU: {gap:.3g} over twice {own:.3g}")
        grad_gap = l2(res["card_bf16"][1], res["cpu_bf16"][1])
        grad_own = l2(res["cpu_bf16"][1], res["cpu_f32"][1])
        if name != "smp_lovasz":
            check(grad_gap <= 2 * grad_own + 1e-6, f"bf16 {name} input gradient, card vs CPU: "
                                                    f"{grad_gap:.3g} over twice {grad_own:.3g}")
        xd, ld = logits.to(dev), labels.to(dev)
        ms = time_ms(lambda: fn([xd], ld), reps=10, warmup=2)
        out[name] = dict(value=float(res["card_bf16"][0]), gap=gap, own=own, grad_gap=grad_gap,
                         grad_own=grad_own, ms=ms)
        log(f"bf16 {name} on 12x{HW}x{HW}x{NCLASS} logits: {out[name]['value']:.6f} (CPU "
            f"{float(res['cpu_bf16'][0]):.6f}; card vs CPU {gap:.3g}, at most twice {own:.3g}; "
            f"input gradient {grad_gap:.3g}, at most twice {grad_own:.3g}), {ms:.3f} ms on the card")
    return out


def run_bf16_zoo(dev, seed: int, f32_records: dict, f32_zoo: dict) -> dict:
    """Phase 18, timed: K2 bf16, the nine models in bf16 at phase 16's
    geometry (beside phase 16's f32 numbers, `f32_zoo`), card against CPU,
    the CLIs and the smp losses."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")

    record = check_norm_convs_bf16(dev, seed, f32_records["norm_convs"])
    mark("K2 bf16")
    path = run_zoo_path(dev, seed, BF16)
    path.pop("unet_state")
    for name, row in path["models"].items():
        f32 = f32_zoo["models"][name]
        log(f"bf16 zoo {name} beside f32: {row['step_ms']:.2f} ms/step (f32 {f32['step_ms']:.2f}), "
            f"eval {row['eval_ms']:.2f} ms/batch (f32 {f32['eval_ms']:.2f}), peak "
            f"{row['peak_mib']:.1f} MiB (f32 {f32['peak_mib']:.1f}), logits {row['out_dtype']}")
    mark("the nine models")
    cpu = zoo_bf16_card_vs_cpu(dev, seed)
    mark("card vs CPU")
    with tempfile.TemporaryDirectory() as work:
        clis = run_bf16_zoo_clis(work)
    mark("CLIs")
    losses = run_bf16_smp_losses(dev, seed)
    mark("smp losses")
    seconds = time.perf_counter() - t0
    log(f"phase 18 (the zoo in bf16, K2 in bf16): {seconds:.1f} s (done by: {', '.join(marks)})")
    return dict(record=record, path=path, card_vs_cpu=cpu, clis=clis, losses=losses,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 19: the SENAS_PALLAS_BN path, remat and the config keys
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def pallas_bn(on: bool):
    """SENAS_PALLAS_BN at "1" (on) or "0" inside; the process's value
    restored after, so that no other phase runs with the gate."""
    kept = os.environ.get("SENAS_PALLAS_BN")
    os.environ["SENAS_PALLAS_BN"] = "1" if on else "0"
    try:
        yield
    finally:
        if kept is None:
            del os.environ["SENAS_PALLAS_BN"]
        else:
            os.environ["SENAS_PALLAS_BN"] = kept


# BatchNorm shapes held beyond the fixed model's own: the 1x1 planes of
# PSPNet's pooled pyramid and DeepLabV3+'s image pool, PSP pool sizes 3 and 6
# (9 and 36, not multiples of the vector width), the encoders' deepest stage
# and a large plane; the last is also the timed shape.
BN_EXTRA_SHAPES = ((2, 64, 1, 1), (2, 64, 3, 3), (2, 64, 6, 6), (2, 512, 8, 8),
                   (12, 32, 256, 256))
BN_TIMED_SHAPE = (12, 32, 256, 256)
BN_PROFILED = 10
BN_MODES = ("kernels", "twins", "off")


@contextlib.contextmanager
def bn_inputs(model):
    """Within it, the shapes of the 4-D inputs that `model`'s BatchNorms are
    called on, in call order, collect in the yielded list."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)) if args[0].dim() == 4 else None)
        for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def _bn_case(dev, shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * (1 + torch.rand(c, generator=g))[:, None, None]
         + 0.3 * torch.randn(c, generator=g)[:, None, None])
    state = {"scale": 0.5 + torch.rand(c, generator=g), "bias": 0.2 * torch.randn(c, generator=g),
             "mean": 0.2 * torch.randn(c, generator=g), "var": 0.5 + torch.rand(c, generator=g)}
    readout = torch.randn(shape, generator=g)
    return (x.to(dev, dtype), {k: v.to(dev) for k, v in state.items()},
            readout.to(dev, dtype))


def _bn_run(x, state, readout, train, dtype, mode):
    """One BatchNorm(dtype) forward and backward from `state` on x: the gate
    on ("kernels"), the gate on with the kernels' plain twins in their
    place ("twins"), or off ("off": F.batch_norm). Returns y and the
    gradients of x, scale and bias, and the running stats after."""
    bn = BatchNorm(x.shape[1], dtype=dtype).to(x.device)
    bn.load_state_dict(state)
    xi = x.detach().clone().requires_grad_()
    with pallas_bn(mode != "off"), (twins_swapped() if mode == "twins"
                                    else contextlib.nullcontext()):
        y = bn(xi, train=train)
        grads = torch.autograd.grad(y, (xi, bn.scale, bn.bias), readout.to(y.dtype))
    return dict(y=y.detach(), dx=grads[0], dscale=grads[1], dbias=grads[2],
                mean=bn.mean.clone(), var=bn.var.clone())


def _bn_f64(x, g, state, train, shift=0.0):
    """BatchNorm's output and the gradients of x and scale for cotangent g,
    in f64, with the batch mean and variance (train mode) moved by `shift`
    times a few f32 ulps of the channel's second moment: d_mu = 2^-20
    sqrt(E[x^2]), d_var = 2^-20 E[x^2]: what the one-sweep variance (against
    the two-pass form) or another summation order may move them by."""
    xd, gd = x.double(), g.double()
    col = lambda t: t.double()[None, :, None, None]
    dims = (0, 2, 3)
    if train:
        m2 = (xd ** 2).mean(dim=dims, keepdim=True)
        mu = xd.mean(dim=dims, keepdim=True) + shift * 2.0 ** -20 * m2.sqrt()
        var = ((xd - xd.mean(dim=dims, keepdim=True)) ** 2).mean(dim=dims, keepdim=True) \
            + shift * 2.0 ** -20 * m2
    else:
        mu, var = col(state["mean"]), col(state["var"])
    inv = (var + 1e-5).rsqrt()
    xhat = (xd - mu) * inv
    y = xhat * col(state["scale"]) + col(state["bias"])
    if train:
        dx = col(state["scale"]) * inv * (gd - gd.mean(dim=dims, keepdim=True)
                                          - xhat * (gd * xhat).mean(dim=dims, keepdim=True))
    else:
        dx = col(state["scale"]) * inv * gd
    return dict(y=y, dx=dx, dscale=(gd * xhat).sum(dim=dims), dbias=gd.sum(dim=dims))


def _bn_allowance(x, g, state, train) -> tuple:
    """Per element of y and of each gradient, how far two f32 evaluations of
    BatchNorm may lie apart: 1e-5 of |y| + 1 (each gradient: 1e-4 of its
    largest magnitude), plus, in train mode, how far the batch stats moved
    by a few f32 ulps (`_bn_f64`) move it. Returns (allowances, the f64
    values)."""
    exact = _bn_f64(x, g, state, train)
    allow = {"y": 1e-5 * (exact["y"].abs() + 1)}
    for k in ("dx", "dscale", "dbias"):
        allow[k] = 1e-4 * exact[k].abs().max().clamp_min(1e-30).expand_as(exact[k])
    if train:
        for shift in (1.0, -1.0):
            moved = _bn_f64(x, g, state, train, shift)
            for k in allow:
                allow[k] = allow[k] + (moved[k] - exact[k]).abs()
    return allow, exact


def check_bn_path(dev, seed: int, shapes) -> dict:
    """BatchNorm with the gate on held, at each shape, train and eval, f32
    and bf16, forward and backward with the running stats, against the same
    path on the kernels' plain twins and against the gate off: f32 outputs
    within `_bn_allowance` of both, and so their gradients; bf16 outputs
    against the twins at the bf16 bound (equal but on max(1, 1e-3 of the
    elements), each within one bf16 ulp or 2^-21 of |y| + 1, plus the
    allowance), bf16 gradients within 2e-2 of the largest magnitude;
    running stats within 1e-5 of their largest magnitude."""
    worst = {"y": 0.0, "y_off": 0.0, "dx": 0.0, "dx_off": 0.0, "stats": 0.0, "bf16_share": 0.0,
             "bf16_grad_rel": 0.0}
    for i, shape in enumerate(shapes):
        for dtype in (torch.float32, BF16):
            for train in (True, False):
                x, state, readout = _bn_case(dev, shape, seed + i, dtype)
                runs = {mode: _bn_run(x, state, readout, train, dtype, mode) for mode in BN_MODES}
                allow, exact = _bn_allowance(x.float(), readout.float(), state, train)
                got = runs["kernels"]
                what = f"BatchNorm {list(shape)} {dtype} train={train}"
                for ref in ("twins", "off"):
                    want = runs[ref]
                    suffix = "" if ref == "twins" else "_off"
                    if dtype == torch.float32:
                        over = {k: ((got[k].double() - want[k].double()).abs() / allow[k]).max()
                                .item() for k in ("y", "dx", "dscale", "dbias")}
                        check(max(over.values()) <= 1.0,
                              f"{what}: against {ref}, parts of the allowance {over}")
                        worst["y" + suffix] = max(worst["y" + suffix], over["y"])
                        worst["dx" + suffix] = max(worst["dx" + suffix],
                                                   over["dx"], over["dscale"], over["dbias"])
                    else:
                        grad = max(rel_err(got[k].float(), want[k].float())
                                   for k in ("dx", "dscale", "dbias"))
                        check(grad <= BF16_GRAD_REL, f"{what}: gradients against {ref} rel "
                                                     f"{grad:.3g}")
                        worst["bf16_grad_rel"] = max(worst["bf16_grad_rel"], grad)
                    stats = max(float((got[k] - want[k]).abs().max()
                                      / want[k].abs().max().clamp_min(1.0)) for k in ("mean", "var"))
                    check(stats <= 1e-5, f"{what}: running stats against {ref}: {stats:.3g}")
                    worst["stats"] = max(worst["stats"], stats)
                if dtype == BF16:
                    diff = (got["y"].double() - runs["twins"]["y"].double()).abs()
                    mag = torch.maximum(got["y"].double().abs(), runs["twins"]["y"].double().abs())
                    ulp = torch.exp2(torch.floor(torch.log2(torch.where(
                        mag > 0, mag, torch.ones_like(mag)))) - 7)
                    terms = exact["y"].abs() + 1
                    n_diff = int((diff > 0).sum())
                    check(n_diff <= max(1, int(BF16_SHARE * diff.numel()))
                          and bool((diff <= torch.maximum(ulp, terms * 2.0 ** -21)
                                    + allow["y"]).all()),
                          f"{what}: {n_diff} of {diff.numel()} bf16 outputs differ from the "
                          f"twins', worst {diff.max().item():.3g}")
                    worst["bf16_share"] = max(worst["bf16_share"], n_diff / diff.numel())
        log(f"  BatchNorm gate on at {list(shape)}: held to its twins and to the gate off "
            f"(worst so far {({k: float(f'{v:.3g}') for k, v in worst.items()})})")
        torch.cuda.empty_cache()
    return worst


# The library call that computes what each K1 kernel computes at n=1: the
# CUDA steps of SyncBatchNorm, each reading and writing the kernel's bytes
# (per-channel operands where the kernel's are per plane)
LIBRARY_N1 = {"branch_stats": "torch.batch_norm_stats", "apply_mix": "torch.batch_norm_elemt",
              "bwd_reduce": "torch.batch_norm_backward_reduce",
              "bwd_dx": "torch.batch_norm_backward_elemt"}


def library_n1_calls(x, state):
    """The four library calls of `LIBRARY_N1` as callables of (x, g), with
    the per-channel operands made here (f32, as SyncBatchNorm keeps them)."""
    c = x.shape[1]
    mean, invstd = torch.batch_norm_stats(x, ge.EPS)
    w, b = state["scale"].float(), state["bias"].float()
    count = torch.full((1,), x.numel() // c, dtype=torch.int32, device=x.device)
    sum_dy, sum_dy_xmu = (0.01 * state["bias"].float() for _ in range(2))
    return {"stats": lambda x, g: torch.batch_norm_stats(x, ge.EPS),
            "mix": lambda x, g: torch.batch_norm_elemt(x, w, b, mean, invstd, ge.EPS),
            "reduce": lambda x, g: torch.batch_norm_backward_reduce(g, x, mean, invstd, w, True,
                                                                    False, False),
            "dx": lambda x, g: torch.batch_norm_backward_elemt(g, x, mean, invstd, w, sum_dy,
                                                               sum_dy_xmu, count)}


def time_bn_kernels(dev, seed: int) -> dict:
    """K1a-K1d at n=1 on BN_TIMED_SHAPE in f32 and bf16, x and g rotated
    over L2-cold copies (`cold_sets`): each kernel's call and device time in
    turns with its library call (kernel, library, library, kernel;
    `LIBRARY_N1`) and with its plain twin, its byte bound; the gated
    BatchNorm's forward and backward (glue included) and F.batch_norm's
    (cuDNN: the whole module); the kernel launches of one forward and one
    backward each way (torch.profiler)."""
    b, c, h, w = BN_TIMED_SHAPE
    out = {}
    for dtype in (torch.float32, BF16):
        e = torch.finfo(dtype).bits // 8
        x, state, g = _bn_case(dev, BN_TIMED_SHAPE, seed, dtype)
        xs = [x]
        a, k = state["scale"][None, None, :].expand(1, b, c).contiguous(), \
            state["bias"][None, :].expand(b, c).contiguous()
        ds = [0.01 * state["bias"][None, None, :].expand(1, b, c).contiguous()] * 2
        n, planes = b * c * h * w, b * c
        nbytes = dict(stats=n * e + 2 * planes * 4, mix=2 * n * e + 2 * planes * 4,
                      reduce=2 * n * e + 2 * planes * 4, dx=3 * n * e + 3 * planes * 4)
        t = k1_times(xs, a, k, g, *ds)
        library = library_n1_calls(x, state)
        sets = cold_sets((x, g))
        for key, kernel in (("stats", lambda x, g: ge.branch_stats([x])),
                            ("mix", lambda x, g: ge.apply_mix([x], a, k)),
                            ("reduce", lambda x, g: ge.bwd_reduce([x], g)),
                            ("dx", lambda x, g: ge.bwd_dx([x], g, a, *ds))):
            got = in_turns_ms({key: kernel, key + "_library": library[key]}, sets)
            t[key + "_library"] = got[key + "_library"]
            t[key + "_with_library"] = got[key]
        modules, launches = {}, {}
        for on in (True, False):
            bn = BatchNorm(c, dtype=dtype).to(dev)
            bn.load_state_dict(state)
            xi = x.detach().clone().requires_grad_()
            with pallas_bn(on):
                fwd = lambda: bn(xi, train=True)
                y = fwd()
                params = (xi, bn.scale, bn.bias)
                bwd = lambda: torch.autograd.grad(y, params, g, retain_graph=True)
                key = "gate" if on else "library"
                modules[f"{key}_fwd"] = time_ms(fwd)
                modules[f"{key}_bwd"] = time_ms(bwd)
                # launches a call: the profiler over BN_PROFILED calls (it may
                # record no device time over a single short call)
                for part, fn in (("fwd", fwd), ("bwd", bwd)):
                    n = profile(lambda: [fn() for _ in range(BN_PROFILED)],
                                f"{BN_PROFILED} BatchNorm {part} calls, gate {on}, "
                                f"{dtype}").get("launches")
                    launches[f"{key}_{part}"] = None if n is None else n / BN_PROFILED
        bound = {key: nb / PEAK_BYTES_PER_S * 1e3 for key, nb in nbytes.items()}
        suffix = "" if dtype == torch.float32 else BF16_SUFFIX
        for name, key in _TIMED:
            pair = "fwd" if key in ("stats", "mix") else "bwd"
            lib, beside = t[key + "_library"], t[key + "_with_library"]
            out[name + suffix] = k1_record(
                BN_TIMED_SHAPE, 1, t[key], t[f"{key}_plain"], bound[key], pass_=pair,
                library=LIBRARY_N1[name], library_ms=lib["device_ms"],
                library_call_ms=lib["ms"], library_readings=lib["device_readings"],
                library_spread=lib["device_spread"],
                device_beside_library=beside["device_readings"],
                pair_ms=t["stats"]["ms"] + t["mix"]["ms"] if pair == "fwd"
                else t["reduce"]["ms"] + t["dx"]["ms"],
                pair_bound_ms=(bound["stats"] + bound["mix"] if pair == "fwd"
                               else bound["reduce"] + bound["dx"]),
                gated_module_ms=modules[f"gate_{pair}"],
                module_library_ms=modules[f"library_{pair}"],
                launches_per_call=dict(gate=launches[f"gate_{pair}"],
                                       library=launches[f"library_{pair}"]))
        log(f"  BatchNorm n=1 at {list(BN_TIMED_SHAPE)} {dtype}, L2-cold (call ms / device ms / "
            "spread / beside the library / plain ms / bound ms / library: device ms, call ms): "
            + " | ".join(f"{name} {t[key]['ms']:.4f} / {t[key]['device_ms']:.4f} / "
                         f"{t[key]['device_spread']:.4f} / "
                         f"{t[key + '_with_library']['device_ms']:.4f} / "
                         f"{t[key + '_plain']['ms']:.4f} / {bound[key]:.4f} / {LIBRARY_N1[name]} "
                         f"{t[key + '_library']['device_ms']:.4f}, "
                         f"{t[key + '_library']['ms']:.4f}" for name, key in _TIMED)
            + f" | gated module fwd {modules['gate_fwd']:.4f} bwd {modules['gate_bwd']:.4f}"
            f" | F.batch_norm fwd {modules['library_fwd']:.4f} bwd {modules['library_bwd']:.4f}"
            f" | launches {launches}")
        torch.cuda.empty_cache()
    return out


def _gate_turns(label, step_fn, bn_count, reps: int = 2) -> dict:
    """Steps with the gate on and off in turns (on, off, off, on), `reps`
    a turn after one warm-up call each way; the wrapper counts of one gated
    step held to `bn_count` (each 4-D BatchNorm: K1a and K1b forward, K1c
    and K1d backward), and the inputs it copied (to NCHW or to f32)
    (`BatchNorm.pallas_copies`); then one step each way under
    torch.profiler."""
    times = {True: [], False: []}
    for on in (True, False):
        with pallas_bn(on):
            step_fn()
    torch.cuda.synchronize()
    for on in (True, False, False, True):
        with pallas_bn(on):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                step_fn()
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) * 1e3 / reps)
    reset_counts()
    copies = BatchNorm.pallas_copies
    with pallas_bn(True):
        step_fn()
    torch.cuda.synchronize()
    copies = BatchNorm.pallas_copies - copies
    got = {k: v for k, v in counts().items() if v}
    by_kernel = {}
    for name, v in got.items():
        by_kernel[name.removesuffix(BF16_SUFFIX)] = by_kernel.get(name.removesuffix(BF16_SUFFIX),
                                                                   0) + v
    check(by_kernel == {name: bn_count for name, _ in _TIMED},
          f"{label}: a gated step launched {got}, expected {bn_count} of each K1 kernel")
    profiles = {}
    for on in (True, False):
        with pallas_bn(on):
            prof = profile(step_fn, f"{label}, gate {'on' if on else 'off'}")
        classes = prof.get("by_class_ms", {})
        prof["bn_class_ms"] = sum(v for c, v in classes.items()
                                  if c == "batch norm" or "(K1" in c)
        profiles["on" if on else "off"] = prof
    log(f"{label}: ms/step gate on {[round(t, 2) for t in times[True]]}, off "
        f"{[round(t, 2) for t in times[False]]} (in turns on, off, off, on); launches of a "
        f"gated step {got}; inputs the gated BatchNorms copied (to NCHW or to f32) {copies}")
    return dict(ms_on=float(np.mean(times[True])), ms_off=float(np.mean(times[False])),
                turns=dict(on=times[True], off=times[False]), launches=got,
                profile=profiles, nchw_copies=copies)


def run_bn_gate_steps(dev, seed: int) -> dict:
    """The promise12-fixed-train step (f32), the same in bf16 and the zoo's
    unet step in bf16, each with the gate on and off in turns."""
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    batch = _batches(np.random.RandomState(seed + 19), 1, bs, HW, dev)[0]
    out, total = {}, {name: 0 for name in KERNELS}
    for label, make in (
            ("fixed f32", lambda g: _fixed_model(t, dev, g)),
            ("fixed bf16", lambda g: _fixed_model(t, dev, g, BF16)),
            ("unet bf16", lambda g: _zoo_model("unet", t["depth"], dev, g, BF16))):
        model = make(torch.Generator().manual_seed(seed + 19))
        state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
        step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
        with bn_inputs(model) as seen, pallas_bn(False):
            step(state, batch)
        out[label] = _gate_turns(f"{label} step, batch {bs}", lambda: step(state, batch),
                                 len(seen))
        out[label]["bn_calls"] = len(seen)
        out[label]["bn_shapes"] = sorted(set(seen))
        add_counts(total, {k: out[label]["launches"].get(k, 0) for k in KERNELS})
        del model, state, step
        torch.cuda.empty_cache()
    return dict(steps=out, launches=total)


# the six optimizers of the port beyond sgd and adam, one fixed step each
OTHER_OPTIMIZERS = {
    "adamax": {"name": "adamax", "lr": 2e-3, "weight_decay": 5e-4},
    "adadelta": {"name": "adadelta", "lr": 1.0, "rho": 0.9, "weight_decay": 5e-4},
    "adagrad": {"name": "adagrad", "lr": 1e-2, "weight_decay": 5e-4},
    "rmsprop": {"name": "rmsprop", "lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-4},
    "asgd": {"name": "asgd", "lr": 6e-3, "weight_decay": 5e-4},
    "adabound": {"name": "adabound", "lr": 1e-3, "weight_decay": 5e-4},
}


@contextlib.contextmanager
def module_outputs(model, forced=None):
    """Within it, every tensor that a module of `model` returns is kept, in
    call order, in the yielded list (on the CPU); with `forced` (such a list
    from another run) each is replaced by the forced value, exactly, with
    the gradient passing through the module's own output."""
    seen, hooks = [], []

    def hook(mod, args, out):
        if not torch.is_tensor(out) or not out.is_floating_point():
            return None
        seen.append(out.detach().cpu().clone())
        if forced is None:
            return None
        want = forced[len(seen) - 1].to(out.device, out.dtype)
        return out - out.detach() + want

    hooks = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def split_step_card_vs_cpu(dev, seed: int, optimizers=None) -> dict:
    """One fixed train step (phase 7's: depth 3, c 8, 64x64, batch 2) on the
    card and on the CPU from identical state, held to CARD_CPU_LIMITS in
    three parts, since the step's gradients are discontinuous at that
    scale: an input of a ReLU or a max pool that lies within rounding of a
    kink sends a whole gradient element another way. (The gated BatchNorm's
    one-sweep variance moves the forward by ~1e-6, which at this seed flips
    such a kink: the gradients jump by 1.3e-3, as the CPU's own do when one
    BatchNorm output moves by 1e-6 noise. An adaptive optimizer's first
    step, lr g/|g| on gradients at rounding level, does the same to the
    update.)
    - forward: the loss and the running stats, card against the CPU's step;
    - gradients: their norm and their relative difference (as the weights'
      update is measured), card against the CPU's step with its forward
      forced to the card's module outputs (`module_outputs`), so that both
      take every kink the same way;
    - update: the weights after the card's step against the CPU's
      optimizer stepped from the same state on the card's gradients, for
      the config's optimizer and for each of `optimizers` (name -> config:
      the card's step once more with it; the forward and the gradients of
      a first step do not depend on it).
    Returns the parts' numbers and the plain comparison's."""
    t = dict(load_config(CONFIG)["training"], depth=3, init_channels=8)
    model0 = _fixed_model(t, "cpu", torch.Generator().manual_seed(seed + 5)).state_dict()
    batch = _batches(np.random.RandomState(seed + 5), 1, 2, 64, "cpu")[0]
    before = {"model": {k: v.clone() for k, v in model0.items()}, "arch": {}}
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}

    def run_on(d, opt_cfg, forced=None):
        model = _fixed_model(t, d, None)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        state = FixedTrainState.create(model, opt_cfg)
        names = {id(p): k for k, p in model.named_parameters()}
        grads = {}
        state.opt.register_step_pre_hook(lambda opt, args, kw: grads.update(
            {names[id(p)]: p.grad.detach().cpu().clone() for g in opt.param_groups
             for p in g["params"]}))
        with module_outputs(model, forced) as seen:
            m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                state, {k: v.to(d) for k, v in batch.items()})
        return cpu(m), {"model": cpu(model.state_dict()), "arch": {}}, grads, seen

    def update_rel(opt_cfg, after_card, g_card):
        """The card's update against the CPU's optimizer on g_card."""
        model = _fixed_model(t, "cpu", None)
        model.load_state_dict(model0)
        opt = build_optimizer(list(model.parameters()), opt_cfg)
        for k, p in model.named_parameters():
            p.grad = g_card[k]
        opt.step()
        return _state_rel(before, after_card, {"model": cpu(model.state_dict()),
                                               "arch": {}})["weights"]

    m_card, after_card, g_card, seen = run_on(dev, t["model_optimizer"])
    m_cpu, after_cpu, _, _ = run_on("cpu", t["model_optimizer"])
    m_forced, _, g_forced, _ = run_on("cpu", t["model_optimizer"], forced=seen)
    forward = _metrics_rel(m_card, m_cpu, ("loss",))
    forward["bn_stats"] = _state_rel(before, after_card, after_cpu)["bn_stats"]
    grads = _metrics_rel(m_card, m_forced, ("grad_norm",))
    grads["weights"] = _update_rel({k: torch.zeros_like(v) for k, v in g_forced.items()},
                                   g_card, g_forced, list(g_forced))
    update = {t["model_optimizer"]["name"]: update_rel(t["model_optimizer"], after_card, g_card)}
    for name, opt_cfg in (optimizers or {}).items():
        _, after, g, _ = run_on(dev, opt_cfg)
        update[name] = update_rel(opt_cfg, after, g)
    plain = dict(metrics=_metrics_rel(m_card, m_cpu, ("loss", "grad_norm")),
                 state=_state_rel(before, after_card, after_cpu))
    return dict(forward=forward, grads=grads, update=update, plain=plain)


def run_config_keys_card_vs_cpu(dev, seed: int) -> dict:
    """`split_step_card_vs_cpu` with the gate on (the kernels on the card,
    their twins on the CPU), and with it off for the updates of the six
    other optimizers, each part held to CARD_CPU_LIMITS (metrics: loss,
    grad_norm; weights: the gradients and each update; bn_stats); then the
    gated step with TF32 on, which the limits must catch."""
    lim = CARD_CPU_LIMITS
    within = lambda r: (r["forward"]["loss"] <= lim["metrics"]
                        and r["forward"]["bn_stats"] <= lim["bn_stats"]
                        and r["grads"]["grad_norm"] <= lim["metrics"]
                        and r["grads"]["weights"] <= lim["weights"]
                        and max(r["update"].values()) <= lim["weights"])
    out = {}
    with pallas_bn(True):
        out["pallas_bn"] = split_step_card_vs_cpu(dev, seed)
    out["optimizers"] = split_step_card_vs_cpu(dev, seed, OTHER_OPTIMIZERS)
    for name, r in out.items():
        log(f"  fixed step card vs CPU ({name}): forward {r['forward']}, gradients (forward "
            f"forced) {r['grads']}, updates on the card's gradients {r['update']}; the plain "
            f"comparison {r['plain']}")
        check(within(r), f"card and CPU fixed steps disagree ({name}): {r} (limits {lim})")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pallas_bn(True):
            tf32 = split_step_card_vs_cpu(dev, seed)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  the same with the gate on and TF32 on: forward {tf32['forward']}, gradients "
        f"{tf32['grads']}, update {tf32['update']}")
    check(not within(tf32), "the split card-vs-CPU limits let a step with TF32 on pass")
    out["pallas_bn_tf32"] = tf32
    return out


def _remat_pair(build, step_fn, batches, want_fn, reps: int = 2) -> dict:
    """For remat off and on: a state from `build(remat)` and its steps
    (the first a warm-up), host-clock ms/step, the peak memory, and the
    launches of the `reps` timed steps held to want_fn(state, remat)."""
    out = {}
    for remat in (False, True):
        state = build(remat)
        step_fn(state, batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times = []
        for batch in batches[1:reps + 1]:
            t0 = time.perf_counter()
            m = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(float(m["loss"])), f"remat={remat} step: loss {float(m['loss'])}")
        got, want = counts(), want_fn(state, remat)
        check(got == want, f"{reps} steps with remat={remat} launched {got}, expected {want}")
        out[remat] = dict(ms=float(np.mean(times)), peak_mib=torch.cuda.max_memory_allocated()
                          / 2**20, launches=got)
        del state
        torch.cuda.empty_cache()
    return out


def run_remat(dev, seed: int) -> dict:
    """remat at full width: the search step (do_arch) and the fixed step,
    off then on, ms/step and peak memory (the search step's kernel launches
    held to the count with the recompute: K1a and K1b twice a pass); at
    phase 7's reduced size under cuDNN's deterministic algorithms, the
    search and fixed steps with remat on against off, three runs off and
    two on in turns: the forward (loss, arch loss, running stats) equal to
    1e-6, the gradient norm, weights and arch tables within phase 7's
    limits (CARD_CPU_LIMITS), beside the spread of the runs with it off.
    The card's max-pool and bilinear-upsampling backwards add with
    atomics, so the weights differ run to run (~5e-6 of their update) with
    or without remat; on the CPU the steps are equal."""
    s = load_config(CONFIG)["searching"]
    t = load_config(CONFIG)["training"]
    rng = np.random.RandomState(seed + 21)
    sb = [(tb, vb) for tb, vb in zip(*[iter(_batches(rng, 6, s["batch_size"], HW, dev))] * 2)]
    fb = _batches(rng, 3, t["batch_size"], HW, dev)
    meta, depth = s["meta_node_num"], s["depth"]

    def build_search(remat):
        gen = torch.Generator().manual_seed(seed + 21)
        model = _supernet(s, dev, gen, remat=remat)
        arch = init_arch_params(meta, depth, use_sharing=s["sharing_normal"], generator=gen,
                                device=dev)
        return SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])

    search_step = make_search_step(lambda a: normalize_arch(a, meta),
                                   build_loss(s["loss"]["name"]), grad_clip=s["grad_clip"])
    search = _remat_pair(build_search, lambda st, b: search_step(st, *b, True), sb,
                         lambda st, remat: {name: 2 * v for name, v in per_step(
                             expected_launches(st.model), True, remat).items()})
    fixed_step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    fixed = _remat_pair(lambda remat: FixedTrainState.create(
        _fixed_model(t, dev, torch.Generator().manual_seed(seed + 22), remat=remat),
        t["model_optimizer"]), fixed_step, fb, lambda st, remat: {name: 0 for name in KERNELS})
    for label, pair in (("search step (do_arch)", search), ("fixed step", fixed)):
        log(f"remat {label} at full width: off {pair[False]['ms']:.2f} ms/step, peak "
            f"{pair[False]['peak_mib']:.1f} MiB; on {pair[True]['ms']:.2f} ms/step, peak "
            f"{pair[True]['peak_mib']:.1f} MiB")

    # reduced size: the same step with remat off and on in turns (off, on,
    # off, on, off), deterministic cuDNN
    rs = dict(s, depth=3, init_channels=8)
    rt = dict(t, depth=3, init_channels=8)
    gen = torch.Generator().manual_seed(seed + 23)
    s0 = _supernet(rs, "cpu", gen).state_dict()
    arch0 = init_arch_params(rs["meta_node_num"], 3, use_sharing=False, generator=gen, device="cpu")
    f0 = _fixed_model(rt, "cpu", gen).state_dict()
    tb, vb = _batches(np.random.RandomState(seed + 23), 2, 2, 64, dev)

    def search_run(remat):
        model = _supernet(rs, dev, None, remat=remat)
        model.load_state_dict({k: v.to(dev) for k, v in s0.items()})
        state = SearchTrainState.create(model, {k: v.clone().to(dev) for k, v in arch0.items()},
                                        rs["model_optimizer"], rs["arch_optimizer"])
        before = _snapshot(state)
        m = search_step(state, tb, vb, True)
        return before, {k: v.cpu() for k, v in m.items()}, _snapshot(state)

    def fixed_run(remat):
        model = _fixed_model(rt, dev, None, remat=remat)
        model.load_state_dict({k: v.to(dev) for k, v in f0.items()})
        state = FixedTrainState.create(model, rt["model_optimizer"])
        snap = lambda: {"model": {k: v.clone() for k, v in model.state_dict().items()}, "arch": {}}
        before = snap()
        m = fixed_step(state, tb)
        return before, {k: v.cpu() for k, v in m.items()}, snap()

    equal = {}
    with deterministic_cudnn():
        for label, run, keys in (("search", search_run, ("loss", "arch_loss", "grad_norm")),
                                 ("fixed", fixed_run, ("loss", "grad_norm"))):
            runs = [(remat, run(remat)) for remat in (False, True, False, True, False)]
            dist = lambda a, b: {**_metrics_rel(a[1], b[1], keys),
                                 **_state_rel(b[0], a[2], b[2])}
            pairs = lambda x, y: [dist(a, b) for i, (ra, a) in enumerate(runs)
                                  for j, (rb, b) in enumerate(runs)
                                  if i < j and (ra, rb) in ((x, y), (y, x))]
            worst = lambda ds: {k: max(d[k] for d in ds) for k in ds[0]}
            equal[label] = dict(on_vs_off=worst(pairs(True, False)),
                                off_vs_off=worst(pairs(False, False)))
    for label, r in equal.items():
        log(f"  {label} step, remat on vs off (depth 3, c 8, 64x64, batch 2, deterministic "
            f"cuDNN; the largest of 6 pairs): {r['on_vs_off']}; off vs off, the card's own "
            f"spread (3 pairs): {r['off_vs_off']}")
        on, lim = r["on_vs_off"], CARD_CPU_LIMITS
        check(all(on[k] <= 1e-6 for k in ("loss", "arch_loss", "bn_stats") if k in on)
              and on["grad_norm"] <= lim["metrics"] and on["weights"] <= lim["weights"]
              and on["arch"] <= lim["arch"],
              f"{label} step: remat on and off differ: {r} (the forward within 1e-6, the "
              f"rest within {lim})")
    return dict(search=search, fixed=fixed, equal=equal)


def run_config_clis(work: str) -> dict:
    """configs/senas/senas_synthetic.yml with the keys the port used to
    refuse, through the CLIs in this process: search_arc for one epoch with
    `beta_mode: grouped`, `multi_gpus: true`, `mesh_spatial: 2` and
    `arch_optimizer: adabound`, then train_model for one epoch with
    `remat: true` and `model_optimizer: rmsprop`."""
    cfg = load_config(RUNNER_CONFIG)
    cfg["searching"].update(beta_mode="grouped", multi_gpus=True, mesh_spatial=2)
    cfg["searching"]["arch_optimizer"] = dict(cfg["searching"]["arch_optimizer"],
                                              name="adabound")
    cfg["searching"]["arch_optimizer"]["betas"] = list(cfg["searching"]["arch_optimizer"]["betas"])
    cfg["training"]["remat"] = True
    cfg["training"]["model_optimizer"] = dict(cfg["training"]["model_optimizer"],
                                              name="rmsprop", lr=1e-3)
    config = os.path.join(work, "senas_synthetic_keys.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    log_root = os.path.join(work, "logs")
    out = _in_process(search_arc.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    search_dir = _run_dir(out)
    genotype = parse_genotype(out.split("best genotype: ")[1].strip())
    with open(os.path.join(search_dir, "run.log")) as f:
        text = f.read()
    check("beta_mode = grouped" in text and "only 1 device visible" in text,
          "the search run's log lacks its beta_mode or multi_gpus line")
    out = _in_process(train_model.main, "--config", config, "--epoch", "1", "--log_root", log_root)
    train = _scalars(_run_dir(out))
    search = _scalars(search_dir)
    check(all(np.isfinite(v) for v in (*search.values(), *train.values())),
          f"config-key CLI scalars {search} {train}")
    log(f"config-key CLIs: search val dice {search['Val/dice']:.4f}, genotype {genotype!r}; "
        f"train (remat, rmsprop) val dice {train['Val/dice']:.4f}")
    return dict(search_val_dice=search["Val/dice"], train_val_dice=train["Val/dice"],
                genotype=repr(genotype))


def run_config_keys(dev, seed: int) -> dict:
    """Phase 19, timed: the gated BatchNorm path's checks and times, the
    gate on and off in three steps, card against CPU (gate, optimizers),
    remat and the CLIs."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")
        log(f"phase 19: {marks[-1]}")

    t = load_config(CONFIG)["training"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed + 18))
    batch = _batches(np.random.RandomState(seed + 18), 1, t["batch_size"], HW, dev)[0]
    with bn_inputs(model) as seen, torch.no_grad():
        model(batch["image"], train=True)
    shapes = sorted(set(seen)) + [s for s in BN_EXTRA_SHAPES if s not in seen]
    del model
    log(f"BatchNorm shapes held: {len(shapes)} ({len(set(seen))} of the fixed model's "
        f"{len(seen)} calls) + {list(BN_EXTRA_SHAPES)}")
    worst = check_bn_path(dev, seed, shapes)
    mark("BN checks")
    timed = time_bn_kernels(dev, seed)
    mark("BN times")
    steps = run_bn_gate_steps(dev, seed)
    mark("gate on/off steps")
    card_cpu = run_config_keys_card_vs_cpu(dev, seed)
    mark("card vs CPU")
    remat = run_remat(dev, seed)
    mark("remat")
    with tempfile.TemporaryDirectory() as work:
        clis = run_config_clis(work)
    mark("CLIs")
    seconds = time.perf_counter() - t0
    log(f"phase 19 (config keys, SENAS_PALLAS_BN, remat): {seconds:.1f} s ({', '.join(marks)})")
    return dict(checks=worst, timed=timed, steps=steps["steps"], launches=steps["launches"],
                card_vs_cpu=card_cpu, remat=remat, clis=clis, seconds=seconds,
                bn_shapes=[list(s) for s in shapes])


# ---------------------------------------------------------------------------
# Phase 20: the encoder families
# ---------------------------------------------------------------------------

# one encoder of each class of models/encoders_{extra,families,mnv3,resnest}.py
FAMILY_NAMES = ("vgg13_bn", "densenet121", "mobilenet_v2", "efficientnet-b0",
                "se_resnext50_32x4d", "xception", "inceptionv4", "inceptionresnetv2", "dpn68",
                "timm-mobilenetv3_large_100", "timm-resnest14d")
# the card-vs-CPU step: depth 5, batch 2, 64x64
FAMILY_SMALL_HW = 64
# the gated BatchNorm's steps (SENAS_PALLAS_BN=1 against off, in turns)
FAMILY_GATED = ("timm-resnest14d", "dpn68")
# the card-vs-CPU steps: every family but the Inceptions and Xception, whose
# CPU steps in f64 and f32 took 33.2 of the 70 s of this check (NVIDIA H100
# 80GB HBM3, 700 W); the CPU tests hold all eleven to senas_tpu, and the
# full-width steps run them on the card
FAMILY_CARD_CPU = tuple(n for n in FAMILY_NAMES
                        if n not in ("xception", "inceptionv4", "inceptionresnetv2"))
FAMILY_DEEPLAB = "efficientnet-b0"


def _family_unet(name, dev, gen, dtype=None, depth=5):
    """A Unet on the encoder `name` at the promise12 `training:` decoder
    widths (256, 128, 64, 32, 16)[:depth]."""
    return zoo.Unet(classes=NCLASS, in_channels=IN_CHANNELS, encoder_name=name,
                    encoder_depth=depth, decoder_channels=(256, 128, 64, 32, 16)[:depth],
                    dtype=dtype, device=dev, generator=gen)


def device_launches(fn) -> int:
    """The device kernels one call of fn() launches (torch.profiler, CUDA
    activity only), after one warm-up call; -1 where the profiler records
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    return n if n else -1


def run_family_steps(dev, seed: int, names=None) -> dict:
    """A Unet on each encoder of `names` at the promise12 `training:`
    geometry (batch 12 of 256x256x1, depth 5, SGD 6e-3 / 0.9 / 5e-4, clip 5,
    dice_ce), 1 + 3 train steps in f32 (TF32 off) and in bf16: ms/step,
    peak memory and device launches a step; finite losses and logits of the
    right shape and dtype; no port kernel launched (the BatchNorm gate is
    off). `names` None: FAMILY_NAMES."""
    names = names or FAMILY_NAMES
    t = load_config(CONFIG)["training"]
    bs, loss_fn = t["batch_size"], _fixed_loss(t)
    batches = _batches(np.random.RandomState(seed + 20), FIXED_STEPS, bs, HW, dev)
    reset_counts()
    rows = {}
    for name in names:
        for tag, dtype in (("f32", None), ("bf16", BF16)):
            model = _family_unet(name, dev, torch.Generator().manual_seed(seed + 20), dtype)
            state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
            step = make_train_step(loss_fn, grad_clip=t["grad_clip"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                m = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
                check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
                      f"{tag} unet on {name} step {i}: loss {losses[-1]}")
            peak = torch.cuda.max_memory_allocated()
            launches = device_launches(lambda: step(state, batches[-1]))
            with torch.inference_mode():
                out = model(batches[0]["image"], train=False)[0]
            want = torch.float32 if dtype is None else dtype
            check(tuple(out.shape) == (bs, HW, HW, NCLASS) and out.dtype == want
                  and bool(torch.isfinite(out).all())
                  and all(p.dtype == torch.float32 for p in model.parameters()),
                  f"{tag} unet on {name}: logits {tuple(out.shape)} {out.dtype}")
            row = dict(step_ms=float(np.mean(times[1:])), first_ms=times[0],
                       peak_mib=peak / 2**20, launches_per_step=launches, losses=losses,
                       parameters=sum(p.numel() for p in model.parameters()))
            rows.setdefault(name, {})[tag] = row
            log(f"{tag} unet on {name} ({row['parameters']} parameters, batch {bs}, {HW}x{HW}): "
                f"{row['step_ms']:.2f} ms/step (first {times[0]:.1f}), peak "
                f"{row['peak_mib']:.1f} MiB, {launches} device launches a step, loss "
                f"{losses[0]:.5f} -> {losses[-1]:.5f}")
            del model, state, step, out
            torch.cuda.empty_cache()
    got = counts()
    check(not any(got.values()), f"the steps on {', '.join(names)} launched {got}")
    return rows


# The card-vs-CPU step's limits: phase 16's, in f32 and in f64. Each may
# widen to FAMILY_SPREAD times the CPU's own f32-vs-f64 distance (in f64,
# that distance scaled by 2^-29, the ratio of the two unit roundoffs):
# train-mode BatchNorm over the 8 values a channel of the 2x2 maps of
# batch 2 at 64x64 makes the deepest maps ill-conditioned (the CPU tests:
# inceptionv4's 2x2 map 0.12 of its magnitude off its f64 run in f32, its
# f64 step 8.8e-9 apart on the card and the CPU in the grad norm). The
# distance is the CPU's alone, so a fault of the card's path does not
# widen it. InceptionV4 runs at 128x128 (4x4 maps), where the check still
# means something.
FAMILY_F32_LIMITS = dict(loss=1e-5, bn_stats=1e-4, grad_norm=1e-3, weights=2e-2)
FAMILY_F64_LIMITS = dict(ZOO_CPU_LIMITS["float64"])
FAMILY_SPREAD = 5.0
FAMILY_SMALL_HW_OF = {"inceptionv4": 128}
# SK-Net's attention BatchNorm normalises 2 values a channel at batch 2
# with flax's one-sweep variance: timm-skresnext50_32x4d's step is then
# chaotic (the CPU's own f32 grad norm 0.78 off its f64 one, the card's f64
# weights 1.7e-7 off the CPU's, where the f32 distance scaled by 2^-29
# allows 1.8e-8); at batch 4 the CPU's own f32 distance is 2.0e-4.
FAMILY_SMALL_BATCH_OF = {"timm-skresnext50_32x4d": 4}


def family_card_vs_cpu(dev, seed: int, cases=None) -> dict:
    """Each case's train step (by default a Unet on each FAMILY_CARD_CPU
    encoder; depth 5, batch 2, 64x64, see FAMILY_SMALL_HW_OF and
    FAMILY_SMALL_BATCH_OF) on the card
    and on the CPU from one state: in f64 the whole step; in f32 (TF32 off)
    in three parts, as phase 19 splits it (`split_step_card_vs_cpu`): the
    forward (loss, running stats), the gradients with the CPU's forward
    forced to the card's module outputs, and the update (SGD on the card's
    gradients). Limits: phase 16's, or FAMILY_SPREAD times the CPU's own
    f32-vs-f64 distance where larger. `cases` maps a label to a function
    (device, generator) -> model."""
    t = load_config(CONFIG)["training"]
    opt = t["model_optimizer"]
    rows = {}
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    if cases is None:
        cases = {name: functools.partial(_family_unet, name) for name in FAMILY_CARD_CPU}
    for name, build_model in cases.items():
        t_case = time.perf_counter()
        hw = FAMILY_SMALL_HW_OF.get(name, FAMILY_SMALL_HW)
        bs = FAMILY_SMALL_BATCH_OF.get(name, 2)
        model0 = build_model("cpu", torch.Generator().manual_seed(seed + 21)).state_dict()
        batch = _batches(np.random.RandomState(seed + 21), 1, bs, hw, "cpu")[0]
        params = [k for k in model0 if k.rsplit(".", 1)[-1] not in ("mean", "var")]
        stats = [k for k in model0 if k not in params]

        def run_on(d, dtype, forced=None):
            model = build_model(d, None)
            model.load_state_dict({k: v.to(d) for k, v in model0.items()})
            model.to(dtype)
            # one CPU generator: the same dropout masks on both devices
            state = FixedTrainState.create(model, opt, rng=torch.Generator())
            names = {id(p): k for k, p in model.named_parameters()}
            grads = {}
            state.opt.register_step_pre_hook(lambda o, a, kw: grads.update(
                {names[id(p)]: p.grad.detach().cpu().clone() for g in o.param_groups
                 for p in g["params"]}))
            with module_outputs(model, forced) as seen:
                m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                    state, {"image": batch["image"].to(d, dtype), "label": batch["label"].to(d)})
            return cpu(m), cpu(model.state_dict()), grads, seen

        def stats_rel(a, b):
            return max(float((a[k].double() - b[k].double()).abs().max()
                             / b[k].double().abs().max().clamp_min(1.0)) for k in stats)

        def step_rel(ma, sa, mb, sb, before):
            return dict(**_metrics_rel(ma, mb, ("loss", "grad_norm")),
                        weights=_update_rel(before, sa, sb, params), bn_stats=stats_rel(sa, sb))

        before64 = {k: v.double() for k, v in model0.items()}
        m64c, s64c, _, _ = run_on("cpu", torch.float64)
        m_cpu, s_cpu, _, _ = run_on("cpu", torch.float32)
        own = step_rel(m_cpu, s_cpu, m64c, s64c, before64)
        lim32 = {k: max(v, FAMILY_SPREAD * own[k]) for k, v in FAMILY_F32_LIMITS.items()}
        lim64 = {k: max(v, FAMILY_SPREAD * own[k] * 2.0 ** -29)
                 for k, v in FAMILY_F64_LIMITS.items()}
        m64d, s64d, _, _ = run_on(dev, torch.float64)
        f64 = step_rel(m64d, s64d, m64c, s64c, before64)
        check(all(f64[k] <= lim64[k] for k in lim64),
              f"{name}: f64 step card vs CPU {f64} (limits {lim64}; CPU f32 vs f64 {own})")
        m_card, s_card, g_card, seen = run_on(dev, torch.float32)
        m_forced, _, g_forced, _ = run_on("cpu", torch.float32, forced=seen)
        forward = dict(**_metrics_rel(m_card, m_cpu, ("loss",)), bn_stats=stats_rel(s_card, s_cpu))
        grads = dict(**_metrics_rel(m_card, m_forced, ("grad_norm",)),
                     weights=_update_rel({k: torch.zeros_like(v) for k, v in g_forced.items()},
                                         g_card, g_forced, list(g_forced)))
        model = build_model("cpu", None)
        model.load_state_dict(model0)
        sgd = build_optimizer(list(model.parameters()), opt)
        for k, p in model.named_parameters():
            p.grad = g_card[k]
        sgd.step()
        update = _update_rel(model0, s_card, cpu(model.state_dict()), params)
        got = dict(loss=forward["loss"], bn_stats=forward["bn_stats"],
                   grad_norm=grads["grad_norm"], weights=max(grads["weights"], update))
        check(all(got[k] <= lim32[k] for k in lim32),
              f"{name}: f32 step card vs CPU {got} (limits {lim32}; CPU f32 vs f64 {own})")
        rows[name] = dict(hw=hw, batch=bs, f64=f64, forward=forward, grads=grads, update=update,
                          cpu_own=own, limits=dict(f32=lim32, f64=lim64))
        log(f"{name} step card vs CPU (depth 5, {hw}x{hw}, batch {bs}): f64 {f64} (limits "
            f"{lim64}); f32 forward {forward}, gradients (forward forced) {grads}, update "
            f"{update:.3g} (limits {lim32}); CPU f32 vs f64 {own} "
            f"({time.perf_counter() - t_case:.1f} s)")
    return rows


def run_family_deeplab(dev, seed: int, name=None) -> dict:
    """One f32 train step of DeepLabV3+ on the encoder `name` at output
    stride 16 (its deepest stage dilated) at the promise12 `training:`
    geometry, and a second one timed. `name` None: FAMILY_DEEPLAB."""
    name = name or FAMILY_DEEPLAB
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    batch = _batches(np.random.RandomState(seed + 22), 1, bs, HW, dev)[0]
    model = zoo.DeepLabV3Plus(classes=NCLASS, in_channels=IN_CHANNELS,
                              encoder_name=name, output_stride=16,
                              device=dev, generator=torch.Generator().manual_seed(seed + 22))
    enc = model.encoder
    check([f.shape[-1] for f in enc(batch["image"].permute(0, 3, 1, 2)[:1])] ==
          [HW, HW // 2, HW // 4, HW // 8, HW // 16, HW // 16],
          f"deeplab_v3_plus: the {name} pyramid is not at output stride 16")
    state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    m2 = step(state, batch)
    torch.cuda.synchronize()
    ms2 = (time.perf_counter() - t0) * 1e3
    loss = float(m["loss"])
    check(np.isfinite(loss) and np.isfinite(float(m2["loss"])),
          f"deeplab_v3_plus on {name}: loss {loss}")
    with torch.inference_mode():
        out = model(batch["image"], train=False)[0]
    check(tuple(out.shape) == (bs, HW, HW, NCLASS) and bool(torch.isfinite(out).all()),
          f"deeplab_v3_plus on {name}: logits {tuple(out.shape)}")
    row = dict(first_ms=ms, step_ms=ms2, loss=loss, peak_mib=torch.cuda.max_memory_allocated()
               / 2**20)
    log(f"deeplab_v3_plus on {name} at output stride 16, batch {bs}: first step "
        f"{ms:.1f} ms, second {ms2:.2f} ms, loss {loss:.5f}, peak {row['peak_mib']:.1f} MiB")
    del model, state
    torch.cuda.empty_cache()
    return row


# K1a and K1c at n=1 beside phase 19's timed shape
K1_FAMILY_REFERENCE = BN_TIMED_SHAPE


def time_k1_at(dev, shape, seed: int) -> dict:
    """K1a (branch_stats) and K1c (bwd_reduce: its partial and finish
    kernels) at n=1 on `shape` in f32 and bf16, x and g rotated over
    L2-cold copies (`cold_sets`): the call's ms (CUDA events around 20
    back-to-back calls, as phase 19 times them), the device ms
    (`queued_ms`), the plain twin's ms, the byte bound (each input read
    once, each output written once), and the device time's share of it."""
    b, c, h, w = shape
    out = {}
    for dtype in (torch.float32, BF16):
        e = torch.finfo(dtype).bits // 8
        x, _, g = _bn_case(dev, shape, seed, dtype)
        sets, n, planes = cold_sets((x, g)), b * c * h * w, b * c
        for name, fn, plain, nbytes in (
                ("branch_stats", lambda x, g: ge.branch_stats([x]),
                 lambda x, g: ge.branch_stats_plain([x]), n * e + 2 * planes * 4),
                ("bwd_reduce", lambda x, g: ge.bwd_reduce([x], g),
                 lambda x, g: ge.bwd_reduce_plain([x], g), 2 * n * e + 2 * planes * 4)):
            got = in_turns_ms({name: fn, "plain": plain}, sets)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            key = name + ("" if dtype == torch.float32 else BF16_SUFFIX)
            out[key] = k1_record(shape, 1, got[name], got["plain"], bound,
                                 copies=len(sets))
    log(f"  K1a / K1c at n=1 on {list(shape)}, L2-cold (call ms / device ms / spread / plain ms "
        f"/ bound ms / device share of bound): "
        + " | ".join(f"{k} {r['ms']:.4f} / {r['device_ms']:.4f} / {r['device_spread']:.4f} / "
                     f"{r['plain_ms']:.4f} / {r['bound_ms']:.5f} / {r['share_of_bound']:.3f}"
                     for k, r in out.items()))
    return out


K1_FAMILY_PLANES = ("smallest", "largest", "phase 19's")


def run_family_gate(dev, seed: int, names=None, planes=K1_FAMILY_PLANES,
                    known=()) -> dict:
    """The gated BatchNorm on a Unet on each encoder of `names`: K1a-K1d held
    to their plain twins (and to the gate off) at every shape the encoders'
    BatchNorms see in a step (their 1x1 attention planes included), K1a's
    and K1c's device times at `planes` (of the largest and the smallest
    plane, the largest of the shapes not in `known`, and phase 19's shape),
    and each Unet's f32 step with the gate on
    and off in turns (`_gate_turns`), whose K1 launches a step must equal
    its BatchNorm calls, one for each `BatchNorm` module of the model.
    `names` None: FAMILY_GATED."""
    names = names or FAMILY_GATED
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    batch = _batches(np.random.RandomState(seed + 23), 1, bs, HW, dev)[0]
    out, total, shapes = {}, {name: 0 for name in KERNELS}, set()
    for name in names:
        model = _family_unet(name, dev, torch.Generator().manual_seed(seed + 23))
        state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
        step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
        with bn_inputs(model.encoder) as enc_seen, pallas_bn(False):
            step(state, batch)
        with bn_inputs(model) as seen, pallas_bn(False):
            step(state, batch)
        modules = sum(isinstance(m, BatchNorm) for m in model.modules())
        check(len(seen) == modules, f"unet on {name}: {len(seen)} BatchNorm calls a step, "
                                    f"{modules} BatchNorm modules")
        shapes |= set(enc_seen)
        out[name] = _gate_turns(f"unet on {name} f32 step, batch {bs}",
                                lambda: step(state, batch), len(seen))
        out[name].update(bn_calls=len(seen), bn_modules=modules,
                         encoder_bn_shapes=sorted(set(enc_seen)))
        add_counts(total, {k: out[name]["launches"].get(k, 0) for k in KERNELS})
        del model, state, step
        torch.cuda.empty_cache()
    shapes = sorted(shapes, key=lambda s: (s[2] * s[3], s[1], s[0]))
    log(f"encoder BatchNorm shapes of {', '.join(names)} at batch {bs}: {len(shapes)} "
        f"({shapes})")
    worst = check_bn_path(dev, seed + 23, shapes)
    plane = lambda s: (s[2] * s[3], s[1])
    at = {"smallest": shapes[0], "largest": max(shapes, key=plane),
          "largest new": max([s for s in shapes if s not in set(known)] or shapes, key=plane),
          "phase 19's": K1_FAMILY_REFERENCE}
    timed = {label: time_k1_at(dev, at[label], seed + 24) for label in planes}
    return dict(steps=out, launches=total, checks=worst, timed=timed,
                shapes=[list(s) for s in shapes])


def run_encoder_families(dev, seed: int) -> dict:
    """Phase 20, timed: the eleven families' Unet steps in f32 and bf16,
    card against CPU, DeepLabV3+ at output stride 16, the gated
    BatchNorm."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")
        log(f"phase 20: {marks[-1]}")

    steps = run_family_steps(dev, seed)
    mark("full-width steps")
    card_cpu = family_card_vs_cpu(dev, seed)
    mark("card vs CPU")
    deeplab = run_family_deeplab(dev, seed)
    mark("deeplab")
    gate = run_family_gate(dev, seed)
    mark("gate")
    seconds = time.perf_counter() - t0
    log(f"phase 20 (the encoder families): {seconds:.1f} s ({', '.join(marks)})")
    return dict(steps=steps, card_vs_cpu=card_cpu, deeplab=deeplab, gate=gate,
                launches=gate["launches"], seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 21: the timm residual variants
# ---------------------------------------------------------------------------

# one encoder of each class of models/encoders_timm2.py
TIMM2_NAMES = ("timm-res2net50_26w_4s", "timm-regnety_016", "timm-skresnet18", "timm-gernet_s")
# the card-vs-CPU steps: a Unet on each of those and on the grouped Res2Net
# and SK-Net; a RegNet dilated to output stride 8 under DeepLabV3+ (the Unet
# has no output stride)
TIMM2_CARD_CPU = TIMM2_NAMES + ("timm-res2next50", "timm-skresnext50_32x4d")
TIMM2_DILATED = "timm-regnetx_002"
TIMM2_GATED = ("timm-regnety_016", "timm-skresnet18")
# DeepLabV3+ at output stride 16 at full width: both SK paths at the
# deepest stage's dilation (the reference's quirk)
TIMM2_DEEPLAB = "timm-skresnet18"
# every name's eval forward: batch 2 of 64x64x1, a Unet at depth 4 (5
# until the wall passed ~800 s: the deepest stage holds most of a big
# variant's weights, drawn on the host)
TIMM2_EVERY_HW = 64
TIMM2_EVERY_DEPTH = 4


def _deeplab_os8(name, dev, gen):
    return zoo.DeepLabV3Plus(classes=NCLASS, in_channels=IN_CHANNELS, encoder_name=name,
                             output_stride=8, device=dev, generator=gen)


def run_timm2_every_name(dev, seed: int) -> dict:
    """Each of the 37 names of models/encoders_timm2.py: a Unet
    (TIMM2_EVERY_DEPTH, the promise12 decoder widths) built on the card in f32 (its weights drawn
    from the seed) and in bf16 (built on the meta device and given the f32
    model's weights), one eval-mode forward each at batch 2 of 64x64x1:
    finite logits of the right shape and dtype, and the encoder's pyramid
    channels equal to `encoder_out_channels`. Seconds each (build and
    forward)."""
    image = _batches(np.random.RandomState(seed + 25), 1, 2, TIMM2_EVERY_HW, dev)[0]["image"]
    rows = {}
    for name in TIMM2_ENCODERS:
        want = encoder_out_channels(name, TIMM2_EVERY_DEPTH, IN_CHANNELS)
        row, weights = {}, None
        for tag, dtype in (("f32", None), ("bf16", BF16)):
            t0 = time.perf_counter()
            if weights is None:
                model = _family_unet(name, dev, torch.Generator().manual_seed(seed + 25), dtype,
                                     TIMM2_EVERY_DEPTH)
                weights = model.state_dict()
            else:
                with torch.device("meta"):
                    model = _family_unet(name, "meta", None, dtype, TIMM2_EVERY_DEPTH)
                model = model.to_empty(device=dev)
                model.load_state_dict(weights)
            with torch.inference_mode():
                feats = model.encoder(image.permute(0, 3, 1, 2).contiguous(), train=False)
                out = model(image, train=False)[0]
            torch.cuda.synchronize()
            got = tuple(int(f.shape[1]) for f in feats)
            check(got == want, f"{tag} {name}: pyramid channels {got}, encoder_out_channels {want}")
            check(tuple(out.shape) == (2, TIMM2_EVERY_HW, TIMM2_EVERY_HW, NCLASS)
                  and out.dtype == (dtype or torch.float32) and bool(torch.isfinite(out).all()),
                  f"{tag} unet on {name}: logits {tuple(out.shape)} {out.dtype}")
            row[tag] = dict(s=time.perf_counter() - t0,
                            parameters=sum(p.numel() for p in model.parameters()))
            del model, feats, out
        rows[name] = row
        del weights
    torch.cuda.empty_cache()
    log(f"every timm residual variant (unet at depth {TIMM2_EVERY_DEPTH}, eval, batch 2, "
        f"{TIMM2_EVERY_HW}x{TIMM2_EVERY_HW}, "
        f"f32 and bf16): {len(rows)} names; seconds (build + forward) f32, bf16 and parameters "
        f"{ {n: (round(r['f32']['s'], 2), round(r['bf16']['s'], 2), r['f32']['parameters']) for n, r in rows.items()} }")
    return rows


def run_timm_residual_variants(dev, seed: int, known_shapes=()) -> dict:
    """Phase 21, timed: the four class representatives' Unet steps in f32
    and bf16, every name's forward, card against CPU (and DeepLabV3+ on
    TIMM2_DILATED at output stride 8), DeepLabV3+ at output stride 16 on
    TIMM2_DEEPLAB, the gated BatchNorm on TIMM2_GATED (K1a/K1c timed at the
    largest BN plane not among `known_shapes`)."""
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f} s")
        log(f"phase 21: {marks[-1]}")

    steps = run_family_steps(dev, seed, TIMM2_NAMES)
    mark("full-width steps")
    every = run_timm2_every_name(dev, seed)
    mark("every name")
    cases = {name: functools.partial(_family_unet, name) for name in TIMM2_CARD_CPU}
    cases[f"deeplab_v3_plus on {TIMM2_DILATED} at output stride 8"] = functools.partial(
        _deeplab_os8, TIMM2_DILATED)
    card_cpu = family_card_vs_cpu(dev, seed, cases)
    mark("card vs CPU")
    deeplab = run_family_deeplab(dev, seed, TIMM2_DEEPLAB)
    mark("deeplab")
    gate = run_family_gate(dev, seed, TIMM2_GATED, planes=("largest new",), known=known_shapes)
    mark("gate")
    seconds = time.perf_counter() - t0
    log(f"phase 21 (the timm residual variants): {seconds:.1f} s ({', '.join(marks)})")
    return dict(steps=steps, every_name=every, card_vs_cpu=card_cpu, deeplab=deeplab, gate=gate,
                launches=gate["launches"], seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 22: data parallelism (senas_torch/parallel)
# ---------------------------------------------------------------------------

DP_RANKS = 2
# steps each run times after the compared one, its collectives timed
DP_TIMED = 1
# the gloo ranks' whole job, their start-up and build included
DP_TIMEOUT_S = 300
# Limits of the data-parallel steps against the single-process step from one
# state, both under deterministic algorithms. The ranks' batch statistics
# and the gradient are the same sums in another order (the synced
# BatchNorm's two passes, the epilogue's sums over the ranks, the all-reduce
# of the partial gradients): near init the pre-BN kernels' gradients cancel,
# so f32 rounding moves the update by O(1e-3) (phase 6's kernels against
# their twins: 1.1e-3 to 1.3e-3 at full width). A CPU rehearsal of this
# comparison at c 8, depth 3, 64x64 (the full width does not run on the
# CPU) read: search step grad norm 7.2e-6, weight update 2.7e-3, arch
# update 1.2e-3, running stats 4.1e-7; fixed step weight update 1.5e-5,
# running stats 1.1e-7. The limits: phase 6's for the metrics and running
# stats, 1e-2 for the updates. The CPU tests hold the same steps in f64 to
# 1e-10 (tests/test_torch_mesh_steps.py); a rank on the wrong rows or a
# statistic over one rank's rows moves them by O(1).
DP_LIMITS = dict(STEP_LIMITS, weights=1e-2, arch=1e-2)
# tp, fp and fn may differ by this share of the batch's pixels: a pixel
# whose two logits lie within f32 rounding of each other may flip (the
# fixed step over one NCCL rank read fp 133158 against 133157 of 786,432
# pixels on an H100)
DP_COUNT_SHARE = 1e-5
DP_KERNELS = ("branch_stats", "apply_mix", "bwd_reduce", "bwd_dx")


def _dp_search(dev, seed: int, mesh=None, spatial: bool = False) -> dict:
    """The promise12 search step (do_arch) at full width from the seed's
    state, under `mesh` (None: one process on the global batch of 8), with
    `spatial` the image rows split over its spatial axis: the compared step
    under deterministic algorithms (its metrics, the state before and after
    on the host, the kernels' launches), then DP_TIMED steps timed on the
    host clock, with the time inside the collectives."""
    from senas_torch.parallel.mesh import place_state, shard_batch, shard_train_step
    s = load_config(CONFIG)["searching"]
    meta, bs = s["meta_node_num"], s["batch_size"]
    gen = torch.Generator().manual_seed(seed + 22)
    model = _supernet(s, dev, gen)
    arch = init_arch_params(meta, s["depth"], use_sharing=s["sharing_normal"], generator=gen,
                            device=dev)
    state = SearchTrainState.create(model, arch, s["model_optimizer"], s["arch_optimizer"])
    step = make_search_step(lambda a: normalize_arch(a, meta),
                            build_loss(s["loss"]["name"], s["deep_supervision"]),
                            grad_clip=s["grad_clip"])
    rng = np.random.RandomState(seed + 22)
    pairs = [tuple(_batches(rng, 2, bs, HW, dev)) for _ in range(1 + DP_TIMED)]
    if mesh is not None:
        place_state(mesh, state)
        step = shard_train_step(step, mesh)
        pairs = [tuple(shard_batch(mesh, b, spatial=spatial) for b in p) for p in pairs]
    return _dp_steps(state, lambda p: step(state, p[0], p[1], True), pairs, mesh)


def _dp_fixed(dev, seed: int, mesh=None, spatial: bool = False) -> dict:
    """The promise12 fixed train step (`training:`, global batch 12) as
    `_dp_search` runs the search step."""
    from senas_torch.parallel.mesh import place_state, shard_batch, shard_train_step
    t = load_config(CONFIG)["training"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed + 23))
    state = FixedTrainState.create(model, t["model_optimizer"], rng=torch.Generator())
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    batches = _batches(np.random.RandomState(seed + 23), 1 + DP_TIMED, t["batch_size"], HW, dev)
    if mesh is not None:
        place_state(mesh, state)
        step = shard_train_step(step, mesh)
        batches = [shard_batch(mesh, b, spatial=spatial) for b in batches]
    return _dp_steps(state, lambda b: step(state, b), batches, mesh)


# promise12-zoo-rows: the factory's nine models under the row split, and
# unet once in bf16 and once with SENAS_PALLAS_BN=1 (label: (name, dtype,
# gated))
DP_ZOO = {**{name: (name, None, False) for name in ZOO_MODELS},
          "unet_bf16": ("unet", torch.bfloat16, False), "unet_gated": ("unet", None, True)}
# Held to the one-process f64 step instead of `DP_LIMITS`: manet's f32 step
# is itself farther than `DP_LIMITS` from its f64 step (PAB's softmax over
# the whole HW x HW map; one process on an H100 read grad norm 5.55e-3 and
# weight update 1.46e-2 off the f64 step's), so the split step must lie at
# most twice as far from the f64 step as the one-process f32 step does.
# Every f32 model's distances to its f64 step are logged beside.
DP_ZOO_EXACT = ("manet",)
# promise12-encoder-rows: a Unet (phase 20's, `_family_unet`) on an encoder
# of each new row-split form: TF 'SAME' at stride 2 and SE (mnv3), split
# attention with its 1x1 BatchNorm and the avd pools (resnest, also with
# SENAS_PALLAS_BN=1), SK with FlaxBatchNorm (skresnet18), rectangular
# convolutions and count-excluding pools (inceptionv4), the ceil-mode pool
# and SE (se_resnext50), and efficientnet-b0 in bf16 beside its f32 step
# (label: (encoder, dtype, gated))
DP_ENCODERS = {"timm-mobilenetv3_large_100": ("timm-mobilenetv3_large_100", None, False),
               "timm-resnest14d": ("timm-resnest14d", None, False),
               "timm-resnest14d_gated": ("timm-resnest14d", None, True),
               "timm-skresnet18": ("timm-skresnet18", None, False),
               "inceptionv4": ("inceptionv4", None, False),
               "se_resnext50_32x4d": ("se_resnext50_32x4d", None, False),
               "efficientnet-b0": ("efficientnet-b0", None, False),
               "efficientnet-b0_bf16": ("efficientnet-b0", torch.bfloat16, False)}
# Every f32 encoder row is held to the f64 step of its model (the label of
# its encoder, ungated: the kernels take no f64; `_dp_f64_compare`), not to
# one process's f32 step: two of them are chaotic in f32. A one-sweep
# variance E[x^2] - mu^2 over [12, C, 1, 1] maps (12 values a channel,
# their mean far above their spread: SK-Net's flax-rule attention
# BatchNorm, and the gated BatchNorm on the split attention's map)
# amplifies any rounding of its input. On an NVIDIA H100 the split steps
# of timm-skresnet18 and the gated timm-resnest14d read weight updates
# 1.49e-2 and 1.51e-2 off one process's (`DP_LIMITS`: 1e-2), the gated one
# 9 pixels off in tp and fn (7.86 admitted); and one process's own gated
# step lay 1.27e-2 (weights), 2.43e-5 (running stats) and 8 pixels from
# its f64 step, the split's 1.35e-2, 2.10e-5 and 6. Each split step must lie
# within `DP_LIMITS` of the f64 step, or at most twice as far from it as
# one process's f32 step; its distances to one process are logged beside.
DP_ENCODERS_F64 = {label: enc for label, (enc, dtype, _) in DP_ENCODERS.items()
                   if dtype is None}


def _dp_zoo(dev, seed: int, label: str, mesh=None, f64: bool = False) -> dict:
    """The fixed train step of DP_ZOO[label] (or of a Unet on the encoder of
    DP_ENCODERS[label]) at the promise12 `training:` geometry (global batch
    12, 256x256, depth 5; pspnet 3), as `_dp_fixed` runs the SENAS model's,
    with the image rows split over `mesh`'s spatial axis; with `f64`, the
    compared step alone in f64 in one process. The compared step runs under
    cuDNN's deterministic algorithms: the zoo's bilinear resizes and nearest
    picks have no deterministic backward on the card (their atomics
    stay)."""
    from senas_torch.parallel.mesh import place_state, shard_batch, shard_train_step
    t = load_config(CONFIG)["training"]
    gen = torch.Generator().manual_seed(seed + 24)
    if label in DP_ZOO:
        name, dtype, gated = DP_ZOO[label]
        model = _zoo_model(name, ZOO_DEPTH.get(name, t["depth"]), dev, gen, dtype)
    else:
        name, dtype, gated = DP_ENCODERS[label]
        model = _family_unet(name, dev, gen, dtype, t["depth"])
    state = FixedTrainState.create(model, t["model_optimizer"], seed=seed, rng=torch.Generator())
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    batches = _batches(np.random.RandomState(seed + 24), 1 + DP_TIMED, t["batch_size"], HW, dev)
    if f64:
        model.double()
        batches = [dict(b, image=b["image"].double()) for b in batches[:1]]
    if mesh is not None:
        place_state(mesh, state)
        step = shard_train_step(step, mesh)
        batches = [shard_batch(mesh, b, spatial=True) for b in batches]
    with pallas_bn(gated):
        out = _dp_steps(state, lambda b: step(state, b), batches, mesh, deterministic_cudnn)
    del model, state
    torch.cuda.empty_cache()
    return out


def _dp_snapshot(state) -> dict:
    arch = getattr(state, "arch", {})
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "arch": {k: v.detach().cpu().clone() for k, v in arch.items()}}


def _dp_steps(state, run, inputs, mesh, deterministic=deterministic_algorithms) -> dict:
    before = _dp_snapshot(state)
    reset_counts()
    with deterministic():
        m = run(inputs[0])
    torch.cuda.synchronize()
    launches = counts()
    out = dict(metrics={k: v.detach().cpu() for k, v in m.items()}, before=before,
               after=_dp_snapshot(state), launches=launches)
    timed = [collective_share(lambda: run(x)) for x in inputs[1:]]
    out["ms"] = [t["wall_ms"] for t in timed]
    out["collectives"] = timed[-1] if mesh is not None else {}
    return out


def collective_share(fn) -> dict:
    """fn()'s wall time on the host clock, the time inside the process
    group's calls (`senas_torch.parallel.collectives._all_reduce_`, every
    sum the step makes, timed around each call) and their number, and the
    halo exchanges' and the whole-level gathers' calls and bytes among them
    (`parallel.spatial.HALO`): a
    gloo call returns when its sum is done, an NCCL call when the sum is
    queued on the stream. torch.profiler's host view of the same calls
    reads the same time, but its analysis of a search step over gloo (~10^5
    host events) cost more seconds than the step."""
    from senas_torch.parallel import collectives, spatial
    inner, spent = collectives._all_reduce_, []

    def timed(t, group):
        t0 = time.perf_counter()
        out = inner(t, group)
        spent.append(time.perf_counter() - t0)
        return out

    collectives._all_reduce_ = timed
    spatial.reset_halo_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        collectives._all_reduce_ = inner
    inside_ms = sum(spent) * 1e3
    return dict(wall_ms=wall_ms, inside_ms=inside_ms, calls=len(spent),
                share=inside_ms / wall_ms, halo_calls=spatial.HALO["calls"],
                halo_bytes=spatial.HALO["bytes"], gathers=spatial.HALO["gathers"],
                gather_bytes=spatial.HALO["gather_bytes"])


def _dp_rank_main(rank: int, port: int, out: str, seed: int) -> int:
    """One gloo rank of phase 22 on card 0 (`chip_smoke.py --dp-rank`)."""
    import torch.distributed as dist

    from senas_torch.parallel.mesh import INIT_TIMEOUT, MeshSpec, make_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DP_RANKS, rank=rank, timeout=INIT_TIMEOUT)
    mesh = make_mesh(device=dev)
    check(mesh.backend == "gloo" and mesh.world_size == DP_RANKS, f"rank {rank}: mesh {mesh}")
    res = {"search": _dp_search(dev, seed, mesh), "fixed": _dp_fixed(dev, seed, mesh)}
    # the image rows split over the same two ranks
    rows = make_mesh(spec=MeshSpec(data=1, spatial=DP_RANKS), device=dev)
    check(rows.spatial_group is not None and rows.spatial_index == rank,
          f"rank {rank}: spatial mesh {rows}")
    res["spatial_search"] = _dp_search(dev, seed, rows, spatial=True)
    res["spatial_fixed"] = _dp_fixed(dev, seed, rows, spatial=True)
    res["zoo"] = {label: _dp_zoo(dev, seed, label, rows) for label in DP_ZOO}
    res["encoders"] = {label: _dp_zoo(dev, seed, label, rows) for label in DP_ENCODERS}
    torch.save(res, out)
    dist.destroy_process_group()
    return 0


def _dp_compare(label: str, got: dict, want: dict, keys, pixels: int) -> dict:
    rel_m = _metrics_rel(got["metrics"], want["metrics"], keys)
    counts_off = max(float((got["metrics"][k] - want["metrics"][k]).abs().max())
                     for k in ("tp", "fp", "fn"))
    check(counts_off <= DP_COUNT_SHARE * pixels,
          f"{label}: tp/fp/fn {[got['metrics'][k].tolist() for k in ('tp', 'fp', 'fn')]} "
          f"against {[want['metrics'][k].tolist() for k in ('tp', 'fp', 'fn')]}")
    check(all(torch.equal(got["before"][p][k], want["before"][p][k])
              for p in ("model", "arch") for k in want["before"][p]),
          f"{label}: the runs did not start from one state")
    rel_s = _state_rel(want["before"], got["after"], want["after"])
    if not want["after"]["arch"]:
        rel_s.pop("arch")
    check(max(rel_m.values()) <= DP_LIMITS["metrics"]
          and all(v <= DP_LIMITS[k] for k, v in rel_s.items()),
          f"{label}: metrics {rel_m}, state {rel_s} (limits {DP_LIMITS})")
    return dict(metrics=rel_m, state=rel_s, counts_off=counts_off)


def _dp_bf16_compare(label: str, got: dict, want: dict, f32: dict) -> dict:
    """ROADMAP's bf16 bound with the one-process step as the reference: a
    rank's bf16 weight update and running stats lie at most twice as far
    (relative L2) from the one-process bf16 step's as those lie from the
    one-process f32 step's, plus 1e-6; its loss and gradient norm within
    twice the one-process bf16 error of the weight update. Under the split
    a bf16 convolution of a block sums in another order than that of the
    whole map (cuDNN's algorithm follows the shape), and the rounding
    differences grow through the step as bf16 ones do."""
    check(all(torch.equal(got["before"]["model"][k], want["before"]["model"][k])
              and torch.equal(f32["before"]["model"][k], want["before"]["model"][k])
              for k in want["before"]["model"]), f"{label}: the runs did not start from one state")
    before = want["before"]["model"]
    params = [k for k in before if k.rsplit(".", 1)[-1] not in ("mean", "var")]
    own = _update_rel(before, want["after"]["model"], f32["after"]["model"], params)
    out = {"weights": (_update_rel(before, got["after"]["model"], want["after"]["model"], params),
                       own),
           "bn_stats": (_stats_l2(want["before"], got["after"], want["after"]),
                        _stats_l2(want["before"], want["after"], f32["after"]))}
    for k in ("loss", "grad_norm"):
        a, b = float(got["metrics"][k]), float(want["metrics"][k])
        out[k] = (abs(a - b) / max(abs(b), 1e-30), own)
    check(all(gap <= 2 * o + 1e-6 for gap, o in out.values()),
          f"{label}: against one process (gap, one-process bf16 vs f32) {out}, gap at most "
          "twice the latter plus 1e-6")
    return {k: dict(gap=g, own=o) for k, (g, o) in out.items()}


def _dp_exact_compare(label: str, got: dict, want: dict, f64: dict, pixels: int,
                      hold: bool = True) -> dict:
    """A split f32 step and the one-process f32 step against the one-process
    f64 step: the relative distances of their losses, gradient norms and
    weight updates (in L2). With `hold` (DP_ZOO_EXACT), the split's must be
    at most twice the one-process step's, plus 1e-6, and its running stats
    within `DP_LIMITS` and its tp/fp/fn within `DP_COUNT_SHARE` of the
    one-process f32 step's."""
    wide = lambda snap: {k: v.double() for k, v in snap.items()}
    before = wide(want["before"]["model"])
    check(all(torch.equal(got["before"]["model"][k], want["before"]["model"][k])
              and torch.equal(f64["before"]["model"][k], before[k]) for k in before),
          f"{label}: the runs did not start from one state")
    params = [k for k in before if k.rsplit(".", 1)[-1] not in ("mean", "var")]
    ref = f64["after"]["model"]
    out = {"weights": (_update_rel(before, wide(got["after"]["model"]), ref, params),
                       _update_rel(before, wide(want["after"]["model"]), ref, params))}
    for k in ("loss", "grad_norm"):
        b = float(f64["metrics"][k])
        out[k] = tuple(abs(float(run["metrics"][k]) - b) / max(abs(b), 1e-30)
                       for run in (got, want))
    against = {k: dict(split=g, one_process=o) for k, (g, o) in out.items()}
    if not hold:
        return dict(against_f64=against)
    check(all(gap <= 2 * own + 1e-6 for gap, own in out.values()),
          f"{label}: (split, one process) against the f64 step {out}, the split at most twice "
          "as far plus 1e-6")
    bn = _state_rel(want["before"], got["after"], want["after"])["bn_stats"]
    counts_off = max(float((got["metrics"][k] - want["metrics"][k]).abs().max())
                     for k in ("tp", "fp", "fn"))
    check(bn <= DP_LIMITS["bn_stats"] and counts_off <= DP_COUNT_SHARE * pixels,
          f"{label}: running stats {bn}, tp/fp/fn off by {counts_off}")
    return dict(against_f64=against, bn_stats=bn, counts_off=counts_off)


def _dp_f64_compare(label: str, got: dict, want: dict, f64: dict, pixels: int) -> dict:
    """A split f32 step held to the one-process f64 step (DP_ENCODERS_F64):
    its loss, gradient norm, weight update, running stats and tp/fp/fn each
    within `DP_LIMITS` (`DP_COUNT_SHARE` of the pixels) of the f64 step's,
    or at most twice as far from it as the one-process f32 step's."""
    wide = lambda snap: {k: v.double() for k, v in snap.items()}
    before = wide(want["before"]["model"])
    check(all(torch.equal(got["before"]["model"][k], want["before"]["model"][k])
              and torch.equal(f64["before"]["model"][k], before[k]) for k in before),
          f"{label}: the runs did not start from one state")
    params = [k for k in before if k.rsplit(".", 1)[-1] not in ("mean", "var")]
    ref = {"before": {"model": before, "arch": {}}, "after": f64["after"]}
    limits = dict(loss=DP_LIMITS["metrics"], grad_norm=DP_LIMITS["metrics"],
                  weights=DP_LIMITS["weights"], bn_stats=DP_LIMITS["bn_stats"],
                  counts=DP_COUNT_SHARE * pixels)

    def distances(run):
        after = {"model": wide(run["after"]["model"]), "arch": {}}
        out = {k: abs(float(run["metrics"][k]) - float(f64["metrics"][k]))
               / max(abs(float(f64["metrics"][k])), 1e-30) for k in ("loss", "grad_norm")}
        out["weights"] = _update_rel(before, after["model"], f64["after"]["model"], params)
        out["bn_stats"] = _state_rel(ref["before"], after, f64["after"])["bn_stats"]
        out["counts"] = max(float((run["metrics"][k].double() - f64["metrics"][k].double())
                                  .abs().max()) for k in ("tp", "fp", "fn"))
        return out

    split, one = distances(got), distances(want)
    against = {k: dict(split=split[k], one_process=one[k], limit=limits[k]) for k in limits}
    check(all(split[k] <= max(limits[k], 2 * one[k]) for k in limits),
          f"{label}: against the f64 step {against}: each of the split's distances within its "
          "limit or at most twice the one-process step's")
    return dict(against_f64=against)


def _dp_zoo_rows(single: dict, ranks: list, bs: int, exact: dict, table=None) -> dict:
    """promise12-zoo-rows (`table` DP_ZOO, the default) or -encoder-rows
    (DP_ENCODERS): each step of every gloo rank held to the one-process
    step (`DP_LIMITS`; a bf16 step by ROADMAP's bf16 bound against the
    f32 step of the label named by its model or encoder,
    `_dp_bf16_compare`; DP_ZOO_EXACT's by the f64 step, `_dp_exact_compare`;
    DP_ENCODERS_F64's by the f64 step alone, `_dp_f64_compare`), the ranks'
    states equal after it; a gated step's
    K1a-K1d launched on every rank and in one process, the same number of
    times, the others' on none. Returns per label the comparisons, ms/step
    and the collectives of rank 0."""
    table = DP_ZOO if table is None else table
    out = {}
    for label in table:
        want = single[label]
        if table[label][1] == torch.bfloat16:
            cmp = {f"rows{r}": _dp_bf16_compare(f"zoo {label} step, rows rank {r} of {DP_RANKS}",
                                                got[label], want, single[table[label][0]])
                   for r, got in enumerate(ranks)}
        elif label in DP_ZOO_EXACT:
            cmp = {f"rows{r}": _dp_exact_compare(f"zoo {label} step, rows rank {r} of {DP_RANKS}",
                                                 got[label], want, exact[label], bs * HW * HW)
                   for r, got in enumerate(ranks)}
        elif label in DP_ENCODERS_F64:
            cmp = {f"rows{r}": _dp_f64_compare(f"zoo {label} step, rows rank {r} of {DP_RANKS}",
                                               got[label], want, exact[label], bs * HW * HW)
                   for r, got in enumerate(ranks)}
            rel = _state_rel(want["before"], ranks[0][label]["after"], want["after"])
            cmp["rows0"]["against_one_process"] = dict(
                metrics=_metrics_rel(ranks[0][label]["metrics"], want["metrics"],
                                     ("loss", "grad_norm")),
                weights=rel["weights"], bn_stats=rel["bn_stats"])
        else:
            cmp = {f"rows{r}": _dp_compare(f"zoo {label} step, rows rank {r} of {DP_RANKS}",
                                           got[label], want, ("loss", "grad_norm"), bs * HW * HW)
                   for r, got in enumerate(ranks)}
            if label in exact:
                cmp["rows0"].update(_dp_exact_compare(label, ranks[0][label], want, exact[label],
                                                      bs * HW * HW, hold=False))
        check(all(torch.equal(a[label]["after"]["model"][k], ranks[0][label]["after"]["model"][k])
                  for a in ranks[1:] for k in a[label]["after"]["model"]),
              f"zoo {label} step: the gloo ranks' states differ after the step")
        k1 = [{k: run["launches"][k] for k in DP_KERNELS} for run in [want] + [g[label]
                                                                           for g in ranks]]
        gated = table[label][2]
        check(all((all(v > 0 for v in c.values()) and c == k1[0]) if gated
                  else not any(c.values()) for c in k1),
              f"zoo {label} step: K1a-K1d launches (one process, then each rank) {k1}")
        ms = {"single": float(np.mean(want["ms"])),
              **{f"rows{r}": float(np.mean(g[label]["ms"])) for r, g in enumerate(ranks)}}
        col = {f"rows{r}": g[label]["collectives"] for r, g in enumerate(ranks)}
        c0 = col["rows0"]
        log(f"zoo {label} step: ms/step {ms}; rank 0: {c0['calls']} collective calls, "
            f"{c0['inside_ms']:.2f} of {c0['wall_ms']:.2f} ms inside them ({c0['share']:.3f} of "
            f"the step); halo exchanges {c0['halo_calls']} calls, {c0['halo_bytes']} bytes; "
            f"whole-level gathers {c0['gathers']} calls, {c0['gather_bytes']} bytes; K1a-K1d "
            f"{k1}; against one process {cmp} (limits {DP_LIMITS})")
        out[label] = dict(compare=cmp, ms=ms, collectives=col, k1=k1)
    return out


def _zoo_distances(zoo: dict) -> dict:
    """Per DP_ZOO label, rank 0's distances to one process in short: (grad
    norm, weight update, tp/fp/fn off) under `DP_LIMITS`; for unet bf16 the
    (gap, one-process bf16 vs f32) pairs of the update and the grad norm;
    for DP_ZOO_EXACT the (split, one process) distances to the f64 step of
    the grad norm and the update; with each f32 model's f64 pair too; for
    DP_ENCODERS_F64 the grad norm and update against one process, then the
    (split, one process) distances to the f64 step of the grad norm, the
    update, the running stats and the counts."""
    out = {}
    for label, r in zoo.items():
        c = r["compare"]["rows0"]
        f64 = c.get("against_f64")
        if "metrics" in c:
            row = (f"{c['metrics']['grad_norm']:.3g}", f"{c['state']['weights']:.3g}",
                   c["counts_off"])
        elif "weights" in c:
            row = tuple(f"{c[k]['gap']:.3g}/{c[k]['own']:.3g}" for k in ("grad_norm", "weights"))
        elif "against_one_process" in c:
            one = c["against_one_process"]
            row = (f"{one['metrics']['grad_norm']:.3g}", f"{one['weights']:.3g}")
        else:
            row = ()
        if f64:
            row += tuple(f"f64 {k} {f64[k]['split']:.3g}/{f64[k]['one_process']:.3g}"
                         for k in ("grad_norm", "weights", "bn_stats", "counts") if k in f64)
        out[label] = row
    return out


def run_data_parallel(dev, seed: int) -> dict:
    """Phase 22: the search step (do_arch) and the fixed step at full width
    over two gloo ranks sharing the card (each a process: over the data
    axis, 4 and 6 rows of the global batches 8 and 12; then over the
    spatial axis, every row and 128 of the 256 image rows) and over one
    NCCL rank in this process, each held to the single-process step on the
    global batch from one state, both under deterministic algorithms;
    K1a-K1d launched on every rank; ms/step on each, the share of a step
    inside the collectives, their calls and the halo exchanges' bytes."""
    import torch.distributed as dist

    from senas_torch.parallel.launch import free_port
    from senas_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        port = free_port()
        outs = [os.path.join(work, f"rank{r}.pt") for r in range(DP_RANKS)]
        logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(DP_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                                   "--dp-port", str(port), "--dp-out", outs[r],
                                   "--seed", str(seed)], stdout=logs[r],
                                  stderr=subprocess.STDOUT, cwd=ROOT)
                 for r in range(DP_RANKS)]
        try:
            single = {"search": _dp_search(dev, seed), "fixed": _dp_fixed(dev, seed)}
            single_zoo = {label: _dp_zoo(dev, seed, label) for label in DP_ZOO}
            single_enc = {label: _dp_zoo(dev, seed, label) for label in DP_ENCODERS}
            f64_enc = {ref: _dp_zoo(dev, seed, ref, f64=True)
                       for ref in dict.fromkeys(DP_ENCODERS_F64.values())}
            exact_enc = {label: f64_enc[ref] for label, ref in DP_ENCODERS_F64.items()}
            exact_zoo = {label: _dp_zoo(dev, seed, label, f64=True) for label in ZOO_MODELS}
            nccl_port = free_port()
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{nccl_port}",
                                    world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
            try:
                mesh = make_mesh(device=torch.device("cuda", torch.cuda.current_device()))
                check(mesh.backend == "nccl" and mesh.group is not None, f"NCCL mesh {mesh}")
                nccl = {"search": _dp_search(dev, seed, mesh), "fixed": _dp_fixed(dev, seed, mesh)}
            finally:
                dist.destroy_process_group()
            deadline = time.perf_counter() + DP_TIMEOUT_S
            while any(p.poll() is None for p in procs) and time.perf_counter() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            f.close()
            check(p.returncode == 0, f"data-parallel rank {r} exited {p.returncode}:\n"
                                     f"{text[-4000:]}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
    rows = {}
    cfg = load_config(CONFIG)
    for name, keys, bs in (("search", ("loss", "arch_loss", "grad_norm"),
                            cfg["searching"]["batch_size"]),
                           ("fixed", ("loss", "grad_norm"), cfg["training"]["batch_size"])):
        want, pixels = single[name], bs * HW * HW
        rows[name] = {"nccl": _dp_compare(f"{name} step, one NCCL rank", nccl[name], want, keys,
                                          pixels)}
        runs = {"single": want, "nccl": nccl[name]}
        for kind, label in ((name, "gloo"), (f"spatial_{name}", "rows")):
            for r, got in enumerate(ranks):
                rows[name][f"{label}{r}"] = _dp_compare(
                    f"{name} step, {label} rank {r} of {DP_RANKS}", got[kind], want, keys, pixels)
                runs[f"{label}{r}"] = got[kind]
            for r, a in enumerate(ranks[1:], 1):
                check(all(torch.equal(a[kind]["after"][p][k], ranks[0][kind]["after"][p][k])
                          for p in ("model", "arch") for k in a[kind]["after"][p]),
                      f"{name} step ({label}): the gloo ranks' states differ after the step")
        for label, run in runs.items():
            k1 = {k: run["launches"][k] for k in DP_KERNELS}
            if name == "search":
                check(all(v > 0 for v in k1.values()),
                      f"search step ({label}): K1a-K1d launches {k1}")
            col = run["collectives"]
            log(f"{name} step ({label}): {np.mean(run['ms']):.2f} ms/step "
                f"{[round(x, 2) for x in run['ms']]}, K1a-K1d launches {k1}"
                + (f", collectives {col['inside_ms']:.2f} of {col['wall_ms']:.2f} ms "
                   f"({col['share']:.3f} of the step, {col['calls']} calls; halo exchanges "
                   f"{col['halo_calls']} calls, {col['halo_bytes']} bytes)" if col else ""))
        log(f"{name} step against one process: " + ", ".join(
            f"{lbl} metrics {r['metrics']} state {r['state']}" for lbl, r in rows[name].items())
            + f" (limits {DP_LIMITS})")
    log("rows: MeshSpec(data=1, spatial=2) over the two gloo ranks, each with every batch row "
        f"and {HW // DP_RANKS} of the {HW} image rows; NCCL refuses two ranks on one device, "
        "so the split rows have no NCCL case on one card")
    zoo = _dp_zoo_rows(single_zoo, [r["zoo"] for r in ranks], cfg["training"]["batch_size"],
                       exact_zoo)
    encoders = _dp_zoo_rows(single_enc, [r["encoders"] for r in ranks],
                            cfg["training"]["batch_size"], exact_enc, DP_ENCODERS)
    seconds = time.perf_counter() - t0
    labels = lambda name: (("single", single[name]), ("nccl", nccl[name]),
                           *((f"gloo{r}", got[name]) for r, got in enumerate(ranks)),
                           *((f"rows{r}", got[f"spatial_{name}"]) for r, got in enumerate(ranks)))
    return dict(rows=rows, seconds=seconds, zoo=zoo, encoders=encoders,
                launches={k: nccl["search"]["launches"][k] + nccl["fixed"]["launches"][k]
                          + single_zoo["unet_gated"]["launches"][k]
                          + single_enc["timm-resnest14d_gated"]["launches"][k] for k in KERNELS},
                ms={name: {label: float(np.mean(run["ms"])) for label, run in labels(name)}
                    for name in ("search", "fixed")},
                collectives={name: {label: run["collectives"] for label, run in labels(name)
                                    if run["collectives"]}
                             for name in ("search", "fixed")})


# ---------------------------------------------------------------------------
# Phase 23: the generic loaders (JPEG, Pillow's resampling) through train_model
# ---------------------------------------------------------------------------

# each tree: its dataset, image (H, W), train and val counts, its masks' classes
GENERIC_TREES = {"pascal_voc": dict(hw=(375, 500), train=24, val=12, classes=21),
                 "ade20k": dict(hw=(512, 683), train=24, val=12, classes=150)}
GENERIC_DISTINCT = 3          # distinct images a tree, written under many names
GENERIC_MODELS = ("unet", "senas")
GENERIC_REMAT_BYTES = 70e9    # above this peak a model trains with remat
GENERIC_DROPOUT = 0.2
GENERIC_TIMED = 6             # samples timed a tree
GENERIC_CPU = dict(depth=3, c=8, hw=64, batch=2)   # the ADE20K card-vs-CPU step
GENERIC_DROPOUT_HW = 64       # the dropout checks: full width, batch 2 of 64x64x3
GENERIC_DROPOUT_TIMED = (12, 256)   # the dropout timings: batch 12 of 256x256x3

_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
                    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
                    60, 61, 54, 47, 55, 62, 63])
# the example tables of the JPEG standard (Annex K), natural order
_LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13,
                    16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56,
                    68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103,
                    121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66,
                                                             24, 26, 56, 47, 66]
# Huffman tables of fixed length: every DC size a 4-bit code, every AC
# symbol (EOB, ZRL, run/size) an 8-bit one
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
_DC_CODE = {s: (i, 4) for i, s in enumerate(_DC_SYMBOLS)}
_AC_CODE = {s: (i, 8) for i, s in enumerate(_AC_SYMBOLS)}


def _dct_matrix() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    c = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)   # byte stuffing
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)   # pad with 1-bits
        return bytes(self.out)


def _size(v: int) -> int:
    return int(abs(v)).bit_length()


def encode_jpeg(img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0") -> bytes:
    """A baseline JFIF JPEG of uint8 `img` ([H, W] gray or [H, W, 3] RGB):
    YCbCr with 4:2:0 or 4:4:4 chroma, the standard's example quantisation
    tables scaled to `quality`, Huffman tables of fixed code length. What
    the data trees of phase 23 are written with (Pillow and cv2 are not
    promised on the card's machine); Pillow decodes the files it writes as
    the port does (tests/test_torch_jpeg.py)."""
    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    h, w = img.shape[:2]
    hs = 1 if gray or subsampling == "4:4:4" else 2
    if not gray and subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling {subsampling!r}: 4:2:0 or 4:4:4")
    mcu = 8 * hs
    ph, pw = -(-h // mcu) * mcu, -(-w // mcu) * mcu
    x = np.pad(img.astype(np.float64), ((0, ph - h), (0, pw - w)) + ((0, 0),) * (img.ndim - 2),
               mode="edge")
    if gray:
        planes = [x]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        if hs == 2:
            planes[1:] = [p.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3)) for p in planes[1:]]
    tables = [_quant_table(_LUMA_Q, quality), _quant_table(_CHROMA_Q, quality)]
    cm = _dct_matrix()
    coefs = []
    for i, p in enumerate(planes):
        blk = _blocks(p - 128.0)
        f = np.einsum("ux,abxy,vy->abuv", cm, blk, cm).reshape(blk.shape[:2] + (64,))
        q = tables[min(i, 1)].astype(np.float64)
        coefs.append(np.round(f / q).astype(np.int64)[..., _ZIGZAG])
    bw = _BitWriter()
    preds = [0] * len(planes)
    by_n, bx_n = ph // mcu, pw // mcu
    units = [(0, hs)] + [(i, 1) for i in range(1, len(planes))]
    for my in range(by_n):
        for mx in range(bx_n):
            for ci, n in units:
                for dy in range(n):
                    for dx in range(n):
                        zz = coefs[ci][my * n + dy, mx * n + dx]
                        diff = int(zz[0]) - preds[ci]
                        preds[ci] = int(zz[0])
                        s = _size(diff)
                        bw.put(*_DC_CODE[s])
                        if s:
                            bw.put(diff if diff > 0 else diff - 1, s)
                        nz = np.flatnonzero(zz[1:]) + 1
                        last = 0
                        for k in nz:
                            run = int(k) - last - 1
                            while run > 15:
                                bw.put(*_AC_CODE[0xF0])
                                run -= 16
                            v = int(zz[k])
                            s = _size(v)
                            bw.put(*_AC_CODE[(run << 4) | s])
                            bw.put(v if v > 0 else v - 1, s)
                            last = int(k)
                        if last < 63:
                            bw.put(*_AC_CODE[0x00])
    data = bw.flush()

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(tables[:1 if gray else 2]):
        out.append(seg(0xDB, bytes([t]) + bytes(q[_ZIGZAG].astype(np.uint8).tolist())))
    comps = [(1, (hs << 4) | hs, 0)] + ([] if gray else [(2, 0x11, 1), (3, 0x11, 1)])
    out.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                   + b"".join(bytes(c) for c in comps)))
    for t in range(1 if gray else 2):
        dc = bytes([0, 0, 0, len(_DC_SYMBOLS)] + [0] * 12)
        ac = bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8)
        out.append(seg(0xC4, bytes([t]) + dc + bytes(_DC_SYMBOLS)))
        out.append(seg(0xC4, bytes([0x10 | t]) + ac + bytes(_AC_SYMBOLS)))
    sos = bytes([len(comps)]) + b"".join(bytes([cid, (min(i, 1) << 4) | min(i, 1)])
                                        for i, (cid, _, _) in enumerate(comps))
    out.append(seg(0xDA, sos + b"\x00\x3f\x00"))
    out.append(data + b"\xff\xd9")
    return b"".join(out)


def encode_png(arr: np.ndarray, palette: np.ndarray = None) -> bytes:
    """An 8-bit PNG of uint8 [H, W]: gray, or palette indices with
    `palette` [n, 3] (a PLTE chunk)."""
    arr = np.asarray(arr, np.uint8)
    h, w = arr.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr], axis=1).tobytes()
    colour = 0 if palette is None else 3
    parts = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    parts += [chunk(b"IDAT", zlib.compress(raw, 6)), chunk(b"IEND", b"")]
    return b"".join(parts)


def _generic_pair(rng, h: int, w: int, classes: int, background: int, void: int,
                  border: int):
    """An RGB scene of a few elliptic objects over a gradient, with noise,
    and its label map: object classes in [1, classes) over `background`,
    with `border` pixels of `void` around each object (VOC: background 0,
    a 255 border; ADE20K: a labelled background, a void 0 border)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([120 + 80 * np.sin(x / (40 + 20 * k) + k) * np.cos(y / 50.0) for k in range(3)],
                   -1)
    lab = np.full((h, w), background, np.uint8)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(h / 12, h / 3), rng.uniform(w / 12, w / 3)
        d = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2
        img[d < 1] = rng.uniform(20, 235, 3)
        lab[(d >= 1) & (d < (1 + border / min(ry, rx)) ** 2)] = void
        lab[d < 1] = int(rng.randint(1, classes))
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), lab


def write_generic_tree(root: str, name: str, rng) -> dict:
    """A data tree in the layout `senas_torch/data/generic.py` walks:
    VOCdevkit/VOC2012 (JPEGImages, palette PNGs with a 255 border,
    ImageSets/Segmentation/{trainval,val}.txt) or ADEChallengeData2016
    (images/ and annotations/ {training,validation}, gray PNGs with void
    0). GENERIC_DISTINCT images, half 4:2:0 and half 4:4:4, written under
    every name. Returns the counts and the files' bytes."""
    tree = GENERIC_TREES[name]
    h, w = tree["hw"]
    pairs = []
    for i in range(GENERIC_DISTINCT):
        if name == "pascal_voc":
            img, lab = _generic_pair(rng, h, w, tree["classes"], 0, 255, border=5)
        else:
            img, lab = _generic_pair(rng, h, w, tree["classes"], 1 + i, 0, border=3)
        jpg = encode_jpeg(img, 90, "4:2:0" if i % 2 == 0 else "4:4:4")
        if name == "pascal_voc":
            palette = np.random.RandomState(i).randint(0, 256, (256, 3))
            png = encode_png(lab, palette)
        else:
            png = encode_png(lab)
        pairs.append((img, lab, jpg, png))
    names = {"train": [f"{name}_{i:04d}" for i in range(tree["train"])],
             "val": [f"{name}_v{i:04d}" for i in range(tree["val"])]}
    written = 0

    def put(path, data):
        nonlocal written
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        written += len(data)

    for split, stems in names.items():
        for i, stem in enumerate(stems):
            _, _, jpg, png = pairs[i % GENERIC_DISTINCT]
            if name == "pascal_voc":
                base = os.path.join(root, "VOCdevkit", "VOC2012")
                put(os.path.join(base, "JPEGImages", stem + ".jpg"), jpg)
                put(os.path.join(base, "SegmentationClass", stem + ".png"), png)
            else:
                base = os.path.join(root, "ADEChallengeData2016")
                sub = "training" if split == "train" else "validation"
                put(os.path.join(base, "images", sub, stem + ".jpg"), jpg)
                put(os.path.join(base, "annotations", sub, stem + ".png"), png)
    if name == "pascal_voc":
        base = os.path.join(root, "VOCdevkit", "VOC2012", "ImageSets", "Segmentation")
        os.makedirs(base, exist_ok=True)
        for fname, split in (("trainval.txt", "train"), ("val.txt", "val")):
            with open(os.path.join(base, fname), "w") as f:
                f.write("\n".join(names[split]) + "\n")
    return dict(pairs=pairs, names=names, bytes=written)


def _sample_ms(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    return (time.perf_counter() - t0) * 1e3 / reps


def time_generic(dataset, tree: dict) -> dict:
    """ms per sample of the JPEG decode, the bilinear resize to the
    scale-jitter's middle size, and the whole train-mode __getitem__."""
    paths = dataset.images[:GENERIC_DISTINCT]
    decode = _sample_ms(lambda i: read_image(paths[i % len(paths)], "RGB"), GENERIC_TIMED)
    img = read_image(paths[0], "RGB")
    h, w = img.shape[:2]
    long = int(dataset.base_size * 1.5)
    size = (long, int(1.0 * h * long / w + 0.5)) if w >= h else (int(1.0 * w * long / h + 0.5), long)
    resample = _sample_ms(lambda i: pilresample.resize_bilinear(img, size), GENERIC_TIMED)
    random.seed(0)
    item = _sample_ms(lambda i: dataset[i % len(dataset)], GENERIC_TIMED)
    return dict(decode_ms=decode, resample_ms=resample, resample_to=list(size), getitem_ms=item)


def _generic_config(work: str, name: str, remat: bool) -> str:
    """senas_promise12.yml with `data.dataset` set to `name` (and
    `training.remat`)."""
    cfg = load_config(CONFIG)
    cfg["data"]["dataset"] = name
    cfg["training"]["remat"] = remat
    path = os.path.join(work, f"generic_{name}_{int(remat)}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)
    return path


def _generic_train(work: str, root: str, name: str, model: str) -> dict:
    """train_model for one epoch on the tree, in this process; remat on
    when the step's peak passes GENERIC_REMAT_BYTES without it."""
    for remat in (False, True):
        torch.cuda.reset_peak_memory_stats()
        out = _in_process(train_model.main, "--config", _generic_config(work, name, remat),
                          "--model", model, "--epoch", "1", "--data_root", root,
                          "--log_root", os.path.join(work, "logs"))
        peak = torch.cuda.max_memory_allocated()
        sc = _scalars(_run_dir(out))
        check(all(np.isfinite(v) for v in sc.values()), f"{name} {model} scalars {sc}")
        if peak <= GENERIC_REMAT_BYTES:
            break
    row = dict(ms_per_step=1e3 / sc["Train/steps_per_sec"],
               prefetch_wait_share=sc["Train/prefetch_wait_share"], peak_gb=peak / 1e9,
               remat=remat, loss=sc["Train/Loss"])
    log(f"  {name} {model}: {row}")
    return row


def _generic_batch(root: str, seed: int) -> dict:
    """One decoded ADE20K train batch of GENERIC_CPU's size: the window of
    its samples with the most labelled pixels that still holds void ones
    (-1)."""
    ds = get_dataset("ade20k", root, mode="train")
    random.seed(seed)
    samples = [ds[i] for i in range(GENERIC_CPU["batch"])]
    hw = GENERIC_CPU["hw"]
    img = np.stack([s[0] for s in samples])
    lab = np.stack([s[1] for s in samples]).astype(np.int64)
    best = (-1, 0, 0)
    for y in range(0, lab.shape[1] - hw + 1, hw // 2):
        for x in range(0, lab.shape[2] - hw + 1, hw // 2):
            win = lab[:, y:y + hw, x:x + hw]
            if (win == -1).any() and int((win >= 0).sum()) > best[0]:
                best = (int((win >= 0).sum()), y, x)
    _, y, x = best
    return {"image": torch.from_numpy(np.ascontiguousarray(img[:, y:y + hw, x:x + hw])),
            "label": torch.from_numpy(np.ascontiguousarray(lab[:, y:y + hw, x:x + hw]))}


def _step_card_vs_cpu(build, batch: dict, t: dict, dev, dtype=torch.float32) -> tuple:
    """One fixed train step of `build(device)` in `dtype` from one state on
    the CPU and on the card (dropout from one CPU generator): (metrics rel,
    state rel, metrics on the card)."""
    model0 = build("cpu").to(dtype).state_dict()

    def run_on(d):
        model = build(d).to(dtype)
        model.load_state_dict({k: v.to(d) for k, v in model0.items()})
        state = FixedTrainState.create(model, t["model_optimizer"], rng=torch.Generator())
        m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
            state, {k: (v.to(dtype) if v.is_floating_point() else v).to(d)
                    for k, v in batch.items()})
        return ({k: v.cpu() for k, v in m.items()},
                {"model": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                 "arch": {}})

    before = {"model": {k: v.clone() for k, v in model0.items()}, "arch": {}}
    m_cpu, after_cpu = run_on("cpu")
    m_card, after_card = run_on(dev)
    return (_metrics_rel(m_card, m_cpu, ("loss", "grad_norm")),
            _state_rel(before, after_card, after_cpu), m_card)


def run_generic_path(dev, seed: int, work: str) -> dict:
    """Phase 23: the generic trees through the loaders and train_model, an
    ADE20K step with void labels on the card against the CPU, and
    SenasModel's dropout (remat on against off, card against CPU)."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 23)
    t = load_config(CONFIG)["training"]
    out = dict(trees={}, card_vs_cpu={})
    root = os.path.join(work, "generic")
    for name in GENERIC_TREES:
        tree = write_generic_tree(root, name, rng)
        ds = get_dataset(name, root, mode="train")
        check(len(ds) == GENERIC_TREES[name]["train"]
              and len(get_dataset(name, root, mode="val")) == GENERIC_TREES[name]["val"],
              f"{name}: {len(ds)} train samples")
        # the decoder against the written pixels (a lossy code: close, not equal)
        img, lab = tree["pairs"][0][:2]
        got = read_image(ds.images[0], "RGB")
        mask = read_image(ds.masks[0], None)
        err = float(np.abs(got.astype(np.int64) - img).mean())
        check(got.shape == img.shape and err < 12 and np.array_equal(mask, lab),
              f"{name}: decoded {got.shape}, mean |err| {err:.2f}, mask equal "
              f"{np.array_equal(mask, lab)}")
        x, y = ds[0]
        crop = tuple(ds.crop_size)
        check(x.shape == crop + (3,) and x.dtype == np.float32 and y.shape == crop
              and np.isfinite(x).all(), f"{name} sample {x.shape} {x.dtype} {y.shape}")
        labels = np.unique(y)
        check(labels.min() >= (-1 if name == "ade20k" else 0) and labels.max() < ds.num_class,
              f"{name} labels {labels}")
        timing = time_generic(ds, tree)
        rows = {m: _generic_train(work, root, name, m) for m in GENERIC_MODELS}
        out["trees"][name] = dict(timing, bytes=tree["bytes"], decode_mean_abs_err=err,
                                  labels=[int(labels.min()), int(labels.max())], models=rows)
        log(f"generic-{name}: decode {timing['decode_ms']:.2f} ms, resample to "
            f"{timing['resample_to']} {timing['resample_ms']:.2f} ms, __getitem__ "
            f"{timing['getitem_ms']:.2f} ms a sample; {rows}")

    # one decoded ADE20K batch, void labels included, card against CPU
    batch = _generic_batch(root, seed)
    ct = dict(t, depth=GENERIC_CPU["depth"], init_channels=GENERIC_CPU["c"])
    ade = GENERIC_TREES["ade20k"]["classes"]
    build = lambda d: SenasModel(ade, 3, c=ct["init_channels"], depth=ct["depth"],
                                 genotype=getattr(geno_searched, ct["geno_type"]), device=d,
                                 generator=torch.Generator().manual_seed(seed + 23))
    rel_m, rel_s, m = _step_card_vs_cpu(build, batch, ct, dev)
    void = int((batch["label"] == -1).sum())
    check(0 < void < batch["label"].numel(), f"the ADE20K batch holds {void} void pixels")
    log(f"generic ADE20K step card vs CPU (depth {ct['depth']}, c {ct['init_channels']}, "
        f"{GENERIC_CPU['hw']}x{GENERIC_CPU['hw']}, batch {GENERIC_CPU['batch']}, {void} void "
        f"pixels): loss {float(m['loss']):.6f}, metrics rel {rel_m}, state {rel_s} (limits "
        f"{CARD_CPU_LIMITS})")
    check(np.isfinite(float(m["loss"])) and _within(rel_m, rel_s),
          f"the ADE20K step on the card and the CPU disagree: {rel_m} {rel_s}")
    out["card_vs_cpu"]["ade20k_void"] = dict(metrics=rel_m, state=rel_s, void_pixels=void)

    # SenasModel at dropout_prob 0.2, full width: the card against the CPU
    # from one CPU generator, remat on against off on the card
    out["dropout"] = run_generic_dropout(dev, seed, t)
    out["seconds"] = time.perf_counter() - t0
    return out


def _dropout_model(t, d, seed: int, p: float = GENERIC_DROPOUT, remat: bool = False):
    return SenasModel(21, 3, c=t["init_channels"], depth=t["depth"], dropout_prob=p,
                      genotype=getattr(geno_searched, t["geno_type"]), remat=remat, device=d,
                      generator=torch.Generator().manual_seed(seed + 24))


def _dropout_batch(rng, b: int, hw: int, dev) -> dict:
    return {"image": torch.from_numpy(rng.randn(b, hw, hw, 3).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.randint(0, 21, (b, hw, hw))).to(dev)}


def run_generic_dropout(dev, seed: int, t: dict) -> dict:
    """SenasModel with dropout_prob GENERIC_DROPOUT at full width (c 32,
    depth 5), batch 2 of 64x64x3: one step on the card against the CPU from
    one CPU generator, and on the card with remat on against off (cuDNN
    deterministic), both in f64 within CARD_CPU_LIMITS (in f32 the CPU's
    own full-width step lies 1.2e-3 of its update from its f64 one at this
    size, a BatchNorm over the 2x2 deepest maps; the f32 card-vs-CPU
    distance is logged); then ms/step and peak at batch 12 of 256x256x3
    with dropout, with dropout and remat, and at dropout_prob 0."""
    hw, f64 = GENERIC_DROPOUT_HW, torch.float64
    batch = _dropout_batch(np.random.RandomState(seed + 24), 2, hw, "cpu")
    build = lambda d: _dropout_model(t, d, seed)
    rel_m, rel_s, _ = _step_card_vs_cpu(build, batch, t, dev, f64)
    check(_within(rel_m, rel_s), f"the f64 dropout step on the card and the CPU disagree: "
                                 f"{rel_m} {rel_s}")
    f32_m, f32_s, _ = _step_card_vs_cpu(build, batch, t, dev)
    before = {"model": {k: v.clone() for k, v in build("cpu").to(f64).state_dict().items()},
              "arch": {}}
    runs = {}
    for remat in (False, True):
        model = _dropout_model(t, dev, seed, remat=remat).to(f64)
        state = FixedTrainState.create(model, t["model_optimizer"], rng=torch.Generator())
        with deterministic_cudnn():
            m = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])(
                state, {k: (v.to(f64) if v.is_floating_point() else v).to(dev)
                        for k, v in batch.items()})
        runs[remat] = ({k: v.cpu() for k, v in m.items()},
                       {"model": {k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()}, "arch": {}})
    remat_m = _metrics_rel(runs[True][0], runs[False][0], ("loss", "grad_norm"))
    remat_s = _state_rel(before, runs[True][1], runs[False][1])
    check(_within(remat_m, remat_s), f"remat on and off disagree on the dropout step: "
                                     f"{remat_m} {remat_s}")
    b, thw = GENERIC_DROPOUT_TIMED
    timed_batch = _dropout_batch(np.random.RandomState(seed + 25), b, thw, dev)
    timed = {}
    for label, p, remat in (("dropout_0", 0.0, False), ("dropout", GENERIC_DROPOUT, False),
                            ("dropout_remat", GENERIC_DROPOUT, True)):
        model = _dropout_model(t, dev, seed, p, remat)
        state = FixedTrainState.create(model, t["model_optimizer"])
        step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
        torch.cuda.reset_peak_memory_stats()
        step(state, timed_batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            s0 = time.perf_counter()
            m = step(state, timed_batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - s0) * 1e3)
        check(np.isfinite(float(m["loss"])), f"{label}: loss {float(m['loss'])}")
        timed[label] = dict(ms=float(np.mean(times)),
                            peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        del model, state
        torch.cuda.empty_cache()
    out = dict(card_vs_cpu=dict(metrics=rel_m, state=rel_s),
               card_vs_cpu_f32=dict(metrics=f32_m, state=f32_s),
               remat=dict(metrics=remat_m, state=remat_s), timed=timed)
    log(f"generic dropout (SenasModel c {t['init_channels']}, depth {t['depth']}, p "
        f"{GENERIC_DROPOUT}): f64 card vs CPU (batch 2 of {hw}x{hw}x3) {out['card_vs_cpu']}; "
        f"f64 remat on against off {out['remat']} (limits {CARD_CPU_LIMITS}); f32 card vs CPU "
        f"(logged) {out['card_vs_cpu_f32']}; batch {b} of {thw}x{thw}x3 ms/step and peak MiB "
        f"{timed}")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the long tail (M17)
# ---------------------------------------------------------------------------

LEGACY_HW = 64                # the legacy blocks' card-vs-CPU inputs: batch 2 of 64x64
LEGACY_C = 8
LEGACY_F64_LIMIT = 1e-9       # f64: each tensor within 1e-9 of its largest magnitude
# pytorch-semseg's SegNet: (width, convolutions) of each SegnetDown, mirrored
# by the SegnetUps
SEGNET_WIDTHS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SOM_GRID, SOM_SAMPLES, SOM_ITERATIONS = (20, 20), (1000, 16), 20
SOM_LIMIT = 1e-5              # the f32 SOM weights, card against CPU, before a tie
SOM_TIE_ULPS = 4              # a best-matching unit may differ only at a near-tie
SOM_F64_LIMIT = 1e-9          # the card's f64 20-iteration weights against the CPU's
RUNSCORE_CLASSES = 5
CLI_SAMPLES = 32              # calc_mean_std's synthetic samples


class LegacySegNet(torch.nn.Module):
    """pytorch-semseg's SegNet from the legacy blocks: SegnetDown x 5 at
    SEGNET_WIDTHS, the mirrored SegnetUp x 5 (widths 512, 256, 128, 64,
    64) and a 1x1 head. NHWC in and out, as the fixed train step gives and
    takes."""

    def __init__(self, in_channels: int, nclass: int):
        super().__init__()
        c = in_channels
        for i, (w, n) in enumerate(SEGNET_WIDTHS):
            setattr(self, f"down{i + 1}", lb.SegnetDown(c, w, n))
            c = w
        for i in reversed(range(len(SEGNET_WIDTHS))):
            w = SEGNET_WIDTHS[max(i - 1, 0)][0]
            setattr(self, f"up{i + 1}", lb.SegnetUp(c, w, SEGNET_WIDTHS[i][1]))
            c = w
        self.head = lb.ConvNorm(c, nclass, 1, norm=None)

    def forward(self, x, train: bool = False, rng=None):
        x, saved = x.permute(0, 3, 1, 2).contiguous(), []
        for i in range(len(SEGNET_WIDTHS)):
            x, idx, hw = getattr(self, f"down{i + 1}")(x, train)
            saved.append((idx, hw))
        for i in reversed(range(len(SEGNET_WIDTHS))):
            x = getattr(self, f"up{i + 1}")(x, *saved[i], train)
        return self.head(x, train).permute(0, 2, 3, 1)


def _legacy_cases():
    """(label, block, NCHW input shapes, extra arguments) of each legacy
    block class and the customize modules at batch 2 of 64x64."""
    b, c, hw, h2 = 2, LEGACY_C, LEGACY_HW, LEGACY_HW // 2
    pooled, idx = lb.max_pool_argmax_2x2(torch.randn(b, 16, hw, hw, dtype=torch.float64,
                                                     generator=torch.Generator().manual_seed(2)))
    return [
        ("ConvNorm batch", lambda: lb.ConvNorm(c, 16, 3, stride=2, padding=1, act=True),
         [(b, c, hw, hw)], ()),
        ("ConvNorm group", lambda: lb.ConvNorm(c, 16, 3, padding=2, dilation=2, norm="group",
                                               n_groups=4), [(b, c, hw, hw)], ()),
        ("ConvNorm transposed", lambda: lb.ConvNorm(c, 16, 3, stride=2, padding=1,
                                                    transpose=True), [(b, c, h2, h2)], ()),
        ("UnetConv2", lambda: lb.UnetConv2(c, 16), [(b, c, hw, hw)], ()),
        ("UnetUp", lambda: lb.UnetUp(16, c, 8), [(b, c, hw, hw), (b, 16, h2, h2)], ()),
        ("UnetUp bilinear", lambda: lb.UnetUp(16, c, 8, is_deconv=False),
         [(b, c, hw, hw), (b, 16, h2, h2)], ()),
        ("SegnetDown", lambda: lb.SegnetDown(c, 16, 3), [(b, c, hw, hw)], ()),
        ("SegnetUp", lambda: lb.SegnetUp(16, c, 2), [tuple(pooled.shape)], (idx, (hw, hw))),
        ("ResidualBlock", lambda: lb.ResidualBlock(c, 16, 2), [(b, c, hw, hw)], ()),
        ("ResidualBottleneck", lambda: lb.ResidualBottleneck(c, 4, 2), [(b, c, hw, hw)], ()),
        ("LinknetUp", lambda: lb.LinknetUp(c, 16), [(b, c, h2, h2)], ()),
        ("FRRU", lambda: lb.FRRU(c, 16, 2), [(b, c, h2, h2), (b, 32, hw, hw)], ()),
        ("FRRU group", lambda: lb.FRRU(c, 16, 4, group_norm=True, n_groups=4),
         [(b, c, hw // 4, hw // 4), (b, 32, hw, hw)], ()),
        ("RU", lambda: lb.RU(c, c), [(b, c, hw, hw)], ()),
        ("ResidualConvUnit", lambda: lb.ResidualConvUnit(c), [(b, c, hw, hw)], ()),
        ("MultiResolutionFusion", lambda: lb.MultiResolutionFusion(c, 16, 2, 4, low_channels=c),
         [(b, c, h2 + 2, h2 + 2), (b, c, hw // 4 + 2, hw // 4 + 2)], ()),
        ("ChainedResidualPooling", lambda: lb.ChainedResidualPooling(c, c), [(b, c, hw, hw)], ()),
        ("BottleNeckPSP", lambda: lb.BottleNeckPSP(c, 4, 16, dilation=2), [(b, c, hw, hw)], ()),
        ("BottleNeckIdentifyPSP", lambda: lb.BottleNeckIdentifyPSP(c, 4, 2), [(b, c, hw, hw)], ()),
        ("ResidualBlockPSP", lambda: lb.ResidualBlockPSP(c, 3, 4, 16, stride=2),
         [(b, c, hw, hw)], ()),
        ("CascadeFeatureFusion", lambda: lb.CascadeFeatureFusion(3, c, c, 16),
         [(b, c, h2, h2), (b, c, hw, hw)], ()),
        ("PyramidPooling", lambda: customize.PyramidPooling(16), [(b, 16, hw, hw)], ()),
        ("PyramidPooling resize", lambda: customize.PyramidPooling(16), [(b, 16, 50, 50)], ()),
        ("ConcurrentModule", lambda: customize.ConcurrentModule(
            [lb.ConvNorm(c, 4, 3, padding=1), lb.ConvNorm(c, 6, 1)]), [(b, c, hw, hw)], ()),
    ]


def _legacy_run(block, xs, extra, readouts=None):
    """A train-mode forward and backward of sum(output * readout): the
    outputs, the inputs' and parameters' gradients, the running stats."""
    dev = xs[0].device
    xs = [x.clone().requires_grad_() for x in xs]
    out = block(*xs, *[e.to(dev) if isinstance(e, torch.Tensor) else e for e in extra],
                train=True)
    outs = [o for o in (out if isinstance(out, tuple) else (out,))
            if isinstance(o, torch.Tensor) and o.is_floating_point()]
    if readouts is None:
        g = torch.Generator().manual_seed(7)
        readouts = [torch.randn(o.shape, dtype=o.dtype, generator=g) for o in outs]
    sum((o * r.to(dev)).sum() for o, r in zip(outs, readouts)).backward()
    got = {f"out{i}": o.detach() for i, o in enumerate(outs)}
    got.update({f"dx{i}": x.grad for i, x in enumerate(xs)})
    got.update({f"d.{k}": p.grad for k, p in block.named_parameters() if p.grad is not None})
    got.update({f"buffer.{k}": v for k, v in block.named_buffers()})
    return {k: v.cpu() for k, v in got.items()}, readouts


def legacy_blocks_card_vs_cpu(dev, seed: int) -> dict:
    """Each legacy block class and the customize modules in f64, train
    mode, on the card against the CPU from one state: outputs, input and
    parameter gradients and running stats, each within LEGACY_F64_LIMIT of
    its largest magnitude, under deterministic algorithms (warn_only)."""
    out = {}
    for i, (label, make, shapes, extra) in enumerate(_legacy_cases()):
        block = init_params_(make().double(), torch.Generator().manual_seed(seed + i))
        g = torch.Generator().manual_seed(seed + 100 + i)
        xs = [torch.randn(s, dtype=torch.float64, generator=g) * 1.3 + 0.2 for s in shapes]
        card = copy.deepcopy(block).to(dev)
        want, readouts = _legacy_run(block, xs, extra)
        # F.interpolate's antialiased backward (the linear resizes other
        # than 2x) has no deterministic CUDA version: it adds with atomics,
        # whose order moves an f64 sum by ~1e-16 of it
        with deterministic_algorithms(warn_only=True):
            got, _ = _legacy_run(card, [x.to(dev) for x in xs], extra, readouts)
        check(got.keys() == want.keys(), f"{label}: {sorted(set(got) ^ set(want))}")
        worst = max(rel_err(got[k], want[k]) for k in want)
        out[label] = worst
        check(worst <= LEGACY_F64_LIMIT, f"legacy {label}: the card lies {worst:.3g} from the "
                                         f"CPU in f64 (limit {LEGACY_F64_LIMIT})")
    log(f"legacy blocks card vs CPU (f64, batch 2 of {LEGACY_HW}x{LEGACY_HW}, train mode, "
        f"deterministic algorithms; worst tensor's max |diff| over its max |value|, limit "
        f"{LEGACY_F64_LIMIT}): { {k: float(f'{v:.3g}') for k, v in out.items()} }")
    return out


def run_legacy_segnet(dev, seed: int) -> dict:
    """legacy-segnet-train: LegacySegNet at the `training:` geometry (batch
    12 of 256x256x1, SGD, dice_ce, f32, TF32 off): 1 + 3 steps with the
    gate on, the kernels' counts set to 0 before and read after (each of
    K1a-K1d once a BatchNorm a step); the gated BatchNorm at each shape
    the path gives it held to the kernels' plain twins and to the gate off
    (check_bn_path); then the gate on and off in turns with a profile each
    way."""
    t = load_config(CONFIG)["training"]
    bs = t["batch_size"]
    batch = _batches(np.random.RandomState(seed + 24), 1, bs, HW, dev)[0]
    model = init_params_(LegacySegNet(IN_CHANNELS, NCLASS),
                         torch.Generator().manual_seed(seed + 24)).to(dev)
    state = FixedTrainState.create(model, t["model_optimizer"], seed=seed)
    step = make_train_step(_fixed_loss(t), grad_clip=t["grad_clip"])
    with bn_inputs(model) as seen, pallas_bn(False):
        step(state, batch)
    bn_calls = len(seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    with pallas_bn(True):
        m = step(state, batch)
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    want = {name: (4 * bn_calls if name in EPILOGUE_REPLACES else 0) for name in KERNELS}
    check(launches == want, f"legacy-segnet-train: 1 + 3 gated steps launched {launches}, "
                            f"expected {want}")
    check(np.isfinite(float(m["loss"])), f"legacy-segnet-train loss {float(m['loss'])}")
    shapes = sorted(set(seen))
    t0 = time.perf_counter()
    bn_worst = check_bn_path(dev, seed + 24, shapes)
    bn_check_s = time.perf_counter() - t0
    log(f"legacy-segnet-train's {len(shapes)} BatchNorm shapes {[list(x) for x in shapes]} held "
        f"to the twins and the gate off in {bn_check_s:.1f} s: worst "
        f"{ {k: float(f'{v:.3g}') for k, v in bn_worst.items()} }")
    turns = _gate_turns(f"legacy-segnet-train, batch {bs}", lambda: step(state, batch), bn_calls)
    params_m = sum(p.numel() for p in model.parameters()) / 1e6
    log(f"legacy-segnet-train (SegnetDown x5 at {[w for w, _ in SEGNET_WIDTHS]}, {params_m:.2f} "
        f"M params, batch {bs} of {HW}x{HW}x{IN_CHANNELS}): gated 1 + 3 steps "
        f"{[round(x, 2) for x in times]} ms, peak {peak:.1f} MiB, loss {float(m['loss']):.5f}; "
        f"{bn_calls} BatchNorm calls a step, launches {launches}")
    del model, state
    torch.cuda.empty_cache()
    return dict(ms_gated=float(np.mean(times)), peak_mib=peak, bn_calls=bn_calls,
                launches=launches, turns=turns, params_m=params_m, bn_shapes=shapes,
                bn_worst=bn_worst, bn_check_s=bn_check_s)


def _som_grid(som, dev, dtype):
    gx, gy = torch.meshgrid(torch.arange(som.width), torch.arange(som.height), indexing="ij")
    return torch.stack([gx, gy]).to(dev, dtype)


def _som_bmu_trace(som, data, init, dev):
    """`train_som`'s f32 loop (senas_torch/som.py) op for op on `dev`, each
    step's best-matching unit and the two smallest squared distances
    recorded: (the final weights as float64 numpy, the weights after each
    iteration [iters, W, H, D], the units [iters, n], the two distances
    [iters, n, 2]). Its final weights are held bit for bit to `fit`'s."""
    f32 = torch.float32
    w = torch.as_tensor(init, dtype=f32, device=dev)
    coords = _som_grid(som, dev, f32)
    tc = torch.tensor(som.time_constant, dtype=f32, device=dev)
    snaps, bmus, tops = [], [], []
    for step in range(som.n_iterations):
        t = torch.tensor(float(step), dtype=f32, device=dev)
        decay = torch.exp(-t / tc)
        radius = float(som.initial_radius) * decay
        lr = float(som.initial_learning_rate) * decay
        two_r2 = 2.0 * radius ** 2
        units, two = [], []
        for vector in torch.as_tensor(data, dtype=f32, device=dev):
            sq = ((w - vector) ** 2).sum(dim=-1)
            flat_idx = torch.argmin(sq)
            units.append(flat_idx)
            two.append(torch.topk(sq.reshape(-1), 2, largest=False).values)
            bx = torch.div(flat_idx, som.height, rounding_mode="floor")
            by = flat_idx % som.height
            grid_sq = (coords[0] - bx) ** 2 + (coords[1] - by) ** 2
            influence = torch.exp(-grid_sq / two_r2)
            w = w + lr * influence[..., None] * (vector - w)
        snaps.append(w.cpu().numpy().astype(float))
        bmus.append(torch.stack(units).cpu().numpy())
        tops.append(torch.stack(two).double().cpu().numpy())
    return snaps[-1], np.stack(snaps), np.stack(bmus), np.stack(tops)


def run_som_card_vs_cpu(dev, seed: int) -> dict:
    """KohonenSOM.fit on the card (device=None) against the CPU, f32, timed.
    The two fits part where a sample's two nearest nodes tie to an f32
    ulp: the devices round the squared distances apart and take different
    best-matching units, and in the ordering phase (large radius and rate)
    that one step reorganises the map. So the witness is the loop traced
    step by step on both devices (`_som_bmu_trace`, bit-equal to `fit`):
    the units agree up to the first that differs, the weights within
    SOM_LIMIT after every iteration before it, and at it both devices'
    two nearest distances lie within SOM_TIE_ULPS ulps of each other. The
    same loop (`train_som`) in f64 over all SOM_ITERATIONS is held to
    SOM_F64_LIMIT with every sample predicted alike. The f32 fits' weight
    difference, share of samples alike and quantization errors (and the
    initial weights') are logged, with the seconds of each run."""
    data = np.random.RandomState(seed + 24).rand(*SOM_SAMPLES)
    w, h = SOM_GRID
    t0 = time.perf_counter()
    card = KohonenSOM(w, h, SOM_ITERATIONS, random_state=seed).fit(data, record_history=True)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = KohonenSOM(w, h, SOM_ITERATIONS, random_state=seed, device="cpu").fit(
        data, record_history=True)
    cpu_s = time.perf_counter() - t0

    def fitted(weights):
        som = KohonenSOM(w, h)
        som.weights = weights
        return som

    diff = float(np.abs(card.weights - cpu.weights).max())
    share = float((card.predict(data) == cpu.predict(data)).all(axis=1).mean())
    qe = {"card": card.quantization_error(data), "cpu": cpu.quantization_error(data)}
    init = np.random.default_rng(seed).random((w, h, SOM_SAMPLES[1]))
    qe_init = float(fitted(init).quantization_error(data))
    check(len(card.quantization_error_history_) == SOM_ITERATIONS
          and np.isfinite(card.quantization_error_history_).all(),
          f"the card's SOM history {card.quantization_error_history_}")
    # the witness: where the f32 loops part
    t0 = time.perf_counter()
    trace = {"card": _som_bmu_trace(cpu, data, init, dev),
             "cpu": _som_bmu_trace(cpu, data, init, "cpu")}
    trace_s = time.perf_counter() - t0
    check(np.array_equal(trace["card"][0], card.weights)
          and np.array_equal(trace["cpu"][0], cpu.weights),
          "the traced SOM loop is not bit-equal to KohonenSOM.fit")
    (_, snap_card, bmu_card, top_card), (_, snap_cpu, bmu_cpu, top_cpu) = (trace["card"],
                                                                           trace["cpu"])
    differ = np.argwhere(bmu_card != bmu_cpu)
    flip = tuple(int(v) for v in differ[0]) if len(differ) else None
    before = flip[0] if flip else SOM_ITERATIONS
    early = float(np.abs(snap_card[:before] - snap_cpu[:before]).max()) if before else 0.0
    tie = {}
    if flip:
        for name, top in (("card", top_card), ("cpu", top_cpu)):
            near, second = top[flip]
            tie[name] = dict(gap=float(second - near),
                             ulps=float((second - near) / np.spacing(np.float32(second))))
    # the same loop in f64, card and CPU
    f64 = {}
    for name, on in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        weights, _ = train_som(
            torch.as_tensor(init, dtype=torch.float64, device=on),
            torch.as_tensor(data, dtype=torch.float64, device=on),
            _som_grid(cpu, on, torch.float64), height=h, n_iterations=SOM_ITERATIONS,
            initial_radius=float(cpu.initial_radius), time_constant=float(cpu.time_constant),
            initial_lr=float(cpu.initial_learning_rate), record_history=False)
        f64[name] = (weights.cpu().numpy(), time.perf_counter() - t0)
    f64_diff = float(np.abs(f64["card"][0] - f64["cpu"][0]).max())
    f64_share = float((fitted(f64["card"][0]).predict(data)
                       == fitted(f64["cpu"][0]).predict(data)).all(axis=1).mean())
    f64_to_f32 = float(np.abs(f64["cpu"][0] - cpu.weights).max())
    steps = SOM_ITERATIONS * SOM_SAMPLES[0]
    log(f"SOM {w}x{h}, {SOM_SAMPLES[0]}x{SOM_SAMPLES[1]} samples, {SOM_ITERATIONS} iterations, "
        f"f32: card {card_s:.2f} s ({card_s / steps * 1e6:.1f} us a sample step), CPU "
        f"{cpu_s:.2f} s; weights max |diff| {diff:.3g}, predicted alike {share:.4f}, "
        f"quantization error card {qe['card']:.6f} CPU {qe['cpu']:.6f} (initial {qe_init:.6f}), "
        f"topographic error card {card.topographic_error(data):.4f} CPU "
        f"{cpu.topographic_error(data):.4f}; traced ({trace_s:.2f} s): first differing unit "
        f"(iteration, sample) {flip}, card {bmu_card[flip] if flip else None} CPU "
        f"{bmu_cpu[flip] if flip else None}, the two nearest squared distances apart by {tie} "
        f"(limit {SOM_TIE_ULPS} ulps), weights before it within {early:.3g} (limit {SOM_LIMIT}), "
        f"units differing in the last iteration {int((bmu_card[-1] != bmu_cpu[-1]).sum())}; "
        f"f64: card {f64['card'][1]:.2f} s, CPU {f64['cpu'][1]:.2f} s, weights max |diff| "
        f"{f64_diff:.3g} (limit {SOM_F64_LIMIT}), predicted alike {f64_share:.4f}, the f64 CPU "
        f"fit {f64_to_f32:.3g} from the f32 CPU fit")
    check(early <= SOM_LIMIT, f"the SOM's f32 weights part before any unit differs: {early}")
    check(all(v["ulps"] <= SOM_TIE_ULPS for v in tie.values()),
          f"the SOM's first differing unit {flip} is no near-tie: {tie}")
    check(f64_diff <= SOM_F64_LIMIT and f64_share == 1.0,
          f"the SOM's {SOM_ITERATIONS} iterations in f64 on the card and the CPU disagree: "
          f"{f64_diff} {f64_share}")
    return dict(card_s=card_s, cpu_s=cpu_s, us_per_sample_step=card_s / steps * 1e6,
                max_abs_diff=diff, share_alike=share, qe=qe, qe_init=qe_init, trace_s=trace_s,
                first_flip=flip, tie=tie, before_flip_max_abs_diff=early,
                f64_card_s=f64["card"][1], f64_cpu_s=f64["cpu"][1], f64_max_abs_diff=f64_diff,
                f64_share_alike=f64_share, f64_to_f32=f64_to_f32)


def run_runscore_on_card(dev, seed: int) -> dict:
    """RunScore on CUDA label maps (torch.bincount on the card) against
    numpy, labels -1 and >= n included: equal matrices and scores."""
    n = RUNSCORE_CLASSES
    rng = np.random.RandomState(seed + 24)
    trues = rng.randint(-1, n + 2, (12, HW, HW))
    preds = rng.randint(0, n, (12, HW, HW))
    card, ref = RunScore(n), RunScore(n)
    t0 = time.perf_counter()
    card.update(torch.from_numpy(trues).to(dev), torch.from_numpy(preds).to(dev))
    ms = (time.perf_counter() - t0) * 1e3
    ref.update(trues, preds)
    (cs, ciu), (rs, riu) = card.get_scores(), ref.get_scores()
    check(np.array_equal(card.confusion_matrix, ref.confusion_matrix)
          and all(np.array_equal(cs[k], rs[k], equal_nan=True) for k in rs)
          and np.array_equal(list(ciu.values()), list(riu.values()), equal_nan=True),
          f"RunScore on the card {cs} against numpy {rs}")
    log(f"RunScore on CUDA label maps (12 of {HW}x{HW}, {n} classes): equal to numpy, "
        f"{ms:.2f} ms an update; {cs}")
    return dict(ms=ms, scores={k: float(v) for k, v in cs.items()})


def run_misc_on_card(dev, seed: int) -> dict:
    """get_gpus_memory_info (bytes_limit is mem_get_info's total),
    device_memory_log's lines, flops_params_info of SenasModel at the
    `training:` geometry."""
    best, stats = get_gpus_memory_info()
    _, total = torch.cuda.mem_get_info(0)
    check(best in stats and stats[0]["bytes_limit"] == total
          and set(stats[0]) == {"bytes_limit", "bytes_in_use", "peak_bytes_in_use"},
          f"get_gpus_memory_info: {best} {stats}, mem_get_info total {total}")
    lines = []
    device_memory_log(argparse.Namespace(info=lines.append), top_k=5)
    check(lines[0].startswith("device 0: in_use=") and any(x.startswith("live arrays: ")
                                                            for x in lines),
          f"device_memory_log lines {lines[:3]}")
    t = load_config(CONFIG)["training"]
    model = _fixed_model(t, dev, torch.Generator().manual_seed(seed)).eval()
    x = torch.zeros(t["batch_size"], HW, HW, IN_CHANNELS, device=dev)
    t0 = time.perf_counter()
    info = flops_params_info(model, x)
    s = time.perf_counter() - t0
    check(info["flops"] > 0 and info["params_m"] == sum(p.numel() for p in model.parameters())
          / 1e6, f"flops_params_info {info}")
    log(f"get_gpus_memory_info: card {best} of {len(stats)}, {stats}; device_memory_log "
        f"{lines[:3]}; flops_params_info of SenasModel at training: (batch {t['batch_size']} of "
        f"{HW}x{HW}x{IN_CHANNELS}, inference): {info['flops'] / 1e12:.4f} TFLOP, "
        f"{info['params_m']:.4f} M params, {s:.2f} s")
    del model
    return dict(stats=stats, flops=info["flops"], params_m=info["params_m"], flops_s=s)


def run_tail_clis(work: str) -> dict:
    """The two user tools in this process: calc_mean_std on the card
    (its default) against --device cpu on the synthetic dataset, and
    cell_visualize's .dot files against genotype_to_dot."""
    argv = ("--dataset", "synthetic", "--data-root", work, "--limit", str(CLI_SAMPLES))
    card = _in_process(calc_mean_std.main, *argv)
    cpu = _in_process(calc_mean_std.main, *argv, "--device", "cpu")
    check(card == cpu, f"calc_mean_std on the card {card!r} and the CPU {cpu!r}")
    t = load_config(CONFIG)["training"]
    out_dir = os.path.join(work, "cells")
    _in_process(cell_visualize.main, "--geno-name", t["geno_type"], "--directory", out_dir,
                "--format", "png")
    g = getattr(geno_searched, t["geno_type"])
    for tag, gene in (("DownC", g.down), ("UpC", g.up)):
        names = [n for n in os.listdir(out_dir) if n.startswith(tag) and n.endswith(".dot")]
        check(len(names) == 1, f"cell_visualize wrote {names}")
        with open(os.path.join(out_dir, names[0])) as f:
            check(f.read() == genotype_to_dot(gene), f"{names[0]} differs from genotype_to_dot")
    return dict(calc_mean_std=card.strip().splitlines())


def run_long_tail(dev, seed: int, work: str) -> dict:
    """Phase 24: the legacy blocks card against CPU, legacy-segnet-train
    (the gated BatchNorm's K1a-K1d), the SOM, RunScore, misc and the two
    user tools."""
    t0 = time.perf_counter()
    marks = []

    def timed(label, fn, *a):
        s0 = time.perf_counter()
        r = fn(*a)
        marks.append(f"{label} {time.perf_counter() - s0:.1f} s")
        return r

    out = dict(blocks=timed("blocks", legacy_blocks_card_vs_cpu, dev, seed),
               segnet=timed("segnet", run_legacy_segnet, dev, seed),
               som=timed("som", run_som_card_vs_cpu, dev, seed),
               runscore=timed("runscore", run_runscore_on_card, dev, seed),
               misc=timed("misc", run_misc_on_card, dev, seed),
               clis=timed("clis", run_tail_clis, work))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 24 (the long tail): {out['seconds']:.1f} s ({', '.join(marks)})")
    return out


# K1a's and K1c's n=1 shapes that `--k1` times beside phase 19's: a 1x1
# squeeze, 16x16 maps, and the encoder families' large planes (phases 20-21)
K1_SHAPES = ((12, 32, 1, 1), (12, 512, 16, 16), (12, 64, 128, 128), (12, 48, 128, 128))


def run_k1_only(dev, seed: int) -> dict:
    """`--k1`: phases 1-2, K1a-K1d against their plain twins with their
    timings (phase 3's f32 checks, phase 17's bf16 ones), phase 19's n=1
    timings beside the library calls, and K1a and K1c at K1_SHAPES; one
    JSON line of the readings. Drives no model path and prints no result."""
    environment()
    build()
    f32 = check_kernels(dev)
    bf16 = check_kernels_bf16(dev, f32)
    timed = {name: r["timed"] for name, r in (*f32.items(), *bf16.items())}
    log(json.dumps(timed))
    timed["shapes"] = {str(list(s)): time_k1_at(dev, s, seed + 24) for s in K1_SHAPES}
    log(json.dumps(timed["shapes"]))
    timed["n1"] = time_bn_kernels(dev, seed)
    log(json.dumps(timed["n1"]))
    return timed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, arch tables and batches")
    # phase 22 starts this script as its gloo ranks with these
    ap.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-out", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--k1", action="store_true",
                    help="only build, check and time K1a-K1d (run_k1_only); no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    if args.dp_rank is not None:
        return _dp_rank_main(args.dp_rank, args.dp_port, args.dp_out, args.seed)
    # TF32 off for convolutions and matmuls, so that the card computes in
    # f32 and its results can be held to the CPU's.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuBLAS's fixed workspace (32 MiB, its default on Hopper), read at the
    # first cuBLAS call, which `deterministic_algorithms` needs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda")
    if args.k1:
        run_k1_only(dev, args.seed)
        return 0

    t_start = time.perf_counter()
    phase_s = {}

    def phase(n, fn, *a):
        """fn(*a), its seconds added to phase n's and logged."""
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[n] = round(phase_s.get(n, 0.0) + time.perf_counter() - t0, 1)
        log(f"phase {n}: {phase_s[n]:.1f} s")
        return out

    smi = phase(1, environment)
    found = phase(1, libraries)
    sass = phase(2, build)
    records = phase(3, check_kernels, dev)
    records["norm_convs"] = phase(3, check_norm_convs, dev, args.seed)
    paths = {"norm_convs_call": phase(4, run_norm_convs_path, dev, args.seed)}
    evald = paths["eval"] = phase(5, run_eval_path, dev, args.seed)
    search = paths["search_step"] = phase(6, run_search_path, dev, args.seed)
    card_cpu = phase(7, train_card_vs_cpu, dev, args.seed)
    runner = phase(8, run_runner)
    fixed = paths["fixed_train_eval"] = phase(9, run_fixed_path, dev, args.seed)
    fixed_cpu = phase(10, fixed_card_vs_cpu, dev, args.seed)
    fixed_clis = phase(11, run_fixed_clis)
    with tempfile.TemporaryDirectory() as work:
        serve = paths["serve"] = phase(12, run_serve_path, dev, fixed, args.seed, work)
        paths["submission"] = phase(13, run_submission, dev, serve.pop("pred"), work, args.seed)
    with tempfile.TemporaryDirectory() as work:
        data = paths["promise12_data"] = phase(14, run_promise12_path, dev, evald["expect"], work,
                                               args.seed, found)
    with tempfile.TemporaryDirectory() as work:
        shipped = paths["shipped_configs"] = phase(15, run_shipped_configs, dev,
                                                   evald["expect"], work, args.seed)
    zoo = paths["zoo"] = phase(16, run_zoo, dev, args.seed)
    bf16 = phase(17, run_bf16, dev, args.seed, records)
    records.update(bf16["records"])
    bf16_zoo = phase(18, run_bf16_zoo, dev, args.seed, records, zoo)
    records["norm_convs" + BF16_SUFFIX] = bf16_zoo["record"]
    paths["bf16_zoo"] = bf16_zoo["path"]
    paths["bf16_search_step"] = bf16["search"]["search"]
    paths["bf16_search_eval"] = bf16["search"]["eval"]
    paths["bf16_fixed_train_eval"] = dict(launches={
        k: bf16["fixed"]["train"]["launches"][k] + bf16["fixed"]["eval"]["launches"][k]
        for k in KERNELS})
    keys = phase(19, run_config_keys, dev, args.seed)
    paths["pallas_bn_steps"] = dict(launches=keys["launches"])
    paths["remat_search_steps"] = dict(launches={
        k: sum(keys["remat"]["search"][r]["launches"][k] for r in (False, True)) for k in KERNELS})
    families = phase(20, run_encoder_families, dev, args.seed)
    paths["encoder_families"] = dict(launches=families["launches"])
    timm2 = phase(21, run_timm_residual_variants, dev, args.seed,
                  {tuple(s) for s in families["gate"]["shapes"]})
    paths["timm_residual_variants"] = dict(launches=timm2["launches"])
    dp = phase(22, run_data_parallel, dev, args.seed)
    paths["data_parallel"] = dict(launches=dp["launches"])
    with tempfile.TemporaryDirectory() as work:
        generic = phase(23, run_generic_path, dev, args.seed, work)
    with tempfile.TemporaryDirectory() as work:
        tail = phase(24, run_long_tail, dev, args.seed, work)
    paths["legacy_segnet_train"] = dict(launches=tail["segnet"]["launches"])

    kernels = []
    for name, k in KERNELS.items():
        by_path = {p: r["launches"][name] for p, r in paths.items()}
        check(sum(by_path.values()) > 0, f"{name} was launched on no path: {by_path}")
        r = records[name]
        row = {"name": name, "route": "cuda", "source": k["source"],
               "replaces": k["replaces"], "launches": sum(by_path.values()),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "launches_by_path": by_path, "timed": r["timed"]}
        if name == "norm_convs" + BF16_SUFFIX:
            row.update(bound_by="operations", library_ms=r["library_ms"],
                       library_note="three cuDNN bf16 convolutions (F.conv2d) and torch.cat",
                       bound_note="one bf16 product per product at 989 TFLOP/s bf16",
                       bytes_bound_ms=r["bytes_bound_ms"], f32_ms=r["f32_ms"],
                       tflops=r["tflops"], dtype="bfloat16", shape=r["shape"], n=r["n"],
                       max_share_differing=r["max_share_differing"],
                       max_allowance_used=r["max_allowance_used"])
        elif name == "norm_convs":
            row.update(bound_by="operations", library_ms=r["library_ms"],
                       library_note="three cuDNN convolutions (F.conv2d) and torch.cat, "
                                    "TF32 off",
                       library_tf32_ms=r["library_tf32_ms"],
                       library_single_call_ms=r["library_single_call_ms"],
                       bound_note="3xTF32: 3 TF32 products per f32 product at 495 TFLOP/s",
                       f32_bound_ms=r["f32_bound_ms"], bytes_bound_ms=r["bytes_bound_ms"],
                       tf32_control_rel=r["tf32_control_rel"],
                       tflops_f32_equivalent=r["tflops_f32_equivalent"],
                       tensor_core_sass=sass, shape=r["shape"], n=r["n"])
        else:
            per_search_step = ({f"do_arch={d}": per_step(bf16["search"]["expect"], d)[name]
                                for d in (False, True)} if k["dtype"] == "bfloat16" else
                               {f"do_arch={d}": search["per_step"][d][name]
                                for d in ("False", "True")})
            row.update(bound_by="bytes", library_ms=None, library_note=LIBRARY_NOTE,
                       shape=[8, GROUP_C, HW, HW], n=6, dtype=k["dtype"],
                       launches_per_search_step=per_search_step)
            row.update({f: r[f] for f in K1_ROW_KEYS + ("f32_device_ms",) if f in r})
            row["bn_n1"] = keys["timed"][name]
            if name.removesuffix(BF16_SUFFIX) in ("branch_stats", "bwd_reduce"):
                row["bn_n1_families"] = {label: r[name]
                                         for label, r in families["gate"]["timed"].items()}
                row["bn_n1_timm2"] = {label: r[name]
                                      for label, r in timm2["gate"]["timed"].items()}
        if "max_rel_err" in r:
            row["max_rel_err"] = r["max_rel_err"]
        kernels.append(row)
    log(f"summary: eval {evald['eval_ms']:.2f} ms/batch, search {search['step_ms']:.2f} "
        f"ms/step, peak {search['peak_mib']:.1f} MiB, card vs CPU step {card_cpu}, "
        f"runner {runner}; fixed train {fixed['step_ms']:.2f} ms/step, eval "
        f"{fixed['eval_ms']:.2f} ms/batch, peak {fixed['peak_mib']:.1f} MiB, card vs CPU "
        f"{fixed_cpu}, CLIs {fixed_clis}; norm_convs {records['norm_convs']['ms']:.4f} ms "
        f"(plain {records['norm_convs']['plain_ms']:.4f}, library "
        f"{records['norm_convs']['library_ms']:.4f}, library TF32 "
        f"{records['norm_convs']['library_tf32_ms']:.4f}, bound "
        f"{records['norm_convs']['bound_ms']:.4f}, f32 bound "
        f"{records['norm_convs']['f32_bound_ms']:.4f}; SASS {sass})")
    log(f"serve summary: batch 1 {serve['ms'][1]['mean']:.3f} ms/request, batch 12 "
        f"{serve['ms'][12]['mean']:.3f} ms/request, {serve['images_per_s']:.1f} images/s, export "
        f"{serve['export_s']:.2f} s, artifact {serve['artifact_mb']:.2f} MB, load "
        f"{serve['load_s']:.2f} s, peak {serve['peak_mib']:.1f} MiB, card vs CPU "
        f"{serve['cpu_err']:.3g}, TF32 control {serve['tf32_control']}; submission "
        f"{paths['submission']['metrics']}")
    log(f"promise12 data path summary: cache {data['cache']['wall_s']:.2f} s (CLAHE "
        f"{data['cache']['clahe_s']:.2f}, resize {data['cache']['resize_s']:.2f}, curvature "
        f"flow {data['cache']['curvature_flow_s']:.2f}); loader ms/batch {data['loader_ms']}; "
        f"search {data['search_ms_per_step']:.2f} ms/step, prefetch wait "
        f"{data['search_prefetch_wait_share']:.4f}, val fetch "
        f"{data['search_val_fetch_share']:.4f}; fixed {data['train_ms_per_step']:.2f} ms/step, "
        f"prefetch wait {data['train_prefetch_wait_share']:.4f}; launches {data['launches']}; "
        f"contour grid {data['contour_grid']}; libraries that import {found}")
    log(f"shipped configs summary: decode ms/slice {shipped['decode_ms']}; ms/batch "
        f"{shipped['batch_ms']}; heart extraction {shipped['extract_s']:.2f} s; CHAOS search "
        f"{shipped['search_ms_per_step']:.2f} ms/step, prefetch wait "
        f"{shipped['search_prefetch_wait_share']:.4f}, val fetch "
        f"{shipped['search_val_fetch_share']:.4f}; heart train "
        f"{shipped['train_ms_per_step']:.2f} ms/step, prefetch wait "
        f"{shipped['train_prefetch_wait_share']:.4f}; launches {shipped['launches']}")
    log(f"zoo summary ({zoo['seconds']:.1f} s): ms/step, peak MiB "
        f"{ {n: (round(r['step_ms'], 2), round(r['peak_mib'], 1)) for n, r in zoo['models'].items()} }; "
        f"profiles (idle share, busy ms, launches) "
        f"{ {n: (round(r['profile'].get('idle_share', -1), 3), round(r['profile'].get('busy_ms', -1), 2), r['profile'].get('launches')) for n, r in zoo['models'].items() if 'profile' in r} }; "
        f"serving unet batch 1 {zoo['serve']['ms'][1]['mean']:.3f} ms, batch 12 "
        f"{zoo['serve']['ms'][12]['mean']:.3f} ms; losses ms "
        f"{ {n: round(r['ms'], 3) for n, r in zoo['losses'].items()} }")
    bs, bf, bc = bf16["search"], bf16["fixed"], bf16["card_vs_cpu"]
    share_of_bound = {n: {k: round(v["gap"] / max(2 * v["own"] + 1e-6, 1e-30), 3)
                          for k, v in r["bound"].items()} for n, r in bc.items()}
    log(f"bf16 summary ({bf16['seconds']:.1f} s), f32 beside it: search step "
        f"{bs['search']['ms']:.2f} ms/step (f32 {search['step_ms']:.2f}), peak "
        f"{bs['search']['peak_mib']:.1f} MiB (f32 {search['peak_mib']:.1f}), idle share "
        f"{bs['search']['profile'].get('idle_share', -1):.3f} (f32 "
        f"{search['profile'].get('idle_share', -1):.3f}), busy "
        f"{bs['search']['profile'].get('busy_ms', -1):.2f} ms (f32 "
        f"{search['profile'].get('busy_ms', -1):.2f}), launches "
        f"{bs['search']['profile'].get('launches')} (f32 {search['profile'].get('launches')}); "
        f"search-eval {bs['eval']['ms']:.2f} ms/batch (f32 {evald['eval_ms']:.2f}), peak "
        f"{bs['eval']['peak_mib']:.1f} MiB (f32 {evald['peak_mib']:.1f}), idle "
        f"{bs['eval']['profile'].get('idle_share', -1):.3f} (f32 "
        f"{evald['profile'].get('idle_share', -1):.3f}); fixed train "
        f"{bf['train']['ms']:.2f} ms/step (f32 {fixed['step_ms']:.2f}), peak "
        f"{bf['train']['peak_mib']:.1f} MiB (f32 {fixed['peak_mib']:.1f}), idle "
        f"{bf['train']['profile'].get('idle_share', -1):.3f} (f32 "
        f"{fixed['profile'].get('idle_share', -1):.3f}), busy "
        f"{bf['train']['profile'].get('busy_ms', -1):.2f} ms (f32 "
        f"{fixed['profile'].get('busy_ms', -1):.2f}); fixed eval {bf['eval']['ms']:.2f} "
        f"ms/batch (f32 {fixed['eval_ms']:.2f}); card vs CPU "
        f"{share_of_bound} of the bound; CLIs {bf16['clis']}")
    k2b, bz = bf16_zoo["record"], bf16_zoo["path"]["models"]
    log(f"bf16 zoo summary ({bf16_zoo['seconds']:.1f} s): ms/step bf16 (f32) "
        f"{ {n: (round(r['step_ms'], 2), round(zoo['models'][n]['step_ms'], 2)) for n, r in bz.items()} }; "
        f"peak MiB bf16 (f32) "
        f"{ {n: (round(r['peak_mib'], 1), round(zoo['models'][n]['peak_mib'], 1)) for n, r in bz.items()} }; "
        f"logits { {n: r['out_dtype'] for n, r in bz.items()} }; profiles (idle share, busy ms, "
        f"launches) { {n: (round(r['profile'].get('idle_share', -1), 3), round(r['profile'].get('busy_ms', -1), 2), r['profile'].get('launches')) for n, r in bz.items() if 'profile' in r} }; "
        f"card vs CPU share of the bound "
        f"{ {n: round(max(v['gap'] / max(2 * v['own'] + 1e-6, 1e-30) for v in r['bound'].values()), 3) for n, r in bf16_zoo['card_vs_cpu'].items()} }; "
        f"CLIs {bf16_zoo['clis']}; norm_convs bf16 {k2b['ms']:.4f} ms (f32 kernel "
        f"{k2b['f32_ms']:.4f}, plain {k2b['plain_ms']:.4f}, cuDNN bf16 {k2b['library_ms']:.4f}, "
        f"bound {k2b['bound_ms']:.4f})")
    steps = keys["steps"]
    log(f"phase 19 summary ({keys['seconds']:.1f} s): gate on/off ms/step "
        f"{ {n: (round(r['ms_on'], 2), round(r['ms_off'], 2)) for n, r in steps.items()} }; "
        f"busy ms, idle share, BN-class ms, launches on/off "
        f"{ {n: [(round(p.get('busy_ms', -1), 2), round(p.get('idle_share', -1), 3), round(p.get('bn_class_ms', -1), 2), p.get('launches')) for p in r['profile'].values()] for n, r in steps.items()} }; "
        f"BatchNorm calls a step { {n: r['bn_calls'] for n, r in steps.items()} }; checks "
        f"{keys['checks']}; remat ms/step, peak MiB off/on "
        f"{ {n: [(round(r['ms'], 2), round(r['peak_mib'], 1)) for r in keys['remat'][n].values()] for n in ('search', 'fixed')} }; "
        f"remat equal {keys['remat']['equal']}; card vs CPU {keys['card_vs_cpu']}; "
        f"CLIs {keys['clis']}")
    fam = families["steps"]
    log(f"phase 20 summary ({families['seconds']:.1f} s): unet ms/step f32, bf16 "
        f"{ {n: (round(r['f32']['step_ms'], 2), round(r['bf16']['step_ms'], 2)) for n, r in fam.items()} }; "
        f"peak MiB f32, bf16 "
        f"{ {n: (round(r['f32']['peak_mib'], 1), round(r['bf16']['peak_mib'], 1)) for n, r in fam.items()} }; "
        f"device launches a step f32, bf16 "
        f"{ {n: (r['f32']['launches_per_step'], r['bf16']['launches_per_step']) for n, r in fam.items()} }; "
        f"deeplab_v3_plus os 16 {families['deeplab']}; gate on/off ms/step "
        f"{ {n: (round(r['ms_on'], 2), round(r['ms_off'], 2)) for n, r in families['gate']['steps'].items()} }; "
        f"gated BN checks {families['gate']['checks']}; K1a/K1c device ms, share of bound "
        f"{ {lab: {k: (round(v['device_ms'], 4), v['share_of_bound']) for k, v in r.items()} for lab, r in families['gate']['timed'].items()} }")
    t2 = timm2["steps"]
    log(f"phase 21 summary ({timm2['seconds']:.1f} s): unet ms/step f32, bf16 "
        f"{ {n: (round(r['f32']['step_ms'], 2), round(r['bf16']['step_ms'], 2)) for n, r in t2.items()} }; "
        f"peak MiB f32, bf16 "
        f"{ {n: (round(r['f32']['peak_mib'], 1), round(r['bf16']['peak_mib'], 1)) for n, r in t2.items()} }; "
        f"device launches a step f32, bf16 "
        f"{ {n: (r['f32']['launches_per_step'], r['bf16']['launches_per_step']) for n, r in t2.items()} }; "
        f"every name {len(timm2['every_name'])}; deeplab_v3_plus os 16 {timm2['deeplab']}; gate "
        f"on/off ms/step "
        f"{ {n: (round(r['ms_on'], 2), round(r['ms_off'], 2)) for n, r in timm2['gate']['steps'].items()} }; "
        f"BatchNorm calls, modules "
        f"{ {n: (r['bn_calls'], r['bn_modules']) for n, r in timm2['gate']['steps'].items()} }; "
        f"gated BN checks {timm2['gate']['checks']}; K1a/K1c device ms, share of bound "
        f"{ {lab: {k: (r2['shape'], round(r2['device_ms'], 4), r2['share_of_bound']) for k, r2 in r.items()} for lab, r in timm2['gate']['timed'].items()} }")
    log(f"phase 22 summary ({dp['seconds']:.1f} s): ms/step (one process, one NCCL rank, "
        f"each gloo rank over data 2, each over data 1 x spatial 2) "
        f"{ {n: {k: round(v, 2) for k, v in r.items()} for n, r in dp['ms'].items()} }; "
        f"share of a step inside the collectives "
        f"{ {n: {k: round(v['share'], 3) for k, v in r.items()} for n, r in dp['collectives'].items()} }; "
        f"collective calls, halo calls, halo bytes a step "
        f"{ {n: {k: (v['calls'], v['halo_calls'], v['halo_bytes']) for k, v in r.items()} for n, r in dp['collectives'].items()} }; "
        f"against one process {dp['rows']}")
    log(f"promise12-zoo-rows summary: ms/step (one process, rank 0, rank 1) "
        f"{ {n: tuple(round(v, 2) for v in r['ms'].values()) for n, r in dp['zoo'].items()} }; "
        f"rank 0's share inside the collectives, calls, halo calls and bytes, gathers and bytes "
        f"{ {n: (round(c['share'], 3), c['calls'], c['halo_calls'], c['halo_bytes'], c['gathers'], c['gather_bytes']) for n, c in ((n, r['collectives']['rows0']) for n, r in dp['zoo'].items())} }; "
        f"rank 0 against one process {_zoo_distances(dp['zoo'])}")
    log(f"promise12-encoder-rows summary: ms/step (one process, rank 0, rank 1) "
        f"{ {n: tuple(round(v, 2) for v in r['ms'].values()) for n, r in dp['encoders'].items()} }; "
        f"rank 0's share inside the collectives, calls, halo calls and bytes, gathers and bytes "
        f"{ {n: (round(c['share'], 3), c['calls'], c['halo_calls'], c['halo_bytes'], c['gathers'], c['gather_bytes']) for n, c in ((n, r['collectives']['rows0']) for n, r in dp['encoders'].items())} }; "
        f"K1a-K1d a gated step (one process, rank 0, rank 1) "
        f"{dp['encoders']['timm-resnest14d_gated']['k1']}; "
        f"rank 0 against one process {_zoo_distances(dp['encoders'])}")
    gen_rows = {f"{n}/{m}": (round(r['ms_per_step'], 2), round(r['prefetch_wait_share'], 4),
                             round(r['peak_gb'], 2), r['remat'])
                for n, tr in generic["trees"].items() for m, r in tr["models"].items()}
    log(f"phase 23 summary ({generic['seconds']:.1f} s): decode, resample, __getitem__ ms a "
        f"sample { {n: (round(tr['decode_ms'], 2), round(tr['resample_ms'], 2), round(tr['getitem_ms'], 2)) for n, tr in generic['trees'].items()} }; "
        f"ms/step, prefetch wait share, peak GB, remat {gen_rows}; ADE20K void step card vs "
        f"CPU {generic['card_vs_cpu']['ade20k_void']}; dropout {generic['dropout']}")
    seg = tail["segnet"]
    log(f"phase 24 summary ({tail['seconds']:.1f} s): legacy blocks card vs CPU worst "
        f"{max(tail['blocks'].values()):.3g} (f64); legacy-segnet-train gated "
        f"{seg['ms_gated']:.2f} ms/step, gate on/off in turns {seg['turns']['ms_on']:.2f} / "
        f"{seg['turns']['ms_off']:.2f} ms/step, peak {seg['peak_mib']:.1f} MiB, idle share on/off "
        f"{seg['turns']['profile']['on'].get('idle_share', -1):.3f} / "
        f"{seg['turns']['profile']['off'].get('idle_share', -1):.3f}, K1a-K1d a gated step "
        f"{seg['bn_calls']} each, its {len(seg['bn_shapes'])} BatchNorm shapes held in "
        f"{seg['bn_check_s']:.1f} s (worst {seg['bn_worst']}); SOM card {tail['som']['card_s']:.2f} s, CPU "
        f"{tail['som']['cpu_s']:.2f} s, f32 max |diff| {tail['som']['max_abs_diff']:.3g}, alike "
        f"{tail['som']['share_alike']:.4f}, parting at (iteration, sample) "
        f"{tail['som']['first_flip']} on a tie {tail['som']['tie']}; f64 max |diff| "
        f"{tail['som']['f64_max_abs_diff']:.3g}; RunScore {tail['runscore']['ms']:.2f} ms; flops "
        f"{tail['misc']['flops'] / 1e12:.4f} TFLOP; calc_mean_std {tail['clis']['calc_mean_std']}")
    log(f"phase seconds {phase_s}")
    log(f"card: {smi}; total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
