"""Rank processes for the tests that hold the port's sharded paths to their
single-process ones (tests/test_torch_collectives.py,
tests/test_torch_mesh_steps.py, tests/test_torch_spatial_*.py). It imports
torch, numpy and senas_torch, nothing of JAX: the parent test computes the
JAX references and hands numpy arrays to the ranks.

    python tests/torch_mesh_workers.py <job file> <rank> <world> <port>

A job (a pickle) lists cases, each a function of this module and its
keyword arguments. Every case takes `mesh` (None: the single-process run,
which the parent calls in its own process) and numpy inputs of the GLOBAL
batch, cuts its own rows, and returns a dict of numpy results whose keys
say how the parent puts the ranks' values together:

  * "rows:<name>": this rank's rows of a per-row result; concatenated over
    the ranks in rank order, it must equal the single-process result;
  * "sum:<name>": this rank's part of a sum (a parameter's gradient);
    summed over the ranks;
  * "block<a>:<name>": under a mesh with a spatial axis, this rank's block
    of a per-row result: its data index's batch rows and its image rows
    on axis <a> (2 for NCHW, 1 for NHWC); put back in place over the ranks;
  * any other key: a global result, the same on every rank.

A case's keyword `mesh_spec` (data, spatial) runs it on that mesh of the
job's ranks (every rank makes it, in job order); without, on
MeshSpec(data=world); `mesh_spec=()` runs it with no mesh, as the
single-process reference (a job of one rank computes references beside
the ranks of another).

`Ranks` runs a job over `world` gloo ranks on 127.0.0.1: every process
group has a 60 s timeout, the whole job a deadline after which every rank
is killed and the test fails.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from contextlib import nullcontext
from datetime import timedelta

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 120
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _rows(mesh, b):
    return slice(None) if mesh is None else mesh.rows(b)


def _active(mesh):
    from senas_torch.parallel.collectives import activate
    return nullcontext() if mesh is None else activate(mesh)


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# Collectives and the batch statistics (tests/test_torch_collectives.py)
# ---------------------------------------------------------------------------

@case
def reduce_and_gather(mesh, x, w):
    """all_reduce_sum of a batch sum S and gather_batch of the rows' x * S,
    forward and backward: loss = sum(w * G). As in a model, the loss reads
    the statistic only through the rows."""
    from senas_torch.parallel.collectives import all_reduce_sum, gather_batch
    r = _rows(mesh, x.shape[0])
    xl = torch.from_numpy(x[r]).requires_grad_()
    with _active(mesh):
        s = all_reduce_sum(xl.sum(dim=0))
        g = gather_batch(xl * s)
        loss = (torch.from_numpy(w) * g).sum()
        loss.backward()
        labels = gather_batch(torch.arange(x.shape[0])[r])
    return {"s": _np(s), "g": _np(g), "loss": _np(loss), "rows:dx": _np(xl.grad),
            "labels": _np(labels)}


def _load(module, params: dict, buffers: dict):
    with torch.no_grad():
        for k, v in params.items():
            getattr(module, k).copy_(torch.from_numpy(v))
        for k, v in buffers.items():
            getattr(module, k).copy_(torch.from_numpy(v))
    return module


def _norm_case(mesh, module, x, r_weights):
    """A train-mode forward of `module` on this rank's rows of x, loss =
    sum(y * r_weights) over the global batch, its backward; then an eval
    forward on the same rows."""
    from senas_torch.parallel.collectives import gather_batch
    rows = _rows(mesh, x.shape[0])
    xl = torch.from_numpy(x[rows]).requires_grad_()
    with _active(mesh):
        y = module(xl, train=True)
        loss = (torch.from_numpy(r_weights) * gather_batch(y)).sum()
        grads = torch.autograd.grad(loss, [xl, module.scale, module.bias])
        y_eval = module(torch.from_numpy(x[rows]), train=False)
    return {"rows:y": _np(y), "rows:dx": _np(grads[0]), "sum:dscale": _np(grads[1]),
            "sum:dbias": _np(grads[2]), "mean": _np(module.mean), "var": _np(module.var),
            "rows:y_eval": _np(y_eval), "loss": _np(loss)}


@case
def batchnorm(mesh, x, r_weights, params, buffers, gated=False):
    """primitives.BatchNorm: the default path, or the gated one through the
    fused epilogue's plain twins (SENAS_PALLAS_BN=1)."""
    from senas_torch.ops.primitives import BatchNorm
    before = os.environ.get("SENAS_PALLAS_BN")
    os.environ["SENAS_PALLAS_BN"] = "1" if gated else "0"
    try:
        bn = _load(BatchNorm(x.shape[1]).to(torch.float64), params, buffers)
        return _norm_case(mesh, bn, x, r_weights)
    finally:
        if before is None:
            del os.environ["SENAS_PALLAS_BN"]
        else:
            os.environ["SENAS_PALLAS_BN"] = before


@case
def flax_batchnorm(mesh, x, r_weights, params, buffers):
    """encoders_timm2.FlaxBatchNorm (SK-Net's attention BN)."""
    from senas_torch.models.encoders_timm2 import FlaxBatchNorm
    bn = _load(FlaxBatchNorm(x.shape[1]).to(torch.float64), params, buffers)
    return _norm_case(mesh, bn, x, r_weights)


@case
def epilogue(mesh, xs, r_weights, scales, biases, alphas, se_w1=None, se_w2=None,
             none_alpha=None, none_bias=None, E=1, P=1):
    """fused_group_epilogue in train mode (with SE where se_w1 is given, and
    the closed-form 'none' branch) and group_epilogue_reference on the same
    rows: outputs, the batch stats, the gradients of every input."""
    from senas_torch.ops.grouped_epilogue import fused_group_epilogue, group_epilogue_reference
    from senas_torch.parallel.collectives import gather_batch
    rows = _rows(mesh, xs[0].shape[0])
    t = lambda a: torch.from_numpy(a).requires_grad_()
    xl = [t(x[rows]) for x in xs]
    par = [[t(a) for a in group] for group in (scales, biases, alphas)]
    kw = dict(train=True, E=E, P=P)
    extra = []
    if se_w1 is not None:
        w1, w2 = t(se_w1), t(se_w2)
        kw.update(se_index=0, se_w1=w1, se_w2=w2)
        extra += [w1, w2]
    if none_alpha is not None:
        na, nb = t(none_alpha), t(none_bias)
        kw.update(none_alpha_col=na, none_bias=nb)
        extra += [na, nb]
    leaves = xl + [p for group in par for p in group] + extra
    out = {}
    with _active(mesh):
        for name, fn in (("fused", fused_group_epilogue), ("reference", group_epilogue_reference)):
            res = fn(xl, *par, **kw)
            mixed, stats = res if name == "fused" else (res, None)
            loss = (torch.from_numpy(r_weights) * gather_batch(mixed)).sum()
            grads = torch.autograd.grad(loss, leaves)
            out[f"rows:{name}_mixed"] = _np(mixed)
            for i, g in enumerate(grads):
                key = f"rows:{name}_dx{i}" if i < len(xl) else f"sum:{name}_d{i}"
                out[key] = _np(g)
            if stats is not None:
                out[f"{name}_mu"], out[f"{name}_var"] = _np(stats[0]), _np(stats[1])
    return out


@case
def dropout(mesh, x, seed):
    """primitives.Dropout(0.5) with one generator seed: the masks of the
    global batch, each rank's rows."""
    from senas_torch.ops.primitives import Dropout
    rows = _rows(mesh, x.shape[0])
    with _active(mesh):
        y = Dropout(0.5)(torch.from_numpy(x[rows]), train=True,
                         rng=torch.Generator().manual_seed(seed))
    return {"rows:y": _np(y)}


# ---------------------------------------------------------------------------
# Steps (tests/test_torch_mesh_steps.py)
# ---------------------------------------------------------------------------

def _batch(mesh, batch, dtype):
    r = _rows(mesh, batch["image"].shape[0])
    return {"image": torch.from_numpy(batch["image"][r]).to(dtype),
            "label": torch.from_numpy(batch["label"][r])}


def _metrics(m):
    return {k: _np(v).astype(np.float64) if v.is_floating_point() else _np(v)
            for k, v in m.items()}


def _build_fixed(model, c, depth, variables, dtype, encoder=None):
    from senas_torch import convert
    from senas_torch.models import geno_searched, zoo
    from senas_torch.models.senas_model import SenasModel
    gen = torch.Generator().manual_seed(0)
    if model == "unet":
        net = zoo.Unet(classes=2, in_channels=1, encoder_name=encoder, encoder_depth=depth,
                       decoder_channels=(64, 32, 16, 8)[:depth], device="cpu", generator=gen)
    else:
        net = SenasModel(nclass=2, in_channels=1, c=c, depth=depth,
                         genotype=getattr(geno_searched, model), device="cpu", generator=gen)
    if variables is not None:
        convert.load_variables(net, variables)
    return net.to(dtype)


@case
def fixed_steps(mesh, batches, eval_batch, opt_cfg, clip=5.0, loss="dice_ce",
                model="senas_node_4", c=8, depth=3, variables=None, encoder=None,
                dtype="float64", gated=False):
    """FixedTrainState + make_train_step for len(batches) steps, then
    make_eval_step on eval_batch: per-step metrics, the eval metrics and
    masks, and the final weights and running stats (flax layout)."""
    from senas_torch import convert
    from senas_torch.parallel.mesh import place_state, shard_train_step
    from senas_torch.train.loss import build_loss
    from senas_torch.train.trainer import FixedTrainState, make_eval_step, make_train_step
    dt = getattr(torch, dtype)
    before = os.environ.get("SENAS_PALLAS_BN")
    os.environ["SENAS_PALLAS_BN"] = "1" if gated else "0"
    try:
        net = _build_fixed(model, c, depth, variables, dt, encoder)
        state = FixedTrainState.create(net, opt_cfg)
        step = make_train_step(build_loss(loss), grad_clip=clip)
        evaluate = make_eval_step(net, build_loss(loss))
        if mesh is not None:
            place_state(mesh, state)
            step, evaluate = shard_train_step(step, mesh), shard_train_step(evaluate, mesh)
        out = {f"step{i}": _metrics(step(state, _batch(mesh, b, dt)))
               for i, b in enumerate(batches)}
        ev = _metrics(evaluate(_batch(mesh, eval_batch, dt)))
    finally:
        if before is None:
            del os.environ["SENAS_PALLAS_BN"]
        else:
            os.environ["SENAS_PALLAS_BN"] = before
    out["eval"] = ev
    out["variables"] = convert.state_dict_to_variables(net)
    return out


@case
def search_steps(mesh, batches, do_arch, arch, w_cfg, a_cfg, meta, depth, c,
                 variables=None, dtype="float64"):
    """SearchTrainState + make_search_step over (train, val) batch pairs,
    then make_search_eval_step on the first val batch: per-step metrics,
    the final weights, running stats and arch tables."""
    from senas_torch import convert
    from senas_torch.parallel.mesh import place_state, shard_train_step
    from senas_torch.search import supernet as tsn
    from senas_torch.train.loss import build_loss
    from senas_torch.train.trainer import (SearchTrainState, make_search_eval_step,
                                           make_search_step)
    dt = getattr(torch, dtype)
    net = tsn.SenasSearch(in_channels=1, c=c, nclass=2, depth=depth, meta_node_num=meta,
                          device="cpu", generator=torch.Generator().manual_seed(0))
    if variables is not None:
        convert.load_variables(net, variables)
    net = net.to(dt)
    tables = {k: v.to(dt) for k, v in convert.arch_to_torch(arch, "cpu").items()}
    state = SearchTrainState.create(net, tables, w_cfg, a_cfg)
    normalize = lambda a: tsn.normalize_arch(a, meta)
    step = make_search_step(normalize, build_loss("dice_ce"), grad_clip=5.0)
    evaluate = make_search_eval_step(net, normalize, build_loss("dice_ce"))
    if mesh is not None:
        place_state(mesh, state)
        step, evaluate = shard_train_step(step, mesh), shard_train_step(evaluate, mesh)
    out = {f"step{i}": _metrics(step(state, _batch(mesh, tb, dt), _batch(mesh, vb, dt), a))
           for i, ((tb, vb), a) in enumerate(zip(batches, do_arch))}
    out["eval"] = _metrics(evaluate(state.arch, _batch(mesh, batches[0][1], dt)))
    out["variables"] = convert.state_dict_to_variables(net)
    out["arch"] = {k: _np(v) for k, v in state.arch.items()}
    return out


# ---------------------------------------------------------------------------
# The image-H split (tests/test_torch_spatial_*.py)
# ---------------------------------------------------------------------------

def _block(mesh, a, axis=2):
    """This rank's block of a global per-row array: its data index's batch
    rows and, under a spatial axis, its image rows on `axis`."""
    if mesh is None:
        return a
    a = a[mesh.rows(a.shape[0])]
    if mesh.spec.spatial > 1:
        idx = [slice(None)] * a.ndim
        idx[axis] = mesh.image_rows(a.shape[axis])
        a = a[tuple(idx)]
    return a


def _split_active(mesh, image_hw):
    from senas_torch.parallel.collectives import activate
    return nullcontext() if mesh is None else activate(mesh, image_hw=tuple(image_hw))


SPATIAL_OPS = {
    # name: (function of primitives, its keyword arguments, weight shape or None)
    "conv3": ("conv2d", {}, (4, 3, 3, 3)),
    "conv3_s2": ("conv2d", {"stride": 2}, (4, 3, 3, 3)),
    "conv5_d2": ("conv2d", {"dilation": 2}, (4, 3, 5, 5)),
    "conv5_d3": ("conv2d", {"dilation": 3}, (4, 3, 5, 5)),
    "conv5_d3_s2": ("conv2d", {"dilation": 3, "stride": 2}, (4, 3, 5, 5)),
    "conv7": ("conv2d", {}, (4, 3, 7, 7)),
    "conv1_s2": ("conv2d", {"stride": 2}, (4, 3, 1, 1)),
    "dw3_s2": ("conv2d", {"stride": 2, "groups": 3}, (6, 1, 3, 3)),
    "dw5": ("conv2d", {"groups": 3}, (6, 1, 5, 5)),
    "tconv3": ("conv_transpose2d", {}, (3, 4, 3, 3)),
    "tconv5_d2": ("conv_transpose2d", {"dilation": 2}, (3, 4, 5, 5)),
    "tconv5_d3": ("conv_transpose2d", {"dilation": 3}, (3, 4, 5, 5)),
    "tdw3": ("conv_transpose2d", {"groups": 3}, (3, 2, 3, 3)),
    "tconv1": ("conv_transpose2d", {"torch_padding": 0}, (3, 4, 1, 1)),
    "avg": ("avg_pool_3x3", {}, None),
    "avg_s2": ("avg_pool_3x3", {"stride": 2}, None),
    "max": ("max_pool_3x3", {"stride": 1}, None),
    "max_s2": ("max_pool_3x3", {}, None),
    "max2": ("max_pool_2x2", {}, None),
    "up": ("upsample2x", {}, None),
    "mean": ("image_mean", {}, None),
}


@case
def spatial_ops(mesh, x, weights, r_weights, ops, image_hw):
    """Each op of SPATIAL_OPS on this rank's block of x [B, C, H, W] under
    the row split of an image `image_hw`, and its backward: loss = sum of
    r_weights[op] * the op's gathered output (NHWC). Returns each op's
    output block, the gradient of x's block and of the weight."""
    from senas_torch.ops import primitives as P
    from senas_torch.parallel.collectives import gather_batch
    out = {}
    with _split_active(mesh, image_hw):
        for name in ops:
            fn, kw, _ = SPATIAL_OPS[name]
            xl = torch.from_numpy(_block(mesh, x)).requires_grad_()
            leaves = [xl]
            if name in weights:
                w = torch.from_numpy(weights[name]).requires_grad_()
                leaves.append(w)
                y = getattr(P, fn)(xl, w, **kw)
            else:
                y = getattr(P, fn)(xl, **kw)
            nhwc = y.permute(0, 2, 3, 1) if y.dim() == 4 else y
            loss = (torch.from_numpy(r_weights[name]) * gather_batch(nhwc)).sum()
            grads = torch.autograd.grad(loss, leaves)
            if y.dim() == 4:
                out[f"block2:{name}_y"] = _np(y)
            else:
                out[f"{name}_y"] = _np(gather_batch(y))
            out[f"block2:{name}_dx"] = _np(grads[0])
            if len(grads) > 1:
                out[f"sum:{name}_dw"] = _np(grads[1])
            out[f"{name}_loss"] = _np(loss)
    return out


WINDOW_OPS = {
    # name: (function of primitives, its keyword arguments, weight shape or
    # None; the torch function of the global image, its keyword arguments,
    # and the (left, right, top, bottom) F.pad before it or None)
    "conv1x7": ("conv2d_padded", {"padding": (0, 3)}, (4, 3, 1, 7),
                "conv2d", {"padding": (0, 3)}, None),
    "conv7x1": ("conv2d_padded", {"padding": (3, 0)}, (4, 3, 7, 1),
                "conv2d", {"padding": (3, 0)}, None),
    "conv3x1_s2": ("conv2d_padded", {"padding": (1, 0), "stride": 2}, (4, 3, 3, 1),
                   "conv2d", {"padding": (1, 0), "stride": 2}, None),
    "conv3_valid_s2": ("conv2d_padded", {"padding": (0, 0), "stride": 2}, (4, 3, 3, 3),
                       "conv2d", {"stride": 2}, None),
    "conv1x3_valid": ("conv2d_padded", {"padding": (0, 0)}, (4, 3, 1, 3),
                      "conv2d", {}, None),
    "same3_s2": ("conv2d_padded", {"padding": ((0, 1), (0, 1)), "stride": 2}, (4, 3, 3, 3),
                 "conv2d", {"stride": 2}, (0, 1, 0, 1)),
    "same5_s2": ("conv2d_padded", {"padding": ((1, 2), (1, 2)), "stride": 2}, (4, 3, 5, 5),
                 "conv2d", {"stride": 2}, (1, 2, 1, 2)),
    "same5_s2_dw": ("conv2d_padded", {"padding": ((1, 2), (1, 2)), "stride": 2, "groups": 3},
                    (6, 1, 5, 5), "conv2d", {"stride": 2, "groups": 3}, (1, 2, 1, 2)),
    "rows_lo_hi_s2": ("conv2d_padded", {"padding": ((2, 0), (1, 1)), "stride": 2},
                      (4, 3, 3, 3), "conv2d", {"stride": 2, "padding": (0, 1)}, (0, 0, 2, 0)),
    "max3_s2_ceil": ("max_pool", {"k": 3, "stride": 2, "padding": (0, 1)}, None,
                     "max_pool2d", {"kernel_size": 3, "stride": 2}, (0, 1, 0, 1)),
    "max3_s1": ("max_pool", {"k": 3, "stride": 1, "padding": 1}, None,
                "max_pool2d", {"kernel_size": 3, "stride": 1, "padding": 1}, None),
    "max3_s2": ("max_pool", {"k": 3, "stride": 2, "padding": 1}, None,
                "max_pool2d", {"kernel_size": 3, "stride": 2, "padding": 1}, None),
    "max3_s1_ceil": ("max_pool", {"k": 3, "stride": 1, "padding": (0, 1)}, None,
                     "max_pool2d", {"kernel_size": 3, "stride": 1}, (0, 1, 0, 1)),
    "max2_s2": ("max_pool", {"k": 2, "stride": 2}, None,
                "max_pool2d", {"kernel_size": 2, "stride": 2}, None),
    "avg3_s1_excl": ("avg_pool", {"k": 3, "stride": 1, "padding": 1, "count_include_pad": False},
                     None, "avg_pool2d", {"kernel_size": 3, "stride": 1, "padding": 1,
                                          "count_include_pad": False}, None),
    "avg3_s2_excl": ("avg_pool", {"k": 3, "stride": 2, "padding": 1, "count_include_pad": False},
                     None, "avg_pool2d", {"kernel_size": 3, "stride": 2, "padding": 1,
                                          "count_include_pad": False}, None),
    "avg3_s1_incl": ("avg_pool", {"k": 3, "stride": 1, "padding": 1}, None,
                     "avg_pool2d", {"kernel_size": 3, "stride": 1, "padding": 1}, None),
    "avg3_s2_incl": ("avg_pool", {"k": 3, "stride": 2, "padding": 1}, None,
                     "avg_pool2d", {"kernel_size": 3, "stride": 2, "padding": 1}, None),
    "avg2_s2_excl": ("avg_pool", {"k": 2, "stride": 2, "count_include_pad": False}, None,
                     "avg_pool2d", {"kernel_size": 2, "stride": 2,
                                    "count_include_pad": False}, None),
}


def window_reference(name, x, w=None):
    """WINDOW_OPS[name] as the torch op of the global image x."""
    import torch.nn.functional as F
    _, _, _, fn, kw, pad = WINDOW_OPS[name]
    if pad is not None:
        x = F.pad(x, pad, value=float("-inf") if fn == "max_pool2d" else 0.0)
    return getattr(F, fn)(x, w, **kw) if w is not None else getattr(F, fn)(x, **kw)


@case
def spatial_windows(mesh, x, weights, r_weights, ops, image_hw):
    """Each op of WINDOW_OPS on this rank's block of x [B, C, H, W] under
    the row split of an image `image_hw` (a split of its own for each op,
    which enters the levels it makes), or, without a mesh, the torch op of
    the global image (`window_reference`); and its backward: loss = sum of
    r_weights[op] * the op's gathered output (NHWC). Returns each op's
    output block, the gradient of x's block and of the weight."""
    from senas_torch.ops import primitives as P
    from senas_torch.parallel.collectives import gather_batch
    out = {}
    for name in ops:
        fn, kw = WINDOW_OPS[name][:2]
        xl = torch.from_numpy(_block(mesh, x)).requires_grad_()
        leaves = [xl] + ([torch.from_numpy(weights[name]).requires_grad_()]
                         if name in weights else [])
        with _split_active(mesh, image_hw):
            if mesh is None:
                y = window_reference(name, *leaves)
            else:
                y = getattr(P, fn)(*leaves, **kw)
            loss = (torch.from_numpy(r_weights[name]) * gather_batch(y.permute(0, 2, 3, 1))).sum()
            grads = torch.autograd.grad(loss, leaves)
        out[f"block2:{name}_y"] = _np(y)
        out[f"block2:{name}_dx"] = _np(grads[0])
        if len(grads) > 1:
            out[f"sum:{name}_dw"] = _np(grads[1])
        out[f"{name}_loss"] = _np(loss)
    return out


def _spatial_batch(mesh, batch, dtype, spatial):
    from senas_torch.parallel.mesh import shard_batch
    if mesh is None:
        return {"image": torch.from_numpy(batch["image"]).to(dtype),
                "label": torch.from_numpy(batch["label"])}
    b = shard_batch(mesh, batch, spatial=spatial)
    b["image"] = torch.from_numpy(np.ascontiguousarray(b["image"])).to(dtype)
    b["label"] = torch.from_numpy(np.ascontiguousarray(b["label"]))
    return b


@case
def spatial_fixed_steps(mesh, batches, eval_batch, opt_cfg, clip=5.0, loss="dice_ce",
                        model="senas_node_4", c=8, depth=3, variables=None, dtype="float64",
                        gated=False, remat=False, spatial=True, dropout_prob=0.0):
    """fixed_steps with each batch placed by `shard_batch(spatial=...)`:
    the image rows split over the mesh's spatial axis (`dropout_prob`: the
    model's spatial dropout)."""
    from senas_torch import convert
    from senas_torch.models import geno_searched
    from senas_torch.models.senas_model import SenasModel
    from senas_torch.parallel.mesh import place_state, shard_train_step
    from senas_torch.train.loss import build_loss
    from senas_torch.train.trainer import FixedTrainState, make_eval_step, make_train_step
    dt = getattr(torch, dtype)
    before = os.environ.get("SENAS_PALLAS_BN")
    os.environ["SENAS_PALLAS_BN"] = "1" if gated else "0"
    try:
        net = SenasModel(nclass=2, in_channels=1, c=c, depth=depth, remat=remat,
                         genotype=getattr(geno_searched, model), device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         dropout_prob=dropout_prob)
        if variables is not None:
            convert.load_variables(net, variables)
        net = net.to(dt)
        state = FixedTrainState.create(net, opt_cfg)
        step = make_train_step(build_loss(loss), grad_clip=clip)
        evaluate = make_eval_step(net, build_loss(loss))
        if mesh is not None:
            place_state(mesh, state)
            step, evaluate = shard_train_step(step, mesh), shard_train_step(evaluate, mesh)
        out = {f"step{i}": _metrics(step(state, _spatial_batch(mesh, b, dt, spatial)))
               for i, b in enumerate(batches)}
        out["eval"] = _metrics(evaluate(_spatial_batch(mesh, eval_batch, dt, spatial)))
    finally:
        if before is None:
            del os.environ["SENAS_PALLAS_BN"]
        else:
            os.environ["SENAS_PALLAS_BN"] = before
    out["variables"] = convert.state_dict_to_variables(net)
    return out


@case
def spatial_search_steps(mesh, batches, do_arch, arch, w_cfg, a_cfg, meta, depth, c,
                         variables=None, dtype="float64", remat=False, spatial=True):
    """search_steps with each batch placed by `shard_batch(spatial=...)`."""
    from senas_torch import convert
    from senas_torch.parallel.mesh import place_state, shard_train_step
    from senas_torch.search import supernet as tsn
    from senas_torch.train.loss import build_loss
    from senas_torch.train.trainer import (SearchTrainState, make_search_eval_step,
                                           make_search_step)
    dt = getattr(torch, dtype)
    net = tsn.SenasSearch(in_channels=1, c=c, nclass=2, depth=depth, meta_node_num=meta,
                          remat=remat, device="cpu", generator=torch.Generator().manual_seed(0))
    if variables is not None:
        convert.load_variables(net, variables)
    net = net.to(dt)
    tables = {k: v.to(dt) for k, v in convert.arch_to_torch(arch, "cpu").items()}
    state = SearchTrainState.create(net, tables, w_cfg, a_cfg)
    normalize = lambda a: tsn.normalize_arch(a, meta)
    step = make_search_step(normalize, build_loss("dice_ce"), grad_clip=5.0)
    evaluate = make_search_eval_step(net, normalize, build_loss("dice_ce"))
    if mesh is not None:
        place_state(mesh, state)
        step, evaluate = shard_train_step(step, mesh), shard_train_step(evaluate, mesh)
    place = lambda b: _spatial_batch(mesh, b, dt, spatial)
    out = {f"step{i}": _metrics(step(state, place(tb), place(vb), a))
           for i, ((tb, vb), a) in enumerate(zip(batches, do_arch))}
    out["eval"] = _metrics(evaluate(state.arch, place(batches[0][1])))
    out["variables"] = convert.state_dict_to_variables(net)
    out["arch"] = {k: _np(v) for k, v in state.arch.items()}
    return out


# the decoder widths of a zoo Unet on a named encoder (narrow: the encoder
# is what its tests hold) and of its DeepLabV3+
ENCODER_DECODER = {"unet": (32, 16, 8, 8, 8), "deeplab_v3_plus": 32}


def _zoo_model(model, depth, variables, dtype, precision, encoder=None, output_stride=16):
    """The factory's `model` in `dtype`, or with f32 weights computing in
    bf16 where `precision` is "bf16". With `encoder`, the zoo's Unet or
    DeepLabV3+ (`model` "unet" or "deeplab_v3_plus", at `output_stride`)
    on that encoder, 1 channel in and 2 classes out, as a direct
    `zoo.Unet(encoder_name=...)` call builds it."""
    from senas_torch import convert
    from senas_torch.models import zoo
    from senas_torch.models.factory import get_segmentation_model
    bf16 = precision == "bf16"
    built = dict(device="cpu", dtype=torch.bfloat16 if bf16 else None,
                 generator=torch.Generator().manual_seed(0))
    if encoder is None:
        net = get_segmentation_model(model, "synthetic", depth=depth, **built)
    elif model == "unet":
        net = zoo.Unet(classes=2, in_channels=1, encoder_name=encoder, encoder_depth=depth,
                       decoder_channels=ENCODER_DECODER[model][:depth], **built)
    else:
        net = zoo.DeepLabV3Plus(classes=2, in_channels=1, encoder_name=encoder,
                                encoder_depth=depth, output_stride=output_stride,
                                decoder_channels=ENCODER_DECODER[model], **built)
    if variables is not None:
        convert.load_variables(net, variables)
    return net if bf16 else net.to(dtype)


@case
def spatial_zoo_steps(mesh, batches, eval_batch, opt_cfg, model, depth, clip=5.0,
                      loss="dice_ce", variables=None, dtype="float64", gated=False,
                      spatial=True, seed=0, precision=None, dropout=True, encoder=None,
                      output_stride=16):
    """fixed_steps for the factory's baseline model `model` at `depth` (its
    weights from seed 0, or `variables`; `precision` "bf16": f32 weights
    computing in bf16; with `encoder`, the zoo's Unet or DeepLabV3+ on that
    encoder, `_zoo_model`), each batch placed by
    `shard_batch(spatial=...)`; the dropout generator reseeded from
    (`seed`, step) as the trainer does, or every Dropout the identity
    without `dropout`. Also the squared norm of every GroupNorm's output in
    the eval step's forward, a sum over the ranks, and the halo exchanges
    and level gathers the steps made (the same count on every rank)."""
    from senas_torch import convert
    from senas_torch.ops.primitives import Dropout, GroupNorm
    from senas_torch.parallel.spatial import HALO, reset_halo_counts
    from senas_torch.parallel.mesh import place_state, shard_train_step
    from senas_torch.train.loss import build_loss
    from senas_torch.train.trainer import FixedTrainState, make_eval_step, make_train_step
    dt = getattr(torch, dtype)
    before = os.environ.get("SENAS_PALLAS_BN"), Dropout.forward
    os.environ["SENAS_PALLAS_BN"] = "1" if gated else "0"
    if not dropout:
        Dropout.forward = lambda self, x, train=False, rng=None: x
    norms = {}
    try:
        net = _zoo_model(model, depth, variables, dt, precision, encoder, output_stride)
        for name, m in net.named_modules():
            if isinstance(m, GroupNorm):
                m.register_forward_hook(lambda m, i, y, name=name: norms.__setitem__(
                    f"sum:gn_{name}", _np((y.double() ** 2).sum())))
        state = FixedTrainState.create(net, opt_cfg, seed=seed)
        step = make_train_step(build_loss(loss), grad_clip=clip)
        evaluate = make_eval_step(net, build_loss(loss))
        if mesh is not None:
            place_state(mesh, state)
            step, evaluate = shard_train_step(step, mesh), shard_train_step(evaluate, mesh)
        reset_halo_counts()
        out = {f"step{i}": _metrics(step(state, _spatial_batch(mesh, b, dt, spatial)))
               for i, b in enumerate(batches)}
        norms.clear()
        out["eval"] = _metrics(evaluate(_spatial_batch(mesh, eval_batch, dt, spatial)))
        out["halo_calls"] = np.array(HALO["calls"] + HALO["gathers"])
    finally:
        if before[0] is None:
            del os.environ["SENAS_PALLAS_BN"]
        else:
            os.environ["SENAS_PALLAS_BN"] = before[0]
        Dropout.forward = before[1]
    out["variables"] = convert.state_dict_to_variables(net)
    out.update(norms)
    return out


# ---------------------------------------------------------------------------
# The rank process and its launcher
# ---------------------------------------------------------------------------

def _rank_main(job_path, rank, world, port):
    import torch.distributed as dist

    from senas_torch.parallel.mesh import MeshSpec, make_mesh
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=60))
    meshes = {None: make_mesh(), (): None}
    results = []
    for name, kw in job:
        kw = dict(kw)
        spec = kw.pop("mesh_spec", None)
        if spec not in meshes:
            meshes[spec] = make_mesh(spec=MeshSpec(*spec))
        results.append(CASES[name](meshes[spec], **kw))
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


class Ranks:
    """A job running over `world` rank processes; `results()` waits."""

    def __init__(self, job, tmp_dir, world=2, timeout=JOB_TIMEOUT_S):
        from senas_torch.parallel.launch import free_port
        self.path = os.path.join(str(tmp_dir), f"job-{time.monotonic_ns()}.pkl")
        with open(self.path, "wb") as f:
            pickle.dump(job, f)
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                                             if p)}
        port = free_port()
        self.world, self.deadline = world, time.monotonic() + timeout
        self.logs = [open(f"{self.path}.{r}.log", "w+") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), self.path,
                                        str(r), str(world), str(port)], env=env, cwd=ROOT,
                                       stdout=self.logs[r], stderr=subprocess.STDOUT)
                      for r in range(world)]

    def _tail(self, r):
        self.logs[r].seek(0)
        return self.logs[r].read()[-3000:]

    def results(self):
        """Per rank, the list of its cases' results. A rank that fails, or
        a job past its deadline, kills every rank and fails the test."""
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > self.deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{self._tail(r)}"
        out = []
        for r in range(self.world):
            with open(f"{self.path}.{r}", "rb") as f:
                out.append(pickle.load(f))
        for log in self.logs:
            log.close()
        return out


def combine(per_rank, spec=None):
    """One case's results of every rank -> one dict laid out like the
    single-process result: rows concatenated, partial sums summed, blocks
    put back in place over the mesh `spec` (data, spatial); a global result
    is checked to be the same on every rank."""
    data, spatial = spec or (len(per_rank), 1)
    out = {}
    for key in per_rank[0]:
        vals = [r[key] for r in per_rank]
        if key.startswith("rows:"):
            out[key] = np.concatenate(vals)
        elif key.startswith("sum:"):
            out[key] = np.sum(vals, axis=0)
        elif key.startswith("block"):
            axis = int(key[len("block"):key.index(":")])
            out[key] = np.concatenate([
                np.concatenate(vals[d * spatial:(d + 1) * spatial], axis=axis)
                for d in range(data)])
        else:
            for v in vals[1:]:
                _assert_same(v, vals[0], key)
            out[key] = vals[0]
    return out


def _assert_same(a, b, key):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), key
        for k in b:
            _assert_same(a[k], b[k], f"{key}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=f"{key} differs between ranks")


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
