"""Translate PyTorch reference checkpoints into flax-named variable trees.

Port of `senas_tpu/compat/torch_import.py` (numpy only; torch is needed
only to `torch.load`). The output is the same numpy tree with the flax
names that the JAX package's translator gives (tests/test_torch_compat.py
holds them equal, leaf by leaf), and `senas_torch.convert.load_variables`
loads it into the port's `SenasModel` and `SenasSearch`.

The reference framework's checkpoints:

- train CLI: ``{'epoch', 'dur_time', 'model_state', 'model_optimizer',
  'best_pixAcc', 'best_mIoU', 'best_dice_coeff', 'best_loss'}``
  (reference experiments/train_model.py:220-233), where ``model_state`` is
  a ``SenasModel`` state_dict (models/senas_model.py:78-179).
- search CLI: ``{'epoch', 'dur_time', 'cur_patience', 'geno_type',
  'model_state', 'arch_optimizer', 'model_optimizer', 'alphas_dict',
  'betas_dict', 'scheduler'}`` (experiments/search_arc.py:227-238), where
  ``model_state`` is a ``NAS`` state_dict: the supernet under the ``net.``
  prefix plus the seven architecture tables registered as top-level
  nn.Parameters (search/senas_search.py:138-168).

Their state_dicts (torch NCHW conv layouts, the ConvTranspose2d
flipped-kernel convention, BatchNorm weight/bias against scale/bias, SE
Linear transposes) become flax variable trees, for the per-edge ("naive")
supernet layout and the grouped/fused one that the port's `SenasSearch`
runs. Optimizer state is not translated: the import CLI builds a fresh
optimizer from the config and carries the run meta (epoch, best metrics,
patience) over. torchvision-style ResNet / ResNeXt state_dicts (the local
stand-in for smp's pretrained-weight URLs) translate into the zoo's
encoder (`translate_resnet_encoder`, `set_encoder_variables`); the zoo's
models themselves are in `senas_torch/compat/zoo_import.py`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from senas_torch.core.genotype import DownOps, NormOps, UpOps, parse_genotype

# candidate-op vocabulary classes (utils/operations.py:8-48)
_POOLISH = ("avg_pool", "max_pool", "up_sample", "identity", "none")
_CONVISH = ("conv_3", "dil_3_conv_5", "dil_2_conv_5")
_DEPSEP = ("dep_sep_conv_3", "dep_sep_conv_5")


# ---------------------------------------------------------------------------
# torch layout -> flax layout (numpy)
# ---------------------------------------------------------------------------

def _conv(w: np.ndarray) -> np.ndarray:
    """Conv2d (O, I, kH, kW) -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0)).copy()


def _tconv(w: np.ndarray) -> np.ndarray:
    """ConvTranspose2d (I, O, kH, kW): torch correlates the spatially
    FLIPPED kernel with in/out swapped; flax's is an unflipped lhs-dilated
    correlation, so flip + transpose to HWIO."""
    return np.flip(w, axis=(2, 3)).transpose(2, 3, 0, 1).copy()


def _dw_tconv(w: np.ndarray) -> np.ndarray:
    """Depthwise ConvTranspose2d (C, 1, kH, kW) -> the grouped-transpose
    HWIO layout (kH, kW, 1, C), spatially flipped."""
    return np.flip(w, axis=(2, 3)).transpose(2, 3, 1, 0).copy()


def _dense(w: np.ndarray) -> np.ndarray:
    """Linear (O, I) -> flax Dense kernel (I, O)."""
    return np.ascontiguousarray(w.T)


def state_dict_to_numpy(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """torch state_dict -> {key: float32-preserving np.ndarray}, stripping
    any DataParallel ``module.`` prefix (convert_state_dict,
    utils/utils.py:113-123)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """torch.load a reference checkpoint onto host memory."""
    import torch
    return torch.load(path, map_location="cpu")


def classify_checkpoint(ckpt: Dict[str, Any]) -> str:
    """'search' | 'train' | 'state_dict' (a bare state_dict)."""
    if "alphas_dict" in ckpt or "arch_optimizer" in ckpt:
        return "search"
    if "model_state" in ckpt:
        return "train"
    return "state_dict"


class _Tree:
    """Dotted-key accessor over a numpy state_dict."""

    def __init__(self, sd: Dict[str, np.ndarray], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def sub(self, name: str) -> "_Tree":
        return _Tree(self.sd, f"{self.prefix}{name}.")

    def t(self, name: str) -> np.ndarray:
        return self.sd[self.prefix + name]

    def has(self, name: str) -> bool:
        return (self.prefix + name) in self.sd

    def bn(self, name: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        p = {"scale": self.t(f"{name}.weight").copy(),
             "bias": self.t(f"{name}.bias").copy()}
        s = {"mean": self.t(f"{name}.running_mean").copy(),
             "var": self.t(f"{name}.running_var").copy()}
        return p, s


# ---------------------------------------------------------------------------
# fixed SenasModel (models/senas_model.py) -> SenasModel variables
# ---------------------------------------------------------------------------

def _translate_op(ref: _Tree, op_name: str, transpose: bool):
    """One candidate op (a chosen op of a fixed cell, or a branch of a
    supernet MixedOp): reference Sequential/AdapterBlock layouts
    (utils/operations.py:8-183, dropout=0) -> its variables."""
    conv_fn = _tconv if transpose else _conv
    if op_name in _CONVISH:
        bn_p, bn_s = ref.bn("1")
        return ({"_ConvWeight_0": {"kernel": conv_fn(ref.t("0.weight"))},
                 "BatchNorm_0": bn_p},
                {"BatchNorm_0": bn_s})
    if op_name == "se_conv_3":
        bn_p, bn_s = ref.bn("1")
        return ({"ConvBn_0": {
                    "_ConvWeight_0": {"kernel": conv_fn(ref.t("0.weight"))},
                    "BatchNorm_0": bn_p},
                 "SEBlock_0": {
                    "Dense_0": {"kernel": _dense(ref.t("2.excitation.0.weight"))},
                    "Dense_1": {"kernel": _dense(ref.t("2.excitation.2.weight"))}}},
                {"ConvBn_0": {"BatchNorm_0": bn_s}})
    if op_name in _DEPSEP:
        dbn_p, dbn_s = ref.bn("1")
        pbn_p, pbn_s = ref.bn("4")
        depth_fn = _dw_tconv if transpose else _conv
        return ({"depth": {"kernel": depth_fn(ref.t("0.weight"))},
                 "depth_norm": dbn_p,
                 "point": {"kernel": _conv(ref.t("3.weight"))},
                 "point_norm": pbn_p},
                {"depth_norm": dbn_s, "point_norm": pbn_s})
    if op_name in _POOLISH:
        bn_p, bn_s = ref.bn("norm")
        p = {"BatchNorm_0": bn_p}
        if ref.has("conv.weight"):
            p["kernel"] = _conv(ref.t("conv.weight"))
        return p, {"BatchNorm_0": bn_s}
    raise NotImplementedError(op_name)


def _translate_pre_post(ref: _Tree, cell_type: str, params, stats) -> None:
    """A cell's preprocess0 (RectifyResample for a down cell, ShrinkBlock for
    an up cell) and post_process (RectifyBlock)."""
    if cell_type == "down":
        bn_p, bn_s = ref.bn("preprocess0.2")
        p = {"BatchNorm_0": bn_p}
        if ref.has("preprocess0.1.weight"):
            p["kernel"] = _conv(ref.t("preprocess0.1.weight"))
        params["preprocess0"], stats["preprocess0"] = p, {"BatchNorm_0": bn_s}
    else:
        bn_p, bn_s = ref.bn("preprocess0.norm")
        params["preprocess0"] = {"kernel": _conv(ref.t("preprocess0.conv.weight")),
                                 "BatchNorm_0": bn_p}
        stats["preprocess0"] = {"BatchNorm_0": bn_s}
    bn_p, bn_s = ref.bn("post_process.norm")
    params["post_process"] = {"kernel": _conv(ref.t("post_process.conv.weight")),
                              "BatchNorm_0": bn_p}
    stats["post_process"] = {"BatchNorm_0": bn_s}


def _translate_fixed_cell(ref: _Tree, gene, cell_type: str):
    """BuildCell (models/senas_model.py:4-64): preprocess0, the 2*meta
    chosen ops, post_process."""
    params, stats = {}, {}
    _translate_pre_post(ref, cell_type, params, stats)
    for i, (op_name, inp) in enumerate(gene):
        # UP ops sit on the vertical input (idx 1) of up cells; they use
        # transpose convs — everything else is a plain conv
        transpose = cell_type == "up" and inp == 1
        p, s = _translate_op(ref.sub(f"_ops.{i}"), op_name, transpose)
        params[f"op_{i}"], stats[f"op_{i}"] = p, s
    return params, stats


def _translate_stems(ref: _Tree, params, stats):
    bn_p, bn_s = ref.bn("stem0.1")
    params["stem0"] = {"_ConvWeight_0": {"kernel": _conv(ref.t("stem0.0.weight"))},
                       "BatchNorm_0": bn_p}
    stats["stem0"] = {"BatchNorm_0": bn_s}
    blk = ref.sub("stem1.2")
    bn1_p, bn1_s = blk.bn("bn1")
    bn2_p, bn2_s = blk.bn("bn2")
    params["stem1_block"] = {"conv1": _conv(blk.t("conv1.weight")),
                             "conv2": _conv(blk.t("conv2.weight")),
                             "bn1": bn1_p, "bn2": bn2_p}
    stats["stem1_block"] = {"bn1": bn1_s, "bn2": bn2_s}


def _head_conv(ref: _Tree) -> Dict[str, Any]:
    return {"_ConvWeight_0": {"kernel": _conv(ref.t("head_block.0.segmentation_head.1.weight"))}}


def translate_senas_model(sd: Dict[str, np.ndarray], genotype,
                          depth: int) -> Dict[str, Any]:
    """Reference SenasModel state_dict -> SenasModel variables.

    ``genotype`` is a Genotype or its string form. Gamma-pruned up cells
    are absent from both trees (senas_model.py:123-127) — whatever
    ``blocks.{i}.{j}`` keys the reference kept are walked."""
    if isinstance(genotype, str):
        genotype = parse_genotype(genotype)
    ref = _Tree(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    _translate_stems(ref, params, stats)

    for j in range(1, depth):
        p, s = _translate_fixed_cell(ref.sub(f"blocks.0.{j}"), genotype.down, "down")
        params[f"down_{j}"], stats[f"down_{j}"] = p, s

    up_keys = sorted({k.split(".")[1] + "." + k.split(".")[2]
                      for k in sd if k.startswith("blocks.")
                      and not k.startswith("blocks.0.")})
    for ij in up_keys:
        i, j = ij.split(".")
        p, s = _translate_fixed_cell(ref.sub(f"blocks.{i}.{j}"), genotype.up, "up")
        params[f"up_{i}_{j}"], stats[f"up_{i}_{j}"] = p, s

    hp, hs = _translate_fixed_cell(ref.sub("head_block.0.up_cell"), genotype.up, "up")
    params["head"] = {"up_cell": hp, "segmentation_head": _head_conv(ref)}
    stats["head"] = {"up_cell": hs}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# supernet (search/senas_search.py SenasSearch) -> naive per-edge variables
# ---------------------------------------------------------------------------

def _edge_optype(cell_type: str, edge_idx: int, meta: int):
    """Edge index -> (candidate-op vocabulary, uses-transpose-conv)
    per the reference's per-edge op-type assignment (search/cell.py:76-90)."""
    offsets = [sum(2 + i for i in range(n)) for n in range(meta)]
    for off in offsets:
        if edge_idx == off + 0:
            return (DownOps, False) if cell_type == "down" else (NormOps, False)
        if edge_idx == off + 1:
            return (DownOps, False) if cell_type == "down" else (UpOps, True)
    return (NormOps, False)


def _translate_search_cell(ref: _Tree, cell_type: str, meta: int):
    params, stats = {}, {}
    _translate_pre_post(ref, cell_type, params, stats)
    n_edges = sum(2 + i for i in range(meta))
    for e in range(n_edges):
        ops, transpose = _edge_optype(cell_type, e, meta)
        ep, es = {}, {}
        for bi, bname in enumerate(ops):
            bp, bs = _translate_op(ref.sub(f"_ops.{e}._ops.{bi}"), bname, transpose)
            ep[f"branch_{bi}_{bname}"] = bp
            es[f"branch_{bi}_{bname}"] = bs
        params[f"edge_{e}"], stats[f"edge_{e}"] = ep, es
    return params, stats


# ---------------------------------------------------------------------------
# naive per-edge layout -> the grouped/fused layout
# (the inverse of the slicing in search/fused_cell.py GroupedMixedOp)
# ---------------------------------------------------------------------------

def _stack_trees(trees: Sequence[Any]) -> Any:
    """Nested dicts of arrays with one structure -> the same structure with
    each leaf stacked on a new leading axis (flax's vmapped `inner_n`)."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _group_mixedops(edges_p: List[dict], edges_s: List[dict],
                    ops: Sequence[str]):
    """Stack E naive MixedOp variable trees into one GroupedMixedOp tree."""
    E = len(edges_p)
    gp: Dict[str, Any] = {}
    gs: Dict[str, Any] = {}

    def _cat_bn(key_out, trees_p, trees_s, path):
        def get(t):
            for k in path:
                t = t[k]
            return t
        gp[key_out] = {"scale": np.concatenate([get(p)["scale"] for p in trees_p]),
                       "bias": np.concatenate([get(p)["bias"] for p in trees_p])}
        gs[key_out] = {"mean": np.concatenate([get(s)["mean"] for s in trees_s]),
                       "var": np.concatenate([get(s)["var"] for s in trees_s])}

    for i, name in enumerate(ops):
        key = f"branch_{i}_{name}"
        ps = [e[key] for e in edges_p]
        ss = [e[key] for e in edges_s]
        if name in _POOLISH:
            # grouped layout never materializes the zero op's adapter conv
            if "kernel" in ps[0] and name != "none":
                gp[f"{name}_kernel"] = np.concatenate(
                    [p["kernel"] for p in ps], axis=-1)
            _cat_bn(f"{name}_bn", ps, ss, ("BatchNorm_0",))
        elif name in _CONVISH:
            gp[f"{name}_kernel"] = np.concatenate(
                [p["_ConvWeight_0"]["kernel"] for p in ps], axis=-1)
            _cat_bn(f"{name}_bn", ps, ss, ("BatchNorm_0",))
        elif name == "se_conv_3":
            gp[f"{name}_kernel"] = np.concatenate(
                [p["ConvBn_0"]["_ConvWeight_0"]["kernel"] for p in ps], axis=-1)
            _cat_bn(f"{name}_bn", ps, ss, ("ConvBn_0", "BatchNorm_0"))
            gp[f"{name}_se1"] = np.stack(
                [p["SEBlock_0"]["Dense_0"]["kernel"] for p in ps])
            gp[f"{name}_se2"] = np.stack(
                [p["SEBlock_0"]["Dense_1"]["kernel"] for p in ps])
        elif name in _DEPSEP:
            # grouped depthwise uses feature_group_count=C with multiplier
            # E: channel c of edge e lives at flattened index c*E + e
            dk0 = ps[0]["depth"]["kernel"]  # (kh, kw, 1, C)
            C = dk0.shape[-1]
            dk = np.zeros(dk0.shape[:3] + (C * E,), dk0.dtype)
            dbn_p = {"scale": np.zeros(C * E, np.float32),
                     "bias": np.zeros(C * E, np.float32)}
            dbn_s = {"mean": np.zeros(C * E, np.float32),
                     "var": np.zeros(C * E, np.float32)}
            for e in range(E):
                idx = np.arange(C) * E + e
                dk[..., idx] = ps[e]["depth"]["kernel"]
                for f in ("scale", "bias"):
                    dbn_p[f][idx] = ps[e]["depth_norm"][f]
                for f in ("mean", "var"):
                    dbn_s[f][idx] = ss[e]["depth_norm"][f]
            gp[f"{name}_dkernel"] = dk
            gp[f"{name}_dbn"], gs[f"{name}_dbn"] = dbn_p, dbn_s
            gp[f"{name}_pkernel"] = np.stack(
                [p["point"]["kernel"][0, 0] for p in ps])  # (E, C, P)
            _cat_bn(f"{name}_pbn", ps, ss, ("point_norm",))
        else:
            raise NotImplementedError(name)
    return gp, gs


def _fuse_cell(cp: Dict[str, Any], cs: Dict[str, Any], meta: int,
               cell_type: str):
    """Naive SearchCell variables -> FusedSearchCell variables."""
    t0 = DownOps if cell_type == "down" else NormOps
    t1 = DownOps if cell_type == "down" else UpOps
    offsets = [sum(2 + i for i in range(n)) for n in range(meta)]
    fp = {"preprocess0": cp["preprocess0"], "post_process": cp["post_process"]}
    fs = {"preprocess0": cs["preprocess0"], "post_process": cs["post_process"]}
    for gkey, ops, j in (("group0", t0, 0), ("group1", t1, 1)):
        edges_p = [cp[f"edge_{offsets[n] + j}"] for n in range(meta)]
        edges_s = [cs[f"edge_{offsets[n] + j}"] for n in range(meta)]
        fp[gkey], fs[gkey] = _group_mixedops(edges_p, edges_s, ops)
    for n in range(1, meta):
        fp[f"inner_{n}"] = _stack_trees([cp[f"edge_{offsets[n] + 2 + j}"] for j in range(n)])
        fs[f"inner_{n}"] = _stack_trees([cs[f"edge_{offsets[n] + 2 + j}"] for j in range(n)])
    return fp, fs


def translate_senas_search(sd: Dict[str, np.ndarray], depth: int,
                           meta_node_num: int,
                           fused: bool = True) -> Dict[str, Any]:
    """Reference SenasSearch state_dict (the ``net.``-stripped part of a
    NAS state_dict) -> SenasSearch variables, in the naive per-edge layout
    (``fused=False``) or the grouped layout (the one the port's supernet
    has)."""
    ref = _Tree(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    _translate_stems(ref, params, stats)

    cells = [(f"down_{j}", f"blocks.0.{j}", "down") for j in range(1, depth)]
    cells += [(f"up_{i}_{j}", f"blocks.{i}.{j}", "up")
              for i in range(1, depth) for j in range(depth - i)]
    cells.append(("head", "head_block.0.up_cell", "up"))
    for ours, theirs, ctype in cells:
        p, s = _translate_search_cell(ref.sub(theirs), ctype, meta_node_num)
        if fused:
            p, s = _fuse_cell(p, s, meta_node_num, ctype)
        params[ours], stats[ours] = p, s
    params["head"] = {"up_cell": params["head"], "segmentation_head": _head_conv(ref)}
    stats["head"] = {"up_cell": stats["head"]}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# architecture parameters
# ---------------------------------------------------------------------------

_ARCH_KEYS = ("alphas_dn", "alphas_up", "alphas_dn_nm", "alphas_up_nm",
              "betas_dn", "betas_up", "gamma")


def translate_arch_params(src: Dict[str, Any],
                          use_sharing: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """Reference architecture tables -> the arch dict
    (`senas_torch.search.supernet.init_arch_params` naming).

    ``src`` may be a full search checkpoint, a NAS state_dict (the seven
    tables are registered as top-level nn.Parameters,
    search/senas_search.py:145-154), or the checkpoint's
    ``alphas_dict``/``betas_dict`` payloads merged into one mapping.

    ``use_sharing=None`` auto-detects the reference's ``sharing_normal``
    flag: with sharing ON the up/dn normal tables are the SAME Parameter
    (senas_search.py:148-149), so identical values mean shared."""
    flat: Dict[str, np.ndarray] = {}
    if "model_state" in src:  # full checkpoint
        flat.update(state_dict_to_numpy(src["model_state"]))
        for d in (src.get("alphas_dict") or {}, src.get("betas_dict") or {}):
            flat.update(state_dict_to_numpy(d))
    else:
        flat.update(state_dict_to_numpy(src))
    out = {}
    for k in _ARCH_KEYS:
        if k in flat:
            out[k] = np.asarray(flat[k], np.float32)
    missing = [k for k in _ARCH_KEYS if k not in out and k != "alphas_up_nm"]
    if missing:
        raise KeyError(f"arch tables missing from checkpoint: {missing}")
    if use_sharing is None:
        use_sharing = "alphas_up_nm" not in out or bool(
            np.array_equal(out["alphas_dn_nm"], out["alphas_up_nm"]))
    if use_sharing:
        out.pop("alphas_up_nm", None)
    return out


# ---------------------------------------------------------------------------
# high-level import API
# ---------------------------------------------------------------------------

def _as_ckpt(path_or_ckpt) -> Dict[str, Any]:
    if isinstance(path_or_ckpt, str):
        return load_torch_checkpoint(path_or_ckpt)
    return path_or_ckpt


def import_fixed_checkpoint(path_or_ckpt, genotype, depth: int = 5):
    """Train-CLI checkpoint -> (SenasModel variables, run meta).

    Meta keys match what runner/train.py's resume reads: epoch, dur_time,
    best_dice, best_miou (reference keys best_dice_coeff/best_mIoU,
    train_model.py:220-233)."""
    ckpt = _as_ckpt(path_or_ckpt)
    sd = state_dict_to_numpy(ckpt["model_state"] if "model_state" in ckpt else ckpt)
    variables = translate_senas_model(sd, genotype, depth)
    meta = {
        "epoch": int(ckpt.get("epoch", 0)),
        "dur_time": float(ckpt.get("dur_time", 0.0)),
        "best_dice": float(ckpt.get("best_dice_coeff", 0.0)),
        "best_miou": float(ckpt.get("best_mIoU", 0.0)),
        "best_pixacc": float(ckpt.get("best_pixAcc", 0.0)),
        "imported_from": "torch",
    }
    return variables, meta


def import_search_checkpoint(path_or_ckpt, depth: int, meta_node_num: int,
                             use_sharing: Optional[bool] = None,
                             fused: bool = True):
    """Search-CLI checkpoint -> (supernet variables, arch dict, run meta).

    Meta keys match runner/search.py's resume: epoch, dur_time,
    cur_patience, geno_type (search_arc.py:227-238)."""
    ckpt = _as_ckpt(path_or_ckpt)
    msd = state_dict_to_numpy(ckpt["model_state"] if "model_state" in ckpt else ckpt)
    net_sd = {k[len("net."):]: v for k, v in msd.items() if k.startswith("net.")}
    if not net_sd:  # a bare SenasSearch state_dict, no NAS wrapper
        net_sd = msd
    variables = translate_senas_search(net_sd, depth, meta_node_num, fused=fused)
    arch = translate_arch_params(ckpt if "model_state" in ckpt else msd, use_sharing)
    meta = {
        "epoch": int(ckpt.get("epoch", 0)),
        "dur_time": float(ckpt.get("dur_time", 0.0)),
        "cur_patience": int(ckpt.get("cur_patience", 0)),
        "imported_from": "torch",
    }
    if ckpt.get("geno_type") is not None:
        meta["geno_type"] = str(ckpt["geno_type"])
    return variables, arch, meta


# ---------------------------------------------------------------------------
# torchvision-style encoder weights (the local replacement for smp's
# pretrained-weight URLs, reference encoders/__init__.py:64-77)
# ---------------------------------------------------------------------------

def translate_resnet_encoder(sd: Dict[str, Any], name: str = "") -> Dict[str, Any]:
    """torchvision-naming ResNet / ResNeXt state_dict -> the variables of
    the zoo's ResNetEncoder (senas_torch/models/encoders.py). BasicBlock
    (conv1/conv2) and Bottleneck (conv1/conv2/conv3) stacks and the
    downsample shortcut; fc/classifier keys are ignored."""
    sd = state_dict_to_numpy(sd)
    tree = _Tree(sd)
    params: Dict[str, Any] = {"conv1": _conv(tree.t("conv1.weight"))}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = tree.bn("bn1")
    gi = 1
    while f"layer{gi}.0.conv1.weight" in sd:
        b = 0
        while f"layer{gi}.{b}.conv1.weight" in sd:
            blk = tree.sub(f"layer{gi}.{b}")
            key = f"layer{gi}_{b}"
            bp = {"conv1": _conv(blk.t("conv1.weight")), "conv2": _conv(blk.t("conv2.weight"))}
            bs: Dict[str, Any] = {}
            bp["bn1"], bs["bn1"] = blk.bn("bn1")
            bp["bn2"], bs["bn2"] = blk.bn("bn2")
            if blk.has("conv3.weight"):
                bp["conv3"] = _conv(blk.t("conv3.weight"))
                bp["bn3"], bs["bn3"] = blk.bn("bn3")
            if blk.has("downsample.0.weight"):
                bp["down_conv"] = _conv(blk.t("downsample.0.weight"))
                bp["down_bn"], bs["down_bn"] = blk.bn("downsample.1")
            params[key], stats[key] = bp, bs
            b += 1
        gi += 1
    return {"params": params, "batch_stats": stats}


def _graft(tgt: Dict[str, Any], src: Dict[str, Any], path: str) -> Dict[str, Any]:
    out = {}
    for k, v in tgt.items():
        if isinstance(v, dict):
            out[k] = _graft(v, src[k], f"{path}/{k}")
        elif tuple(np.shape(v)) != tuple(np.shape(src[k])):
            raise ValueError(f"encoder shape mismatch at {path}/{k}: model {np.shape(v)} vs "
                             f"imported {np.shape(src[k])}")
        else:
            out[k] = src[k]
    return out


def set_encoder_variables(variables: Dict[str, Any],
                          enc_vars: Dict[str, Any]) -> Dict[str, Any]:
    """Graft imported encoder weights into a zoo model's variables (the
    encoder lives under the `encoder` name). Shapes are checked leaf by
    leaf; imported stages beyond the model's encoder depth are dropped."""
    new = {k: dict(v) for k, v in variables.items()}
    for col in ("params", "batch_stats"):
        if col not in variables or "encoder" not in variables[col]:
            raise KeyError(f"no encoder subtree under variables[{col!r}]")
        tgt = variables[col]["encoder"]
        src = {k: v for k, v in enc_vars[col].items() if k in tgt}
        missing = sorted(set(tgt) - set(src))
        if missing:
            raise KeyError(f"imported encoder lacks modules {missing} "
                           f"required by the model ({col})")
        new[col] = {**variables[col], "encoder": _graft(tgt, src, f"{col}/encoder")}
    return new
