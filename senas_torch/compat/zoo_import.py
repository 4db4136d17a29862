"""Translate reference baseline-zoo torch checkpoints into flax-named trees.

Port of `senas_tpu/compat/zoo_import.py` (numpy only): the same trees,
which `senas_torch.convert.load_variables` loads into the port's zoo
models (tests/test_torch_zoo_import.py holds them equal to senas_tpu's,
leaf by leaf).

The reference's train CLI can train any of the vendored smp baselines
(`--model unet|unet_plus_plus|manet|linknet|fpn|pspnet|deeplab_v3_plus|pan`,
models/__init__.py:8-90) plus the prior-work `nasunet`
(models/nasunet/nas_unet.py); smp checkpoints hold the model's state_dict
(`encoder.* / decoder.* / segmentation_head.* [/ classification_head.*]`,
base/model.py:5-24). This module translates those state_dicts, per
architecture, into the variable trees of `senas_torch/models/zoo.py` /
`models/nasunet.py` — the dotted-key counterpart of the module-traversal
translators that pin zoo parity in tests/test_zoo_parity.py and
tests/test_nasunet_parity.py.

Key torch layouts handled (vendored smp):
- Conv2dReLU = Sequential(conv, bn|Identity, relu) (base/modules.py:10-48)
- Linknet DecoderBlock.block = (Conv2dReLU, TransposeX2, Conv2dReLU) with
  TransposeX2 = (ConvTranspose2d, BN, ReLU) (linknet/decoder.py:6-35)
- FPN p-blocks + Conv3x3GNReLU seg blocks (GroupNorm) (fpn/decoder.py)
- PSP pooling pyramid (pool_size=1 forces use_batchnorm=False ->
  conv bias) (pspnet/decoder.py:10-24)
- DeepLabV3+ ASPP: 1x1 conv / 3 separable atrous branches / image pool /
  project, plus the separable post + fuse blocks (deeplabv3/decoder.py)
- MAnet PAB center + MFAB dual-SE blocks (manet/decoder.py:7-100)
- PAN FPA pyramid + GAU blocks, ConvBnRelu(conv bias + BN)
  (pan/decoder.py:6-140)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from senas_torch.compat.torch_import import (_as_ckpt, _conv, _dense, _tconv, _Tree,
                                             state_dict_to_numpy, translate_resnet_encoder)


def _c2r(t: _Tree) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """smp Conv2dReLU Sequential -> our Conv2dReLU variables. With
    use_batchnorm: (conv .0 biasless, bn .1); without: (conv .0 with
    bias, Identity .1)."""
    if t.has("1.weight"):
        bn_p, bn_s = t.bn("1")
        return ({"kernel": _conv(t.t("0.weight")), "BatchNorm_0": bn_p},
                {"BatchNorm_0": bn_s})
    return ({"kernel": _conv(t.t("0.weight")),
             "bias": t.t("0.bias").copy()}, {})


def _conv_bias(t: _Tree, name: str):
    return _conv(t.t(f"{name}.weight")), t.t(f"{name}.bias").copy()


def _put(params, stats, key, p, s):
    params[key] = p
    if s:
        stats[key] = s


def _head(tree: _Tree, params: Dict[str, Any]):
    k, b = _conv_bias(tree.sub("segmentation_head"), "0")
    params["SegmentationHead_0"] = {"kernel": k, "bias": b}
    if tree.has("classification_head.3.weight"):
        params["classification_head"] = {"Dense_0": {
            "kernel": _dense(tree.t("classification_head.3.weight")),
            "bias": tree.t("classification_head.3.bias").copy()}}


def _base(sd: Dict[str, np.ndarray]):
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    enc = translate_resnet_encoder(enc_sd)
    return ({"encoder": enc["params"]}, {"encoder": enc["batch_stats"]},
            _Tree(sd))


def _count(sd, fmt: str) -> int:
    i = 0
    while fmt.format(i) in sd:
        i += 1
    return i


# ---------------------------------------------------------------------------
# per-architecture translators
# ---------------------------------------------------------------------------

def _unet(sd):
    params, stats, tree = _base(sd)
    for i in range(_count(sd, "decoder.blocks.{}.conv1.0.weight")):
        blk = tree.sub(f"decoder.blocks.{i}")
        p1, s1 = _c2r(blk.sub("conv1"))
        p2, s2 = _c2r(blk.sub("conv2"))
        _put(params, stats, f"dec_{i}",
             {"Conv2dReLU_0": p1, "Conv2dReLU_1": p2},
             {"Conv2dReLU_0": s1, "Conv2dReLU_1": s2})
    _head(tree, params)
    return params, stats


def _unetplusplus(sd):
    params, stats, tree = _base(sd)
    names = sorted({k.split(".")[2] for k in sd
                    if k.startswith("decoder.blocks.x_")})
    for name in names:
        blk = tree.sub(f"decoder.blocks.{name}")
        p1, s1 = _c2r(blk.sub("conv1"))
        p2, s2 = _c2r(blk.sub("conv2"))
        _put(params, stats, name,
             {"Conv2dReLU_0": p1, "Conv2dReLU_1": p2},
             {"Conv2dReLU_0": s1, "Conv2dReLU_1": s2})
    _head(tree, params)
    return params, stats


def _linknet(sd):
    params, stats, tree = _base(sd)
    for i in range(_count(sd, "decoder.blocks.{}.block.0.0.weight")):
        blk = tree.sub(f"decoder.blocks.{i}.block")
        p1, s1 = _c2r(blk.sub("0"))
        p2, s2 = _c2r(blk.sub("2"))
        bn_p, bn_s = blk.bn("1.1")
        _put(params, stats, f"dec_{i}",
             {"Conv2dReLU_0": p1,
              "tkernel": _tconv(blk.t("1.0.weight")),
              "tbias": blk.t("1.0.bias").copy(),
              "BatchNorm_0": bn_p,
              "Conv2dReLU_1": p2},
             {"Conv2dReLU_0": s1, "BatchNorm_0": bn_s, "Conv2dReLU_1": s2})
    _head(tree, params)
    return params, stats


def _fpn(sd):
    params, stats, tree = _base(sd)
    dec = tree.sub("decoder")
    params["p5"], params["p5_b"] = _conv_bias(dec, "p5")
    for name, attr in (("p4_skip", "p4"), ("p3_skip", "p3"),
                       ("p2_skip", "p2")):
        params[name], params[name + "_b"] = _conv_bias(
            dec.sub(attr), "skip_conv")
    for i in range(_count(sd, "decoder.seg_blocks.{}.block.0.block.0.weight")):
        for j in range(_count(
                sd, "decoder.seg_blocks." + str(i) + ".block.{}.block.0.weight")):
            sub = dec.sub(f"seg_blocks.{i}.block.{j}.block")
            params[f"seg_{i}_{j}"] = {
                "kernel": _conv(sub.t("0.weight")),
                "GroupNorm_0": {"scale": sub.t("1.weight").copy(),
                                "bias": sub.t("1.bias").copy()}}
    _head(tree, params)
    return params, stats


def _pspnet(sd):
    params, stats, tree = _base(sd)
    for si in range(_count(sd, "decoder.psp.blocks.{}.pool.1.0.weight")):
        p, s = _c2r(tree.sub(f"decoder.psp.blocks.{si}.pool.1"))
        _put(params, stats, f"psp_{si}", p, s)
    p, s = _c2r(tree.sub("decoder.conv"))
    _put(params, stats, "Conv2dReLU_0", p, s)
    _head(tree, params)
    return params, stats


def _sep(t: _Tree, sep_prefix: str, bn_name: str):
    """smp SeparableConv2d (Sequential dw, pw) + following BN."""
    bn_p, bn_s = t.bn(bn_name)
    return ({"dw": _conv(t.t(f"{sep_prefix}.0.weight")),
             "pw": _conv(t.t(f"{sep_prefix}.1.weight")),
             "BatchNorm_0": bn_p},
            {"BatchNorm_0": bn_s})


def _deeplabv3plus(sd):
    params, stats, tree = _base(sd)
    aspp = tree.sub("decoder.aspp.0")
    ap, asv = {}, {}
    p, s = _c2r(aspp.sub("convs.0"))
    ap["conv1x1"], asv["conv1x1"] = p, s
    for i in range(3):  # ASPPSeparableConv branches (rates 12/24/36)
        p, s = _sep(aspp.sub(f"convs.{1 + i}"), "0", "1")
        ap[f"aspp_{i}"], asv[f"aspp_{i}"] = p, s
    pool = aspp.sub("convs.4")  # (AdaptiveAvgPool, conv, BN, ReLU)
    bn_p, bn_s = pool.bn("2")
    ap["pool_conv"] = {"kernel": _conv(pool.t("1.weight")),
                       "BatchNorm_0": bn_p}
    asv["pool_conv"] = {"BatchNorm_0": bn_s}
    p, s = _c2r(aspp.sub("project"))
    ap["project"], asv["project"] = p, s
    params["ASPP_0"], stats["ASPP_0"] = ap, asv
    p, s = _sep(tree.sub("decoder"), "aspp.1", "aspp.2")
    _put(params, stats, "aspp_post", p, s)
    p, s = _c2r(tree.sub("decoder.block1"))
    _put(params, stats, "highres", p, s)
    p, s = _sep(tree.sub("decoder.block2"), "0", "1")
    _put(params, stats, "fuse", p, s)
    _head(tree, params)
    return params, stats


def _manet(sd):
    params, stats, tree = _base(sd)
    pab = tree.sub("decoder.center")
    tk, tb = _conv_bias(pab, "top_conv")
    ck, cb = _conv_bias(pab, "center_conv")
    bk, bb = _conv_bias(pab, "bottom_conv")
    ok, ob = _conv_bias(pab, "out_conv")
    params["PAB_0"] = {"top": tk, "top_b": tb, "center": ck, "center_b": cb,
                       "bottom": bk, "bottom_b": bb, "out": ok,
                       "out_bias": ob}
    for i in range(_count(sd, "decoder.blocks.{}.conv1.0.weight")):
        blk = tree.sub(f"decoder.blocks.{i}")
        p, s = {}, {}
        if blk.has("hl_conv.0.0.weight"):  # MFAB
            p["Conv2dReLU_0"], s["Conv2dReLU_0"] = _c2r(blk.sub("hl_conv.0"))
            p["Conv2dReLU_1"], s["Conv2dReLU_1"] = _c2r(blk.sub("hl_conv.1"))
            for tag in ("hl", "ll"):
                se = blk.sub(f"SE_{tag}")
                p[f"{tag}_w1"], p[f"{tag}_b1"] = _conv_bias(se, "1")
                p[f"{tag}_w2"], p[f"{tag}_b2"] = _conv_bias(se, "3")
            p["Conv2dReLU_2"], s["Conv2dReLU_2"] = _c2r(blk.sub("conv1"))
            p["Conv2dReLU_3"], s["Conv2dReLU_3"] = _c2r(blk.sub("conv2"))
        else:  # plain DecoderBlock (no skip)
            p["Conv2dReLU_0"], s["Conv2dReLU_0"] = _c2r(blk.sub("conv1"))
            p["Conv2dReLU_1"], s["Conv2dReLU_1"] = _c2r(blk.sub("conv2"))
        _put(params, stats, f"dec_{i}", p, s)
    _head(tree, params)
    return params, stats


def _cbr(t: _Tree):
    """PAN ConvBnRelu: conv(bias) + BN (pan/decoder.py:6-38)."""
    bn_p, bn_s = t.bn("bn")
    k, b = _conv_bias(t, "conv")
    return ({"kernel": k, "bias": b, "BatchNorm_0": bn_p},
            {"BatchNorm_0": bn_s})


def _pan(sd):
    params, stats, tree = _base(sd)
    fpa = tree.sub("decoder.fpa")
    fp, fs = {}, {}
    for ours, theirs in (("branch1", "branch1.1"), ("mid", "mid.0"),
                         ("down1", "down1.1"), ("down2", "down2.1"),
                         ("down3a", "down3.1"), ("down3b", "down3.2"),
                         ("conv2", "conv2"), ("conv1", "conv1")):
        fp[ours], fs[ours] = _cbr(fpa.sub(theirs))
    params["FPABlock_0"], stats["FPABlock_0"] = fp, fs
    for name in ("gau3", "gau2", "gau1"):
        gau = tree.sub(f"decoder.{name}")
        gp, gs = {}, {}
        gp["conv1"], gs["conv1"] = _cbr(gau.sub("conv1.1"))
        gp["conv2"], gs["conv2"] = _cbr(gau.sub("conv2"))
        params[name], stats[name] = gp, gs
    _head(tree, params)
    return params, stats


# ---------------------------------------------------------------------------
# NasUnet (models/nasunet/nas_unet.py — its own op vocabulary, GroupNorm,
# so no batch_stats collection)
# ---------------------------------------------------------------------------

def _nas_convops(t: _Tree, transpose: bool):
    p = {"conv": (_tconv if transpose else _conv)(t.t("conv.weight"))}
    if t.has("norm.weight"):
        p["GroupNorm_0"] = {"scale": t.t("norm.weight").copy(),
                            "bias": t.t("norm.bias").copy()}
    return p


def _nas_op(t: _Tree, name: str):
    """One genotype op (prim_ops_set.py ConvOps / CWeightOp / pooling /
    identity). Parameterless ops are detected by key absence."""
    if not any(k.startswith(t.prefix) for k in t.sd):
        return None
    transpose = name.startswith("up_")
    if "cweight" in name:
        p = {"Dense_0": {"kernel": _dense(t.t("fc.0.weight")),
                         "bias": t.t("fc.0.bias").copy()},
             "Dense_1": {"kernel": _dense(t.t("fc.2.weight")),
                         "bias": t.t("fc.2.bias").copy()}}
        if t.has("conv.weight"):  # stride>=2 variants own a conv + norm
            p.update(_nas_convops(t, transpose))
        return p
    return _nas_convops(t, transpose)


def _nasunet_cell(t: _Tree, names):
    p = {"preprocess0": _nas_convops(t.sub("preprocess0"), False),
         "preprocess1": _nas_convops(t.sub("preprocess1"), False)}
    for j, nm in enumerate(names):
        op_p = _nas_op(t.sub(f"_ops.{j}"), nm)
        if op_p is not None:
            p[f"op_{j}"] = op_p
    return p


def _nasunet(sd):
    from senas_torch.models.nasunet import NAS_UNET_V3
    tree = _Tree(sd)
    down_names = [nm for nm, _ in NAS_UNET_V3.down]
    up_names = [nm for nm, _ in NAS_UNET_V3.up]
    params = {"stem0": _nas_convops(tree.sub("stem0"), False),
              "stem1": _nas_convops(tree.sub("stem1"), False)}
    for i in range(_count(sd, "down_cells.{}.preprocess0.conv.weight")):
        params[f"down_{i}"] = _nasunet_cell(tree.sub(f"down_cells.{i}"),
                                            down_names)
    for i in range(_count(sd, "up_cells.{}.preprocess0.conv.weight")):
        params[f"up_{i}"] = _nasunet_cell(tree.sub(f"up_cells.{i}"), up_names)
    params["head"] = {"conv": _conv(tree.t("nas_unet_head.conv.weight"))}
    return params, {}


_TRANSLATORS = {
    "nasunet": _nasunet,
    "unet": _unet,
    "unet_plus_plus": _unetplusplus,
    "unetplusplus": _unetplusplus,
    "manet": _manet,
    "linknet": _linknet,
    "fpn": _fpn,
    "pspnet": _pspnet,
    "deeplab_v3_plus": _deeplabv3plus,
    "deeplabv3plus": _deeplabv3plus,
    "pan": _pan,
}

ZOO_MODEL_NAMES = tuple(sorted(set(_TRANSLATORS)))


def translate_zoo_model(sd: Dict[str, Any], model_name: str) -> Dict[str, Any]:
    """smp baseline state_dict -> our zoo model variables. ``model_name``
    uses the reference factory names (models/__init__.py:8-90)."""
    if model_name not in _TRANSLATORS:
        raise KeyError(f"no zoo translator for {model_name!r}; have "
                       f"{ZOO_MODEL_NAMES}")
    sd = state_dict_to_numpy(sd)
    params, stats = _TRANSLATORS[model_name](sd)
    out = {"params": params}
    if stats:  # nasunet is GroupNorm-only — no batch_stats collection
        out["batch_stats"] = stats
    return out


def import_zoo_checkpoint(path_or_ckpt, model_name: str):
    """Reference train-CLI checkpoint of a baseline model ->
    (variables, run meta) — the zoo counterpart of
    ``import_fixed_checkpoint``."""
    ckpt = _as_ckpt(path_or_ckpt)
    sd = ckpt["model_state"] if "model_state" in ckpt else ckpt
    variables = translate_zoo_model(sd, model_name)
    meta = {
        "epoch": int(ckpt.get("epoch", 0)),
        "dur_time": float(ckpt.get("dur_time", 0.0)),
        "best_dice": float(ckpt.get("best_dice_coeff", 0.0)),
        "best_miou": float(ckpt.get("best_mIoU", 0.0)),
        "best_pixacc": float(ckpt.get("best_pixAcc", 0.0)),
        "imported_from": "torch",
    }
    return variables, meta
