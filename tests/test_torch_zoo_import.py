"""The port's baseline-zoo checkpoint import against senas_tpu's on the CPU.

For each of the factory's nine zoo names, an smp-layout state_dict is
written here from numpy-made flax variables, with the keys that
senas_tpu/compat/zoo_import.py reads (torch's conv, transposed-conv,
Linear, BatchNorm and GroupNorm layouts). The writer is checked by the
round trip in senas_tpu (its translator gives back the variables, leaf for
leaf); the port's `translate_zoo_model` must give senas_tpu's tree on that
state_dict, exactly, and the tree loads into the port's model. Then a
reference train checkpoint of a unet goes through `python -m
senas_torch.import_torch_checkpoint --model unet` and the port's
TrainRunner resumes from it; and a torchvision-style resnet state_dict
goes into a model's encoder (`translate_resnet_encoder`,
`set_encoder_variables`)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.compat import zoo_import as jzi
from senas_tpu.compat.torch_import import translate_resnet_encoder as j_translate_encoder
from senas_tpu.models.factory import get_segmentation_model as jget
from senas_tpu.models.nasunet import NAS_UNET_V3
from senas_torch import convert
from senas_torch.compat import (ZOO_MODEL_NAMES, import_zoo_checkpoint, set_encoder_variables,
                                translate_resnet_encoder, translate_zoo_model)
from senas_torch.core.config import load_config
from senas_torch.import_torch_checkpoint import main as import_cli
from senas_torch.models.factory import get_segmentation_model as tget
from senas_torch.runner.train import TrainRunner

from torch_port_util import flat, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")

# (name, depth, input side) at which the variables' shapes are taken
ZOO = [("unet", 3, 32), ("unet_plus_plus", 3, 32), ("manet", 3, 32), ("linknet", 3, 32),
       ("fpn", 4, 32), ("pspnet", 3, 32), ("pan", 5, 128), ("deeplab_v3_plus", 5, 32),
       ("nasunet", 2, 32)]


# ---------------------------------------------------------------------------
# flax variables -> an smp-layout state_dict (the inverse of zoo_import)
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.sd = {}

    def conv(self, key, kernel, bias=None):
        self.sd[f"{key}.weight"] = np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))
        if bias is not None:
            self.sd[f"{key}.bias"] = np.asarray(bias)

    def tconv(self, key, kernel):
        self.sd[f"{key}.weight"] = np.ascontiguousarray(
            np.flip(np.asarray(kernel), axis=(0, 1)).transpose(2, 3, 0, 1))

    def dense(self, key, p):
        self.sd[f"{key}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
        self.sd[f"{key}.bias"] = np.asarray(p["bias"])

    def bn(self, key, p, s):
        self.sd.update({f"{key}.weight": p["scale"], f"{key}.bias": p["bias"],
                        f"{key}.running_mean": s["mean"], f"{key}.running_var": s["var"],
                        f"{key}.num_batches_tracked": np.array(3)})

    def gn(self, key, p):
        self.sd.update({f"{key}.weight": p["scale"], f"{key}.bias": p["bias"]})

    def c2r(self, key, p, s):
        """smp Conv2dReLU: (conv, bn | Identity, relu)."""
        if "BatchNorm_0" in p:
            self.conv(f"{key}.0", p["kernel"])
            self.bn(f"{key}.1", p["BatchNorm_0"], s["BatchNorm_0"])
        else:
            self.conv(f"{key}.0", p["kernel"], p["bias"])

    def cbr(self, key, p, s):
        """PAN ConvBnRelu: conv (bias) + bn."""
        self.conv(f"{key}.conv", p["kernel"], p["bias"])
        self.bn(f"{key}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    def sep(self, dw_pw, bn_key, p, s):
        self.conv(f"{dw_pw}.0", p["dw"])
        self.conv(f"{dw_pw}.1", p["pw"])
        self.bn(bn_key, p["BatchNorm_0"], s["BatchNorm_0"])

    def encoder(self, p, s):
        self.conv("encoder.conv1", p["conv1"])
        self.bn("encoder.bn1", p["bn1"], s["bn1"])
        for key in p:
            if not key.startswith("layer"):
                continue
            g, b = key[len("layer"):].split("_")
            pre, bp, bs = f"encoder.layer{g}.{b}", p[key], s[key]
            for i in (1, 2, 3):
                if f"conv{i}" in bp:
                    self.conv(f"{pre}.conv{i}", bp[f"conv{i}"])
                    self.bn(f"{pre}.bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
            if "down_conv" in bp:
                self.conv(f"{pre}.downsample.0", bp["down_conv"])
                self.bn(f"{pre}.downsample.1", bp["down_bn"], bs["down_bn"])

    def head(self, p):
        self.conv("segmentation_head.0", p["SegmentationHead_0"]["kernel"],
                  p["SegmentationHead_0"]["bias"])


def _blocks(w, prefix, p, s, names):
    for i, name in enumerate(names):
        w.c2r(f"{prefix}.conv{i + 1}", p[name], s[name])


def write_smp_state_dict(name, variables):
    p, s = variables["params"], variables.get("batch_stats", {})
    w = _Writer()
    if name == "nasunet":
        _write_nasunet(w, p)
        return w.sd
    w.encoder(p["encoder"], s["encoder"])
    w.head(p)
    if name in ("unet", "unet_plus_plus"):
        for key in p:
            if key.startswith(("dec_", "x_")):
                blk = key.replace("dec_", "") if name == "unet" else key
                _blocks(w, f"decoder.blocks.{blk}", p[key], s[key],
                        ("Conv2dReLU_0", "Conv2dReLU_1"))
    elif name == "linknet":
        for key in (k for k in p if k.startswith("dec_")):
            pre, bp, bs = f"decoder.blocks.{key[4:]}.block", p[key], s[key]
            w.c2r(f"{pre}.0", bp["Conv2dReLU_0"], bs["Conv2dReLU_0"])
            w.tconv(f"{pre}.1.0", bp["tkernel"])
            w.sd[f"{pre}.1.0.bias"] = bp["tbias"]
            w.bn(f"{pre}.1.1", bp["BatchNorm_0"], bs["BatchNorm_0"])
            w.c2r(f"{pre}.2", bp["Conv2dReLU_1"], bs["Conv2dReLU_1"])
    elif name == "fpn":
        w.conv("decoder.p5", p["p5"], p["p5_b"])
        for lvl in (4, 3, 2):
            w.conv(f"decoder.p{lvl}.skip_conv", p[f"p{lvl}_skip"], p[f"p{lvl}_skip_b"])
        for key in (k for k in p if k.startswith("seg_")):
            i, j = key.split("_")[1:]
            pre = f"decoder.seg_blocks.{i}.block.{j}.block"
            w.conv(f"{pre}.0", p[key]["kernel"])
            w.gn(f"{pre}.1", p[key]["GroupNorm_0"])
    elif name == "pspnet":
        for key in (k for k in p if k.startswith("psp_")):
            w.c2r(f"decoder.psp.blocks.{key[4:]}.pool.1", p[key], s.get(key, {}))
        w.c2r("decoder.conv", p["Conv2dReLU_0"], s["Conv2dReLU_0"])
    elif name == "deeplab_v3_plus":
        ap, asv = p["ASPP_0"], s["ASPP_0"]
        w.c2r("decoder.aspp.0.convs.0", ap["conv1x1"], asv["conv1x1"])
        for i in range(3):
            w.sep(f"decoder.aspp.0.convs.{1 + i}.0", f"decoder.aspp.0.convs.{1 + i}.1",
                  ap[f"aspp_{i}"], asv[f"aspp_{i}"])
        w.conv("decoder.aspp.0.convs.4.1", ap["pool_conv"]["kernel"])
        w.bn("decoder.aspp.0.convs.4.2", ap["pool_conv"]["BatchNorm_0"],
             asv["pool_conv"]["BatchNorm_0"])
        w.c2r("decoder.aspp.0.project", ap["project"], asv["project"])
        w.sep("decoder.aspp.1", "decoder.aspp.2", p["aspp_post"], s["aspp_post"])
        w.c2r("decoder.block1", p["highres"], s["highres"])
        w.sep("decoder.block2.0", "decoder.block2.1", p["fuse"], s["fuse"])
    elif name == "manet":
        pab = p["PAB_0"]
        for ours, theirs in (("top", "top_conv"), ("center", "center_conv"),
                             ("bottom", "bottom_conv")):
            w.conv(f"decoder.center.{theirs}", pab[ours], pab[ours + "_b"])
        w.conv("decoder.center.out_conv", pab["out"], pab["out_bias"])
        for key in (k for k in p if k.startswith("dec_")):
            pre, bp, bs = f"decoder.blocks.{key[4:]}", p[key], s[key]
            if "hl_w1" in bp:
                w.c2r(f"{pre}.hl_conv.0", bp["Conv2dReLU_0"], bs["Conv2dReLU_0"])
                w.c2r(f"{pre}.hl_conv.1", bp["Conv2dReLU_1"], bs["Conv2dReLU_1"])
                for tag in ("hl", "ll"):
                    w.conv(f"{pre}.SE_{tag}.1", bp[f"{tag}_w1"], bp[f"{tag}_b1"])
                    w.conv(f"{pre}.SE_{tag}.3", bp[f"{tag}_w2"], bp[f"{tag}_b2"])
                _blocks(w, pre, bp, bs, ("Conv2dReLU_2", "Conv2dReLU_3"))
            else:
                _blocks(w, pre, bp, bs, ("Conv2dReLU_0", "Conv2dReLU_1"))
    elif name == "pan":
        fp, fs = p["FPABlock_0"], s["FPABlock_0"]
        for ours, theirs in (("branch1", "branch1.1"), ("mid", "mid.0"), ("down1", "down1.1"),
                             ("down2", "down2.1"), ("down3a", "down3.1"), ("down3b", "down3.2"),
                             ("conv2", "conv2"), ("conv1", "conv1")):
            w.cbr(f"decoder.fpa.{theirs}", fp[ours], fs[ours])
        for gau in ("gau3", "gau2", "gau1"):
            w.cbr(f"decoder.{gau}.conv1.1", p[gau]["conv1"], s[gau]["conv1"])
            w.cbr(f"decoder.{gau}.conv2", p[gau]["conv2"], s[gau]["conv2"])
    return w.sd


def _nas_convops(w, key, p, transpose=False):
    (w.tconv if transpose else w.conv)(f"{key}.conv", p["conv"])
    if "GroupNorm_0" in p:
        w.gn(f"{key}.norm", p["GroupNorm_0"])


def _write_nasunet(w, p):
    _nas_convops(w, "stem0", p["stem0"])
    _nas_convops(w, "stem1", p["stem1"])
    for kind, names in (("down", [n for n, _ in NAS_UNET_V3.down]),
                        ("up", [n for n, _ in NAS_UNET_V3.up])):
        for key in (k for k in p if k.startswith(f"{kind}_")):
            pre, cp = f"{kind}_cells.{key.split('_')[1]}", p[key]
            _nas_convops(w, f"{pre}.preprocess0", cp["preprocess0"])
            _nas_convops(w, f"{pre}.preprocess1", cp["preprocess1"])
            for j, nm in enumerate(names):
                if f"op_{j}" not in cp:
                    continue
                op, opre = cp[f"op_{j}"], f"{pre}._ops.{j}"
                if "cweight" in nm:
                    w.dense(f"{opre}.fc.0", op["Dense_0"])
                    w.dense(f"{opre}.fc.2", op["Dense_1"])
                if "conv" in op:
                    _nas_convops(w, opre, op, transpose=nm.startswith("up_"))
    w.conv("nas_unet_head.conv", p["head"]["conv"])


def _variables(name, depth, hw, seed=0):
    rng = np.random.RandomState(seed)
    jm = jget(name, dataset="promise12", depth=depth)
    return random_variables(jm, rng, jnp.ones((1, hw, hw, 1)), False)


def _equal(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module", params=ZOO, ids=[z[0] for z in ZOO])
def written(request):
    name, depth, hw = request.param
    variables = _variables(name, depth, hw)
    sd = write_smp_state_dict(name, variables)
    return dict(name=name, depth=depth, variables=variables, sd=sd)


def test_the_writer_round_trips_through_senas_tpu(written):
    """senas_tpu's translator gives back the variables the state_dict was
    written from: the writer holds the keys and layouts it reads."""
    _equal(jzi.translate_zoo_model(written["sd"], written["name"]), written["variables"])


def test_port_translation_is_senas_tpus(written):
    name = written["name"]
    got = translate_zoo_model({k: torch.from_numpy(np.asarray(v)) for k, v in
                               written["sd"].items()}, name)
    _equal(got, jzi.translate_zoo_model(written["sd"], name))
    model = tget(name, dataset="promise12", depth=written["depth"], device="cpu")
    convert.load_variables(model, got)
    _equal(convert.state_dict_to_variables(model), {"batch_stats": {}, **got})


def test_zoo_names_and_meta():
    assert set(ZOO_MODEL_NAMES) == set(jzi.ZOO_MODEL_NAMES)
    with pytest.raises(KeyError, match="no zoo translator"):
        translate_zoo_model({}, "segformer")
    sd = write_smp_state_dict("unet", _variables("unet", 3, 32))
    ckpt = {"model_state": sd, "epoch": 7, "dur_time": 12.5, "best_dice_coeff": 0.75,
            "best_mIoU": 0.5, "best_pixAcc": 0.9}
    (_, meta), (_, jmeta) = import_zoo_checkpoint(ckpt, "unet"), jzi.import_zoo_checkpoint(
        ckpt, "unet")
    assert meta == jmeta and meta["epoch"] == 7


def test_encoder_weights_graft_into_a_zoo_model():
    """A torchvision-naming resnet34 state_dict (with fc keys) translates
    as senas_tpu's does and replaces the encoder of a depth-4 unet over 3
    input channels; stage 5 of the import is dropped."""
    from senas_tpu.models.encoders import get_encoder
    enc = random_variables(get_encoder("resnet34"), np.random.RandomState(2),
                           jnp.ones((1, 32, 32, 3)), False)
    w = _Writer()
    w.encoder(enc["params"], enc["batch_stats"])
    sd = {k[len("encoder."):]: v for k, v in w.sd.items()}
    sd["fc.weight"] = np.zeros((10, 512), np.float32)
    got = translate_resnet_encoder(sd)
    _equal(got, j_translate_encoder(sd))
    _equal(got, enc)
    from senas_torch.models import zoo as tzoo
    model = tzoo.Unet(classes=2, in_channels=3, encoder_name="resnet34", encoder_depth=4,
                      decoder_channels=(64, 32, 16, 8), device="cpu")
    grafted = set_encoder_variables(convert.state_dict_to_variables(model), got)
    convert.load_variables(model, grafted)
    assert np.array_equal(model.encoder.layer3_5.conv2.detach().numpy(),
                          got["params"]["layer3_5"]["conv2"].transpose(3, 2, 0, 1))
    bad = {c: {k: v for k, v in got[c].items() if k != "layer2_0"} for c in got}
    with pytest.raises(KeyError, match="layer2_0"):
        set_encoder_variables(convert.state_dict_to_variables(model), bad)


def test_import_cli_then_resume_the_train_runner(tmp_path):
    """A reference train checkpoint of a unet (the synthetic config's depth
    3) -> `import_torch_checkpoint --model unet` -> TrainRunner resumes at
    the checkpoint's epoch with its weights and runs the epoch left."""
    cfg = load_config(CONFIG)
    depth = cfg["training"]["depth"]
    variables = _variables("unet", depth, 64, seed=4)
    ckpt = {"model_state": {k: torch.from_numpy(np.asarray(v)) for k, v in
                            write_smp_state_dict("unet", variables).items()},
            "epoch": 2, "dur_time": 3.0, "best_dice_coeff": 0.25, "best_mIoU": 0.2}
    path = tmp_path / "checkpint.pth.tar"
    torch.save(ckpt, path)
    out = tmp_path / "imported"
    assert import_cli([str(path), "--config", CONFIG, "--out", str(out), "--model", "unet",
                       "--device", "cpu"]) == 0
    with pytest.raises(SystemExit, match="segformer"):
        import_cli([str(path), "--config", CONFIG, "--out", str(tmp_path / "x"), "--model",
                    "segformer", "--device", "cpu"])

    cfg["training"].update(resume=str(out), epoch=3)
    runner = TrainRunner(cfg, model_name="unet", log_root=str(tmp_path / "logs"),
                         device="cpu")
    assert runner.start_epoch == 2 and runner.best_dice == 0.25
    _equal(convert.state_dict_to_variables(runner.model),
           {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    runner.run()
    assert runner.state.step == len(runner.train_queue) > 0
    assert runner.ckpt.exists("last")
