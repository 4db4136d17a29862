"""The port's smp loss family and smp utils against senas_tpu's on the CPU:
the six `smp_*` loss names of both packages' `build_loss`, and the loss
classes (DiceLoss, JaccardLoss, TverskyLoss, FocalLoss, LovaszLoss binary
and multiclass, per image and not, SoftBCEWithLogitsLoss,
SoftCrossEntropyLoss, with and without ignore_index), each held to
senas_tpu's value and gradient w.r.t. its input on the same numpy-made
NHWC tensors; then smp_utils' five metrics and their Metric wrappers, the
meter and the epoch runners.

Lovasz sorts its errors: its value does not depend on the order within
ties, its gradient does. The inputs here are continuous random draws, so
no two errors tie (ignored pixels tie at -inf, where they weigh nothing).

Tolerances (f32 on both sides): values rtol 1e-5 (atol 1e-6 for those
near 0), gradients atol 1e-6 + rtol 1e-5 of their largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.train import smp_losses as JL
from senas_tpu.train import smp_utils as JU
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_torch.train import smp_losses as TL
from senas_torch.train import smp_utils as TU
from senas_torch.train.loss import build_loss as tbuild_loss

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6


def _data(seed, b=2, hw=8, c=3):
    rs = np.random.RandomState(seed)
    return dict(
        logits=rs.randn(b, hw, hw, c).astype(np.float32),
        labels=rs.randint(0, c, (b, hw, hw)).astype(np.int32),
        blogits=rs.randn(b, hw, hw).astype(np.float32),
        blabels=rs.randint(0, 2, (b, hw, hw)).astype(np.int32),
        mlabels=rs.randint(0, 2, (b, hw, hw, c)).astype(np.int32))


def _both(jfn, tfn, y_pred, y_true):
    """(value, d value / d y_pred) of each package's loss."""
    jv, jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(y_true)))(jnp.asarray(y_pred))
    tp = torch.tensor(y_pred, requires_grad=True)
    tv = tfn(tp, torch.from_numpy(y_true))
    tv.backward()
    return (np.asarray(jv), np.asarray(jg)), (tv.detach().numpy(), tp.grad.numpy())


def _check(jfn, tfn, y_pred, y_true):
    (jv, jg), (tv, tg) = _both(jfn, tfn, y_pred, y_true)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=ATOL + RTOL * np.abs(jg).max())
    assert np.abs(jg).max() > 0


@pytest.mark.parametrize("name", ["smp_dice", "smp_jaccard", "smp_tversky", "smp_focal",
                                  "smp_lovasz", "smp_soft_ce"])
@pytest.mark.parametrize("supervision", [False, True])
def test_smp_loss_names_match(name, supervision):
    d = _data(0)
    jl, tl = jbuild_loss(name, supervision), tbuild_loss(name, supervision)
    # a list of heads: the last one (or, with supervision, their mean)
    _check(lambda p, y: jl([p * 0.5, p], y), lambda p, y: tl([p * 0.5, p], y),
           d["logits"], d["labels"])


CASES = {
    "dice": ("DiceLoss", {}),
    "dice_log_smooth": ("DiceLoss", {"log_loss": True, "smooth": 0.5}),
    "dice_classes": ("DiceLoss", {"classes": (0, 2)}),
    "dice_ignore": ("DiceLoss", {"ignore_index": 1}),
    "dice_probs": ("DiceLoss", {"from_logits": False}),
    "jaccard": ("JaccardLoss", {}),
    "jaccard_ignore": ("JaccardLoss", {"ignore_index": 2, "smooth": 1.0}),
    "tversky": ("TverskyLoss", {"alpha": 0.3, "beta": 0.7}),
    "tversky_gamma": ("TverskyLoss", {"alpha": 0.6, "beta": 0.4, "gamma": 1.5}),
    "focal": ("FocalLoss", {"alpha": 0.25}),
    "focal_ignore": ("FocalLoss", {"ignore_index": 0, "normalized": True}),
    "focal_threshold": ("FocalLoss", {"reduced_threshold": 0.5, "gamma": 3.0}),
    "focal_sum": ("FocalLoss", {"reduction": "sum"}),
    "lovasz": ("LovaszLoss", {}),
    "lovasz_per_image": ("LovaszLoss", {"per_image": True}),
    "lovasz_ignore": ("LovaszLoss", {"ignore_index": 1}),
    "lovasz_per_image_ignore": ("LovaszLoss", {"per_image": True, "ignore_index": 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multiclass_losses_match(case):
    cls, kw = CASES[case]
    d = _data(1)
    y_pred = d["logits"]
    if kw.get("from_logits") is False:
        y_pred = np.asarray(jax.nn.softmax(y_pred, axis=-1))
    _check(getattr(JL, cls)(mode="multiclass", **kw), getattr(TL, cls)(mode="multiclass", **kw),
           y_pred, d["labels"])


BINARY = [("DiceLoss", False), ("JaccardLoss", False), ("TverskyLoss", False),
          ("FocalLoss", False), ("LovaszLoss", False), ("LovaszLoss", True)]


@pytest.mark.parametrize("cls,per_image", BINARY)
def test_binary_losses_match(cls, per_image):
    d = _data(2)
    kw = {"per_image": True} if per_image else {}
    _check(getattr(JL, cls)(mode="binary", **kw), getattr(TL, cls)(mode="binary", **kw),
           d["blogits"], d["blabels"])
    # [B,H,W,1] and an ignored label value
    kw["ignore_index"] = 1 if cls == "FocalLoss" else 0
    _check(getattr(JL, cls)(mode="binary", **kw), getattr(TL, cls)(mode="binary", **kw),
           d["blogits"][..., None], d["blabels"][..., None])


@pytest.mark.parametrize("cls", ["DiceLoss", "JaccardLoss", "FocalLoss"])
def test_multilabel_losses_match(cls):
    d = _data(3)
    _check(getattr(JL, cls)(mode="multilabel"), getattr(TL, cls)(mode="multilabel"),
           d["logits"], d["mlabels"])


@pytest.mark.parametrize("kw", [{}, {"smooth_factor": 0.1, "ignore_index": None},
                                {"pos_weight": 2.0, "reduction": "sum"}])
def test_soft_bce_matches(kw):
    d = _data(4)
    labels = d["blabels"].copy()
    labels[0, 0, :3] = -100      # the default ignore_index
    _check(JL.SoftBCEWithLogitsLoss(**kw), TL.SoftBCEWithLogitsLoss(**kw), d["blogits"],
           labels if kw.get("ignore_index", -100) is not None else d["blabels"])


@pytest.mark.parametrize("kw", [{}, {"smooth_factor": 0.1}, {"ignore_index": 2},
                                {"smooth_factor": 0.2, "reduction": "sum"}])
def test_soft_ce_matches(kw):
    d = _data(5)
    _check(JL.SoftCrossEntropyLoss(**kw), TL.SoftCrossEntropyLoss(**kw), d["logits"],
           d["labels"])


def test_score_helpers_match():
    rs = np.random.RandomState(6)
    a, b = rs.rand(2, 3, 10).astype(np.float32), (rs.rand(2, 3, 10) > 0.5).astype(np.float32)
    for name, extra in (("soft_dice_score", ()), ("soft_jaccard_score", ()),
                        ("soft_tversky_score", (0.3, 0.7))):
        for axis in (None, (0, 2)):
            want = getattr(JL, name)(jnp.asarray(a), jnp.asarray(b), *extra, axis=axis)
            got = getattr(TL, name)(torch.from_numpy(a), torch.from_numpy(b), *extra, axis=axis)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    with pytest.raises(ValueError, match="mode must be one of"):
        TL.DiceLoss(mode="ternary")(torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2))


# ---------------------------------------------------------------------------
# smp_utils
# ---------------------------------------------------------------------------

def _scores(seed, c=3):
    rs = np.random.RandomState(seed)
    return (rs.rand(2, 8, 8, c).astype(np.float32),
            (rs.rand(2, 8, 8, c) > 0.5).astype(np.float32))


@pytest.mark.parametrize("kw", [{}, {"threshold": 0.5}, {"threshold": 0.3, "ignore_channels": [0, 2]}])
@pytest.mark.parametrize("name", ["iou", "f_score", "accuracy", "precision", "recall"])
def test_metric_functions_match(name, kw):
    pr, gt = _scores(0, c=4)
    if name == "accuracy" and "threshold" not in kw:
        kw = {**kw, "threshold": 0.5}
    want = getattr(JU, name)(jnp.asarray(pr), jnp.asarray(gt), **kw)
    got = getattr(TU, name)(torch.from_numpy(pr), torch.from_numpy(gt), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("wrapper,name", [("IoU", "iou_score"), ("Fscore", "fscore"),
                                          ("Accuracy", "accuracy"), ("Precision", "precision"),
                                          ("Recall", "recall")])
def test_metric_wrappers_match(wrapper, name):
    pr, gt = _scores(1)
    jm, tm = getattr(JU, wrapper)(), getattr(TU, wrapper)()
    assert tm.name == jm.name == name
    np.testing.assert_allclose(tm(torch.from_numpy(pr), torch.from_numpy(gt)).numpy(),
                               np.asarray(jm(jnp.asarray(pr), jnp.asarray(gt))), rtol=1e-6)
    assert TU.jaccard is TU.iou


def test_average_value_meter():
    m = TU.AverageValueMeter()
    assert np.isnan(m.std)
    for v in (1.0, 2.0, 3.0):
        m.add(v)
    assert m.mean == pytest.approx(2.0) and m.std == pytest.approx(1.0)


def test_epoch_runners_train_and_valid():
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(3, 2, 1)
    model = lambda x: torch.sigmoid(conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    loss = TL.DiceLoss(mode="multilabel", from_logits=False)
    rs = np.random.RandomState(0)
    loader = [(rs.rand(2, 8, 8, 3).astype(np.float32),
               (rs.rand(2, 8, 8, 2) > 0.5).astype(np.float32)) for _ in range(3)]
    metrics = [TU.IoU(), TU.Fscore()]
    before = TU.ValidEpoch(model, loss, metrics, device="cpu").run(loader)
    assert set(before) == {"loss", "iou_score", "fscore"}
    train = TU.TrainEpoch(model, loss, metrics, torch.optim.SGD(conv.parameters(), lr=0.5),
                          device="cpu")
    for _ in range(5):
        train.run(loader)
    after = TU.ValidEpoch(model, loss, metrics, device="cpu").run(loader)
    assert after["loss"] < before["loss"]
