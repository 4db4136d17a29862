"""senas_torch.train.loss / metrics against senas_tpu's on the same NHWC
logits and labels, made from a seed with numpy.

Tolerance: losses rtol 1e-5 (f32 on both sides, other reduction order);
the confusion counts are integers and must be exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.train import loss as jloss
from senas_tpu.train import metrics as jmetrics
from senas_torch.train import loss as tloss
from senas_torch.train import metrics as tmetrics


def _batch(seed, nclass, heads=1, b=2, h=8, w=8):
    rng = np.random.RandomState(seed)
    logits = [rng.randn(b, h, w, nclass).astype(np.float32) for _ in range(heads)]
    label = rng.randint(0, nclass, size=(b, h, w)).astype(np.int32)
    return logits, label


@pytest.mark.parametrize("supervision", [False, True])
@pytest.mark.parametrize("name", ["cross_entropy", "dice_ce", "dice_sq_ce",
                                  "dice_loss", "dice_square"])
def test_build_loss_matches_jax(name, supervision):
    logits, label = _batch(0, nclass=3, heads=3 if supervision else 1)
    want = jloss.build_loss(name, supervision)([jnp.asarray(x) for x in logits],
                                               jnp.asarray(label))
    got = tloss.build_loss(name, supervision)([torch.from_numpy(x) for x in logits],
                                              torch.from_numpy(label))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_unknown_loss_is_an_error():
    with pytest.raises(NotImplementedError):
        tloss.build_loss("focal")


@pytest.mark.parametrize("nclass", [2, 4])
def test_confusion_counts_and_pix_accuracy_match_jax(nclass):
    (logits,), label = _batch(nclass, nclass)
    jt = [np.asarray(v) for v in jmetrics.confusion_counts(jnp.asarray(logits),
                                                           jnp.asarray(label))]
    tt = tmetrics.confusion_counts(torch.from_numpy(logits), torch.from_numpy(label))
    for name, j, t in zip(("tp", "fp", "fn"), jt, tt):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    np.testing.assert_allclose(
        float(tmetrics.mean_pix_accuracy(torch.from_numpy(logits), torch.from_numpy(label))),
        float(jmetrics.mean_pix_accuracy(jnp.asarray(logits), jnp.asarray(label))),
        rtol=1e-6)


def test_segmentation_metric_accumulates_like_jax():
    jm, tm = jmetrics.SegmentationMetric(3), tmetrics.SegmentationMetric(3)
    for seed in range(3):
        (logits,), label = _batch(10 + seed, 3)
        jm.update(jnp.asarray(label), jnp.asarray(logits))
        tm.update(torch.from_numpy(label), torch.from_numpy(logits))
    assert tm.get() == jm.get()
