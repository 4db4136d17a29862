"""The void label -1 (ADE20K's, `data/generic.py`) through the losses and
metrics of both packages (ROADMAP F6).

The JAX losses index with `jnp.take_along_axis` (a label in [-C, -1]
wraps to label + C; any other label outside [0, C) reads NaN) and
`jax.nn.one_hot` (a zero row outside [0, C)). The port follows that rule
(`senas_torch.train.smp_losses.take_class` / `one_hot`) instead of
raising. Each of the eleven loss names and the metrics run on a batch
whose labels hold -1 (and, for the index rule, -C and C) through both
packages: the values within rtol 1e-5, the gradients within 1e-5 of
their largest element (f32 on both sides, other reduction orders); NaN
where JAX gives NaN; the confusion counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.train import loss as jloss
from senas_tpu.train import metrics as jmetrics
from senas_torch.train import loss as tloss
from senas_torch.train import metrics as tmetrics
from senas_torch.train import smp_losses as tsmp
from torch_port_util import one_torch_thread  # noqa: F401

NAMES = ["cross_entropy", "dice_ce", "dice_sq_ce", "dice_loss", "dice_square", "smp_dice",
         "smp_jaccard", "smp_tversky", "smp_focal", "smp_lovasz", "smp_soft_ce"]


def _batch(seed, nclass=4, b=2, h=6, w=7, void=-1):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, h, w, nclass).astype(np.float32)
    label = rng.randint(0, nclass, size=(b, h, w)).astype(np.int32)
    label[rng.rand(b, h, w) < 0.3] = void
    return logits, label


def _both(name, logits, label):
    jfn, tfn = jloss.build_loss(name), tloss.build_loss(name)
    jv, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(label)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tv = tfn(x, torch.from_numpy(label))
    (tg,) = torch.autograd.grad(tv, x)
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tg.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_losses_on_void_labels_match_jax(name):
    logits, label = _batch(NAMES.index(name))
    (jv, jg), (tv, tg) = _both(name, logits, label)
    assert np.isfinite(jv), (name, jv)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * np.abs(jg).max(), err_msg=name)


@pytest.mark.parametrize("name", ["cross_entropy", "smp_soft_ce", "dice_ce", "smp_dice"])
def test_labels_outside_the_index_rule(name):
    """-C wraps to class 0 in both; C reads NaN in the JAX package's
    gather, and then in the port's too, with the same (finite) gradient."""
    c = 4
    logits, label = _batch(7, nclass=c, void=-c)
    label[0, 0, :3] = c
    (jv, jg), (tv, tg) = _both(name, logits, label)
    if np.isnan(jv):
        assert np.isnan(tv), (name, tv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=1e-5, err_msg=name)
    assert np.isfinite(jg).all() == np.isfinite(tg).all(), name
    ok = np.isfinite(jg)
    np.testing.assert_allclose(tg[ok], jg[ok], rtol=0, atol=1e-5 * np.abs(jg[ok]).max())


def test_take_class_and_one_hot_rule():
    vals = torch.arange(12.0).reshape(3, 4)
    got = tsmp.take_class(vals, torch.tensor([-1, -4, 4]))
    assert got[0].item() == 3.0 and got[1].item() == 4.0 and torch.isnan(got[2])
    oh = tsmp.one_hot(torch.tensor([-1, 0, 3, 4]), 4, torch.float32).numpy()
    np.testing.assert_array_equal(oh, np.asarray(jax.nn.one_hot(jnp.array([-1, 0, 3, 4]), 4)))


def test_metrics_on_void_labels_match_jax():
    jm, tm = jmetrics.SegmentationMetric(4), tmetrics.SegmentationMetric(4)
    for seed in range(3):
        logits, label = _batch(20 + seed)
        jt = [np.asarray(v) for v in jmetrics.confusion_counts(jnp.asarray(logits),
                                                               jnp.asarray(label))]
        tt = tmetrics.confusion_counts(torch.from_numpy(logits), torch.from_numpy(label))
        for j, t in zip(jt, tt):
            np.testing.assert_array_equal(t.numpy(), j)
        np.testing.assert_allclose(
            float(tmetrics.mean_pix_accuracy(torch.from_numpy(logits), torch.from_numpy(label))),
            float(jmetrics.mean_pix_accuracy(jnp.asarray(logits), jnp.asarray(label))),
            rtol=1e-6)
        jm.update(jnp.asarray(label), jnp.asarray(logits))
        tm.update(torch.from_numpy(label), torch.from_numpy(logits))
    assert tm.get() == jm.get()
