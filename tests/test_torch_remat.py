"""remat: every cell (the head's included) recomputed in the backward
(`primitives.remat`, torch.utils.checkpoint), the port's counterpart of
the JAX package's nn.remat.

In the port, remat on against remat off from the same weights and batch:
the train-mode logits, the loss, every gradient and the running stats
after a train step are equal, bit for bit (the CPU's recompute repeats the
first forward exactly), for SenasModel and for SenasSearch with the
grouped (fused) and the per-edge (unfused) cells, with the BN gate off and
on. The running stats advance once a step: the recompute leaves them
alone. The port's remat search step is held to senas_tpu's remat step at
tests/test_torch_search_step.py's limits."""

import os

import pytest
import torch

from senas_torch.core.config import load_config
from senas_torch.models import geno_searched as tgs
from senas_torch.models.senas_model import SenasModel
from senas_torch.ops import grouped_epilogue as ge
from senas_torch.search import supernet as tsn
from senas_torch.train.loss import build_loss

from torch_port_util import assert_search_steps_match, search_step_pair
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
B, HW = 2, 16


def _fixed(remat):
    return SenasModel(nclass=2, in_channels=1, c=4, depth=3, genotype=tgs.senas_node_4,
                      remat=remat, device="cpu", generator=torch.Generator().manual_seed(0))


def _search(remat, fused):
    return tsn.SenasSearch(1, 8, 2, 3, 2, fused=fused, remat=remat, device="cpu",
                           generator=torch.Generator().manual_seed(0))


def _run(model, forward, batch):
    """Train-mode logits, loss and gradients of one backward, and the
    running stats after it."""
    logits = forward(model, batch["image"])
    loss = build_loss("dice_ce")(logits, batch["label"])
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    stats = {k: v.clone() for k, v in model.named_buffers()}
    return logits[0].detach(), loss.detach(), grads, stats


def _assert_same(on, off):
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for g_on, g_off in zip(on[2], off[2]):
        assert (g_on is None) == (g_off is None)
        if g_on is not None:
            assert torch.equal(g_on, g_off)
    assert on[3].keys() == off[3].keys()
    for k in on[3]:
        assert torch.equal(on[3][k], off[3][k]), k


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.randn(B, HW, HW, 1, generator=g),
            "label": (torch.rand(B, HW, HW, generator=g) > 0.6).long()}


@pytest.mark.parametrize("gate", ["0", "1"])
def test_fixed_model_remat_changes_nothing(monkeypatch, gate):
    monkeypatch.setenv("SENAS_PALLAS_BN", gate)
    batch = _batch(1)
    fwd = lambda m, x: m(x, train=True)
    off = _run(_fixed(False), fwd, batch)
    model = _fixed(True)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    on = _run(model, fwd, batch)
    _assert_same(on, off)
    moved = [k for k, v in on[3].items() if not torch.equal(v, stats0[k])]
    assert moved, "the step left every running stat in place"


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("gate", ["0", "1"])
def test_supernet_remat_changes_nothing(monkeypatch, gate, fused):
    monkeypatch.setenv("SENAS_PALLAS_BN", gate)
    batch = _batch(2)
    gen = torch.Generator().manual_seed(3)
    arch = tsn.init_arch_params(2, 3, use_sharing=False, generator=gen, device="cpu")
    arch = {k: 50 * v for k, v in arch.items()}
    aw = tsn.normalize_arch(arch, 2)
    fwd = lambda m, x: m(x, aw, train=True)
    _assert_same(_run(_search(True, fused), fwd, batch), _run(_search(False, fused), fwd, batch))


def test_recompute_runs_the_forward_kernels_again():
    """The epilogue's forward twins run twice a remat step (the recompute),
    the backward ones once; the running stats still move once (above)."""
    calls = {}
    real = {name: getattr(ge, name) for name in ("branch_stats", "apply_mix", "bwd_reduce")}

    def counting(name):
        def fn(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kw)
        return fn

    batch = _batch(4)
    aw = tsn.normalize_arch(tsn.init_arch_params(2, 3, use_sharing=False,
                                                 generator=torch.Generator().manual_seed(5),
                                                 device="cpu"), 2)
    per_run = {}
    for remat in (False, True):
        calls.clear()
        try:
            for name in real:
                setattr(ge, name, counting(name))
            _run(_search(remat, True), lambda m, x: m(x, aw, train=True), batch)
        finally:
            for name, fn in real.items():
                setattr(ge, name, fn)
        per_run[remat] = dict(calls)
    assert per_run[True]["bwd_reduce"] == per_run[False]["bwd_reduce"] > 0
    for name in ("branch_stats", "apply_mix"):
        assert per_run[True][name] == 2 * per_run[False][name] > 0


def test_remat_search_step_matches_jax():
    s = load_config(CONFIG)["searching"]
    runs = search_step_pair(s["model_optimizer"], s["arch_optimizer"], remat=True)
    assert_search_steps_match(runs)
    assert runs["state"].model.remat
