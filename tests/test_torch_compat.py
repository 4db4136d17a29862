"""The port's reference-checkpoint import (senas_torch.compat and the
import CLI) against senas_tpu.compat on the CPU.

The reference's own modules are not in the repository, so a reference
checkpoint is built from JAX-made variables by inverting the JAX
translator (tests/torch_port_util.py). The first tests bind that helper to
the translator: senas_tpu's import gives the variables back exactly. Then
the port's import must give senas_tpu's trees exactly (fixed model; search
checkpoints in the naive and the fused layout, with shared and unshared
normal tables) and its run meta; the imported port models' logits must
match the JAX models' (rtol = atol = 1e-4; c 8, depth 3, 32x32 fixed,
meta 2, 16x16 search); and the CLI's checkpoints must resume TrainRunner,
SearchRunner and testing_model (configs/senas/senas_synthetic.yml)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from senas_tpu import compat as jcompat
from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_tpu.search import supernet as jsn
from senas_torch import compat as tcompat
from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.import_torch_checkpoint import check_structure
from senas_torch.import_torch_checkpoint import main as import_cli
from senas_torch.models import geno_searched as tgs
from senas_torch.models.senas_model import SenasModel
from senas_torch.runner.search import SearchRunner
from senas_torch.runner.train import TrainRunner
from senas_torch.search import supernet as tsn
from senas_torch.testing_model import main as eval_cli

from torch_port_util import (flat, random_variables, reference_search_checkpoint,
                             reference_train_checkpoint)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def assert_trees_equal(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _fixed(c, depth, hw, genotype="senas", seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, hw, hw, 1).astype(np.float32)
    jm = JModel(nclass=2, in_channels=1, c=c, depth=depth, genotype=getattr(jgs, genotype))
    variables = random_variables(jm, rng, jnp.asarray(x), False)
    return dict(jm=jm, x=x, variables=variables,
                ckpt=reference_train_checkpoint(variables, getattr(jgs, genotype)))


def _search(c, depth, meta, hw, use_sharing, seed=1):
    rng = np.random.RandomState(seed)
    shapes = jsn.arch_param_count(meta, depth)
    if use_sharing:
        shapes.pop("alphas_up_nm")
    arch = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    x = rng.randn(2, hw, hw, 1).astype(np.float32)
    naive = jsn.SenasSearch(in_channels=1, c=c, nclass=2, depth=depth, meta_node_num=meta,
                            fused=False)
    variables = random_variables(naive, rng, jnp.asarray(x), jsn.normalize_arch(arch, meta),
                                 False)
    return dict(arch=arch, x=x, variables=variables,
                ckpt=reference_search_checkpoint(variables, arch, meta, use_sharing))


@pytest.fixture(scope="module")
def fixed():
    return _fixed(8, 3, 32)


@pytest.fixture(scope="module", params=[True, False], ids=["shared", "unshared"])
def search(request):
    return dict(_search(8, 3, 2, 16, request.param), use_sharing=request.param)


# ---------------------------------------------------------------------------
# the helper against senas_tpu's translator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("genotype", ["senas", "senas_node_2", "senas_node_3"])
def test_reference_fixed_checkpoint_inverts_the_jax_translator(genotype):
    case = _fixed(8, 3, 16, genotype)
    sd = jcompat.state_dict_to_numpy(case["ckpt"]["model_state"])
    got = jcompat.translate_senas_model(sd, getattr(jgs, genotype), 3)
    assert_trees_equal(got, case["variables"])


def test_reference_search_checkpoint_inverts_the_jax_translator(search):
    sd = jcompat.state_dict_to_numpy(search["ckpt"]["model_state"])
    net = {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")}
    assert_trees_equal(jcompat.translate_senas_search(net, 3, 2, fused=False),
                       search["variables"])
    arch = jcompat.translate_arch_params(search["ckpt"])
    assert arch.keys() == search["arch"].keys()
    for k, v in search["arch"].items():
        np.testing.assert_array_equal(arch[k], v)


# ---------------------------------------------------------------------------
# the port's import against senas_tpu's
# ---------------------------------------------------------------------------

def test_fixed_import_matches_jax(fixed):
    assert tcompat.classify_checkpoint(fixed["ckpt"]) == \
        jcompat.classify_checkpoint(fixed["ckpt"]) == "train"
    got, got_meta = tcompat.import_fixed_checkpoint(fixed["ckpt"], tgs.senas, 3)
    want, want_meta = jcompat.import_fixed_checkpoint(fixed["ckpt"], jgs.senas, 3)
    assert_trees_equal(got, want)
    assert got_meta == want_meta and got_meta["epoch"] == 7 and got_meta["best_dice"] == 80.25
    # a bare state_dict and a genotype string take the same path
    bare, _ = tcompat.import_fixed_checkpoint(fixed["ckpt"]["model_state"],
                                              repr(tgs.senas), 3)
    assert_trees_equal(bare, want)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "naive"])
def test_search_import_matches_jax(search, fused):
    ckpt = search["ckpt"]
    assert tcompat.classify_checkpoint(ckpt) == jcompat.classify_checkpoint(ckpt) == "search"
    got = tcompat.import_search_checkpoint(ckpt, 3, 2, fused=fused)
    want = jcompat.import_search_checkpoint(ckpt, 3, 2, fused=fused)
    assert_trees_equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert ("alphas_up_nm" in got[1]) == (not search["use_sharing"])
    assert got[2] == want[2] and got[2]["cur_patience"] == 2


@pytest.mark.parametrize("use_sharing", [None, True, False])
def test_translate_arch_params_matches_jax(search, use_sharing):
    for src in (search["ckpt"], search["ckpt"]["model_state"]):
        got = tcompat.translate_arch_params(src, use_sharing)
        want = jcompat.translate_arch_params(src, use_sharing)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_imported_fixed_model_logits_match_jax(fixed):
    variables, _ = tcompat.import_fixed_checkpoint(fixed["ckpt"], tgs.senas, 3)
    model = convert.load_variables(
        SenasModel(2, 1, c=8, depth=3, genotype=tgs.senas, device="cpu"), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(fixed["x"]), train=False)[-1].numpy()
    want = fixed["jm"].apply(fixed["variables"], jnp.asarray(fixed["x"]), False)[-1]
    np.testing.assert_allclose(got, np.asarray(want), **LOGIT_TOL)


def test_imported_supernet_logits_match_jax(search):
    variables, arch, _ = tcompat.import_search_checkpoint(search["ckpt"], 3, 2)
    net = convert.load_variables(
        tsn.SenasSearch(in_channels=1, c=8, nclass=2, depth=3, meta_node_num=2,
                        device="cpu"), variables)
    aw = tsn.normalize_arch(convert.arch_to_torch(arch, "cpu"), 2)
    with torch.no_grad():
        got = net(torch.from_numpy(search["x"]), aw, train=False)[-1].numpy()
    jvars, jarch, _ = jcompat.import_search_checkpoint(search["ckpt"], 3, 2)
    jm = jsn.SenasSearch(in_channels=1, c=8, nclass=2, depth=3, meta_node_num=2)
    want = jm.apply(jvars, jnp.asarray(search["x"]), jsn.normalize_arch(jarch, 2), False)[-1]
    np.testing.assert_allclose(got, np.asarray(want), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the import CLI, then the runners resume
# ---------------------------------------------------------------------------

def _save(ckpt, path):
    torch.save(ckpt, path)
    return str(path)


def _config(tmp_path, **sections):
    cfg = load_config(CONFIG)
    for name, values in sections.items():
        cfg[name].update(values)
    cfg["searching"]["arch_optimizer"]["betas"] = list(cfg["searching"]["arch_optimizer"]["betas"])
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def synthetic_fixed():
    """A reference train checkpoint at senas_synthetic.yml's `training:`
    geometry (genotype senas, c 8, depth 3)."""
    return _fixed(8, 3, 16, seed=2)


def test_cli_train_checkpoint_resumes_train_and_test(tmp_path, synthetic_fixed, capsys):
    src = _save(synthetic_fixed["ckpt"], tmp_path / "checkpint.pth.tar")
    out = str(tmp_path / "imported")
    assert import_cli([src, "--config", CONFIG, "--out", out, "--device", "cpu"]) == 0
    assert "imported train checkpoint" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["best.pt", "last.pt"]

    cfg = load_config(CONFIG)
    cfg["training"].update(resume=out, epoch=8)
    runner = TrainRunner(cfg, log_root=str(tmp_path / "logs"), device="cpu")
    assert (runner.start_epoch, runner.best_dice, runner.best_miou) == (7, 80.25, 72.5)
    want, _ = jcompat.import_fixed_checkpoint(synthetic_fixed["ckpt"], jgs.senas, 3)
    assert_trees_equal(convert.state_dict_to_variables(runner.model), want)
    runner.run()
    assert runner.state.step == len(runner.train_queue)   # one epoch: the 8th

    assert eval_cli(["--config", CONFIG, "--device", "cpu", "--resume", out,
                     "--genotype", repr(tgs.senas), "--log_root", str(tmp_path)]) == 0
    assert "'dice'" in capsys.readouterr().out


def test_cli_search_checkpoint_resumes_the_search(tmp_path):
    s = load_config(CONFIG)["searching"]
    case = _search(s["init_channels"], s["depth"], s["meta_node_num"], 16,
                   s["sharing_normal"], seed=3)
    src = _save(case["ckpt"], tmp_path / "search.pth.tar")
    out = str(tmp_path / "imported")
    assert import_cli([src, "--config", CONFIG, "--out", out, "--device", "cpu"]) == 0
    cfg = load_config(CONFIG)
    cfg["searching"].update(resume=out, epoch=4)
    runner = SearchRunner(cfg, log_root=str(tmp_path / "logs"), device="cpu")
    assert (runner.start_epoch, runner.patience, runner.geno_type) == (3, 2, "genotype-string")
    for k, v in case["arch"].items():
        np.testing.assert_array_equal(runner.state.arch[k].detach().numpy(), v)
    want, _, _ = jcompat.import_search_checkpoint(case["ckpt"], s["depth"], s["meta_node_num"])
    assert_trees_equal(convert.state_dict_to_variables(runner.state.model), want)
    runner.run()
    assert runner.state.step == len(runner.train_queue)


def test_cli_rejects_what_it_cannot_import(tmp_path, fixed):
    src = _save(fixed["ckpt"], tmp_path / "c.pth.tar")
    args = [src, "--config", CONFIG, "--out", str(tmp_path / "o"), "--device", "cpu"]
    # a senas checkpoint read as a zoo model's (the zoo is ported since)
    with pytest.raises(SystemExit, match="--model unet: the checkpoint has no key"):
        import_cli(args + ["--model", "unet"])
    with pytest.raises(SystemExit, match="--model 'segformer'"):
        import_cli(args + ["--model", "segformer"])
    # the checkpoint's c 8 against a config of c 16
    wide = _config(tmp_path, training={"init_channels": 16})
    with pytest.raises(SystemExit, match="shape mismatch"):
        import_cli([src, "--config", wide, "--out", str(tmp_path / "o"), "--device", "cpu"])
    assert not os.path.exists(str(tmp_path / "o" / "last.pt"))


def test_check_structure_reports_missing_extra_and_shapes():
    template = {"params": {"a": np.zeros(3), "b": {"c": np.zeros((2, 2))}}}
    check_structure(template, {"params": {"a": np.ones(3), "b": {"c": np.ones((2, 2))}}}, "m")
    with pytest.raises(SystemExit, match=r"missing \['params/b/c'\]"):
        check_structure(template, {"params": {"a": np.ones(3)}}, "m")
    with pytest.raises(SystemExit, match=r"extra \['params/d'\]"):
        check_structure(template, {"params": {**template["params"], "d": np.ones(1)}}, "m")
    with pytest.raises(SystemExit, match="shape mismatch at params/a"):
        check_structure(template, {"params": {"a": np.ones(4), "b": {"c": np.ones((2, 2))}}},
                        "m")


def test_cli_needs_a_card_unless_told_otherwise(tmp_path, fixed):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = _save(fixed["ckpt"], tmp_path / "c.pth.tar")
    with pytest.raises(RuntimeError, match="cuda"):
        import_cli([src, "--config", CONFIG, "--out", str(tmp_path / "o")])
