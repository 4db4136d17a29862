"""The port's SearchRunner and CLI on configs/senas/senas_synthetic.yml, on
the CPU: the epochs run (alpha_begin 1, so both step kinds), a checkpoint
is written each epoch, a resumed run carries the epoch count, patience and
genotype over and runs only the epochs left, and the genotype parses."""

import copy
import json
import os

import pytest
import torch

from senas_torch.core.config import load_config
from senas_torch.core.genotype import parse_genotype
from senas_torch.runner.search import SearchRunner
from senas_torch.search_arc import main as search_main

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    log_root = tmp_path_factory.mktemp("logs")
    cfg = load_config(CONFIG)
    runner = SearchRunner(copy.deepcopy(cfg), config_path=CONFIG, log_root=str(log_root),
                          device="cpu")
    arch0 = {k: v.detach().clone() for k, v in runner.state.arch.items()}
    best = runner.run()
    return dict(cfg=cfg, runner=runner, best=best, arch0=arch0, log_root=log_root)


def _scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_epochs_run_and_checkpoint_is_written(first_run):
    runner, cfg = first_run["runner"], first_run["cfg"]
    epochs = cfg["searching"]["epoch"]
    assert runner.ckpt.exists("last")
    steps_per_epoch = len(runner.train_queue)
    assert runner.state.step == epochs * steps_per_epoch > 0
    rows = _scalars(runner.run_dir)
    assert sorted({r["step"] for r in rows if r["tag"] == "Val/dice"}) == list(range(epochs))
    assert all(r["value"] == r["value"] for r in rows)   # no NaN
    assert os.path.exists(os.path.join(runner.run_dir, "all_scalars.json"))
    assert os.path.exists(os.path.join(runner.run_dir, "senas_synthetic.yml"))
    # arch steps ran (alpha_begin 1 < epochs): the tables moved
    assert any(not torch.equal(v, first_run["arch0"][k]) for k, v in runner.state.arch.items())


def test_genotype_parses(first_run):
    g = parse_genotype(first_run["best"])
    assert repr(g) == first_run["best"]
    assert len(g.down) == 2 * first_run["cfg"]["searching"]["meta_node_num"]


def test_resume_continues(first_run, tmp_path):
    cfg = copy.deepcopy(first_run["cfg"])
    done = cfg["searching"]["epoch"]
    cfg["searching"]["epoch"] = done + 1
    cfg["searching"]["resume"] = first_run["runner"].ckpt.directory
    runner = SearchRunner(cfg, log_root=str(tmp_path), device="cpu")
    assert runner.start_epoch == done
    assert runner.geno_type == first_run["runner"].geno_type
    assert runner.state.step == first_run["runner"].state.step
    for k, v in runner.state.arch.items():
        torch.testing.assert_close(v, first_run["runner"].state.arch[k], rtol=0, atol=0)
    runner.run()
    assert runner.state.step == first_run["runner"].state.step + len(runner.train_queue)
    assert [r["step"] for r in _scalars(runner.run_dir) if r["tag"] == "Val/dice"] == [done]


def test_cli_runs_one_epoch(tmp_path, capsys):
    assert search_main(["--config", CONFIG, "--device", "cpu", "--epoch", "1",
                        "--log_root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "best genotype: Genotype(" in out
    parse_genotype(out.split("best genotype: ")[1].strip())


def test_cli_defaults_stay_in_the_checkout():
    from senas_torch import search_arc
    from senas_torch.runner.common import DEFAULT_LOG_ROOT
    assert DEFAULT_LOG_ROOT == os.path.join(ROOT, "logs")
    assert search_arc.DEFAULT_CONFIG == os.path.join(ROOT, "configs", "senas",
                                                     "senas_promise12.yml")
    assert os.path.exists(search_arc.DEFAULT_CONFIG)


def _log(run_dir):
    with open(os.path.join(run_dir, "run.log")) as f:
        return f.read()


@pytest.mark.parametrize("mesh_spatial", [1, 2])
def test_multi_gpus_on_one_device_runs_there(tmp_path, mesh_spatial):
    """multi_gpus with one visible device (the CPU counts as one) runs on
    it and logs the JAX runner's line; mesh_spatial is not read."""
    cfg = load_config(CONFIG)
    cfg["searching"].update(multi_gpus=True, mesh_spatial=mesh_spatial, epoch=1)
    runner = SearchRunner(cfg, log_root=str(tmp_path), device="cpu")
    runner.run()
    assert runner.state.step == len(runner.train_queue) > 0
    assert "multi_gpus requested but only 1 device visible" in _log(runner.run_dir)


def test_multi_gpus_over_two_devices_raises(tmp_path, monkeypatch):
    from senas_torch.runner import common
    monkeypatch.setattr(common, "visible_devices", lambda device: 2)
    cfg = load_config(CONFIG)
    cfg["searching"].update(multi_gpus=True)
    with pytest.raises(NotImplementedError, match="M13"):
        SearchRunner(cfg, log_root=str(tmp_path), device="cpu")


def test_remat_search_runs(tmp_path):
    """searching.remat builds the supernet with its cells recomputed in the
    backward; an epoch runs and the arch tables move."""
    cfg = load_config(CONFIG)
    cfg["searching"].update(remat=True, epoch=2)
    runner = SearchRunner(cfg, log_root=str(tmp_path), device="cpu")
    assert runner.state.model.remat and runner.state.model.head.remat
    arch0 = {k: v.clone() for k, v in runner.state.arch.items()}
    parse_genotype(runner.run())
    assert any(not torch.equal(v, arch0[k]) for k, v in runner.state.arch.items())


def test_bf16_precision_computes_in_bf16_with_f32_masters(tmp_path):
    """`precision: bf16` builds the supernet in bf16: bf16 logits, f32
    weights, running stats and arch tables, and an f32 checkpoint."""
    cfg = load_config(CONFIG)
    cfg["searching"].update(precision="bf16", epoch=1)
    runner = SearchRunner(cfg, log_root=str(tmp_path), device="cpu")
    assert runner.dtype == torch.bfloat16
    from senas_torch.search.supernet import normalize_arch
    with torch.no_grad():
        out = runner.state.model(torch.zeros(1, 64, 64, 1),
                                 normalize_arch(runner.state.arch, runner.meta_node_num))
    assert out[0].dtype == torch.bfloat16
    runner.run()
    payload = runner.ckpt.restore_raw("last")
    for tensors in (payload["model"], payload["arch"], dict(runner.state.model.named_parameters())):
        assert all(v.dtype == torch.float32 for v in tensors.values() if v.is_floating_point())


@pytest.mark.parametrize("precision", ["fp16", "float16"])
def test_unknown_precision_raises(tmp_path, precision):
    cfg = load_config(CONFIG)
    cfg["searching"]["precision"] = precision
    with pytest.raises(ValueError, match="precision"):
        SearchRunner(cfg, log_root=str(tmp_path), device="cpu")


def test_real_datasets_wait_for_their_data(tmp_path):
    """Every dataset of the shipped configs is ported
    (tests/test_torch_promise12.py, tests/test_torch_m9b_loaders.py) and
    needs its data root; the JAX package's generic loaders (JPEG, Pillow's
    resampling) are not ported."""
    cfg = load_config(CONFIG)
    cfg["data"]["dataset"] = "ade20k"
    with pytest.raises(NotImplementedError, match="not ported yet.*JPEG"):
        SearchRunner(cfg, log_root=str(tmp_path), device="cpu")
    for name in ("promise12", "chaos", "heart", "monusac"):
        cfg["data"]["dataset"] = name
        with pytest.raises(ValueError, match="data_root"):
            SearchRunner(cfg, log_root=str(tmp_path), device="cpu")


def test_loop_shares_count_the_timed_steps(first_run):
    """The loader shares are taken over the steps that steps_per_sec counts
    (the second half), so a slow first step does not weigh in them; each
    PrefetchLoader batch records its own wait."""
    from senas_torch.data import DataLoader, PrefetchLoader, get_dataset
    from senas_torch.utils.misc import steady, steady_share

    assert steady([9.0, 1.0, 2.0, 3.0, 4.0]) == [2.0, 3.0, 4.0]
    assert steady([7.0]) == [7.0]
    assert steady_share([8.0, 0.5, 0.5, 0.5], [10.0, 1.0, 2.0, 2.0]) == pytest.approx(0.25)
    assert steady_share([], []) == 0.0
    loader = PrefetchLoader(DataLoader(get_dataset("synthetic", size=6), 2, workers=0))
    assert len(list(loader)) == len(loader.waits) == 3
    assert all(w >= 0 for w in loader.waits)
    scalars = {r["tag"]: r["value"] for r in _scalars(first_run["runner"].run_dir)}
    assert 0 <= scalars["Train/prefetch_wait_share"] <= 1
    assert 0 <= scalars["Train/val_fetch_share"] <= 1
