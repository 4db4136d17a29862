"""The long tail of the port against senas_tpu: the Kohonen SOM
(`senas_torch/som.py`), the genotype DOT text (`utils/visualize.py`),
`RunScore` (`train/metrics.py`), the rest of `utils/misc.py`,
`utils/logging.create_exp_dir`, and the two user tools
(`senas_torch.calc_mean_std`, `senas_torch.cell_visualize`) run in this
process beside tools/calc_mean_std.py and tools/cell_visualize.py.

Tolerances: the SOM's weights, quantization and topographic errors and
history within 1e-5 of senas_tpu's (50x3 data, a 5x5 grid, 10
iterations), its predictions equal; the DOT text, the scores, the one-hot
maps and the .dot files equal; the tools' means and stds within 1e-12."""

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import geno_searched as jgs
from senas_tpu.som import KohonenSOM as JSOM
from senas_tpu.train.metrics import RunScore as JRunScore
from senas_tpu.utils import logging as jlogging
from senas_tpu.utils import misc as jmisc
from senas_tpu.utils import visualize as jvis
from senas_torch import calc_mean_std, cell_visualize
from senas_torch.core.genotype import Genotype
from senas_torch.models.senas_model import SenasModel
from senas_torch.som import KohonenSOM
from senas_torch.train.metrics import RunScore
from senas_torch.utils import legacy_blocks as tl
from senas_torch.utils import logging as tlogging
from senas_torch.utils import misc as tmisc
from senas_torch.utils import visualize as tvis

from torch_port_util import random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOM_TOL = 1e-5


# ---------------------------------------------------------------------------
# Kohonen SOM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soms():
    data = np.random.RandomState(0).rand(50, 3)
    j = JSOM(5, 5, n_iterations=10, random_state=3).fit(data, record_history=True)
    t = KohonenSOM(5, 5, n_iterations=10, random_state=3, device="cpu").fit(
        data, record_history=True)
    return data, j, t


def test_som_matches_senas_tpu(soms):
    data, j, t = soms
    assert t.weights.dtype == np.float64 and t.weights.shape == (5, 5, 3)
    np.testing.assert_allclose(t.weights, j.weights, rtol=0, atol=SOM_TOL)
    np.testing.assert_array_equal(t.predict(data), j.predict(data))
    assert abs(t.quantization_error(data) - j.quantization_error(data)) <= SOM_TOL
    assert abs(t.topographic_error(data) - j.topographic_error(data)) <= SOM_TOL
    assert len(t.quantization_error_history_) == 10
    np.testing.assert_allclose(t.quantization_error_history_, j.quantization_error_history_,
                               rtol=0, atol=SOM_TOL)
    assert t._best_matching_unit(data[4]) == j._best_matching_unit(data[4])
    # no history unless asked for
    t2 = KohonenSOM(5, 5, n_iterations=2, random_state=3, device="cpu").fit(data)
    assert t2.quantization_error_history_ == []


def test_som_errors_and_save_load(soms, tmp_path):
    data, j, t = soms
    for cls in (JSOM, KohonenSOM):
        with pytest.raises(ValueError):
            cls(0, 3)
        with pytest.raises(ValueError):
            cls(3, 3, n_iterations=0)
        with pytest.raises(RuntimeError):
            cls(3, 3).predict(data)
    with pytest.raises(ValueError):
        KohonenSOM(3, 3, device="cpu").fit(np.zeros(5))
    with pytest.raises(ValueError):
        KohonenSOM(3, 3, device="cpu").fit(np.zeros((0, 3)))
    for cls in (JSOM, KohonenSOM):
        som = cls(3, 3)
        assert som.time_constant == JSOM(3, 3).time_constant
        assert JSOM(1, 1).time_constant == KohonenSOM(1, 1).time_constant == 100.0
    t.save(str(tmp_path / "w"))
    for path in (tmp_path / "w", tmp_path / "w.npy"):
        loaded = KohonenSOM(5, 5).load(str(path))
        np.testing.assert_array_equal(loaded.weights, t.weights)
        np.testing.assert_array_equal(loaded.predict(data), t.predict(data))
    # the JAX package reads the port's file and the port reads its own
    np.testing.assert_array_equal(JSOM(5, 5).load(str(tmp_path / "w")).weights, t.weights)


def test_som_device_defaults_to_the_card():
    som = KohonenSOM(2, 2, n_iterations=1)
    assert som.device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            som.fit(np.random.RandomState(1).rand(4, 2))


# ---------------------------------------------------------------------------
# Genotype visualisation
# ---------------------------------------------------------------------------

GENOTYPES = sorted(k for k, v in vars(jgs).items() if isinstance(v, tuple)
                   and type(v).__name__ == "Genotype")


@pytest.mark.parametrize("name", GENOTYPES)
def test_genotype_dot_text_is_equal(name):
    g = getattr(jgs, name)
    for gene in (g.down, g.up):
        assert tvis.genotype_to_dot(gene) == jvis.genotype_to_dot(gene)


def test_plot_writes_the_same_dot_file(tmp_path):
    gene = jgs.senas_node_4.down
    jp = jvis.plot(gene, "cell", directory=str(tmp_path / "jax"))
    tp = tvis.plot(gene, "cell", directory=str(tmp_path / "port"))
    for d in ("jax", "port"):
        assert os.path.exists(tmp_path / d / "cell.dot")
    assert (tmp_path / "jax" / "cell.dot").read_bytes() == (
        tmp_path / "port" / "cell.dot").read_bytes()
    assert os.path.basename(jp) == os.path.basename(tp)


# ---------------------------------------------------------------------------
# RunScore
# ---------------------------------------------------------------------------

def _labels(seed, n):
    rng = np.random.RandomState(seed)
    trues = rng.randint(-1, n + 2, (3, 9, 7))       # -1 and >= n are left out
    preds = rng.randint(0, n, (3, 9, 7))
    return trues, preds


def _assert_scores_equal(got, want):
    (gs, giu), (ws, wiu) = got, want
    assert list(gs) == list(ws) == ["Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU "]
    for k in ws:
        np.testing.assert_array_equal(np.float64(gs[k]), np.float64(ws[k]), err_msg=k)
        assert np.asarray(gs[k]).dtype == np.float64
    assert giu.keys() == wiu.keys()
    np.testing.assert_array_equal(np.array(list(giu.values())), np.array(list(wiu.values())))


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor"])
def test_runscore_matches_senas_tpu(kind):
    n = 5
    j, t = JRunScore(n), RunScore(n)
    for seed in (0, 1):
        trues, preds = _labels(seed, n)
        j.update(trues, preds)
        if kind == "cpu_tensor":
            t.update(torch.from_numpy(trues), torch.from_numpy(preds))
        else:
            t.update(trues, preds)
    np.testing.assert_array_equal(t.confusion_matrix, j.confusion_matrix)
    assert t.confusion_matrix.dtype == np.float64
    _assert_scores_equal(t.get_scores(), j.get_scores())
    # a class that never occurs: NaN entries as in senas_tpu
    j2, t2 = JRunScore(7), RunScore(7)
    trues, preds = _labels(2, 5)
    j2.update(trues, preds)
    t2.update(trues, preds)
    _assert_scores_equal(t2.get_scores(), j2.get_scores())
    t.reset()
    assert not t.confusion_matrix.any()


# ---------------------------------------------------------------------------
# misc and logging
# ---------------------------------------------------------------------------

def test_one_hot_encoding_is_equal():
    labels = np.random.RandomState(3).randint(0, 4, (2, 5, 6))
    got, want = tmisc.one_hot_encoding(labels, 4), jmisc.one_hot_encoding(labels, 4)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_gpus_memory_info_without_a_card():
    if torch.cuda.is_available():
        best, stats = tmisc.get_gpus_memory_info()
        assert set(stats[best]) == {"bytes_limit", "bytes_in_use", "peak_bytes_in_use"}
    else:
        # senas_tpu's answer on its CPU backend: device 0, no memory stats
        # (one entry a host device, of which the tests' JAX has several)
        best, stats = jmisc.get_gpus_memory_info()
        assert best == 0 and stats[0] == {} and all(s == {} for s in stats.values())
        assert tmisc.get_gpus_memory_info() == (0, {0: {}})


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def test_device_memory_log_lines():
    keep_t = torch.zeros(123, 7)          # noqa: F841 (alive while the log walks)
    keep_j = jnp.zeros((123, 7))          # noqa: F841
    got, want = _Lines(), _Lines()
    stats = tmisc.device_memory_log(got, device="cpu")
    jmisc.device_memory_log(want)
    assert stats == {0: {}}
    assert got.lines[0] == want.lines[0] == "device 0: in_use=0.0MiB limit=0.0MiB peak=0.0MiB"
    head = re.compile(r"^live arrays: \d+ \(\d+\.\dMiB\)$")
    row = re.compile(r"^ +\d+ x [a-z0-9]+\[[0-9, ]*\] = \d+\.\d\dMiB$")
    for lines in (got.lines, want.lines):
        i = next(i for i, line in enumerate(lines) if not line.startswith("device "))
        assert head.match(lines[i]), lines[i]
        assert all(row.match(line) for line in lines[i + 1:])
    assert len(got.lines) <= 2 + 20                     # top_k rows at most
    every = _Lines()
    tmisc.device_memory_log(every, top_k=10 ** 6, device="cpu")
    assert any(x.endswith(" x float32[123, 7] = 0.00MiB") for x in every.lines), every.lines[:5]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmisc.device_memory_log(every)


def test_device_memory_log_skips_symbolic_shapes():
    """A `torch.export` program keeps fake tensors of symbolic shape alive
    (the serving path makes them); the walk leaves them out instead of
    failing on their unhashable shapes."""
    class Double(torch.nn.Module):
        def forward(self, x):
            return x * 2

    program = torch.export.export(Double(), (torch.zeros(3, 4),),  # noqa: F841 (kept alive)
                                  dynamic_shapes=({0: torch.export.Dim("b")},))
    lines = _Lines()
    tmisc.device_memory_log(lines, device="cpu")
    assert lines.lines[1].startswith("live arrays: ")


def test_flops_params_info():
    """params_m equals senas_tpu's count of the same model's params. The
    flops are FlopCounterMode's: 2 a multiply-add of every convolution
    window, its zero padding included, and nothing else; XLA's cost
    analysis counts the taps inside the input only and one flop an element
    of each elementwise op."""
    from senas_tpu.models.senas_model import SenasModel as JModel
    from senas_tpu.models import geno_searched
    from senas_torch import convert
    x = np.random.RandomState(0).randn(1, 16, 16, 1).astype(np.float32)
    jm = JModel(nclass=2, in_channels=1, c=4, depth=2, genotype=geno_searched.senas_node_4)
    v = random_variables(jm, np.random.RandomState(1), jnp.asarray(x), False)
    tm = convert.load_variables(SenasModel(2, 1, c=4, depth=2,
                                           genotype=geno_searched.senas_node_4, device="cpu"), v)
    got = tmisc.flops_params_info(tm.eval(), torch.from_numpy(x))   # NHWC, as SenasModel takes
    want = jmisc.flops_params_info(jm.apply, v, jnp.asarray(x))
    assert got["params_m"] == pytest.approx(want["params_m"], rel=1e-12)
    assert got["flops"] > 0 and want["flops"] > 0
    # one padded 3x3 convolution of 3 -> 8 channels on 10x10 with a bias:
    # 2 * 8 * 3 * 9 * 100 here; XLA: 2 * 8 * 3 * 784 taps inside + 800 adds
    conv = tl.ConvNorm(3, 8, 3, padding=1, norm=None)
    info = tmisc.flops_params_info(conv, torch.zeros(1, 3, 10, 10))
    assert info == {"flops": 43200.0, "params_m": (8 * 3 * 9 + 8) / 1e6}
    from senas_tpu.utils import legacy_blocks as jl
    jconv, xz = jl.ConvNorm(8, 3, padding=1, norm=None), jnp.zeros((1, 10, 10, 3))
    jv = random_variables(jconv, np.random.RandomState(2), xz, False)
    assert jmisc.flops_params_info(jconv.apply, jv, xz) == {
        "flops": 2 * 8 * 3 * 28 * 28 + 800.0, "params_m": info["params_m"]}


def test_create_exp_dir(tmp_path, capsys):
    for mod, sub in ((jlogging, "jax"), (tlogging, "port")):
        path = str(tmp_path / sub / "a")
        assert mod.create_exp_dir(path) == path and os.path.isdir(path)
        assert mod.create_exp_dir(path, "dir {}") == path
    out = capsys.readouterr().out.splitlines()
    assert [line.replace("jax", "port") for line in out[:2]] == out[2:]


# ---------------------------------------------------------------------------
# The two user tools
# ---------------------------------------------------------------------------

def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv, module=None, argv0="tool"):
    """stdout of main(argv) (a JAX tool's main() reads sys.argv)."""
    out = io.StringIO()
    before = sys.argv
    try:
        sys.argv = [argv0] + argv
        with contextlib.redirect_stdout(out):
            main() if module is None else main(argv)
    finally:
        sys.argv = before
    return out.getvalue()


def _numbers(text, key):
    line = next(x for x in text.splitlines() if x.startswith(key))
    return np.array([float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", line)])


def test_calc_mean_std_matches_the_jax_tool(monkeypatch):
    """On the synthetic dataset: the same printed lines, and the unrounded
    numbers (both tools' `round` replaced by the identity) within 1e-12."""
    jtool = _tool("calc_mean_std")
    argv = ["--dataset", "synthetic", "--data-root", "unused", "--limit", "12"]
    want = _run(jtool.main, argv)
    got = _run(calc_mean_std.main, argv + ["--device", "cpu"], module=True)
    assert got == want
    monkeypatch.setattr(jtool, "round", lambda v, n: v, raising=False)
    monkeypatch.setattr(calc_mean_std, "round", lambda v, n: v, raising=False)
    want = _run(jtool.main, argv)
    got = _run(calc_mean_std.main, argv + ["--device", "cpu"], module=True)
    for key in ("mean", "std"):
        w, g = _numbers(want, key), _numbers(got, key)
        assert w.shape == g.shape == (1,)
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_calc_mean_std_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            calc_mean_std.main(["--dataset", "synthetic", "--limit", "1"])


def test_cell_visualize_writes_the_jax_tools_dot_files(tmp_path):
    jtool = _tool("cell_visualize")
    g = jgs.senas_node_4
    genotype_text = repr(Genotype(*g))
    for i, args in enumerate((["--geno-name", "senas_node_4"], ["--genotype", genotype_text])):
        jd, td = tmp_path / f"jax{i}", tmp_path / f"port{i}"
        _run(jtool.main, args + ["--directory", str(jd), "--format", "png"])
        out = _run(cell_visualize.main, args + ["--directory", str(td), "--format", "png"],
                   module=True)
        assert out.splitlines()[0].startswith("DownC: ")
        for tag in ("DownC", "UpC"):
            (jf,) = jd.glob(f"{tag}-*.dot")
            (tf,) = td.glob(f"{tag}-*.dot")
            assert tf.read_bytes() == jf.read_bytes()
