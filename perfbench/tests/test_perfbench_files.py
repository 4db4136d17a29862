"""BENCHMARK.json and the files it names: each cell's configuration,
reference, traffic and metric readers are found by name, a file added to a
copy is found too, and the file keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from perfbench.lib import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = cells.find_cell(BENCH, cell)
    cfg = cells.load_config(BENCH, entry["config"])
    traffic = cells.load_traffic(entry["traffic"])
    ref = cells.load_reference(entry["config"])
    program = cells.load_program(entry["config"])
    assert cfg["name"] == entry["config"] and traffic["kind"]
    assert all(hasattr(ref, f) for f in ("build", "forward", "loss"))
    assert hasattr(program, "set_precision") and cells.load_loop(traffic["kind"]).drive
    # what the cell's loop calls of the program
    wants = (("build_predict",) if traffic["kind"] == "serve_closed" else
             ("BATCHES_PER_STEP", "arch_shapes", "batch_placer", "build_step", "losses",
              "flops_per_step", "first_gradients", "state_change"))
    assert all(hasattr(program, f) for f in wants)
    e2e = cells.end_to_end(BENCH, cell)
    layers = cells.per_layer(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layers
    assert all(m["moves"] in names for m in layers)
    assert set(cells.readers(e2e + layers)) == names | {m["name"] for m in layers}


def test_entries_keep_to_the_contract():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/") and c["source"].startswith("https://")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert all(c in CELLS for c in m.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_file_added_to_a_copy_is_found(tmp_path):
    """A later PR adds a cell as files and entries: a copy with a new
    traffic mix on a new loop, and a configuration with its reference,
    program and metric, finds them all."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench_dir = root / "perfbench"
    (bench_dir / "traffic" / "dummy-mix.json").write_text('{"kind": "dummy-loop", "pool": 3}')
    (bench_dir / "loops" / "dummy-loop.py").write_text(
        "def drive(run, device, hook=None):\n    return 'driven'\n")
    cfg = json.loads((bench_dir / "configs" / "senas-fixed-promise12.json").read_text())
    cfg["name"] = "dummy-config"
    (bench_dir / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    shutil.copy(bench_dir / "reference" / "senas-fixed-promise12.py",
                bench_dir / "reference" / "dummy-config.py")
    (bench_dir / "programs" / "dummy-config.py").write_text(
        "BATCHES_PER_STEP = 5\n\ndef set_precision(cfg):\n    pass\n")
    (bench_dir / "metrics" / "dummy_metric.train.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "dummy-config", "source": "https://example.org",
                             "file": "perfbench/configs/dummy-config.json", "reduced": [],
                             "why": "a dummy"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy_metric.train", "unit": "x", "better": "lower",
                               "source": "host_clock", "layer": "device",
                               "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = cells.load_benchmark(root)
    entry = cells.find_cell(loaded, "dummy-cell")
    assert cells.load_config(loaded, entry["config"], root)["name"] == "dummy-config"
    traffic = cells.load_traffic(entry["traffic"], bench_dir)
    assert traffic["pool"] == 3
    assert cells.load_loop(traffic["kind"], bench_dir).drive(None, None) == "driven"
    assert cells.load_reference("dummy-config", bench_dir).build
    assert cells.load_program("dummy-config", bench_dir).BATCHES_PER_STEP == 5
    layers = cells.per_layer(loaded, "dummy-cell")
    assert [m["name"] for m in layers] == ["dummy_metric.train"]
    assert cells.readers(layers, bench_dir)["dummy_metric.train"](None) == 42.0
    # a metric without `workloads` reaches every cell reporting what it moves
    assert "dummy_metric.train" in {m["name"] for m in cells.per_layer(loaded, CELLS[0])}


def test_set_up_budget_fits():
    """A full check of 24 cells at run_seconds fits the driver's 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
