"""Fixtures of the benchmark's own tests: a copy of BENCHMARK.json whose
configurations are cut to a size the CPU steps in seconds (c 8, depth 3,
32x32, batch 2), with their counts recounted at that size and the limits
of the committed files."""

import copy
import json

import pytest
import torch

from perfbench.lib import cells, counts

TINY = dict(init_channels=8, depth=3, image_size=32, batch_size=2)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    bench = copy.deepcopy(cells.load_benchmark())
    tmp = tmp_path_factory.mktemp("tiny_configs")
    for entry in bench["configs"]:
        cfg = dict(cells.load_config(bench, entry["name"]), **TINY)
        cfg["counts"] = counts.counts(cells.load_reference(entry["name"]), cfg)
        path = tmp / f"{entry['name']}.json"
        path.write_text(json.dumps(cfg))
        entry["file"] = str(path)
    return bench
