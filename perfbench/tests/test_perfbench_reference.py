"""The plain reference against senas_torch at a tiny size on the CPU, and
what each side imports."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.lib import cells
from perfbench.lib.batches import batches
from perfbench.lib.weights import draw_arch, draw_state

from conftest import TINY


def _cfg(name):
    return dict(cells.load_config(cells.load_benchmark(), name), **TINY)


@pytest.mark.parametrize("name", ["senas-search-promise12", "senas-fixed-promise12"])
def test_reference_matches_the_port(name):
    """The same drawn state loads into both; a train-mode forward, its loss
    and gradients, and an eval-mode forward agree to f32 rounding."""
    cfg = _cfg(name)
    ref = cells.load_reference(name)
    cpu = torch.device("cpu")
    model = ref.build(cfg)
    state = draw_state(model, 7, cpu)
    search = cfg["model"] == "SenasSearch"
    arch = (draw_arch(ref.arch_shapes(cfg["meta_node_num"], cfg["depth"],
                                      cfg["sharing_normal"]), 7, cpu) if search else None)
    st, _ = cells.load_program(name).build_step(cfg, state, arch, cpu)
    assert set(st.model.state_dict()) == set(state)
    model.load_state_dict(state)
    batch = batches(np.random.default_rng(3), 1, 2, cfg["image_size"], cfg["in_channels"])[0]
    image, label = torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"])

    def port(train):
        if search:
            from senas_torch.search.supernet import normalize_arch
            return st.model(image, normalize_arch(arch, cfg["meta_node_num"]), train=train)
        return st.model(image, train=train)

    for train in (True, False):
        torch.testing.assert_close(port(train)[-1], ref.forward(model, cfg, arch, image, train)[-1],
                                   rtol=1e-4, atol=1e-5)
    # the train-mode forward moved the running statistics alike
    for k, v in model.state_dict().items():
        torch.testing.assert_close(st.model.state_dict()[k], v, rtol=1e-5, atol=1e-6)
    from senas_torch.train.loss import build_loss
    port_loss = build_loss(cfg["loss"])(port(True), label)
    mine_loss = ref.loss(ref.forward(model, cfg, arch, image, True), label)
    torch.testing.assert_close(port_loss, mine_loss, rtol=1e-5, atol=1e-6)
    gp = torch.autograd.grad(port_loss, list(st.model.parameters()), allow_unused=True)
    gm = torch.autograd.grad(mine_loss, list(model.parameters()), allow_unused=True)
    for a, b in zip(gp, gm):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)


def _imported(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True, cwd=str(cells.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    loaded = _imported("import sys; sys.path.insert(0, '.')\n"
                       "from perfbench.lib import cells\n"
                       "for n in ('senas-search-promise12', 'senas-fixed-promise12'):\n"
                       "    cells.load_reference(n)\n"
                       "import perfbench.reference.training")
    assert not loaded & {"senas_torch", "senas_tpu", "jax", "jaxlib", "flax"}


def test_harness_loads_no_jax():
    """The harness's modules and the port's timed path, imported as a run
    imports them, load neither JAX nor the JAX package."""
    loaded = _imported("import sys; sys.path.insert(0, '.')\n"
                       "import perfbench.run, perfbench.calibrate, perfbench.lib.counts\n"
                       "from perfbench.lib import cells\n"
                       "for n in ('steps', 'serve_closed'):\n"
                       "    cells.load_loop(n)\n"
                       "for n in ('senas-search-promise12', 'senas-fixed-promise12'):\n"
                       "    cells.load_program(n)\n"
                       "import senas_torch.train.trainer, senas_torch.search.supernet\n"
                       "import senas_torch.models.senas_model, senas_torch.serve\n"
                       "import senas_torch.runner.common")
    assert "senas_torch" in loaded
    assert not loaded & {"senas_tpu", "jax", "jaxlib", "flax"}
