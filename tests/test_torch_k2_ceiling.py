"""tools/k2_ceiling.py on the CPU: every ablation's text patch, of the f32
kernel and of the bf16 one, applies to the committed K2 source exactly
once (so the tool measures the kernel as it is), and the tool refuses to
run without a CUDA device in either mode."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "k2_ceiling", os.path.join(ROOT, "tools", "k2_ceiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("table", ["ABLATIONS", "ABLATIONS_BF16"])
def test_every_ablation_patches_the_kernel_once(tool, table):
    source = tool.SOURCE.read_text()
    for name, patches in getattr(tool, table).items():
        text = tool.patched(patches)
        assert (text == source) == (not patches), name
        for old, new in patches:
            assert source.count(old) == 1, (name, old[:60])


def test_a_missing_anchor_raises(tool, monkeypatch):
    monkeypatch.setitem(tool.ABLATIONS, "bad", [("no such line in the kernel", "")])
    with pytest.raises(RuntimeError, match="anchor"):
        tool.patched(tool.ABLATIONS["bad"])


@pytest.mark.parametrize("argv", [[], ["--bf16"]])
def test_needs_a_card(tool, capsys, argv):
    assert tool.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
