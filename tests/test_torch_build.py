"""senas_torch.ops._build on the CPU: the library's key follows the source,
every header of csrc/ and the nvcc flags, so an edited header rebuilds.
Nothing here runs nvcc."""

from senas_torch.ops import _build


def test_library_key_follows_source_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-")

    (tmp_path / "k.cuh").write_text("// v2\n")
    header = _build.library_path("k")
    assert header != first

    (tmp_path / "other.cuh").write_text("// new\n")
    added = _build.library_path("k")
    assert added != header

    (tmp_path / "k.cu").write_text('#include "k.cuh"\n// edited\n')
    source = _build.library_path("k")
    assert source != added

    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_path("k") != source
