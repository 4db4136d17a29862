"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each `senas_torch/csrc/<name>.cu` has a plain `extern "C"` interface and no
PyTorch headers, so `nvcc` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o senas_torch/_build/<name>-<hash>.so <name>.cu

The library lands in `senas_torch/_build/` (git-ignored), keyed by a hash of
the source, the headers of csrc/ (`*.cuh`) and the flags, so an edited
source or header rebuilds and an unchanged one loads at once. `build()` starts one nvcc per source, all together. Nothing
here runs at import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from the toolkit `torch.utils.cpp_extension`
    finds (CUDA_HOME, CUDA_PATH, or the toolkit's default install)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library of `<name>.cu`, keyed by the source, every header of
    csrc/ (one a source includes edits the library) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, started together. Returns seconds per source built
    (0.0 for a cached one). Raises with nvcc's output on failure; the
    compiler's log (registers, spills) is kept beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and load it (once per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
