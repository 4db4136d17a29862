"""Build the native libraries of the data path with g++:

    python -m senas_torch.data.native.build

Two sources, one library each: `augment_native.cpp` (the curvature flow)
and `image_native.cpp` (JPEG decoding, Pillow's resampling passes). A
library lands in `senas_torch/_build/` (git-ignored), keyed by a hash of
its source and the flags, so an edited source rebuilds and an unchanged
one is reused. `senas_torch.data.native` calls `build(name)` at first use.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

from senas_torch.ops._build import BUILD_DIR

HERE = Path(__file__).resolve().parent
SOURCES = ("augment_native", "image_native")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def source(name: str = "augment_native") -> Path:
    return HERE / f"{name}.cpp"


def library_path(name: str = "augment_native") -> Path:
    digest = hashlib.sha256(source(name).read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str = "augment_native") -> Path:
    """Compile library `name` unless it is up to date; returns its path.
    Raises with g++'s output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = source(name)
    proc = subprocess.run(["g++", *FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name} (rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    for name in SOURCES:
        print(f"built {build(name)}")
    sys.exit(0)
