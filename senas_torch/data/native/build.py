"""Build the native curvature flow with g++:

    python -m senas_torch.data.native.build

The library lands in `senas_torch/_build/` (git-ignored), keyed by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one is reused. `senas_torch.data.native` calls `build()` at first use.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

from senas_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "augment_native.cpp"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"augment_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it is up to date; returns its path.
    Raises with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name} (rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
