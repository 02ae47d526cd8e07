"""Build the native hypervolume shared library.

    python -m deap_tpu_torch.native.build

Compiles ``hv.cpp`` with the system C++ compiler into
``deap_tpu_torch/_build/libdeap_tpu_hv-<hash>.so``, named by a hash of
the source so that an edited source is rebuilt.  The policy is the
reference's for its one native component (an optional extension with a
pure-Python fallback): :func:`build` returns ``None`` when there is no
compiler or it fails, and :mod:`deap_tpu_torch.ops.hv` then answers with
its numpy WFG.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["build", "SRC", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "hv.cpp"
BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build() -> Path | None:
    """Compile the shared library if it is not built yet; return its
    path, or ``None`` when it cannot be built."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(_FLAGS).encode())
    lib = BUILD_DIR / f"libdeap_tpu_hv-{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run([cxx, *_FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    except (subprocess.CalledProcessError, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return lib


if __name__ == "__main__":
    path = build()
    if path is None:
        print("build failed (no C++ compiler found?)", file=sys.stderr)
        sys.exit(1)
    print(path)
