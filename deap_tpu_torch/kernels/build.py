"""Build the port's CUDA kernels from the sources in the checkout.

One ``nvcc`` call compiles every file of :data:`SOURCES` (plain C
interfaces, no PyTorch headers: seconds, not minutes; the shared device
functions of :data:`HEADERS` are included) for ``sm_90a``
into one shared library under ``deap_tpu_torch/_build/``.  The library
is named by a hash of every source, header and flag, so an edited file is
rebuilt and an unchanged tree is reused.  Any failure raises
:class:`KernelBuildError` with the compiler's output; nothing falls back.

    python -m deap_tpu_torch.kernels.build      # build and print -Xptxas -v
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["KernelBuildError", "build", "digest", "SOURCES", "HEADERS",
           "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "megakernel.cu", _HERE / "dominance.cu",
           _HERE / "gp_interp.cu", _HERE / "hypervolume.cu",
           _HERE / "probes.cu")
#: included by the sources; part of the library's digest
HEADERS = (_HERE / "device_math.cuh",)
BUILD_DIR = _HERE.parent / "_build"
ARCH = "sm_90a"
#: --fmad=false: no multiply-add contraction beyond the explicit
#: __fmaf_rn calls, so the kernels equal their plain versions bitwise
NVCC_FLAGS = ("-O3", "-std=c++17", "--fmad=false",
              f"-gencode=arch=compute_{ARCH[3:]},code={ARCH}",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    home = CUDA_HOME or os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (CUDA_HOME={home!r}, not on PATH): the CUDA "
            "kernels are built on the machine with the card")
    return found


def digest(sources=SOURCES + HEADERS) -> str:
    """Hash of every source's and header's bytes and the flags: the
    library's name."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(verbose: bool = False) -> Path:
    """Compile :data:`SOURCES` into one library if it is not built yet
    and return its path."""
    lib = BUILD_DIR / f"libdeap_kernels-{digest()}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) on "
                               f"{', '.join(s.name for s in SOURCES)}:\n"
                               f"{proc.stdout}")
    if verbose:
        print(proc.stdout, file=sys.stderr)
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build(verbose=True))
