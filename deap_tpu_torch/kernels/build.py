"""Build the port's CUDA kernels from the sources in the checkout.

``nvcc`` compiles ``megakernel.cu`` (a plain C interface, no PyTorch
headers: seconds, not minutes) for ``sm_90a`` into a shared library under
``deap_tpu_torch/_build/``, named by a hash of the source and flags so an
edited source is rebuilt and an unchanged one is reused.  Any failure
raises :class:`KernelBuildError` with the compiler's output; nothing
falls back.

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

__all__ = ["KernelBuildError", "build", "SOURCE", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "megakernel.cu"
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


def build(verbose: bool = False) -> Path:
    """Compile ``megakernel.cu`` if its library is not built yet and
    return the shared library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libmegakernel-{digest}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}")
    if verbose:
        print(proc.stdout, file=sys.stderr)
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build(verbose=True))
