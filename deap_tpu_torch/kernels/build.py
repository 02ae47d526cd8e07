"""Build the port's CUDA kernels from the sources in the checkout.

One ``nvcc`` call a file of :data:`SOURCES` (plain C interfaces, no
PyTorch headers: seconds, not minutes; the shared device functions of
:data:`HEADERS` are included), all started together, compiles each for
``sm_90a`` to an object; one more call links the objects into one
shared library under ``deap_tpu_torch/_build/``.  The library
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _failed(returncode: int, names, output: str) -> KernelBuildError:
    return KernelBuildError(f"nvcc failed ({returncode}) on "
                            f"{', '.join(names)}:\n{output}")


def build(verbose: bool = False) -> Path:
    """Compile :data:`SOURCES` into one library if it is not built yet
    and return its path: one compiler process a source, all running at
    once, then the link."""
    lib = BUILD_DIR / f"libdeap_kernels-{digest()}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise _failed(p.returncode, [src.name], log)
        tmp = Path(work) / "lib.so"
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise _failed(proc.returncode, [o.name for o in objs],
                          proc.stdout)
        if verbose:
            print("".join(logs), file=sys.stderr)
        os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build(verbose=True))
