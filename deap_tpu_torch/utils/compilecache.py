"""Opt-in persistent cache of the port's built kernels.

The JAX package persists XLA's compiled executables across processes.
The port compiles nothing through XLA: its only compile step is the
build of the hand-written CUDA kernels (and of the native hypervolume
library), whose outputs are already named by a hash of every source,
header and flag (:func:`deap_tpu_torch.kernels.build.digest`).  Pointing
that build at a directory that outlives the checkout is the counterpart
of a persistent compile cache: a restart, or a second checkout of the
same sources, loads the library instead of running ``nvcc`` again.

    from deap_tpu_torch.utils.compilecache import enable_compile_cache
    enable_compile_cache("~/.cache/deap_tpu_torch_kernels")

Off by default (the libraries are built under ``deap_tpu_torch/_build``).
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Optional

__all__ = ["enable_compile_cache", "cache_dir_from_env", "ENV_VAR"]

#: Environment variable that names the cache directory (as in the JAX
#: package).
ENV_VAR = "DEAP_TPU_COMPILE_CACHE"


def cache_dir_from_env() -> Optional[str]:
    """The opt-in directory from ``DEAP_TPU_COMPILE_CACHE`` (None = off)."""
    path = os.environ.get(ENV_VAR, "").strip()
    return path or None


def enable_compile_cache(path, *, min_compile_time_secs: float = 0.0,
                         min_entry_size_bytes: int = 0) -> Optional[Path]:
    """Build and load the kernel libraries under ``path`` (created if
    missing) from now on, so they are reused across processes and
    checkouts.  Returns the resolved directory, or ``None`` with a
    warning when it cannot be created.

    ``min_compile_time_secs`` and ``min_entry_size_bytes`` are accepted
    for the JAX package's signature and have no meaning here: every
    library is cached whatever its build time or size."""
    del min_compile_time_secs, min_entry_size_bytes
    path = Path(path).expanduser().resolve()
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        warnings.warn(f"compile cache disabled: cannot create {path}: {e}")
        return None
    from ..kernels import build as kernel_build
    from ..native import build as native_build
    kernel_build.BUILD_DIR = path
    native_build.BUILD_DIR = path
    return path
