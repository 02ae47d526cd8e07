"""The port stands alone: no module of ``deap_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package — checked on
the source (AST) and in a fresh interpreter."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "deap_tpu")


def _port_files():
    return sorted((ROOT / "deap_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _forbidden_imports(source: str):
    """Absolute imports (at any depth of the module) whose top-level
    package is JAX or the JAX package; ``deap_tpu_torch`` is allowed."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [f"{node.lineno}:{n}" for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_sources_exist():
    assert len(_port_files()) >= 15
    assert (ROOT / "deap_tpu_torch" / "kernels" / "megakernel.cu").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert _forbidden_imports(path.read_text()) == []


def test_scan_catches_a_forbidden_import():
    src = ("import deap_tpu_torch\nfrom deap_tpu.ops import x\n"
           "from . import y\ndef f():\n    import jax.numpy as jnp\n")
    assert _forbidden_imports(src) == ["2:deap_tpu.ops", "5:jax.numpy"]


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import deap_tpu_torch, deap_tpu_torch.algorithms, "
            "deap_tpu_torch.interop, deap_tpu_torch.kernels, "
            "deap_tpu_torch.kernels.build, deap_tpu_torch.ops.generation; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deap_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
