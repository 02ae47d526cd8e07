"""The port stands alone: no module of ``deap_tpu_torch`` (its
``examples/`` too) and not ``chip_smoke.py`` imports JAX, anything of the
JAX package or the repo's JAX ``examples/`` — checked on the source (AST)
and in a fresh interpreter."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "deap_tpu", "examples")
GP_EXAMPLES = ("symbreg", "symbreg_epsilon_lexicase", "symbreg_harm",
               "adf_symbreg", "ant", "multiplexer", "parity", "spambase")


def _port_files():
    return sorted((ROOT / "deap_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _forbidden_imports(source: str):
    """Absolute imports (at any depth of the module) whose top-level
    package is JAX, the JAX package or the repo's ``examples``;
    ``deap_tpu_torch`` (``deap_tpu_torch.examples`` too) is allowed."""
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
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert len(files) >= 15
    for new in ("deap_tpu_torch/ops/hv.py", "deap_tpu_torch/ops/hypervolume.py",
                "deap_tpu_torch/native/build.py", "deap_tpu_torch/native/hv.py",
                "deap_tpu_torch/benchmarks/tools.py", "chip_smoke.py",
                "deap_tpu_torch/probes/__init__.py",
                "deap_tpu_torch/probes/ga.py", "deap_tpu_torch/probes/gp.py",
                "deap_tpu_torch/kernels/peaks.py", "deap_tpu_torch/cma.py",
                "deap_tpu_torch/ops/indicator.py",
                "deap_tpu_torch/examples/__init__.py",
                "deap_tpu_torch/examples/ga/__init__.py",
                "deap_tpu_torch/examples/ga/evopole.py",
                "deap_tpu_torch/ops/constraint.py",
                "deap_tpu_torch/examples/ga/nsga2.py",
                "deap_tpu_torch/examples/ga/nsga3.py",
                "deap_tpu_torch/gp/harm.py", "deap_tpu_torch/gp/adf.py",
                "deap_tpu_torch/gp/routine.py",
                "deap_tpu_torch/benchmarks/gp.py",
                *(f"deap_tpu_torch/examples/gp/{m}.py" for m in GP_EXAMPLES)):
        assert new in files
    for cu in ("megakernel.cu", "dominance.cu", "gp_interp.cu",
               "hypervolume.cu", "probes.cu", "device_math.cuh"):
        assert (ROOT / "deap_tpu_torch" / "kernels" / cu).exists()
    assert (ROOT / "deap_tpu_torch" / "native" / "hv.cpp").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert _forbidden_imports(path.read_text()) == []


def test_scan_catches_a_forbidden_import():
    src = ("import deap_tpu_torch\nfrom deap_tpu.ops import x\n"
           "from . import y\ndef f():\n    import jax.numpy as jnp\n")
    assert _forbidden_imports(src) == ["2:deap_tpu.ops", "5:jax.numpy"]


def test_chip_smoke_imports_nothing_of_jax_when_loaded():
    """Importing ``chip_smoke`` as a module (its ``main`` not run) pulls
    in no JAX and nothing of the JAX package."""
    code = ("import sys; import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deap_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_native_source_is_the_ports_own_copy():
    """``native/hv.cpp`` is a copy inside the port, with the C ABI the
    binding expects; the port never loads the JAX package's library."""
    src = (ROOT / "deap_tpu_torch" / "native" / "hv.cpp").read_text()
    assert 'extern "C" double deap_tpu_hv(' in src
    for py in ("build.py", "hv.py"):
        text = (ROOT / "deap_tpu_torch" / "native" / py).read_text()
        assert "deap_tpu/native" not in text and "deap_tpu.native" not in text


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import deap_tpu_torch, deap_tpu_torch.algorithms, "
            "deap_tpu_torch.interop, deap_tpu_torch.kernels, "
            "deap_tpu_torch.kernels.build, deap_tpu_torch.ops.generation, "
            "deap_tpu_torch.ops.emo, deap_tpu_torch.ops.dominance, "
            "deap_tpu_torch.benchmarks, deap_tpu_torch.gp, "
            "deap_tpu_torch.gp.interp_cuda, deap_tpu_torch.gp.generate, "
            "deap_tpu_torch.gp.variation, deap_tpu_torch.gp.tree, "
            "deap_tpu_torch.ops.hv, deap_tpu_torch.ops.hypervolume, "
            "deap_tpu_torch.native.hv, deap_tpu_torch.native.build, "
            "deap_tpu_torch.benchmarks.tools, deap_tpu_torch.ops.crossover, "
            "deap_tpu_torch.ops.mutation, deap_tpu_torch.kernels.sass, "
            "deap_tpu_torch.kernels.peaks, "
            "deap_tpu_torch.probes, deap_tpu_torch.probes.ga, "
            "deap_tpu_torch.probes.gp, deap_tpu_torch.ops.constraint, "
            "deap_tpu_torch.ops.indicator, deap_tpu_torch.random, "
            "deap_tpu_torch.gp.harm, deap_tpu_torch.gp.adf, "
            "deap_tpu_torch.gp.routine, deap_tpu_torch.benchmarks.gp, "
            "deap_tpu_torch.ops.selection; "
            "deap_tpu_torch.base.Toolbox().hypervolume; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deap_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_scan_catches_an_import_of_the_jax_examples():
    src = ("from examples.ga import evopole\n"
           "from deap_tpu_torch.examples.ga import evopole as ok\n")
    assert _forbidden_imports(src) == ["1:examples.ga"]


def test_port_examples_load_no_jax():
    """The port's examples (each keeps its own copy of
    the JAX example's constants and functions) pull in no JAX, nothing
    of the JAX package and nothing of the repo's ``examples``."""
    code = ("import sys; import deap_tpu_torch.examples.ga.evopole, "
            "deap_tpu_torch.examples.ga.nsga2, "
            "deap_tpu_torch.examples.ga.nsga3, "
            + ", ".join(f"deap_tpu_torch.examples.gp.{m}"
                        for m in GP_EXAMPLES) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deap_tpu', 'examples')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
