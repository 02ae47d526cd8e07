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
GA_EXAMPLES = ("ga/tsp", "ga/nqueens", "ga/knn", "ga/evoknn",
               "ga/evoknn_jmlr", "ga/kursawefct", "es/__init__", "es/fctmin",
               "bbob")
LIB_EXAMPLES = ("ga.onemax_multidemic", "de.basic", "de.sphere", "de.dynamic",
                "pso.basic", "pso.multiswarm", "eda.emna", "eda.pbil",
                "coev.coop_evol", "coev.hillis")
LIB_MODULES = ("creator", "tools", "ops.init", "ops.migration", "de", "pso",
               "eda", "coev", "utils.checkpoint", "utils.compilecache")
DIST_MODULES = ("parallel", "parallel.mapper", "parallel.multihost",
                "parallel.islands", "parallel.emo_sharded",
                "parallel.collectives", "parallel.launch",
                "ops.generation_sharded", "examples.ga.onemax_sharded",
                "examples.ga.onemax_island", "examples.ga.onemax_multihost")
OOC_MODULES = ("bigpop", "bigpop.slicedprng", "bigpop.host", "bigpop.engine",
               "bigpop.runner", "resilience", "resilience.retry",
               "resilience.faultinject", "resilience.runner")
SERVE_MODULES = ("serve", "serve.buckets", "serve.cache", "serve.dispatcher",
                 "serve.metrics", "serve.rebucket", "serve.service",
                 "serve.cli", "serve.net", "serve.net.protocol",
                 "serve.net.httpcommon", "serve.net.server",
                 "serve.net.client", "observability", "observability.events",
                 "observability.sinks", "observability.fleettrace",
                 "observability.profiling", "sanitize",
                 "resilience.quarantine", "serve.top", "serve.router",
                 "serve.router.backend", "serve.router.cli",
                 "serve.router.core", "serve.router.health",
                 "serve.router.placement", "serve.router.server",
                 "serve.router.tenants")
PACKAGES = ("parallel", "bigpop", "resilience", "serve", "serve.net",
            "serve.router", "observability", "sanitize")


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
                "deap_tpu_torch/benchmarks/binary.py",
                "deap_tpu_torch/benchmarks/movingpeaks.py",
                *(f"deap_tpu_torch/examples/gp/{m}.py" for m in GP_EXAMPLES),
                *(f"deap_tpu_torch/examples/{m}.py" for m in GA_EXAMPLES),
                *("deap_tpu_torch/" + m.replace(".", "/") + ".py"
                  for m in LIB_MODULES),
                *("deap_tpu_torch/examples/" + m.replace(".", "/") + ".py"
                  for m in LIB_EXAMPLES),
                *("deap_tpu_torch/" + m.replace(".", "/")
                  + ("/__init__.py" if m in PACKAGES else ".py")
                  for m in DIST_MODULES + OOC_MODULES + SERVE_MODULES)):
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
            "deap_tpu_torch.ops.selection, "
            + ", ".join(f"deap_tpu_torch.{m}"
                        for m in LIB_MODULES + DIST_MODULES + OOC_MODULES
                        + SERVE_MODULES)
            + "; "
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
                        for m in GP_EXAMPLES) + ", "
            + ", ".join(f"deap_tpu_torch.examples.{m}"
                        for m in LIB_EXAMPLES) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deap_tpu', 'examples')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_library_modules_define_the_jax_names():
    """Each of the library modules ported last defines every name of its
    JAX counterpart's ``__all__`` (read from the source: no JAX import)."""
    for m in LIB_MODULES:
        if m == "tools":
            continue                      # no __all__: its own test
        jsrc = (ROOT / "deap_tpu" / (m.replace(".", "/") + ".py")).read_text()
        names = next(ast.literal_eval(node.value)
                     for node in ast.parse(jsrc).body
                     if isinstance(node, ast.Assign)
                     and getattr(node.targets[0], "id", "") == "__all__")
        tsrc = (ROOT / "deap_tpu_torch" / (m.replace(".", "/") + ".py")
                ).read_text()
        defined = {getattr(n, "name", None) for n in ast.parse(tsrc).body} | {
            t.id for n in ast.parse(tsrc).body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)}
        assert set(names) <= defined, (m, set(names) - defined)


def _all_of(path: Path) -> list:
    """The literal ``__all__`` of a source file (read, not imported)."""
    return next(ast.literal_eval(node.value)
                for node in ast.parse(path.read_text()).body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "__all__")


def test_out_of_core_packages_export_the_jax_names():
    """``bigpop`` exports its JAX counterpart's names, and ``resilience``
    (the part the streamed driver needs) only names of the JAX
    package's."""
    assert _all_of(ROOT / "deap_tpu_torch" / "bigpop" / "__init__.py") == \
        _all_of(ROOT / "deap_tpu" / "bigpop" / "__init__.py")
    assert set(_all_of(ROOT / "deap_tpu_torch" / "resilience"
                       / "__init__.py")) <= set(
        _all_of(ROOT / "deap_tpu" / "resilience" / "__init__.py"))


#: the JAX modules of serving, resilience, observability and the
#: sanitizer that the port does not have yet, and where they are queued
#: (ROADMAP.md queue 1): item 11b, the serving fleet; item 12, the tooling
DEFERRED_MODULES = {
    **{f"serve/autoscale/{m}.py": "11b" for m in (
        "__init__", "controller", "fabric", "migrate", "policy")},
    "serve/net/faultwire.py": "11b",
    "resilience/chaos.py": "11b", "resilience/chaosdrill.py": "11b",
    "resilience/faultdrill.py": "11b",
    "observability/cli.py": "12", "observability/metrics.py": "12",
    "observability/telemetry.py": "12", "observability/tracing.py": "12",
    "sanitize/guards.py": "12", "sanitize/runtime.py": "12",
    "sanitize/pytest_plugin.py": "12"}
#: names of a ported module's JAX ``__all__`` that come with a deferred
#: module (re-exported there, or XLA's half of the profiler)
DEFERRED_NAMES = {
    "resilience/__init__.py": {"ChaosLeg", "ChaosPlan", "ChaosFault",
                               "ChaosInjector", "canonical_plan"},
    "observability/__init__.py": {
        "MetricBuffer", "buffer_init", "cross_host_sum", "psum_counters",
        "Telemetry", "STANDARD_COUNTERS", "STANDARD_GAUGES", "Span", "span",
        "PhaseTimes", "aot_phase_times", "capture_trace",
        "device_memory_report", "aot_cost_summary", "phase_split"},
    "observability/profiling.py": {"aot_cost_summary", "phase_split",
                                   "NOMINAL_THROUGHPUT"},
    "sanitize/__init__.py": {"ThreadSanitizer", "TsanLock", "TsanRLock",
                             "TsanCondition", "TSAN_RULES", "runtime"}}
SERVING_DIRS = ("serve", "resilience", "observability", "sanitize")


def test_serving_modules_define_every_jax_name():
    """Every JAX module of ``serve/``, ``resilience/``, ``observability/``
    and ``sanitize/`` has its port counterpart or is listed deferred, and
    the counterpart defines every name of the JAX module's ``__all__``
    but the listed deferred ones (the port imported in a fresh
    interpreter: no JAX)."""
    jroot = ROOT / "deap_tpu"
    pairs = {}
    for d in SERVING_DIRS:
        for path in sorted((jroot / d).rglob("*.py")):
            rel = str(path.relative_to(jroot))
            port = ROOT / "deap_tpu_torch" / rel
            if rel in DEFERRED_MODULES:
                assert not port.exists(), f"{rel} is ported: unlist it"
                continue
            assert port.exists(), f"{rel}: no port counterpart"
            has_all = any(isinstance(n, ast.Assign) and getattr(
                n.targets[0], "id", "") == "__all__"
                for n in ast.parse(path.read_text()).body)
            if has_all:
                mod = "deap_tpu_torch." + rel[:-3].replace("/", ".") \
                    .removesuffix(".__init__")
                pairs[mod] = sorted(set(_all_of(path))
                                    - DEFERRED_NAMES.get(rel, set()))
    assert len(pairs) >= 18
    code = ("import importlib, json, sys; pairs = json.loads(sys.argv[1]); "
            "missing = {m: [n for n in names if not hasattr("
            "importlib.import_module(m), n)] for m, names in pairs.items()}; "
            "missing = {m: v for m, v in missing.items() if v}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deap_tpu')]; print(missing, bad); "
            "sys.exit(1 if missing or bad else 0)")
    import json
    out = subprocess.run([sys.executable, "-c", code, json.dumps(pairs)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
