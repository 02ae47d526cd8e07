"""Generation-engine registry — the single dispatch/rejection site for
``toolbox.generation_engine`` (the port's own copy of
``deap_tpu/engines.py``).  The contract:

* ``"xla"`` (alias ``"scan"``) — the traced select/vary generation; the
  default when the toolbox declares nothing.
* ``"megakernel"`` — the fused single-device generation
  (``deap_tpu_torch/ops/generation.py``, CUDA kernels on the card).
* ``"megakernel_sharded"`` — the mesh-sharded fused generation
  of the JAX package; requires the toolbox to declare
  ``generation_mesh``.  Not ported yet.  A toolbox that declares
  ``generation_engine="megakernel"`` *and* a ``generation_mesh``
  resolves here automatically.
* ``"streamed"`` — the host-driven out-of-core pipeline of the JAX
  package; incompatible with a declared mesh.  Not ported yet.

Rejections are typed: :class:`EngineError` subclasses ``ValueError``
and every message names ``toolbox.generation_engine``.  The two engines
that resolve but have no port yet raise :class:`EngineNotPorted` from
the loops (:func:`require_ported`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["EngineError", "EngineNotPorted", "EngineSpec", "ENGINES",
           "PORTED", "engine_names", "resolve_engine", "require_ported"]


class EngineError(ValueError):
    """Typed rejection for unknown engines or invalid engine/mesh combos.

    Subclasses ``ValueError`` so call sites (and tests) that predate the
    registry keep working; the message always contains the literal
    ``generation_engine`` so failures point at the toolbox knob.
    """


class EngineNotPorted(EngineError, NotImplementedError):
    """The engine resolves, but this port does not implement it yet."""


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One generation engine: canonical name, aliases, mesh contract."""

    name: str
    aliases: Tuple[str, ...] = ()
    requires_mesh: bool = False   # toolbox.generation_mesh must be declared
    forbids_mesh: bool = False    # a declared mesh is a contradiction
    host_driven: bool = False     # cannot run under jit (host round-trips)
    doc: str = ""


ENGINES = {
    spec.name: spec
    for spec in (
        EngineSpec(
            name="xla", aliases=("scan",),
            doc="traced select/vary generation (the default)"),
        EngineSpec(
            name="megakernel",
            doc="fused single-device generation (ops/generation.py); "
                "promoted to megakernel_sharded when the toolbox "
                "declares a mesh"),
        EngineSpec(
            name="megakernel_sharded", requires_mesh=True,
            doc="mesh-sharded fused generation"),
        EngineSpec(
            name="streamed", forbids_mesh=True, host_driven=True,
            doc="host-driven out-of-core pipeline"),
    )
}

#: engines this port implements
PORTED = ("xla", "megakernel")

_ALIASES = {alias: spec.name
            for spec in ENGINES.values() for alias in spec.aliases}


def engine_names() -> Tuple[str, ...]:
    """Canonical engine names, stable order (for error messages/docs)."""
    return tuple(ENGINES)


def resolve_engine(toolbox) -> str:
    """Resolve ``toolbox.generation_engine`` to a canonical engine name.

    The ONE place engine strings are validated: unknown names and
    invalid engine/mesh combinations raise :class:`EngineError` here,
    never at the individual call sites.  Returns the canonical name
    (aliases folded, ``megakernel`` + declared mesh promoted to
    ``megakernel_sharded``).
    """
    engine = getattr(toolbox, "generation_engine", "xla")
    name = _ALIASES.get(engine, engine)
    spec = ENGINES.get(name)
    if spec is None:
        known = ", ".join(
            repr(s.name) if not s.aliases else
            f"{s.name!r} (alias {', '.join(map(repr, s.aliases))})"
            for s in ENGINES.values())
        raise EngineError(
            f"unknown toolbox.generation_engine {engine!r}: expected one "
            f"of {known}")
    mesh = getattr(toolbox, "generation_mesh", None)
    if spec.name == "megakernel" and mesh is not None:
        spec = ENGINES["megakernel_sharded"]
    if spec.requires_mesh and mesh is None:
        raise EngineError(
            f"toolbox.generation_engine {spec.name!r} requires "
            "toolbox.generation_mesh (a device mesh with the population "
            "axis first); declare one or use 'megakernel'")
    if spec.forbids_mesh and mesh is not None:
        raise EngineError(
            f"toolbox.generation_engine {spec.name!r} is host-driven and "
            "cannot target a declared toolbox.generation_mesh: the "
            "streamed pipeline slices through host RAM, not a mesh "
            "program — drop generation_mesh or use 'megakernel_sharded'")
    return spec.name


def require_ported(name: str) -> str:
    """``name`` (a canonical engine) if this port implements it, else a
    typed :class:`EngineNotPorted`."""
    if name not in PORTED:
        raise EngineNotPorted(
            f"toolbox.generation_engine {name!r} is not ported to "
            f"deap_tpu_torch yet (ported: {', '.join(map(repr, PORTED))})")
    return name
