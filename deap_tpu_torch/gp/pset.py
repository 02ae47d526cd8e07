"""Primitive sets compiled to static tables — the PyTorch counterpart of
``deap_tpu/gp/pset.py``.

A primitive set registers primitives, terminals, ephemeral constants and
arguments; :meth:`PrimitiveSetTyped.freeze` compiles it into the tables
the interpreter, the generators and the variation operators read: one
integer code per node (primitives, then terminals, ephemerals and
arguments), arity / return-type / argument-type arrays, per-type
candidate lists, the terminal ratio and the per-code constant samplers.

Trees are triples ``(codes, consts, lengths)`` of fixed-capacity prefix
arrays, as in the JAX package.  Beside the JAX package's tables, a
frozen set carries the **op-kind table** of the CUDA interpreter (K6):
the opcode of each node, or ``-1`` for a primitive whose function has no
kernel form (:data:`deap_tpu_torch.gp.interp_cuda.OPCODES`).

Ephemeral samplers take a batch of keys ``(n, w)`` and return ``(n,)``
values — the port's stand-in for ``jax.vmap`` over the JAX package's
one-key samplers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["Primitive", "Terminal", "Ephemeral", "Argument",
           "PrimitiveSetTyped", "PrimitiveSet", "FrozenPSet", "freeze_pset"]


def freeze_pset(pset):
    """Coerce a (possibly already frozen) primitive set to a FrozenPSet."""
    return pset.freeze() if isinstance(pset, PrimitiveSetTyped) else pset


@dataclasses.dataclass
class Primitive:
    """An operator node: ``func`` takes ``arity`` ``(pop, n_points)``
    tensors and returns one."""
    name: str
    arity: int
    func: Callable
    ret_type: int
    in_types: tuple
    fmt: str | None = None               # e.g. "({0} + {1})"

    def format(self, *args):
        if self.fmt is not None:
            return self.fmt.format(*args)
        return f"{self.name}({', '.join(args)})"


@dataclasses.dataclass
class Terminal:
    """A constant-valued leaf."""
    name: str
    value: float
    ret_type: int

    def format(self):
        return self.name


@dataclasses.dataclass
class Ephemeral:
    """A random-constant leaf: ``sampler(keys (n, w)) -> (n,)`` draws one
    value per occurrence at generation time."""
    name: str
    sampler: Callable
    ret_type: int


@dataclasses.dataclass
class Argument:
    """An input-variable leaf (``ARGx``)."""
    name: str
    index: int
    ret_type: int


class PrimitiveSetTyped:
    """Typed primitive registry (reference ``PrimitiveSetTyped``).  Types
    are arbitrary hashables mapped to small ints in order of first use."""

    def __init__(self, name: str, in_types: Sequence[Any], ret_type: Any,
                 prefix: str = "ARG"):
        self.name = name
        self._type_ids: dict = {}
        self.ret = self._type_id(ret_type)
        self.ins = [self._type_id(t) for t in in_types]
        self.prefix = prefix
        self.primitives: list[Primitive] = []
        self.terminals: list[Terminal] = []
        self.ephemerals: list[Ephemeral] = []
        self.arguments: list[Argument] = []
        self.mapping: dict[str, Any] = {}
        for i, t in enumerate(self.ins):
            arg = Argument(f"{prefix}{i}", i, t)
            self.arguments.append(arg)
            self.mapping[arg.name] = arg
        self._frozen = None

    def _type_id(self, t) -> int:
        if t not in self._type_ids:
            self._type_ids[t] = len(self._type_ids)
        return self._type_ids[t]

    @property
    def n_types(self) -> int:
        return len(self._type_ids)

    def _check_name(self, name):
        if name in self.mapping:
            raise ValueError(
                f"Primitives are required to have a unique name. "
                f"Consider using the argument 'name' to rename your "
                f"second '{name}' primitive.")

    def add_primitive(self, func: Callable, in_types: Sequence[Any],
                      ret_type: Any, name: str | None = None,
                      fmt: str | None = None):
        name = name or getattr(func, "__name__", f"prim{len(self.primitives)}")
        self._check_name(name)
        prim = Primitive(name, len(in_types), func, self._type_id(ret_type),
                         tuple(self._type_id(t) for t in in_types), fmt)
        self.primitives.append(prim)
        self.mapping[name] = prim
        self._frozen = None
        return prim

    def add_terminal(self, value: float, ret_type: Any,
                     name: str | None = None):
        name = name or str(value)
        self._check_name(name)
        term = Terminal(name, float(value), self._type_id(ret_type))
        self.terminals.append(term)
        self.mapping[name] = term
        self._frozen = None
        return term

    def add_ephemeral_constant(self, name: str, sampler: Callable,
                               ret_type: Any):
        """``sampler(keys (n, w)) -> (n,)``."""
        self._check_name(name)
        eph = Ephemeral(name, sampler, self._type_id(ret_type))
        self.ephemerals.append(eph)
        self.mapping[name] = eph
        self._frozen = None
        return eph

    def rename_arguments(self, **kargs):
        """Rename input arguments, e.g. ``rename_arguments(ARG0="x")``."""
        for old_name, new_name in kargs.items():
            arg = self.mapping.get(old_name)
            if not isinstance(arg, Argument):
                raise ValueError(f"{old_name!r} is not an argument of "
                                 f"primitive set {self.name!r}")
            self._check_name(new_name)
            del self.mapping[old_name]
            arg.name = new_name
            self.mapping[new_name] = arg
        self._frozen = None

    addPrimitive = add_primitive
    addTerminal = add_terminal
    addEphemeralConstant = add_ephemeral_constant
    renameArguments = rename_arguments

    @property
    def nodes(self) -> list:
        """Node table: primitives, then terminals, ephemerals, arguments —
        a node's position is its integer code."""
        return (list(self.primitives) + list(self.terminals)
                + list(self.ephemerals) + list(self.arguments))

    def freeze(self) -> "FrozenPSet":
        if self._frozen is None:
            self._frozen = FrozenPSet(self)
        return self._frozen


class PrimitiveSet(PrimitiveSetTyped):
    """Untyped facade: every type is ``object``."""

    def __init__(self, name: str, arity: int, prefix: str = "ARG"):
        super().__init__(name, [object] * arity, object, prefix)

    def add_primitive(self, func, arity: int | Sequence, name=None,
                      fmt=None):
        if isinstance(arity, int):
            in_types = [object] * arity
        elif arity is None:
            raise TypeError("add_primitive() requires an arity (int) or an "
                            "explicit sequence of argument types")
        else:
            in_types = arity
        return super().add_primitive(func, in_types, object, name, fmt)

    def add_terminal(self, value, name=None):
        return super().add_terminal(value, object, name)

    def add_ephemeral_constant(self, name, sampler):
        return super().add_ephemeral_constant(name, sampler, object)

    addPrimitive = add_primitive
    addTerminal = add_terminal
    addEphemeralConstant = add_ephemeral_constant


class FrozenPSet:
    """Static tables compiled from a primitive set (numpy arrays, equal to
    the JAX package's), their tensor copies per device, and the op-kind
    table of the CUDA interpreter."""

    def __init__(self, pset: PrimitiveSetTyped):
        from .interp_cuda import OPCODES, opcode_of
        self.pset = pset
        nodes = pset.nodes
        self.n_nodes = len(nodes)
        self.names = [n.name for n in nodes]
        self.arity = np.array(
            [n.arity if isinstance(n, Primitive) else 0 for n in nodes],
            np.int32)
        self.max_arity = int(self.arity.max()) if len(nodes) else 0
        self.ret_type = np.array([n.ret_type for n in nodes], np.int32)
        self.is_primitive = np.array(
            [isinstance(n, Primitive) for n in nodes], bool)
        self.is_terminal = ~self.is_primitive
        self.is_ephemeral = np.array(
            [isinstance(n, Ephemeral) for n in nodes], bool)
        self.is_argument = np.array(
            [isinstance(n, Argument) for n in nodes], bool)
        self.arg_index = np.array(
            [n.index if isinstance(n, Argument) else 0 for n in nodes],
            np.int32)
        self.const_value = np.array(
            [n.value if isinstance(n, Terminal) else 0.0 for n in nodes],
            np.float32)
        self.in_types = np.zeros((self.n_nodes, max(self.max_arity, 1)),
                                 np.int32)
        for i, n in enumerate(nodes):
            if isinstance(n, Primitive):
                self.in_types[i, :n.arity] = n.in_types

        nt = pset.n_types
        self.prim_by_type = _candidates(
            nt, [(i, n.ret_type) for i, n in enumerate(nodes)
                 if isinstance(n, Primitive)])
        self.term_by_type = _candidates(
            nt, [(i, n.ret_type) for i, n in enumerate(nodes)
                 if not isinstance(n, Primitive)])
        n_term = int(self.is_terminal.sum())
        self.terminal_ratio = n_term / max(1, self.n_nodes)
        self.eph_samplers = [
            n.sampler if isinstance(n, Ephemeral) else None for n in nodes]
        term_cnt = self.term_by_type[1]
        self.args_have_terminals = np.array([
            all(term_cnt[t] > 0 for t in n.in_types)
            if isinstance(n, Primitive) else True
            for n in nodes])

        # the CUDA interpreter's opcode per node; -1: no kernel form
        self.op_kind = np.array(
            [OPCODES["arg"] if isinstance(n, Argument)
             else opcode_of(n.func, n.arity) if isinstance(n, Primitive)
             else OPCODES["const"] for n in nodes], np.int32)
        self._const_fns = None
        self._tables: dict = {}

    def code_of(self, name: str) -> int:
        return self.names.index(name)

    @property
    def kernel_form_missing(self) -> list:
        """Names of the primitives whose function has no K6 opcode."""
        return [self.names[i] for i in np.nonzero(self.op_kind < 0)[0]]

    @property
    def const_fns(self):
        """Per-code constant samplers ``fn(keys (n, w)) -> (n,)`` float32:
        ephemerals draw from their sampler, every other node returns its
        static value (0 for primitives and arguments)."""
        if self._const_fns is None:
            fns = []
            for i in range(self.n_nodes):
                if self.eph_samplers[i] is not None:
                    sampler = self.eph_samplers[i]
                    fns.append(lambda keys, s=sampler:
                               torch.as_tensor(s(keys)).to(torch.float32))
                else:
                    v = float(self.const_value[i])
                    fns.append(lambda keys, v=v: torch.full(
                        keys.shape[:-1], v, dtype=torch.float32,
                        device=keys.device))
            self._const_fns = tuple(fns)
        return self._const_fns

    def tables(self, device) -> dict:
        """The tables as tensors on ``device`` (cached per device):
        int64 index tables, float32 constants, bool masks, and the int32
        op-kind and argument-index tables the kernel reads."""
        device = torch.device(device)
        if device not in self._tables:
            def t(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)
            i64 = torch.int64
            self._tables[device] = {
                "arity": t(self.arity, i64),
                "ret_type": t(self.ret_type, i64),
                "in_types": t(self.in_types, i64),
                "prim_arr": t(self.prim_by_type[0], i64),
                "prim_cnt": t(self.prim_by_type[1], i64),
                "term_arr": t(self.term_by_type[0], i64),
                "term_cnt": t(self.term_by_type[1], i64),
                "const_value": t(self.const_value, torch.float32),
                "is_ephemeral": t(self.is_ephemeral, torch.bool),
                "op_kind": t(self.op_kind, torch.int32),
                "arg_index": t(self.arg_index, torch.int32),
            }
        return self._tables[device]


def _candidates(n_types: int, pairs):
    """pairs: (code, type) -> padded (n_types, max_count) array + counts."""
    buckets = [[] for _ in range(max(n_types, 1))]
    for code, t in pairs:
        buckets[t].append(code)
    width = max(max((len(b) for b in buckets), default=0), 1)
    arr = np.zeros((max(n_types, 1), width), np.int32)
    cnt = np.zeros(max(n_types, 1), np.int32)
    for t, b in enumerate(buckets):
        cnt[t] = len(b)
        for j, c in enumerate(b):
            arr[t, j] = c
    return arr, cnt
