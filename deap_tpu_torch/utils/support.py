"""Statistics, logbook and archives — the PyTorch counterparts of the
JAX package's ``deap_tpu/utils/support.py``.

* :class:`Statistics` / :class:`MultiStatistics` — reducer registries
  whose ``compile`` runs tensor reducers on the device; the loops stack
  the per-generation results and copy them to the host once.
* :class:`Logbook` — host-side chronological records with chapters and
  the column-aligned ASCII ``stream`` (the reference's Logbook).
* :class:`HallOfFame` / :class:`ParetoFront` — fixed-capacity archives
  on the population's device (:func:`hof_update` / :func:`pareto_update`
  are functional updates of an :class:`_ArchiveState`), with thin host
  wrappers.  Fixed capacity and a fill mask replace the reference's
  growing sorted lists.
* :class:`History` — host-side genealogy recorder.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from operator import eq
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..base import Population, _leaves, _map, dominates, lex_sort_indices
from ..base import lexsort

__all__ = ["Statistics", "MultiStatistics", "Logbook", "HallOfFame",
           "ParetoFront", "History", "hof_init", "hof_update", "pareto_init",
           "pareto_update"]


class Statistics:
    """Reducer registry (reference Statistics, support.py:154-210).

    ``key`` extracts the data from what ``compile`` receives — e.g.
    ``Statistics(key=lambda pop: pop.fitness.values[:, 0])``.  Registered
    functions should be tensor reducers (``torch.min``, ``torch.mean``):
    the loops keep their results on the device until the run ends.
    """

    def __init__(self, key: Callable = lambda x: x):
        self.key = key
        self.functions: Dict[str, Callable] = {}
        self.fields: List[str] = []

    def register(self, name: str, function: Callable, *args, **kargs):
        self.functions[name] = partial(function, *args, **kargs)
        self.fields.append(name)

    def compile(self, data) -> Dict[str, Any]:
        values = self.key(data)
        return {name: func(values) for name, func in self.functions.items()}


class MultiStatistics(dict):
    """Dict of named :class:`Statistics` compiled together into nested
    chapters (reference MultiStatistics, support.py:212-259)."""

    def __init__(self, **kargs):
        super().__init__(**kargs)
        self.fields = sorted(kargs.keys())

    def register(self, name: str, function: Callable, *args, **kargs):
        for stats in self.values():
            stats.register(name, function, *args, **kargs)

    def compile(self, data) -> Dict[str, Dict[str, Any]]:
        return {name: stats.compile(data) for name, stats in self.items()}


class Logbook(list):
    """Chronological list of dict records with nested chapters and aligned
    ASCII streaming (reference Logbook, support.py:261-487)."""

    def __init__(self):
        super().__init__()
        self.buffindex = 0
        self.chapters: Dict[str, "Logbook"] = {}
        self.columns_len = None
        self.header = None
        self.log_header = True

    def record(self, **infos):
        apply_to_all = {k: v for k, v in infos.items() if not isinstance(v, dict)}
        for key, value in list(infos.items()):
            if isinstance(value, dict):
                chapter_infos = dict(value)
                chapter_infos.update(apply_to_all)
                if key not in self.chapters:
                    self.chapters[key] = Logbook()
                self.chapters[key].record(**chapter_infos)
                del infos[key]
        self.append(infos)

    def record_stacked(self, **stacked):
        """Unpack per-generation stacked arrays (as produced by a scanned
        loop) into one ``record`` call per generation.

        Each leaf is copied to host numpy ONCE up front: a device->host
        copy inside the per-generation loop would repeat the transfer
        O(ngen) times per leaf."""
        def to_host(v):
            if isinstance(v, dict):
                return {k: to_host(x) for k, x in v.items()}
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu()
            return np.asarray(v)

        def length(v):
            if isinstance(v, dict):
                return length(next(iter(v.values())))
            return len(v)

        def slice_i(v, i):
            if isinstance(v, dict):
                return {k: slice_i(x, i) for k, x in v.items()}
            x = v[i]
            return x.item() if np.ndim(x) == 0 else x

        stacked = {k: to_host(v) for k, v in stacked.items()}
        ngen = length(next(iter(stacked.values())))
        for i in range(ngen):
            self.record(**{k: slice_i(v, i) for k, v in stacked.items()})

    def select(self, *names):
        if len(names) == 1:
            return [entry.get(names[0], None) for entry in self]
        return tuple([entry.get(name, None) for entry in self] for name in names)

    def pop(self, index=0):
        """Retrieve and delete element ``index``, also from the chapters
        (reference support.py:322-333)."""
        if index < self.buffindex:
            self.buffindex -= 1
        for chapter in self.chapters.values():
            chapter.pop(index)
        return super().pop(index)

    def __delitem__(self, key):
        for chapter in self.chapters.values():
            chapter.__delitem__(key)
        super().__delitem__(key)

    @property
    def stream(self) -> str:
        startindex, self.buffindex = self.buffindex, len(self)
        return self.__str__(startindex)

    def __txt__(self, startindex):
        """Render records ``startindex:`` as aligned text lines.

        Column-major pipeline: each column independently yields a *header
        block* (possibly several lines — chapters carry a centered title, a
        dash rule, and their own nested header) and a *body block* (one cell
        per record, chapters contributing their pre-rendered lines).  Blocks
        are then bottom-aligned and zipped into rows.  Column widths live in
        ``self.columns_len`` and only ever grow, so successive ``stream``
        chunks stay aligned with earlier output.
        """
        columns = self.header
        if not columns:
            columns = sorted(self[0].keys()) + sorted(self.chapters.keys())
        if not self.columns_len or len(self.columns_len) != len(columns):
            self.columns_len = [len(str(c)) for c in columns]

        show_header = startindex == 0 and self.log_header
        n_body = len(self) - startindex

        heads: list[list[str]] = []     # per-column header block
        bodies: list[list[str]] = []    # per-column body cells
        for j, name in enumerate(columns):
            chapter = self.chapters.get(name)
            if chapter is not None:
                sub = chapter.__txt__(startindex)
                split = len(sub) - n_body
                width = max((len(s.expandtabs()) for s in sub),
                            default=len(str(name)))
                head = [str(name).center(width), "-" * width] + sub[:split]
                body = sub[split:]
            else:
                body = []
                for rec in self[startindex:]:
                    v = rec.get(name, "")
                    body.append(f"{v:g}" if isinstance(v, float) else str(v))
                width = max(len(s) for s in body) if body else 0
                head = [str(name)]
            self.columns_len[j] = max(self.columns_len[j], width)
            heads.append(head)
            bodies.append(body)

        rows: list[list[str]] = []
        if show_header:
            depth = max(len(h) for h in heads)
            padded = [[""] * (depth - len(h)) + h for h in heads]
            rows.extend(list(r) for r in zip(*padded))
        if n_body:
            rows.extend(list(r) for r in zip(*bodies))

        return ["\t".join(cell.ljust(w)
                          for cell, w in zip(row, self.columns_len))
                for row in rows]

    def __str__(self, startindex=0):
        text = self.__txt__(startindex)
        return "\n".join(text)


# ---------------------------------------------------------------------------
# Archives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _ArchiveState:
    genome: Any                  # tensor or tuple/dict, leaves (maxsize, ...)
    values: torch.Tensor         # (maxsize, nobj) raw objective values
    filled: torch.Tensor         # (maxsize,) bool
    weights: tuple

    @property
    def wvalues(self) -> torch.Tensor:
        return _masked_wvalues(self.values, self.filled, self.weights)


def _masked_wvalues(values, filled, weights) -> torch.Tensor:
    """Weighted values, ``-inf`` on rows not filled."""
    w = torch.stack([values[:, j] * wj for j, wj in enumerate(weights)],
                    dim=1)
    return torch.where(filled[:, None], w, float("-inf"))


def _flat_genome(genome) -> torch.Tensor:
    """Each individual's genome leaves as one ``(n, D)`` float32 row, for
    equality tests."""
    return torch.cat([g.reshape(g.shape[0], -1).to(torch.float32)
                      for g in _leaves(genome)], dim=1)


def _union(state: _ArchiveState, cand: Population, cand_filled):
    """Archive rows then candidate rows: genome, values, filled and the
    masked weighted values."""
    genome = _map(lambda a, b: torch.cat([a, b], 0), state.genome,
                  cand.genome)
    values = torch.cat([state.values, cand.fitness.values], 0)
    filled = torch.cat([state.filled, cand_filled], 0)
    return genome, values, filled, _masked_wvalues(values, filled,
                                                   state.weights)


def _earlier_duplicates(same: torch.Tensor, filled: torch.Tensor):
    """Rows equal (``same``) to an earlier filled row."""
    earlier = torch.ones_like(same).tril(-1)
    return (same & earlier & filled[None, :]).any(1)


def hof_init(maxsize: int, population: Population) -> _ArchiveState:
    """Empty hall-of-fame archive shaped like ``population``'s
    individuals, on their device."""
    fit = population.fitness
    genome = _map(lambda g: torch.zeros((maxsize,) + tuple(g.shape[1:]),
                                        dtype=g.dtype, device=g.device),
                  population.genome)
    return _ArchiveState(
        genome=genome,
        values=torch.zeros((maxsize, fit.nobj), dtype=fit.values.dtype,
                           device=fit.values.device),
        filled=torch.zeros((maxsize,), dtype=torch.bool,
                           device=fit.values.device),
        weights=fit.weights)


def hof_update(state: _ArchiveState, population: Population,
               dedup: bool = True) -> _ArchiveState:
    """Keep the lexicographically best ``maxsize`` individuals of archive
    and population (reference HallOfFame.update).  With ``dedup`` (the
    reference's ``similar=eq``) an exact-duplicate genome enters once.

    The candidates are the population's top ``min(4·maxsize, pop)``
    (``maxsize`` without ``dedup``); duplicates are found among archive
    and candidates by an ``m × m × D`` comparison of float32 casts.  Tied
    rows sort highest index first (:func:`lex_sort_indices`), as in the
    JAX package."""
    maxsize = state.filled.shape[0]
    cand_n = min(4 * maxsize, population.size) if dedup else maxsize
    top = lex_sort_indices(population.fitness.masked_wvalues(),
                           descending=True)[:cand_n]
    cand = population.take(top)
    genome, values, filled, w = _union(state, cand,
                                       cand.fitness.valid[:cand_n])
    order = lex_sort_indices(w, descending=True)
    genome = _map(lambda g: g[order], genome)
    values, filled = values[order], filled[order]
    if dedup:
        flat = _flat_genome(genome)
        same = (flat[:, None, :] == flat[None, :, :]).all(-1)
        keep = filled & ~_earlier_duplicates(same, filled)
        reorder = torch.argsort((~keep).to(torch.uint8), stable=True)
        genome = _map(lambda g: g[reorder], genome)
        values, filled = values[reorder], keep[reorder]
    return _ArchiveState(genome=_map(lambda g: g[:maxsize], genome),
                         values=values[:maxsize], filled=filled[:maxsize],
                         weights=state.weights)


def pareto_init(maxsize: int, population: Population) -> _ArchiveState:
    """Empty Pareto archive: static capacity, pruned by crowding distance
    when full (the reference's ParetoFront grows without bound)."""
    return hof_init(maxsize, population)


def pareto_update(state: _ArchiveState,
                  population: Population) -> _ArchiveState:
    """Keep the nondominated subset of archive and population, dropping
    the crowding-poorest points when over capacity; exact-duplicate
    weighted values keep one copy."""
    from ..ops.emo import assign_crowding_dist, nondominated_ranks

    maxsize = state.filled.shape[0]
    # preselect the population's own nondominated subset, capped at maxsize
    ranks_p, _ = nondominated_ranks(population.fitness.masked_wvalues())
    dist_p = assign_crowding_dist(population.fitness.values, ranks_p)
    order_p = lexsort([-dist_p, ranks_p])[:maxsize]
    cand = population.take(order_p)
    cand_valid = cand.fitness.valid & (ranks_p[order_p] == 0)
    genome, values, filled, w = _union(state, cand, cand_valid)

    dominated = (dominates(w[:, None, :], w[None, :, :])
                 & filled[:, None]).any(0)
    same = (w[:, None, :] == w[None, :, :]).all(-1)
    keep = filled & ~dominated & ~_earlier_duplicates(same, filled)

    ranks = torch.where(keep, 0, 1).to(torch.int32)
    dist = assign_crowding_dist(values, ranks)
    order = lexsort([-torch.where(keep, dist, float("-inf")),
                     (~keep).to(torch.uint8)])
    return _ArchiveState(genome=_map(lambda g: g[order][:maxsize], genome),
                         values=values[order][:maxsize],
                         filled=keep[order][:maxsize], weights=state.weights)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _host_tree(g, fn=lambda a: a):
    """A genome (tensors or arrays, alone or in a tuple/list/dict) as
    host numpy leaves of the same structure, each passed through
    ``fn``."""
    if isinstance(g, dict):
        return {k: _host_tree(v, fn) for k, v in g.items()}
    if isinstance(g, (tuple, list)):
        return type(g)(_host_tree(v, fn) for v in g)
    return fn(_host(g))


def _first_leaf(g):
    while isinstance(g, (dict, tuple, list)):
        g = next(iter(g.values())) if isinstance(g, dict) else g[0]
    return g


class HallOfFame:
    """Host wrapper over :func:`hof_init` / :func:`hof_update` with the
    reference's surface: ``update``, ``clear``, ``len``, iteration and
    ``__getitem__`` giving ``(genome, values)`` as host numpy arrays."""

    _update_fn = staticmethod(hof_update)
    _init_fn = staticmethod(hof_init)

    def __init__(self, maxsize: int, similar: Callable | None = eq):
        self.maxsize = maxsize
        self.similar = similar
        self.state: _ArchiveState | None = None

    def init_state(self, population: Population) -> _ArchiveState:
        self.state = self._init_fn(self.maxsize, population)
        return self.state

    def update(self, population: Population) -> _ArchiveState:
        if self.state is None:
            self.init_state(population)
        if type(self)._update_fn is hof_update:
            self.state = hof_update(self.state, population,
                                    dedup=self.similar is not None)
        else:
            self.state = type(self)._update_fn(self.state, population)
        return self.state

    def clear(self):
        self.state = None

    def __len__(self):
        if self.state is None:
            return 0
        return int(self.state.filled.sum())

    def __getitem__(self, i):
        return (_host_tree(self.state.genome, lambda g: g[i]),
                _host(self.state.values)[i])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @property
    def keys(self) -> np.ndarray:
        return _host(self.state.values)[: len(self)]


class ParetoFront(HallOfFame):
    """Host wrapper over :func:`pareto_init` / :func:`pareto_update`."""

    _update_fn = staticmethod(pareto_update)
    _init_fn = staticmethod(pareto_init)

    def __init__(self, maxsize: int = 1024, similar: Callable | None = eq):
        super().__init__(maxsize, similar)


class History:
    """Genealogy recorder (reference History).  Host-side: snapshots come
    through ``update`` with explicit parent slot indices (an array
    program knows lineage by index, not by object identity).  Produces
    the reference's ``genealogy_tree`` / ``genealogy_history``."""

    def __init__(self):
        self.genealogy_index = 0
        self.genealogy_history: Dict[int, Any] = {}
        self.genealogy_tree: Dict[int, tuple] = {}
        self._latest: np.ndarray | None = None   # per-slot history index

    def update(self, genomes, parent_slots=None):
        """Record a population snapshot.  ``genomes``: a genome with a
        leading pop axis (tensors on any device, or arrays);
        ``parent_slots``: optional ``(pop, nparents)`` slot indices into
        the previous snapshot."""
        host = _host_tree(genomes)
        n = _first_leaf(host).shape[0]
        slots = None if parent_slots is None else _host(parent_slots)
        new_idx = np.zeros(n, dtype=np.int64)
        for i in range(n):
            self.genealogy_index += 1
            new_idx[i] = self.genealogy_index
            self.genealogy_history[self.genealogy_index] = _host_tree(
                host, lambda g: g[i])
            if slots is None or self._latest is None:
                self.genealogy_tree[self.genealogy_index] = tuple()
            else:
                ps = np.atleast_1d(slots[i])
                self.genealogy_tree[self.genealogy_index] = tuple(
                    int(self._latest[p]) for p in ps)
        self._latest = new_idx

    def getGenealogy(self, index: int, max_depth: float = float("inf")):
        """Ancestor subtree of history entry ``index``."""
        gtree = {}
        visited = set()

        def walk(idx, depth):
            if depth > max_depth or idx in visited:
                return
            visited.add(idx)
            parents = self.genealogy_tree.get(idx, ())
            gtree[idx] = list(parents)
            for p in parents:
                walk(p, depth + 1)

        walk(index, 0)
        return gtree
