"""Statistics and logbook — the PyTorch counterparts of the JAX
package's ``deap_tpu/utils/support.py``.

* :class:`Statistics` — a reducer registry whose ``compile`` runs
  tensor reducers on the device; the loops stack the per-generation
  results and copy them to the host once.
* :class:`Logbook` — host-side chronological records with chapters and
  the column-aligned ASCII ``stream`` (the reference's Logbook).

``MultiStatistics`` and ``HallOfFame``/``ParetoFront`` are not ported
yet.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List

import numpy as np
import torch

__all__ = ["Statistics", "Logbook"]


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
