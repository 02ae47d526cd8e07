"""Non-finite fitness quarantine.

A user evaluator that divides by zero or overflows returns NaN/Inf rows,
and NaN is *poisonous* to selection: every comparison against NaN is
false, so masked-wvalue sorts and tournament rank arithmetic return
arbitrary winners — the run keeps going and silently optimizes garbage.
A :class:`Quarantine` attached to the toolbox (``toolbox.quarantine =
Quarantine("penalize")``) is honored by
:func:`deap_tpu_torch.algorithms.evaluate_population` and
:func:`~deap_tpu_torch.algorithms.ea_tell` — and therefore by every loop
and every served session — immediately after each evaluation:

* ``"penalize"`` — non-finite rows get a worst-case sentinel fitness
  (finite, so comparisons stay total); they remain valid and simply lose
  every selection.
* ``"resample"`` — as ``penalize``, plus the offending genome row is
  replaced by a clone of the current lexicographically-best finite row
  and its fitness is invalidated, so the clone is re-evaluated (after
  variation) next generation — the bad genome is discarded from the gene
  pool.
* ``"raise"`` — abort with the offending row indices
  (:class:`NonFiniteFitnessError`).  The mask is read on the host: one
  device-to-host copy of a ``(pop,)`` bool a call.

The sentinels and the donor (first index on lexicographic ties) are the
JAX package's, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import Population, _map, lex_argmax

__all__ = ["Quarantine", "NonFiniteFitnessError", "nonfinite_rows"]


class NonFiniteFitnessError(RuntimeError):
    """Raised by the ``"raise"`` policy; ``rows`` holds the offending
    population indices."""

    def __init__(self, rows):
        rows = np.asarray(rows).tolist()
        super().__init__(
            f"evaluator returned non-finite fitness for row(s) {rows}")
        self.rows = rows


def nonfinite_rows(values: torch.Tensor) -> torch.Tensor:
    """Bool ``(pop,)`` mask of rows with any NaN/Inf objective."""
    return ~torch.all(torch.isfinite(values), dim=-1)


def _raise_rows(bad: torch.Tensor) -> None:
    bad = bad.cpu().numpy()
    if bad.any():
        raise NonFiniteFitnessError(np.nonzero(bad)[0])


@dataclasses.dataclass(frozen=True)
class Quarantine:
    """Policy for non-finite evaluator output.

    ``sentinel`` is the worst-case magnitude in *weighted* space: a
    quarantined row's wvalue becomes ``-sentinel`` on every objective, so
    it loses every maximizing comparison yet stays finite.  The default
    (``None``) uses ``finfo(dtype).max / 16`` — far beyond any real
    fitness, far from overflow.
    """

    policy: str = "penalize"              # penalize | resample | raise
    sentinel: float | None = None

    def __post_init__(self):
        if self.policy not in ("penalize", "resample", "raise"):
            raise ValueError(
                f"unknown quarantine policy {self.policy!r}: expected "
                "'penalize', 'resample' or 'raise'")

    def _sentinel_values(self, weights, dtype, device) -> torch.Tensor:
        big = torch.tensor(torch.finfo(dtype).max, dtype=dtype) / 16 \
            if self.sentinel is None \
            else torch.tensor(self.sentinel, dtype=dtype)
        w = torch.tensor(weights, dtype=dtype)
        # raw value whose weighted form is -big — but both the raw value
        # and its weighted form must stay FINITE for any weight magnitude:
        # cap the raw magnitude at big, so |w| < 1 yields wvalue -big*|w|
        # instead of -big/|w| overflowing to inf.  A zero-weight objective
        # is ignored by every comparison, so 0 is as good as anything.
        absw = torch.where(w != 0, torch.abs(w), torch.ones_like(w))
        mag = torch.minimum(big / absw, big)
        out = torch.where(w != 0, -torch.sign(w) * mag, torch.zeros_like(w))
        return out.to(device)

    def apply(self, population: Population,
              newly: torch.Tensor | None = None) -> Population:
        """Quarantine the non-finite rows of ``population``.

        ``newly`` restricts the scan to rows just assigned by the current
        evaluation (rows the policy has already penalized carry a finite
        sentinel and must not be re-processed).
        """
        fit = population.fitness
        bad = nonfinite_rows(fit.values) & fit.valid
        if newly is not None:
            bad = bad & newly.to(torch.bool)

        from ..observability import events as _events
        if _events.active():          # event tap; inert when closed
            _events.emit("quarantined", bad.sum(dtype=torch.int32))

        if self.policy == "raise":
            _raise_rows(bad)
            return population

        sent = self._sentinel_values(fit.weights, fit.values.dtype,
                                     fit.values.device)
        values = torch.where(bad[:, None], sent[None, :], fit.values)
        fit = dataclasses.replace(fit, values=values)
        if self.policy == "penalize":
            return Population(genome=population.genome, fitness=fit)

        # resample: clone the best finite row over each quarantined genome
        # and invalidate, so the clone re-enters variation + evaluation
        # next generation.  If NO row is finite the donor index is
        # arbitrary — every row already carries the sentinel, so the swap
        # is a no-op in fitness space.
        healthy_w = torch.where((fit.valid & ~bad)[:, None], fit.wvalues,
                                float("-inf"))
        donor = lex_argmax(healthy_w, axis=0)
        genome = _map(
            lambda g: torch.where(
                bad.reshape(bad.shape + (1,) * (g.ndim - 1)),
                g[donor][None], g),
            population.genome)
        return Population(genome=genome, fitness=fit.invalidate(bad))
