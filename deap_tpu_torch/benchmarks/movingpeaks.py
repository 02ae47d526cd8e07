"""Moving Peaks dynamic benchmark — the PyTorch counterpart of
``deap_tpu/benchmarks/movingpeaks.py`` (Branke 1999; the fluctuating
peak count of du Plessis & Engelbrecht 2013).

The landscape is a :class:`PeaksState` of tensors — positions ``(cap,
dim)``, heights and widths ``(cap,)``, the last shift and an ``active``
mask for the fluctuating mode — so evaluation is one peak-by-individual
broadcast (one call serves a ``(n, dim)`` batch), and
:meth:`MovingPeaks.change_peaks_state` is a pure update driven by a key
with the JAX package's key chain: ``split(key, 5)``, then ``split(k_num,
3)`` and ``split(k_new, 4)``.  A stateful wrapper keeps the reference's
``__call__`` / offline-error bookkeeping and its camelCase methods."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random
from .._device import resolve_device
from .._xla_math import fma, row_dot, sqrt

__all__ = ["cone", "sphere", "function1", "MovingPeaks",
           "SCENARIO_1", "SCENARIO_2", "SCENARIO_3"]


# The peak functions' ``fused`` picks XLA's float form: jitted, XLA fuses
# each square into the distance's sum and the width's product into the
# add (``fused=True``); the JAX package's stateful ``__call__``,
# ``globalMaximum`` and ``maximums`` run op by op, where nothing fuses
# (``fused=False``)


def _fma(a, b, c, fused):
    return fma(a, b, c) if fused else a * b + c


def _sq_dist(individual, position, fused):
    """``|x - p|²`` over the last axis."""
    d = individual - position
    return row_dot(d, d, fused=fused)


def cone(individual, position, height, width, fused=True):
    """``h - w ||x - p||``."""
    return _fma(-width, sqrt(_sq_dist(individual, position, fused)), height,
                fused)


def sphere(individual, position, height, width, fused=True):
    """``h ||x - p||²``."""
    return height * _sq_dist(individual, position, fused)


def function1(individual, position, height, width, fused=True):
    """``h / (1 + w ||x - p||²)``."""
    return height / _fma(width, _sq_dist(individual, position, fused), 1.0,
                         fused)


_PEAK_FUNCTIONS = (cone, sphere, function1)     # the ones that take fused


SCENARIO_1 = {"pfunc": function1, "npeaks": 5, "bfunc": None,
              "min_coord": 0.0, "max_coord": 100.0,
              "min_height": 30.0, "max_height": 70.0, "uniform_height": 50.0,
              "min_width": 0.0001, "max_width": 0.2, "uniform_width": 0.1,
              "lambda_": 0.0, "move_severity": 1.0, "height_severity": 7.0,
              "width_severity": 0.01, "period": 5000}

SCENARIO_2 = {"pfunc": cone, "npeaks": 10, "bfunc": None,
              "min_coord": 0.0, "max_coord": 100.0,
              "min_height": 30.0, "max_height": 70.0, "uniform_height": 50.0,
              "min_width": 1.0, "max_width": 12.0, "uniform_width": 0.0,
              "lambda_": 0.5, "move_severity": 1.5, "height_severity": 7.0,
              "width_severity": 1.0, "period": 5000}

SCENARIO_3 = {"pfunc": cone, "npeaks": 50, "bfunc": lambda x: 10,
              "min_coord": 0.0, "max_coord": 100.0,
              "min_height": 30.0, "max_height": 70.0, "uniform_height": 0.0,
              "min_width": 1.0, "max_width": 12.0, "uniform_width": 0.0,
              "lambda_": 0.5, "move_severity": 1.0, "height_severity": 1.0,
              "width_severity": 0.5, "period": 1000}


@dataclasses.dataclass(frozen=True)
class PeaksState:
    position: torch.Tensor        # (cap, dim)
    height: torch.Tensor          # (cap,)
    width: torch.Tensor           # (cap,)
    last_change: torch.Tensor     # (cap, dim)
    active: torch.Tensor          # (cap,) bool


def _scaled_normal(key, shape, severity, fused=True):
    """``normal * severity`` as XLA folds it: ``erf_inv(u)`` times the
    float32 product of ``sqrt(2)`` and the severity (``fused=False``: the
    normal, then the product, op by op)."""
    if not fused:
        return random.normal(key, shape) * float(np.float32(severity))
    c = float(np.float32(random.SQRT2) * np.float32(severity))
    return random.normal_erf_inv(key, shape) * c


def _normalized(shift, severity, fused=True):
    """``severity * shift / |shift|`` a row (0 where the norm is 0), the
    squares fused into the norm's sum as XLA compiles the update
    (``fused=False``: rounded squares, op by op)."""
    norm = sqrt(row_dot(shift, shift, fused=fused))[:, None]
    return torch.where(norm > 0, severity * shift / norm, 0.0)


class MovingPeaks:
    """Dynamic multimodal landscape (reference MovingPeaks).

    :param dim: search-space dimensionality.
    :param key: the port's PRNG key (``PRNGKey(0)`` on ``device`` when
        omitted).
    :param device: where the landscape lives when no key is given
        (default the card).
    Scenario keyword arguments as in the reference; ``npeaks`` may be an
    int or a ``[min, initial, max]`` triple with ``number_severity`` for
    the fluctuating-count mode.
    """

    def __init__(self, dim, key=None, device=None, **kargs):
        sc = dict(SCENARIO_1)
        sc.update(kargs)
        if key is None:
            key = random.PRNGKey(0, device=resolve_device(device))
        self.dim = dim
        self.pfunc = sc["pfunc"]
        self.basis_function = sc["bfunc"]
        npeaks = sc["npeaks"]
        self.minpeaks = self.maxpeaks_n = None
        if hasattr(npeaks, "__getitem__"):
            self.minpeaks, npeaks, self.maxpeaks_n = npeaks
            self.number_severity = sc["number_severity"]
            cap = self.maxpeaks_n
        else:
            cap = npeaks
        self.cap = cap
        for name in ("min_coord", "max_coord", "min_height", "max_height",
                     "min_width", "max_width", "lambda_", "move_severity",
                     "height_severity", "width_severity", "period"):
            setattr(self, name, sc[name])

        k1, k2, k3, k4, self.key = random.split(key, 5)
        dev = key.device
        position = random.uniform(k1, (cap, dim), minval=self.min_coord,
                                  maxval=self.max_coord)
        if sc["uniform_height"] != 0:
            height = torch.full((cap,), float(sc["uniform_height"]),
                                device=dev)
        else:
            height = random.uniform(k2, (cap,), minval=self.min_height,
                                    maxval=self.max_height)
        if sc["uniform_width"] != 0:
            width = torch.full((cap,), float(sc["uniform_width"]),
                               device=dev)
        else:
            width = random.uniform(k3, (cap,), minval=self.min_width,
                                   maxval=self.max_width)
        last_change = random.uniform(k4, (cap, dim)) - 0.5
        active = torch.arange(cap, device=dev) < npeaks
        self.state = PeaksState(position, height, width, last_change, active)

        self._optimum = None
        self._error = None
        self._offline_error = 0.0
        self.nevals = 0

    # -- evaluation ---------------------------------------------------------

    def _pfunc(self, individual, s: PeaksState, fused: bool):
        kw = {"fused": fused} if self.pfunc in _PEAK_FUNCTIONS else {}
        return self.pfunc(individual, s.position, s.height, s.width, **kw)

    def peak_values(self, individual, state: PeaksState | None = None,
                    fused: bool = True):
        """Every peak's response for an individual ``(dim,)`` or a batch
        ``(..., dim)``: ``(..., cap)`` (one more with a basis function),
        inactive peaks ``-inf``.  ``fused`` as the peak functions take
        it."""
        s = state if state is not None else self.state
        vals = self._pfunc(individual[..., None, :], s, fused)
        vals = torch.where(s.active, vals, float("-inf"))
        if self.basis_function is not None:
            basis = torch.as_tensor(self.basis_function(individual),
                                    dtype=vals.dtype, device=vals.device)
            vals = torch.cat([vals, basis.expand(vals.shape[:-1])[..., None]],
                             -1)
        return vals

    def evaluate(self, individual, state: PeaksState | None = None,
                 fused: bool = True):
        """Pure evaluation (the maximum over the peaks), no offline-error
        bookkeeping; jitted XLA's float form unless ``fused`` is false."""
        return self.peak_values(individual, state, fused).amax(-1),

    def __call__(self, individual, count=True):
        """Stateful evaluation with offline-error tracking."""
        if not torch.is_tensor(individual):
            individual = torch.as_tensor(np.asarray(individual, np.float32),
                                         device=self.state.height.device)
        fitness = float(self.evaluate(individual, fused=False)[0])
        if count:
            self.nevals += 1
            if self._optimum is None:
                self._optimum = self.globalMaximum()[0]
                self._error = abs(fitness - self._optimum)
            self._error = min(self._error, abs(fitness - self._optimum))
            self._offline_error += self._error
            if self.period > 0 and self.nevals % self.period == 0:
                self.changePeaks()
        return fitness,

    def _at_centers(self):
        s = self.state
        at = self._pfunc(s.position, s, False)
        return torch.where(s.active, at, float("-inf"))

    def globalMaximum(self):
        """Value and position of the highest peak."""
        at = self._at_centers()
        i = int(torch.argmax(at))
        return float(at[i]), self.state.position[i].cpu().numpy()

    def maximums(self):
        """All visible local maxima, best first."""
        s = self.state
        at = self._at_centers().cpu().numpy()
        seen = self.evaluate(s.position, fused=False)[0].cpu().numpy()
        active = s.active.cpu().numpy()
        out = [(float(at[i]), s.position[i].cpu().numpy())
               for i in range(self.cap) if active[i] and at[i] >= seen[i]]
        return sorted(out, key=lambda t: t[0], reverse=True)

    def offlineError(self):
        return self._offline_error / self.nevals if self.nevals else 0.0

    def currentError(self):
        return self._error

    # -- dynamics -----------------------------------------------------------

    def change_peaks_state(self, key, state: PeaksState,
                           fused: bool = True) -> PeaksState:
        """Functional peak update: a correlated position shift with
        reflection at both bounds, Gaussian height and width changes with
        reflection, and in the fluctuating mode the birth or death of
        peaks (slots ranked by a double stable argsort of ``inf``-masked
        priorities, the amount rounded half to even).  ``fused`` takes
        the jitted update's float forms, ``fused=False`` the op-by-op
        ones (the JAX package's ``changePeaks``)."""
        k_num, k_shift, k_h, k_w, k_new = random.split(key, 5)
        cap, dim = state.position.shape
        active = state.active

        if self.minpeaks is not None:
            ku1, ku2, kpick = random.split(k_num, 3)
            npeaks = active.sum()
            r = float(self.maxpeaks_n - self.minpeaks)
            u = random.uniform(ku1, ())
            amount = torch.round(r * random.uniform(ku2, ())
                                 * float(self.number_severity)).long()
            shrink = u < 0.5
            n_del = torch.minimum(npeaks - self.minpeaks, amount)
            n_add = torch.minimum(self.maxpeaks_n - npeaks, amount)
            prio = random.uniform(kpick, (cap,))
            inf = float("inf")

            def ranks(v):
                return torch.argsort(torch.argsort(v, stable=True),
                                     stable=True)

            act_rank = ranks(torch.where(active, prio, inf))
            inact_rank = ranks(torch.where(active, inf, prio))
            deactivate = active & (act_rank < n_del)
            activate = ~active & (inact_rank < n_add)
            new_active = torch.where(shrink, active & ~deactivate,
                                     active | activate)
            born = new_active & ~active
            kp, kh, kw, kc = random.split(k_new, 4)
            pos_new = random.uniform(kp, (cap, dim), minval=self.min_coord,
                                     maxval=self.max_coord)
            h_new = random.uniform(kh, (cap,), minval=self.min_height,
                                   maxval=self.max_height)
            w_new = random.uniform(kw, (cap,), minval=self.min_width,
                                   maxval=self.max_width)
            c_new = random.uniform(kc, (cap, dim)) - 0.5
            state = PeaksState(
                position=torch.where(born[:, None], pos_new, state.position),
                height=torch.where(born, h_new, state.height),
                width=torch.where(born, w_new, state.width),
                last_change=torch.where(born[:, None], c_new,
                                        state.last_change),
                active=new_active)
            active = new_active

        ms = float(self.move_severity)
        lam = float(np.float32(self.lambda_))
        shift = _normalized(random.uniform(k_shift, (cap, dim)) - 0.5, ms,
                            fused)
        if fused:
            shift = fma(shift, float(np.float32(1.0 - self.lambda_)),
                        lam * state.last_change)
        else:
            shift = (shift * float(np.float32(1.0 - self.lambda_))
                     + lam * state.last_change)
        shift = _normalized(shift, ms, fused)
        new_pos = state.position + shift
        low, high = float(self.min_coord), float(self.max_coord)
        reflect = (new_pos < low) | (new_pos > high)
        reflected = torch.where(new_pos < low, 2.0 * low - new_pos,
                                torch.where(new_pos > high,
                                            2.0 * high - new_pos, new_pos))
        final_shift = torch.where(reflect, -shift, shift)

        def bounce(value, change, lo, hi):
            new = value + change
            return torch.where(new < lo, (2.0 * lo - value) - change,
                               torch.where(new > hi,
                                           (2.0 * hi - value) - change, new))

        dh = _scaled_normal(k_h, (cap,), self.height_severity, fused)
        dw = _scaled_normal(k_w, (cap,), self.width_severity, fused)
        return PeaksState(
            position=reflected,
            height=bounce(state.height, dh, float(self.min_height),
                          float(self.max_height)),
            width=bounce(state.width, dw, float(self.min_width),
                         float(self.max_width)),
            last_change=final_shift,
            active=active)

    def changePeaks(self):
        """Move the peaks, in the op-by-op forms of the JAX package's
        stateful ``changePeaks``."""
        key, self.key = random.split(self.key)
        self.state = self.change_peaks_state(key, self.state, fused=False)
        self._optimum = None
