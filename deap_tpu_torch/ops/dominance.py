"""Dominance counts of a block of rows against every point — the PyTorch
counterpart of ``deap_tpu/ops/dominance_pallas.py``.

``rows_dominate_counts(rows, w)`` returns ``out[j] = #{r : rows[r]
dominates w[j]}`` in maximisation order (every objective ``>=``, at
least one ``>``).  ``-inf`` sentinel rows dominate nothing and a point
never dominates itself, which is what the front peel
(:mod:`deap_tpu_torch.ops.emo`) relies on.  On CUDA tensors it launches
K4 (``deap_tpu_torch/kernels/dominance.cu``), which takes any number of
rows and columns unpadded; on CPU tensors it runs the plain version.
Counts are integers, so the two are equal exactly.
"""

from __future__ import annotations

import torch

from ..base import dominates

__all__ = ["rows_dominate_counts"]

#: elements of one ``(rows, n, m)`` compare block of the plain version
_PLAIN_BLOCK = 1 << 26


def _rows_dominate_counts_plain(rows: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """``sum(dominates(rows[:, None], w[None]), 0)`` as int32, in row
    blocks so the broadcast compare stays bounded for any ``C``."""
    n, m = w.shape
    step = max(1, _PLAIN_BLOCK // max(1, n * m))
    out = torch.zeros((n,), dtype=torch.int32, device=w.device)
    for s in range(0, rows.shape[0], step):
        d = dominates(rows[s:s + step, None, :], w[None, :, :])
        out += d.sum(0, dtype=torch.int32)
    return out


def rows_dominate_counts(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dominator counts of ``rows`` ``(C, m)`` over the points ``w``
    ``(n, m)``, float32; ``(n,)`` int32.  CUDA tensors launch K4
    (replacing ``_counts_pallas``, ``deap_tpu/ops/dominance_pallas.py``)."""
    if rows.device != w.device:
        raise ValueError(f"rows on {rows.device}, w on {w.device}")
    if w.is_cuda:
        from .. import kernels
        return kernels.launch_rows_dominate_counts(rows, w)
    return _rows_dominate_counts_plain(rows, w)
