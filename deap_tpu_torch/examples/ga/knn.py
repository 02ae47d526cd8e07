"""Masked-feature k-nearest-neighbour classifier — the port's counterpart
of ``examples/ga/knn.py``, the fitness model of the evoknn
feature-selection GAs, on the same deterministic synthetic stand-in for
``heart_scale.csv`` (270 samples x 13 features, 6 informative).

:func:`knn_accuracy` takes one mask ``(13,)`` or a batch ``(n, 13)``:
the test-by-train squared distances of the masked coordinates (each
square fused into the sum, as XLA compiles the vmapped evaluation), the
``k`` nearest by a stable sort (``lax.top_k``'s order: the lower index
first on ties), their majority vote (ties to class 1), and the rate of
correct labels (XLA's mean)."""

from __future__ import annotations

import numpy as np
import torch

from ..._device import resolve_device
from ..._xla_math import fma_product, row_dot, row_mean

N_SAMPLES, N_FEATURES, N_INFORMATIVE = 270, 13, 6
N_TRAIN, K = 175, 1


def make_dataset(seed: int = 7, device=None):
    """The JAX example's synthetic set (numpy ``RandomState(seed)``):
    class centres differ on the first N_INFORMATIVE features only."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, N_SAMPLES).astype(np.float32)
    centers = np.zeros((2, N_FEATURES), np.float32)
    centers[0, :N_INFORMATIVE] = -1.0
    centers[1, :N_INFORMATIVE] = 1.0
    X = centers[labels.astype(int)] + rng.normal(
        0, 1.2, (N_SAMPLES, N_FEATURES)).astype(np.float32)
    perm = rng.permutation(N_SAMPLES)
    dev = resolve_device(device)
    return (torch.tensor(X[perm], device=dev),
            torch.tensor(labels[perm], device=dev))


def _masked_distances(features, diff):
    """``sum_j (diff_j * f_j)²`` for each mask ``f`` of ``features``, each
    square fused into the running sum (XLA's form in the vmapped
    evaluation).  A 0/1 mask keeps ``diff_j`` whole or zeroes it, and a
    zero product leaves the sum as it is, so the chain adds the exact
    square of each selected feature, in order, one rounding a step.
    The float64 sum of a square and the float32 sum rounds straight to
    the fused result unless it is inexact and lies on a float32
    midpoint; if any is, the chain is recomputed with exact fused
    multiply-adds."""
    binary = bool(((features == 0) | (features == 1)).all())
    if not binary:
        d = diff * features[..., None, None, :]
        return row_dot(d, d, fused=True)
    sq = diff.double() * diff.double()                # exact squares
    f = features.to(torch.bool)[..., None, None, :]

    def chain(add):
        s = torch.where(f[..., 0], sq[..., 0].float(), 0.0)
        for j in range(1, diff.shape[-1]):
            s = torch.where(f[..., j], add(sq[..., j], s), s)
        return s

    inexact_midpoint = []

    def straight(p, s):
        c = s.double()
        t = p + c
        mid = (t.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
        if bool(mid.any()):             # rare: is that float64 sum inexact?
            tp, tc, tt = p.expand_as(t)[mid], c[mid], t[mid]
            bv = tt - tp
            inexact_midpoint.append(bool(((tp - (tt - bv)) + (tc - bv)
                                          != 0).any()))
        return t.float()

    s = chain(straight)
    if any(inexact_midpoint):
        s = chain(fma_product)
    return s


def knn_accuracy(features, train_x, train_y, test_x, test_y, k: int = K):
    """Classification rate of masked-feature kNN for each mask of
    ``features`` (``(..., n_features)``)."""
    diff = test_x[:, None, :] - train_x[None, :, :]
    dist = _masked_distances(features, diff)          # (..., ntest, ntrain)
    nn = torch.sort(dist, dim=-1, stable=True).indices[..., :k]
    votes = train_y[nn]
    pred = (row_mean(votes) >= 0.5).to(test_y.dtype)
    return row_mean((pred == test_y).to(torch.float32))


if __name__ == "__main__":
    X, y = make_dataset()
    acc_all = knn_accuracy(torch.ones(N_FEATURES, device=X.device),
                           X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:])
    informative = (torch.arange(N_FEATURES, device=X.device)
                   < N_INFORMATIVE).to(torch.float32)
    acc_inf = knn_accuracy(informative, X[:N_TRAIN], y[:N_TRAIN],
                           X[N_TRAIN:], y[N_TRAIN:])
    print(f"all features: {float(acc_all):.3f}  "
          f"informative only: {float(acc_inf):.3f}")
