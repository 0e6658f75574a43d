"""Inverse-distance-weighted finite-difference gradient estimation (Eq. 3).

Compound AI workflows are non-differentiable, so COMPASS-V estimates a
per-axis accuracy gradient at configuration ``c`` by interpolating accuracy
differences from the k nearest *evaluated* configurations, weighted by inverse
distance in the normalized [0,1]^n embedding:

    v_i(c) = sum_{n in N_k(c)} w_n * (dAcc_n / dx_i)  /  sum w_n,
    w_n = d(c, n)^{-p}
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .space import Config, ConfigSpace


@dataclass(frozen=True)
class GradientEstimate:
    vector: Tuple[float, ...]       # one component per parameter axis
    support: int                    # number of neighbors used

    @property
    def magnitude(self) -> float:
        return math.sqrt(sum(v * v for v in self.vector))


def idw_gradient(
    space: ConfigSpace,
    config: Config,
    evaluated: Dict[Config, float],
    *,
    k: int = 8,
    power: float = 2.0,
    eps: float = 1e-9,
) -> GradientEstimate:
    """Estimate the accuracy gradient at ``config`` from evaluated neighbors.

    For each of the k nearest evaluated configurations ``n`` (excluding
    ``config`` itself), the per-axis finite difference is
    ``dAcc / dx_i = (Acc(n) - Acc(c)) * (x_i(n) - x_i(c)) / |x(n) - x(c)|^2``
    — the directional difference projected back on axis i — and the estimates
    are combined with inverse-distance weights ``w_n = d^{-p}`` (Eq. 3).
    """
    if config not in evaluated:
        raise KeyError("config must itself be evaluated to take differences")
    acc_c = evaluated[config]
    xc = space.normalize(config)
    n_axes = space.num_parameters

    # Vectorized nearest-neighbor selection.  The distance math accumulates
    # axis-by-axis columns in the same order as the scalar
    # ``sum((x - y) ** 2 ...)`` (and the embeddings come from the same
    # memoized normalize()), so distances — and therefore the selected
    # neighbor set, the stable tie-break, and the final gradient — are
    # bit-identical to the historical per-pair Python loop.
    others: List[Config] = [c for c in evaluated.keys() if c != config]
    if not others:
        return GradientEstimate(vector=(0.0,) * n_axes, support=0)
    emb = np.array([space.normalize(c) for c in others], dtype=float)
    d2 = np.zeros(len(others), dtype=float)
    for i in range(n_axes):
        diff = emb[:, i] - xc[i]
        d2 += diff * diff
    dist = np.sqrt(d2)
    kept = np.flatnonzero(dist > eps)
    if kept.size == 0:
        return GradientEstimate(vector=(0.0,) * n_axes, support=0)
    sel = kept[np.argsort(dist[kept], kind="stable")[:k]]

    num = [0.0] * n_axes
    den = 0.0
    for t in sel:
        d = float(dist[t])
        other = others[t]
        w = d ** (-power)
        xo = space.normalize(other)
        dacc = evaluated[other] - acc_c
        d2s = d * d
        for i in range(n_axes):
            dx = xo[i] - xc[i]
            if abs(dx) > eps:
                num[i] += w * dacc * dx / d2s
        den += w
    vec = tuple(v / den for v in num)
    return GradientEstimate(vector=vec, support=int(sel.size))


def low_gradient_axes(grad: GradientEstimate, *, fraction: float = 0.5) -> List[int]:
    """Axes whose |gradient| is in the lowest ``fraction`` — lateral expansion
    explores along these to trace the feasible boundary (paper §IV-B)."""
    mags = [abs(v) for v in grad.vector]
    order = sorted(range(len(mags)), key=lambda i: mags[i])
    n = max(1, int(math.ceil(len(mags) * fraction)))
    return order[:n]
