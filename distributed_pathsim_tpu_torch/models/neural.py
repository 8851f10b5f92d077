"""Neural PathSim's quadrature helpers: the analytic Cauchy map's grid.

The rowsum-variant score 2·(C_i·C_j)/(d_i+d_j) looks non-factorizable
because the denominator couples i and j additively, but the Cauchy
kernel identity 1/(d_i+d_j) = ∫₀^∞ e^(-t·d_i) · e^(-t·d_j) dt turns it
into an inner product: with log-spaced quadrature nodes t_k and weights
w_k, φ(j) = vec_k( sqrt(2·w_k) · e^(-d_j·t_k) · C_j ) satisfies
φ(i)·φ(j) ≈ score(i,j) to a few percent relative error. The ANN index
(index/build.py) embeds every node with that map.

This module holds the port's copy of the JAX package's
``models/neural.py`` helpers the index needs (host numpy, unchanged):
the quadrature grid, its gates and the grid width ``QUAD_M``. The
learned tier's serving lane lives in ``learned/``; the two-tower trainer
and its checkpoint extend this module when training is ported.
"""

from __future__ import annotations

import numpy as np

# Quadrature width of the structural index: m log-spaced nodes cover the
# full observed range of 2·d with ~3% max relative error (the JAX
# package's NeuralPathSim.QUAD_M).
QUAD_M = 12


def cauchy_quadrature(
    d: np.ndarray, m: int = 12, margin: float = 2.0
) -> tuple[np.ndarray, np.ndarray]:
    """Log-spaced quadrature (nodes t, weights w) for the Cauchy kernel
    identity 1/(d_i+d_j) = ∫₀^∞ e^(-t·d_i)·e^(-t·d_j) dt over the
    observed denominator range: s = d_i + d_j ∈ [2·min d⁺, 2·max d],
    extended by ``margin`` on each side in u = log t (the trapezoid
    rule needs tail room for uniform relative accuracy)."""
    d = np.asarray(d, dtype=np.float64)
    dpos = d[d > 0]
    if not dpos.size:  # degenerate graph: every denominator is zero
        return np.zeros(m), np.zeros(m)
    s_lo = max(2.0 * float(dpos.min()), 1e-12)
    s_hi = max(2.0 * float(dpos.max()), s_lo * (1.0 + 1e-9))
    u = np.linspace(
        np.log(1.0 / s_hi) - margin, np.log(1.0 / s_lo) + margin, m
    )
    h = float(u[1] - u[0]) if m > 1 else 1.0
    t = np.exp(u)
    return t, h * t


def quadrature_gates(d: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Denominator gates E[j,k] = e^(-d_j·t_k) ∈ [0,1] (f32): the
    complete quadrature picture of 1/(d_j + ·)."""
    return np.exp(
        -np.clip(
            np.asarray(d, np.float64)[:, None] * np.asarray(t)[None, :],
            0.0, 700.0,
        )
    ).astype(np.float32)
