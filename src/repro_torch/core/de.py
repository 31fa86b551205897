"""Density evolution for Rateless IBLT (paper §5, Theorem 5.1).

Port of ``repro/core/de.py``: pure math, unchanged.

Decoding succeeds w.h.p. iff  exp((1/α)·Ei(−q/(αη))) < q  for all q ∈ (0,1].
η*(α) is the smallest feasible η — the asymptotic communication overhead
(η*(0.5) ≈ 1.35, Corollary 5.2).  Self-contained Ei implementation (no scipy
dependency).
"""
from __future__ import annotations

import math

import numpy as np

_EULER = 0.5772156649015328606


def e1(y: float) -> float:
    """Exponential integral E1(y), y > 0.  Ei(−y) = −E1(y)."""
    if y <= 0:
        raise ValueError("E1 domain is y > 0")
    if y <= 1.0:
        # series: E1 = −γ − ln y + Σ (−1)^{k+1} y^k / (k·k!)
        s = 0.0
        term = 1.0
        for k in range(1, 40):
            term *= -y / k
            s -= term / k
        return -_EULER - math.log(y) + s
    # continued fraction (Lentz): E1 = e^{-y} · 1/(y+1−1/(y+3−4/(y+5−…)))
    b = y + 1.0
    c = 1e308
    d = 1.0 / b
    h = d
    for k in range(1, 200):
        a = -k * k
        b += 2.0
        d = 1.0 / (a * d + b)
        c = b + a / c
        dl = c * d
        h *= dl
        if abs(dl - 1.0) < 1e-15:
            break
    return h * math.exp(-y)


def ei_neg(y: float) -> float:
    """Ei(−y) for y > 0."""
    return -e1(y)


def f_limit(q: np.ndarray, eta: float, alpha: float = 0.5) -> np.ndarray:
    """lim_{n→∞} f(q) = exp((1/α)·Ei(−q/(αη)))  (Theorem 5.1)."""
    q = np.asarray(q, dtype=np.float64)
    vals = np.array([math.exp(ei_neg(max(x, 1e-300) / (alpha * eta)) / alpha)
                     for x in q.ravel()])
    return vals.reshape(q.shape)


def feasible(eta: float, alpha: float = 0.5, grid: int = 4000) -> bool:
    """Check Eq. 2:  f_limit(q) < q for all q ∈ (0, 1]."""
    q = np.concatenate([np.logspace(-8, 0, grid // 2),
                        np.linspace(1e-4, 1.0, grid // 2)])
    return bool(np.all(f_limit(q, eta, alpha) < q))


def eta_star(alpha: float = 0.5, tol: float = 1e-4) -> float:
    """Smallest feasible η — the asymptotic overhead for this α."""
    lo, hi = 0.5, 8.0
    assert feasible(hi, alpha)
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if feasible(mid, alpha):
            hi = mid
        else:
            lo = mid
    return hi


def recovered_fraction(eta: float, alpha: float = 0.5, iters: int = 10_000):
    """Fixed point of q ← f(q): expected unrecovered fraction (Fig. 5)."""
    q = 1.0
    for _ in range(iters):
        nq = float(f_limit(np.array([q]), eta, alpha)[0])
        if abs(nq - q) < 1e-12:
            break
        q = nq
    return 1.0 - q
