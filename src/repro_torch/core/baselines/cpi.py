"""Characteristic Polynomial Interpolation (CPI) set reconciliation
[Minsky, Trachtenberg, Zippel 2003] — the PinSketch/minisketch family's
ancestor.  Communication-optimal (m = d symbols), computation-heavy:
O(|A|·d) encode, O(d³) interpolation + root finding to decode (paper §2,
§7.2's 2–2000× computation-gap comparison).

Field: GF(p), p = 2³¹ − 1 (Mersenne; int64-safe products in numpy).  Items
are mapped into the field by a keyed hash, as PinSketch does for >8-byte
items; the recovered field elements are mapped back through a dictionary of
the parties' items (each party knows its own set).

Port of ``repro/core/baselines/cpi.py``: numpy, unchanged.
"""
from __future__ import annotations

import numpy as np

from ..hashing import DEFAULT_KEY, siphash24

P = np.int64(2**31 - 1)


def _to_field(words: np.ndarray, key=DEFAULT_KEY, nbytes=None) -> np.ndarray:
    h = siphash24(words, key, nbytes)
    return ((h >> np.uint64(8)) % np.uint64(P - 2)).astype(np.int64) + 1


def _pow(base: np.ndarray, e: int) -> np.ndarray:
    r = np.ones_like(base)
    b = base % P
    while e:
        if e & 1:
            r = (r * b) % P
        b = (b * b) % P
        e >>= 1
    return r


def _inv(x: np.ndarray) -> np.ndarray:
    return _pow(x, int(P) - 2)


# ------------------------------------------------------ polynomial helpers
def _poly_mod(a: np.ndarray, f: np.ndarray) -> np.ndarray:
    """a mod f over GF(p); coefficients low-to-high, f monic."""
    a = a.copy() % P
    df = len(f) - 1
    if df == 0:
        return np.zeros(1, np.int64)   # mod a nonzero constant
    while len(a) - 1 >= df and len(a) > 1:
        c = a[-1] % P
        if c:
            a[-df - 1:] = (a[-df - 1:] - c * f) % P
        a = a[:-1]
    return a


def _poly_mul(a, b, f=None):
    r = np.convolve(a.astype(object), b.astype(object))
    r = np.array([int(x) % int(P) for x in r], dtype=np.int64)
    if f is not None:
        r = _poly_mod(r, f)
    return r


def _poly_gcd(a, b):
    a, b = a.copy(), b.copy()
    while len(b) > 1 or (len(b) == 1 and b[0] != 0):
        a = _poly_mod(a, _monic(b))
        a, b = b, a
        while len(a) > 1 and a[-1] == 0:
            a = a[:-1]
        while len(b) > 1 and b[-1] == 0:
            b = b[:-1]
    return _monic(a)


def _monic(f):
    f = f % P
    while len(f) > 1 and f[-1] == 0:
        f = f[:-1]
    if f[-1] != 1 and f[-1] != 0:
        f = (f * _inv(f[-1:])[0]) % P
    return f


def _poly_pow_mod(base, e: int, f):
    r = np.array([1], np.int64)
    b = _poly_mod(base.copy(), f)
    while e:
        if e & 1:
            r = _poly_mul(r, b, f)
        b = _poly_mul(b, b, f)
        e >>= 1
    return r


def _roots(f: np.ndarray, rng: np.random.Generator) -> list[int]:
    """All roots of squarefree f with only linear factors (Cantor–Zassenhaus
    equal-degree splitting, degree 1)."""
    f = _monic(f)
    d = len(f) - 1
    if d == 0:
        return []
    if d == 1:
        return [int((-f[0]) % P)]
    # split via gcd((x+r)^((p-1)/2) - 1, f)
    for _ in range(64):
        r = int(rng.integers(0, int(P)))
        g = _poly_pow_mod(np.array([r, 1], np.int64), (int(P) - 1) // 2, f)
        g = g.copy()
        g[0] = (g[0] - 1) % P
        h = _poly_gcd(f, g)
        if 0 < len(h) - 1 < d:
            q = _poly_div_exact(f, h)
            return _roots(h, rng) + _roots(q, rng)
    raise RuntimeError("root splitting failed")


def _poly_div_exact(a, b):
    """a / b (exact) over GF(p), both monic."""
    a = _monic(a.copy() % P)
    b = _monic(b.copy() % P)
    if len(b) == 1:          # division by the constant 1 (monic)
        return a
    out = np.zeros(len(a) - len(b) + 1, np.int64)
    while len(a) >= len(b):
        c = a[-1] % P
        out[len(a) - len(b)] = c
        a[-len(b):] = (a[-len(b):] - c * b) % P
        a = a[:-1]
    return _monic(out)


# ----------------------------------------------------------------- sketch
class CPISketch:
    """Alice-side: m evaluations of χ_A at fixed points z_1..z_m."""

    def __init__(self, m: int, nbytes: int, key=DEFAULT_KEY):
        self.m = m
        self.nbytes = nbytes
        self.key = key
        self.n_items = 0  # transmitted with the sketch (Minsky et al. §3)
        self.z = (np.arange(1, m + 1, dtype=np.int64) * 7919) % P
        self.evals = np.ones(m, dtype=np.int64)
        self.field_to_item: dict[int, np.ndarray] = {}

    def insert(self, words: np.ndarray) -> None:
        vals = _to_field(words, self.key, self.nbytes)
        self.n_items += len(vals)
        for v, w in zip(vals.tolist(), words):
            self.field_to_item[v] = w
        # evals *= prod (z - x)  — vectorized over points, loop over items
        for v in vals.tolist():
            self.evals = (self.evals * ((self.z - v) % P)) % P

    def decode_against(self, other: "CPISketch", d_bound: int | None = None):
        """Recover A△B given the two sketches (Bob holds `other` = his own).

        Returns (vals_only_a, vals_only_b, success).  O(m³) solve — the
        computation cost the paper's §7.2 comparison highlights.

        y(z) = χ_A/χ_B = P/Q with P = χ_{A∖B}·G, Q = χ_{B∖A}·G.  The degree
        difference Δ = deg P − deg Q = |A| − |B| is known (item counts
        travel with the sketch), so we solve for monic P of degree t and
        monic Q of degree t−Δ and strip the common factor G with a gcd.
        """
        m = self.m
        if d_bound is None:
            d_bound = m
        delta = self.n_items - other.n_items
        # d = da + db, da - db = delta  =>  da = (d+delta)/2
        t = max((d_bound + delta + 1) // 2, delta, 0)
        dq = t - delta
        if t + dq > m:
            return None, None, False   # sketch too short for this bound
        y = (self.evals * _inv(other.evals)) % P
        # Σ_{j<t} p_j z^j − y·Σ_{j<dq} q_j z^j = y·z^dq − z^t
        zp = np.ones((m, max(t, dq) + 1), np.int64)
        for j in range(1, zp.shape[1]):
            zp[:, j] = (zp[:, j - 1] * self.z) % P
        Amat = np.concatenate(
            [zp[:, :t], (-(y[:, None] * zp[:, :dq]) % P) % P], axis=1)
        rhs = ((y * zp[:, dq] - zp[:, t]) % P + P) % P
        sol, ok = _solve_mod(Amat, rhs)
        if not ok:
            return None, None, False
        pcoef = np.concatenate([sol[:t], [1]]).astype(np.int64)
        qcoef = np.concatenate([sol[t:], [1]]).astype(np.int64)
        rng = np.random.default_rng(0xC0FFEE)
        try:
            g = _poly_gcd(pcoef.copy(), qcoef.copy())
            pp = _poly_div_exact(_monic(pcoef), g)
            qq = _poly_div_exact(_monic(qcoef), g)
            ra = _roots(pp, rng)
            rb = _roots(qq, rng)
        except Exception:
            return None, None, False
        if len(ra) != len(pp) - 1 or len(rb) != len(qq) - 1:
            return None, None, False
        return ra, rb, True


def _solve_mod(A: np.ndarray, b: np.ndarray):
    """Gaussian elimination over GF(p); returns minimal-norm-ish solution.
    Handles rank deficiency by setting free vars to 0 (smaller true d)."""
    A = A % P
    b = b % P
    m, n = A.shape
    A = np.concatenate([A, b[:, None]], axis=1)
    row = 0
    piv_cols = []
    for col in range(n):
        piv = None
        for r in range(row, m):
            if A[r, col] != 0:
                piv = r
                break
        if piv is None:
            continue
        A[[row, piv]] = A[[piv, row]]
        A[row] = (A[row] * _inv(A[row, col:col + 1])[0]) % P
        mask = np.ones(m, bool)
        mask[row] = False
        factors = A[mask, col:col + 1]
        A[mask] = (A[mask] - factors * A[row]) % P
        piv_cols.append(col)
        row += 1
        if row == m:
            break
    # inconsistency?
    for r in range(row, m):
        if A[r, :n].max(initial=0) == 0 and A[r, n] != 0:
            return None, False
    x = np.zeros(n, np.int64)
    for r, c in enumerate(piv_cols):
        x[c] = A[r, n]
    return x, True
