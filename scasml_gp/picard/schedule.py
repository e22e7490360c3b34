"""Host-side static schedules for the multilevel Picard recursion.

The reference recomputes level tables (Lambert-W inverse-Gamma, Gauss-Legendre
nodes by Newton iteration in Python loops) inside every ``uz_solve`` call
(reference ``solvers/MLP.py:57-139,154``).  Here they are built ONCE on the
host in float64 numpy (SURVEY.md §7 step 4): the recursion tree for a given
(n, rho) is then completely static, so the whole rollout compiles to one XLA
program with fixed shapes.

Also provides the analytic evaluation counters replacing the reference's
Python-side ``self.evaluation_counter`` increments (solvers/MLP.py:24,193,...).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
from scipy.special import lambertw


def inverse_gamma(x: np.ndarray) -> np.ndarray:
    """Approximate inverse of the Gamma function (reference solvers/MLP.py:57-69)."""
    c = 0.036534
    L = np.log((np.asarray(x, np.float64) + c) / np.sqrt(2 * np.pi))
    return np.real(L / np.real(lambertw(L / np.e)) + 0.5)


def leggauss(npts: int, a: float, b: float):
    """Gauss-Legendre nodes/weights on [a, b], ascending.

    Replaces the reference's hand-rolled Newton iteration ``lgwt``
    (solvers/MLP.py:71-109) with numpy's exact Golub-Welsch nodes; the
    reference reverses its descending output, so both are ascending.
    """
    y, w = np.polynomial.legendre.leggauss(npts)
    x = 0.5 * (b - a) * y + 0.5 * (b + a)
    return x, 0.5 * (b - a) * w


class PicardTables(NamedTuple):
    """Static level tables for the quadrature variant
    (semantics of reference ``approx_parameters``, solvers/MLP.py:111-139)."""

    Mf: np.ndarray   # (rhomax, rhomax) int — MC counts for interior f terms
    Mg: np.ndarray   # (rhomax, rhomax+1) int — MC counts for terminal g terms
    Q: np.ndarray    # (rhomax, rhomax) int — quadrature point counts
    c: np.ndarray    # (qmax, qmax) float64 — nodes on [0, T], column k-1 has k
    w: np.ndarray    # (qmax, qmax) float64 — weights


@functools.lru_cache(maxsize=None)
def approx_parameters(
    rhomax: int, T: float, backend: str = "auto"
) -> PicardTables:
    """Build the level tables; 'auto' prefers the native C++ builder
    (scasml_gp.utils.native / native/schedule.cc) and falls back to the
    pure-Python path ('python') when no toolchain is available."""
    rhomax = int(rhomax)
    if backend in ("auto", "native"):
        from scasml_gp.utils.native import native_picard_tables

        out = native_picard_tables(rhomax, float(T))
        if out is not None:
            Mf, Mg, Q, c, w = out
            return PicardTables(Mf=Mf, Mg=Mg, Q=Q, c=c, w=w)
        if backend == "native":
            raise RuntimeError("native schedule library unavailable")
    Q = np.zeros((rhomax, rhomax), dtype=np.int64)
    Mf = np.zeros((rhomax, rhomax), dtype=np.int64)
    Mg = np.zeros((rhomax, rhomax + 1), dtype=np.int64)
    for rho in range(1, rhomax + 1):
        for k in range(1, rho + 1):
            Q[rho - 1, k - 1] = int(np.round(inverse_gamma(rho ** (k / 2.0))))
            Mf[rho - 1, k - 1] = int(np.round(rho ** (k / 2.0)))
            Mg[rho - 1, k - 1] = int(np.round(float(rho ** (k - 1))))
        Mg[rho - 1, rho] = rho**rho
    qmax = int(Q.max()) if Q.size else 0
    qmax = max(qmax, 1)
    c = np.zeros((qmax, qmax))
    w = np.zeros((qmax, qmax))
    for k in range(1, qmax + 1):
        ck, wk = leggauss(k, 0.0, T)
        c[:k, k - 1] = ck
        w[:k, k - 1] = wk
    return PicardTables(Mf=Mf, Mg=Mg, Q=Q, c=c, w=w)


# ---------------------------------------------------------------- counters
@functools.lru_cache(maxsize=None)
def count_evaluations_quadrature(
    n: int, rho: int, T: float, count_fg: bool = False
) -> int:
    """Per-call evaluation count of the quadrature recursion, replicating the
    reference's increments (solvers/MLP.py:193,245,266: += MC_g per uz_solve
    call — including the n==0 early return — and += MC_f per f evaluation;
    with ``count_fg`` additionally +1 per f/g call as in solvers/ScaSML.py:41,59).
    """
    tables = approx_parameters(rho, T)
    Mf, Mg, Q = tables.Mf, tables.Mg, tables.Q

    @functools.lru_cache(maxsize=None)
    def rec(lvl: int) -> int:
        total = int(Mg[rho - 1, lvl]) + (1 if count_fg else 0)  # terminal pass
        if lvl == 0:
            return total
        for l in range(lvl):
            q = int(Q[rho - 1, lvl - l - 1])
            mf = int(Mf[rho - 1, lvl - l - 1])
            for _ in range(q):
                total += rec(l) + mf + (1 if count_fg else 0)
                if l:
                    total += rec(l - 1) + mf + (1 if count_fg else 0)
        return total

    return rec(n)


@functools.lru_cache(maxsize=None)
def count_evaluations_full_history(
    n: int, M: int, scasml_variant: bool = False, count_fg: bool = False
) -> int:
    """Per-call evaluation count of the full-history recursion
    (solvers/MLP_full_history.py:114,154,172 increments += MC_g then += MC_f
    per f evaluation; the ScaSML variant increments MC_g in the loop instead —
    solvers/ScaSML_full_history.py:165,183)."""

    @functools.lru_cache(maxsize=None)
    def rec(lvl: int) -> int:
        mc_g = M**lvl
        total = mc_g + (1 if count_fg else 0)
        if lvl == 0:
            return total
        for l in range(lvl):
            mc_f = M ** (lvl - l)
            inc = mc_g if scasml_variant else mc_f
            total += rec(l) + inc + (1 if count_fg else 0)
            if l:
                total += rec(l - 1) + inc + (1 if count_fg else 0)
        return total

    return rec(n)
