"""Numerics for the paper's error analysis (Section 5).

Implements, for arbitrary value distributions given as (pdf, cdf) callables:

  * Theorem 5.2 / Eq. (6)  — probability the upper-bound sketch overestimates
  * Corollary 5.3 / Eq. (12) — Gaussian closed form for that probability
  * Theorem 5.4 / Eq. (13) — CDF of the overestimation error Z̄
  * Lemma 5.5 / Eq. (16)  — expected overestimation error
  * Corollary 5.6 / Eq. (17) — Gaussian closed-form error CDF
  * Lemma 5.7 / Eq. (18)  — sketch-size sizing rule m(δ, ε, h)
  * Theorem 5.8 / Eq. (19) — the standardised inner-product error Z
    (construction of the statistic; normality is validated empirically in
    benchmarks/fig5_z_normality.py)

All integrals are trapezoid quadrature on numpy grids; these functions are the
oracles that tests and benchmarks compare Monte-Carlo measurements against
(paper Tables 1–2, Figures 4–5, 7).

A copy of ``repro.core.theory`` (numpy only), so that the port imports
nothing of the JAX package; the parity tests hold the two equal.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Distributions (paper Table 1 rows)
# ---------------------------------------------------------------------------

def uniform_dist(lo: float = -1.0, hi: float = 1.0):
    pdf = lambda a: np.where((a >= lo) & (a <= hi), 1.0 / (hi - lo), 0.0)
    cdf = lambda a: np.clip((a - lo) / (hi - lo), 0.0, 1.0)
    grid = np.linspace(lo, hi, 4001)
    return pdf, cdf, grid


def gaussian_dist(mu: float = 0.0, sigma: float = 1.0):
    pdf = lambda a: np.exp(-0.5 * ((a - mu) / sigma) ** 2) / (
        sigma * math.sqrt(2 * math.pi))
    cdf = lambda a: 0.5 * (1 + _erf((a - mu) / (sigma * math.sqrt(2))))
    grid = np.linspace(mu - 8 * sigma, mu + 8 * sigma, 4001)
    return pdf, cdf, grid


def lognormal_dist(sigma: float = 1.0, mu: float = 0.0):
    """Log-normal non-negative values — the text-like collections' value law
    (paper Table 3 / Fig. 6(a); what ``repro_torch.data.synth``'s *_like
    datasets draw).  Lets the generic Eq. (6)/(13) quadratures bound the sketch
    overestimate on SPLADE/BM25-shaped corpora, not just the Table 1 rows.
    """
    s2 = sigma * math.sqrt(2)

    def pdf(a):
        a = np.asarray(a, np.float64)
        safe = np.maximum(a, 1e-300)
        return np.where(a > 0,
                        np.exp(-0.5 * ((np.log(safe) - mu) / sigma) ** 2)
                        / (safe * sigma * math.sqrt(2 * math.pi)), 0.0)

    def cdf(a):
        a = np.asarray(a, np.float64)
        safe = np.maximum(a, 1e-300)
        return np.where(a > 0, 0.5 * (1 + _erf((np.log(safe) - mu) / s2)),
                        0.0)

    grid = np.linspace(0.0, math.exp(mu + 8 * sigma), 8001)
    return pdf, cdf, grid


def zeta_dist(s: float, support_lo: float = -1.0, support_hi: float = 1.0,
              levels: int = 2 ** 10):
    """Paper Table 1: Zeta(s) over [-1, 1] quantised into 2^10 discrete values.

    Probability mass ∝ rank^{-s} assigned to levels spanning the interval,
    largest mass on the smallest |value| ranks — returned as a discrete
    (values, pmf) pair wrapped into pdf/cdf callables via step functions.
    """
    ranks = np.arange(1, levels + 1, dtype=np.float64)
    pmf = ranks ** (-s)
    pmf /= pmf.sum()
    values = np.linspace(support_lo, support_hi, levels)
    order = np.argsort(values)
    v_sorted = values[order]
    p_sorted = pmf[order]
    cum = np.cumsum(p_sorted)

    def cdf(a):
        a = np.asarray(a, np.float64)
        pos = np.searchsorted(v_sorted, a, side="right")
        return np.where(pos == 0, 0.0, cum[np.clip(pos - 1, 0, levels - 1)])

    # "pdf" as discrete pmf lookup on the grid (used only via the grid below).
    def pdf(a):
        a = np.asarray(a, np.float64)
        pos = np.clip(np.searchsorted(v_sorted, a), 0, levels - 1)
        spacing = v_sorted[1] - v_sorted[0]
        return p_sorted[pos] / spacing

    return pdf, cdf, v_sorted


def _erf(x):
    return np.vectorize(math.erf)(x)


# ---------------------------------------------------------------------------
# Theorem 5.2 — probability of overestimation
# ---------------------------------------------------------------------------

def prob_overestimate(pdf: Callable, cdf: Callable, grid: np.ndarray,
                      sum_p: float, m: int, h: int) -> float:
    """Eq. (6): P[X̄_i > X_i] ≈ ∫ [1 - e^{-(h/m)(1-Φ(α)) Σp}]^h φ(α) dα."""
    a = grid
    inner = (1.0 - np.exp(-(h / m) * (1.0 - cdf(a)) * sum_p)) ** h
    return float(np.trapezoid(inner * pdf(a), a))


def prob_overestimate_gaussian_closed(m: int, h: int, n: int, p: float) -> float:
    """Eq. (12): closed form for standard-Gaussian values."""
    beta = (n - 1) * p / m
    total = 1.0
    for k in range(1, h + 1):
        total += (math.comb(h, k) * (-1.0) ** k
                  * (1.0 / (k * h * beta))
                  * (1.0 - math.exp(-k * h * beta)))
    return total


# ---------------------------------------------------------------------------
# Theorem 5.4 / Lemma 5.5 — error CDF and expectation
# ---------------------------------------------------------------------------

def error_cdf(delta, pdf, cdf, grid, sum_p: float, m: int, h: int):
    """Eq. (13): P[Z̄ ≤ δ | active] ≈ 1 - ∫ [1 - e^{-(h/m)(1-Φ(α+δ))Σp}]^h φ dα."""
    delta = np.atleast_1d(np.asarray(delta, np.float64))
    a = grid[None, :]
    d = delta[:, None]
    inner = (1.0 - np.exp(-(h / m) * (1.0 - cdf(a + d)) * sum_p)) ** h
    out = 1.0 - np.trapezoid(inner * pdf(a), grid, axis=-1)
    return out if out.size > 1 else float(out[0])


def expected_error(pdf, cdf, grid, sum_p: float, m: int, h: int,
                   delta_max: float = None, n_delta: int = 600) -> float:
    """Eq. (16): E[Z̄ | active] = ∫_0^∞ P[Z̄ ≥ δ] dδ (truncated quadrature)."""
    if delta_max is None:
        delta_max = float(grid[-1] - grid[0])
    deltas = np.linspace(0.0, delta_max, n_delta)
    tail = 1.0 - np.asarray(error_cdf(deltas, pdf, cdf, grid, sum_p, m, h))
    return float(np.trapezoid(tail, deltas))


def error_cdf_gaussian_closed(delta, sigma: float, m: int, h: int,
                              n: int, p: float):
    """Eq. (17): closed-form CDF for Gaussian(0, σ) values.

    Φ' is the CDF of a zero-mean Gaussian with std σ√2 (difference of two
    coordinate values).
    """
    delta = np.asarray(delta, np.float64)
    phi2 = 0.5 * (1 + _erf(delta / (sigma * math.sqrt(2) * math.sqrt(2))))
    return 1.0 - (1.0 - np.exp(-(h * (n - 1) * p / m) * (1.0 - phi2))) ** h


def required_m(delta: float, eps: float, h: int, n: int, p: float,
               sigma: float) -> float:
    """Lemma 5.7 / Eq. (18): sketch size m for P[Z̄ > δ] < ε."""
    phi2 = 0.5 * (1 + math.erf(delta / (sigma * 2.0)))
    return -h * (n - 1) * p * (1.0 - phi2) / math.log(1.0 - eps ** (1.0 / h))


# ---------------------------------------------------------------------------
# Theorem 5.8 — the standardised inner-product error statistic Z
# ---------------------------------------------------------------------------

def z_statistic(ip_err: np.ndarray, q_vals: np.ndarray, p_active: float,
                mu_active: float, var_uncond: float) -> np.ndarray:
    """Eq. (19) with homogeneous coordinate statistics.

    ip_err: observed ⟨q, x̃ - x⟩ per query-document pair.
    q_vals: [ψ_q] the query's non-zero entries.
    mu_active: E[Z_i | active] (from :func:`expected_error`).
    var_uncond: Var[Z_i] of the unconditional error (mixture of 0 w.p. 1-p
    and the active error w.p. p) — see :func:`unconditional_moments`.
    """
    shift = p_active * mu_active * float(np.sum(q_vals))
    scale = math.sqrt(var_uncond * float(np.sum(q_vals ** 2))) + 1e-30
    return (ip_err - shift) / scale


def unconditional_moments(p_active: float, mu_active: float,
                          var_active: float) -> Tuple[float, float]:
    """§5.2 closing remark: E[Z̄]=pμ, Var(Z̄)=pσ² + p(1-p)μ²."""
    mean = p_active * mu_active
    var = p_active * var_active + p_active * (1 - p_active) * mu_active ** 2
    return mean, var
