"""COUNT / SUM confidence intervals and the unknown-N bound (paper §4.1).

* ``selectivity_ci``  — Lemma 5: Hoeffding-Serfling on the {0,1} view-membership
  indicator column of the scramble.
* ``count_ci``        — selectivity CI scaled by the scramble size R.
* ``n_plus``          — Theorem 3's high-probability upper bound N+ on the
  (unknown) aggregate-view size, with error split alpha (paper uses 0.99).
* ``sum_ci``          — union-bound product of COUNT and AVG CIs, with the
  sign-safe generalization of the paper's [c_l*g_l, c_r*g_r] form.

Every function is elementwise over numpy arrays — pass the per-group
member-count vector ``m_v`` (and optionally per-group ``r``) and get
vectors back — while plain Python floats in produce plain floats out, so
the scalar call sites (tests, ``optstop``) are unchanged.

A numpy port of the host path of :mod:`repro.core.count_sum`.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

__all__ = ["selectivity_ci", "count_ci", "n_plus", "sum_ci",
           "ALPHA_DEFAULT"]

ALPHA_DEFAULT = 0.99

ArrayLike = Union[float, np.ndarray]


def _unwrap(x: np.ndarray, scalar: bool):
    return float(x) if scalar else x


def _is_scalar(*xs) -> bool:
    return all(np.ndim(x) == 0 for x in xs)


def _serfling_eps(r: np.ndarray, R: ArrayLike, delta: float) -> np.ndarray:
    """sqrt(log(1/delta)/(2r) * (1 - (r-1)/R)) — range (b-a)=1 indicator.

    Returns 1.0 (the trivial bound) wherever ``r <= 0``."""
    rho = np.maximum(1.0 - (r - 1.0) / np.asarray(R, np.float64), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        eps = np.sqrt(np.log(1.0 / delta) * rho / (2.0 * r))
    return np.where(r > 0, eps, 1.0)


def selectivity_ci(m_v: ArrayLike, r: ArrayLike, R: ArrayLike,  # aqplint: disable=AQP201(host-only slice of the port: its device twins come with the device-loop slice)
                   delta: float) -> Tuple[ArrayLike, ArrayLike]:
    """Lemma 5: two-sided (1-delta) CI for the view selectivity sigma_V after
    seeing ``m_v`` member rows among ``r`` scanned of an R-row scramble."""
    scalar = _is_scalar(m_v, r, R)
    m_v = np.asarray(m_v, np.float64)
    r = np.asarray(r, np.float64)
    eps = _serfling_eps(r, R, delta / 2.0)  # delta/2 per side (log(2/delta))
    with np.errstate(divide="ignore", invalid="ignore"):
        est = m_v / np.maximum(r, 1.0)
    lo = np.where(r > 0, np.maximum(est - eps, 0.0), 0.0)
    hi = np.where(r > 0, np.minimum(est + eps, 1.0), 1.0)
    return _unwrap(lo, scalar), _unwrap(hi, scalar)


def count_ci(m_v: ArrayLike, r: ArrayLike, R: ArrayLike,  # aqplint: disable=AQP201(host-only slice of the port: its device twins come with the device-loop slice)
             delta: float) -> Tuple[ArrayLike, ArrayLike]:
    """(1-delta) CI for the number of rows in the aggregate view."""
    lo, hi = selectivity_ci(m_v, r, R, delta)
    return (lo * R, hi * R)


def n_plus(m_v: ArrayLike, r: ArrayLike, R: ArrayLike, delta: float,  # aqplint: disable=AQP201(host-only slice of the port: its device twins come with the device-loop slice)
           alpha: float = ALPHA_DEFAULT) -> ArrayLike:
    """Theorem 3: N+ = (m_v/r + sqrt(log(1/((1-alpha) delta)) rho / (2r))) R,
    an upper bound on N failing w.p. < (1-alpha)*delta. The remaining
    alpha*delta budget goes to the AVG bounder evaluated with N+."""
    scalar = _is_scalar(m_v, r, R)
    m_v = np.asarray(m_v, np.float64)
    r = np.asarray(r, np.float64)
    R_arr = np.asarray(R, np.float64)
    eps = _serfling_eps(r, R, (1.0 - alpha) * delta)
    with np.errstate(divide="ignore", invalid="ignore"):
        npl = np.minimum((m_v / np.maximum(r, 1.0) + eps) * R_arr, R_arr)
    out = np.where(r > 0, npl, R_arr)
    return _unwrap(out, scalar)


def sum_ci(count: Tuple[ArrayLike, ArrayLike], avg: Tuple[ArrayLike, ArrayLike],  # aqplint: disable=AQP201(host-only slice of the port: its device twins come with the device-loop slice)
           ) -> Tuple[ArrayLike, ArrayLike]:
    """Union-bound SUM CI from a (1-delta/2) COUNT CI and (1-delta/2) AVG CI.

    The paper states [c_l*g_l, c_r*g_r] (valid for g_l >= 0). For general
    signs: SUM = N * AVG with N in [c_l, c_r] (>=0) and AVG in [g_l, g_r],
    so the extreme products over the box are taken — elementwise.
    """
    cl, cr = count
    gl, gr = avg
    scalar = _is_scalar(cl, cr, gl, gr)
    ll, lr = np.asarray(cl) * gl, np.asarray(cl) * gr
    rl, rr = np.asarray(cr) * gl, np.asarray(cr) * gr
    lo = np.minimum(np.minimum(ll, lr), np.minimum(rl, rr))
    hi = np.maximum(np.maximum(ll, lr), np.maximum(rl, rr))
    return _unwrap(lo, scalar), _unwrap(hi, scalar)
