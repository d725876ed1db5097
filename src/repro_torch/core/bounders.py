"""Sample-size-independent (SSI) error bounders (paper §2.2.3).

Every bounder implements the paper's interface as *pure float64 host math*,
vectorized over a :class:`repro_torch.core.state.StatsBatch` of G
independent aggregate views. Device-side state maintenance lives in
:mod:`repro_torch.kernels`; this module is the "bound evaluation" half (a
numpy port of the host path of :mod:`repro.core.bounders`), which runs
once per OptStop round — batched over all groups, so a high-cardinality
GROUP BY refresh is a handful of numpy kernels rather than G scalar
Python calls.

Conventions (Definition 1):
  * ``lbound_batch(batch, a, b, N, delta)`` returns the (G,) vector of g_l
    with P(g_l > AVG(D_g)) < delta per group — for ANY sample size (SSI).
  * ``rbound_batch`` symmetric; implemented by reflection x -> (a+b) - x.
  * ``interval_batch(...)`` = [lbound(delta/2), rbound(delta/2)] (union
    bound), elementwise.
  * ``a``/``b``/``N`` may each be scalars or (G,) arrays (RangeTrim feeds
    per-group trimmed ranges; Theorem 3 feeds per-group N+).
  * The scalar API (``lbound`` / ``rbound`` / ``interval`` over a
    :class:`Stats`) is a thin size-1 wrapper over the batch path, so the
    two can never drift.

All bounders satisfy the *dataset-size monotonicity* property (§3.3): using
any N' >= N only loosens the bounds, so the engine may pass the Theorem-3
upper bound ``N+`` when the true N is unknown.

Every bounder also has a float64 tensor twin of the batch path
(``lbound_batch_device`` / ``rbound_batch_device`` /
``interval_batch_device`` over a
:class:`repro_torch.core.state.DevStatsBatch`), the port of the
reference's ``*_device`` twins: the same formulas on the card, with
``delta`` allowed to be a device scalar, so the device-resident round
loop refreshes CIs without a host sync. The twins refuse a batch that is
not float64 (:func:`repro_torch.core.state.require_x64`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.core.state import (DevStatsBatch, Stats, StatsBatch,
                                    as_f64, require_x64)

__all__ = [
    "Bounder",
    "HoeffdingBounder",
    "HoeffdingSerflingBounder",
    "BernsteinSerflingBounder",
    "EmpiricalBernsteinSerflingBounder",
    "AndersonDKWBounder",
    "get_bounder",
]

ArrayLike = Union[float, np.ndarray]

# kappa from Bardenet & Maillard (2015), Bernoulli 21(3), Thm. 3/4.
_KAPPA_EBS = 7.0 / 3.0 + 3.0 / math.sqrt(2.0)


def _bcast(x: ArrayLike, like: np.ndarray) -> np.ndarray:
    return np.broadcast_to(np.asarray(x, np.float64), like.shape)


def _rho_serfling(m: np.ndarray, N: ArrayLike) -> np.ndarray:
    """(1 - (m-1)/N): Serfling's without-replacement shrink factor."""
    N = np.asarray(N, np.float64)
    rho = np.maximum(1.0 - (m - 1.0) / np.where(N > 0, N, 1.0), 0.0)
    return np.where(N > 0, rho, 1.0)


def _rho_bardenet(m: np.ndarray, N: ArrayLike) -> np.ndarray:
    """rho_m from Bardenet-Maillard: the tighter two-regime factor."""
    N = np.asarray(N, np.float64)
    Ns = np.where(N > 0, N, 1.0)
    low = np.maximum(1.0 - (m - 1.0) / Ns, 0.0)
    high = np.maximum((1.0 - m / Ns) * (1.0 + 1.0 / np.maximum(m, 1.0)), 0.0)
    return np.where(N > 0, np.where(m <= Ns / 2.0, low, high), 1.0)


def _rho_serfling_device(m: torch.Tensor, N) -> torch.Tensor:
    """Tensor twin of :func:`_rho_serfling`."""
    N = as_f64(N, m)
    rho = torch.clamp(1.0 - (m - 1.0) / torch.where(N > 0, N, 1.0), min=0.0)
    return torch.where(N > 0, rho, 1.0)


def _rho_bardenet_device(m: torch.Tensor, N) -> torch.Tensor:
    """Tensor twin of :func:`_rho_bardenet`."""
    N = as_f64(N, m)
    Ns = torch.where(N > 0, N, 1.0)
    low = torch.clamp(1.0 - (m - 1.0) / Ns, min=0.0)
    high = torch.clamp((1.0 - m / Ns) * (1.0 + 1.0 / torch.clamp(m, min=1.0)),
                       min=0.0)
    return torch.where(N > 0, torch.where(m <= Ns / 2.0, low, high), 1.0)


def _log_ratio(c: float, delta, like: torch.Tensor) -> torch.Tensor:
    """``log(c / delta)`` for a Python number or device scalar ``delta``,
    as a float64 tensor on ``like``'s device. The quotient is a tensor
    division: torch computes a Python number over a tensor as a
    reciprocal times the number, an ulp away from the host's ``c /
    delta``."""
    return torch.log(as_f64(c, like) / as_f64(delta, like))


def _require_f64(s: DevStatsBatch) -> None:
    require_x64("the device bound math", s.count, s.mean, s.m2, s.vmin,
                s.vmax, s.hist)


@dataclasses.dataclass(frozen=True)
class Bounder:
    """Base class. Subclasses override the vectorized ``_lbound_batch``."""

    #: Table-2 pathology flags (documentation + pathology tests).
    has_pma: bool = True
    has_phos: bool = True
    name: str = "base"

    def _lbound_batch(self, s: StatsBatch, a: ArrayLike, b: ArrayLike,
                      N: ArrayLike, delta: float) -> np.ndarray:
        raise NotImplementedError

    # -- batched public API --------------------------------------------------
    def lbound_batch(self, s: StatsBatch, a: ArrayLike, b: ArrayLike,
                     N: ArrayLike, delta: float) -> np.ndarray:
        a_arr = _bcast(a, s.count)
        if not np.any(s.count > 0):  # all-empty: trivial a-priori bound
            return a_arr.copy()
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            lb = self._lbound_batch(s, a, b, N, delta)
            # the mean of data in [a,b] is >= a, always
            lb = np.maximum(lb, a_arr)
        return np.where(s.count > 0, lb, a_arr)

    def rbound_batch(self, s: StatsBatch, a: ArrayLike, b: ArrayLike,
                     N: ArrayLike, delta: float) -> np.ndarray:
        # Reflect x -> (a+b)-x, compute an lbound, reflect back (Alg. 1/3).
        a_arr = _bcast(a, s.count)
        b_arr = _bcast(b, s.count)
        if not np.any(s.count > 0):
            return b_arr.copy()
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            lb = self._lbound_batch(s.reflect(a, b), a, b, N, delta)
            rb = np.minimum((a_arr + b_arr) - lb, b_arr)
        return np.where(s.count > 0, rb, b_arr)

    def interval_batch(self, s: StatsBatch, a: ArrayLike, b: ArrayLike,
                       N: ArrayLike, delta: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
        return (self.lbound_batch(s, a, b, N, delta / 2.0),
                self.rbound_batch(s, a, b, N, delta / 2.0))

    # -- device (float64 tensor) twins of the batch path ---------------------
    def _lbound_batch_device(self, s: DevStatsBatch, a, b, N,
                             delta) -> torch.Tensor:
        raise NotImplementedError

    def lbound_batch_device(self, s: DevStatsBatch, a, b, N,
                            delta) -> torch.Tensor:
        """Tensor twin of :meth:`lbound_batch` over a device-resident
        :class:`DevStatsBatch`. The host path's all-empty short-circuit
        becomes elementwise selection (dead lanes yield the a-priori
        bound either way), so nothing is read back on the host."""
        _require_f64(s)
        a_arr = as_f64(a, s.count).expand(s.count.shape)
        lb = self._lbound_batch_device(s, a, b, N, delta)
        lb = torch.maximum(lb, a_arr)
        return torch.where(s.count > 0, lb, a_arr)

    def rbound_batch_device(self, s: DevStatsBatch, a, b, N,
                            delta) -> torch.Tensor:
        """Tensor twin of :meth:`rbound_batch` (reflection trick)."""
        _require_f64(s)
        a_arr = as_f64(a, s.count).expand(s.count.shape)
        b_arr = as_f64(b, s.count).expand(s.count.shape)
        lb = self._lbound_batch_device(s.reflect(a, b), a, b, N, delta)
        rb = torch.minimum((a_arr + b_arr) - lb, b_arr)
        return torch.where(s.count > 0, rb, b_arr)

    def interval_batch_device(self, s: DevStatsBatch, a, b, N, delta
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.lbound_batch_device(s, a, b, N, delta / 2.0),
                self.rbound_batch_device(s, a, b, N, delta / 2.0))

    # -- scalar API: size-1 wrappers over the batch path ---------------------
    def lbound(self, s: Stats, a: float, b: float, N: float,
               delta: float) -> float:
        return float(self.lbound_batch(StatsBatch.from_stats(s), a, b, N,
                                       delta)[0])

    def rbound(self, s: Stats, a: float, b: float, N: float,
               delta: float) -> float:
        return float(self.rbound_batch(StatsBatch.from_stats(s), a, b, N,
                                       delta)[0])

    def interval(self, s: Stats, a: float, b: float, N: float,
                 delta: float) -> Tuple[float, float]:
        return (self.lbound(s, a, b, N, delta / 2.0),
                self.rbound(s, a, b, N, delta / 2.0))


@dataclasses.dataclass(frozen=True)
class HoeffdingBounder(Bounder):
    """Hoeffding (1963): valid for with- AND without-replacement sampling."""

    has_pma: bool = True
    has_phos: bool = True
    name: str = "hoeffding"

    def _lbound_batch(self, s, a, b, N, delta):
        rng = np.asarray(b, np.float64) - np.asarray(a, np.float64)
        eps = rng * np.sqrt(math.log(1.0 / delta) / (2.0 * s.count))
        return s.mean - eps

    def _lbound_batch_device(self, s, a, b, N, delta):
        rng = as_f64(b, s.count) - as_f64(a, s.count)
        eps = rng * torch.sqrt(_log_ratio(1.0, delta, s.count)
                               / (2.0 * s.count))
        return s.mean - eps


@dataclasses.dataclass(frozen=True)
class HoeffdingSerflingBounder(Bounder):
    """Hoeffding-Serfling (Serfling 1974); paper Algorithm 1."""

    has_pma: bool = True
    has_phos: bool = True
    name: str = "hoeffding_serfling"

    def _lbound_batch(self, s, a, b, N, delta):
        m = s.count
        rho = _rho_serfling(m, N)
        rng = np.asarray(b, np.float64) - np.asarray(a, np.float64)
        eps = rng * np.sqrt(math.log(1.0 / delta) * rho / (2.0 * m))
        return s.mean - eps

    def _lbound_batch_device(self, s, a, b, N, delta):
        m = s.count
        rho = _rho_serfling_device(m, N)
        rng = as_f64(b, m) - as_f64(a, m)
        eps = rng * torch.sqrt(_log_ratio(1.0, delta, m) * rho
                               / (2.0 * m))
        return s.mean - eps


@dataclasses.dataclass(frozen=True)
class BernsteinSerflingBounder(Bounder):
    """Bernstein-Serfling with *known* variance sigma^2 (Bardenet-Maillard
    Thm. 3). Mostly a reference point for tests; ``sigma`` must be supplied.
    """

    sigma: float = 0.0
    has_pma: bool = False
    has_phos: bool = True
    name: str = "bernstein_serfling"

    def _lbound_batch(self, s, a, b, N, delta):
        m = s.count
        rho = _rho_bardenet(m, N)
        log_t = math.log(3.0 / delta)
        rng = np.asarray(b, np.float64) - np.asarray(a, np.float64)
        eps = (self.sigma * np.sqrt(2.0 * rho * log_t / m)
               + _KAPPA_EBS * rng * log_t / m)
        return s.mean - eps

    def _lbound_batch_device(self, s, a, b, N, delta):
        m = s.count
        rho = _rho_bardenet_device(m, N)
        log_t = _log_ratio(3.0, delta, m)
        rng = as_f64(b, m) - as_f64(a, m)
        eps = (self.sigma * torch.sqrt(2.0 * rho * log_t / m)
               + _KAPPA_EBS * rng * log_t / m)
        return s.mean - eps


@dataclasses.dataclass(frozen=True)
class EmpiricalBernsteinSerflingBounder(Bounder):
    """Empirical Bernstein-Serfling (Bardenet-Maillard 2015, Thm. 4);
    paper Algorithm 2. The paper's recommended inner bounder ("Bernstein").

    eps = sigma_hat * sqrt(2 rho log(5/delta) / m)
          + kappa (b - a) log(5/delta) / m,   kappa = 7/3 + 3/sqrt(2)
    """

    has_pma: bool = False
    has_phos: bool = True
    name: str = "bernstein"

    def _lbound_batch(self, s, a, b, N, delta):
        m = s.count
        rho = _rho_bardenet(m, N)
        log_t = math.log(5.0 / delta)
        rng = np.asarray(b, np.float64) - np.asarray(a, np.float64)
        eps = (s.std * np.sqrt(2.0 * rho * log_t / m)
               + _KAPPA_EBS * rng * log_t / m)
        return s.mean - eps

    def _lbound_batch_device(self, s, a, b, N, delta):
        m = s.count
        rho = _rho_bardenet_device(m, N)
        log_t = _log_ratio(5.0, delta, m)
        rng = as_f64(b, m) - as_f64(a, m)
        eps = (s.std * torch.sqrt(2.0 * rho * log_t / m)
               + _KAPPA_EBS * rng * log_t / m)
        return s.mean - eps


@dataclasses.dataclass(frozen=True)
class AndersonDKWBounder(Bounder):
    """Anderson (1969) mean bounds from DKW CDF bands; paper Algorithm 3.

    Valid without replacement for any finite N by paper Theorem 1. Requires
    the histogram field of the batch (bucketized empirical CDF); the bin
    discretization only *widens* bounds (values rounded toward the
    pessimistic bin edge), so guarantees are preserved.

    One-sided DKW: eps = sqrt(log(1/delta) / (2 m)).
    Lower bound (Alg. 3): drop the top-eps mass via a row-wise reversed
    cumulative sum over the (G, K) histogram, re-allocate it at ``a``,
    value surviving bins at their LEFT edge.
    """

    has_pma: bool = True
    has_phos: bool = False
    name: str = "anderson_dkw"

    def _lbound_batch(self, s, a, b, N, delta):
        if s.hist is None:
            raise ValueError("AndersonDKW requires histogram state")
        # The histogram grid is pinned to one [a, b] range shared by the
        # whole batch; per-group ranges would reinterpret every row's bins.
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if (a.ndim and np.ptp(a) != 0) or (b.ndim and np.ptp(b) != 0):
            raise ValueError("AndersonDKW requires a uniform [a, b] range "
                             "across the batch (histogram bins are pinned "
                             "to the a-priori grid)")
        a = float(a.reshape(-1)[0])
        b = float(b.reshape(-1)[0])
        m = s.count
        eps = np.sqrt(math.log(1.0 / delta) / (2.0 * m))
        hist = s.hist
        G, K = hist.shape
        edges = a + (b - a) * np.arange(K) / K  # left edges
        # Drop eps*m mass from the top (possibly fractionally).
        drop = eps * m
        csum_from_top = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]
        # bins fully dropped: csum of bins above them (inclusive) <= drop
        fully = csum_from_top <= drop[:, None]
        kept = np.where(fully, 0.0, hist)
        # the highest surviving bin (per row) may be partially dropped
        surv_any = (~fully).any(axis=1)
        k_hi = (K - 1) - np.argmax((~fully)[:, ::-1], axis=1)
        csum_pad = np.concatenate(
            [csum_from_top, np.zeros((G, 1), np.float64)], axis=1)
        already = np.take_along_axis(csum_pad, (k_hi + 1)[:, None],
                                     axis=1)[:, 0]
        partial = np.maximum(
            np.take_along_axis(kept, k_hi[:, None], axis=1)[:, 0]
            - (drop - already), 0.0)
        rows = np.nonzero(surv_any)[0]
        kept[rows, k_hi[rows]] = partial[rows]
        kept_mass = kept.sum(axis=1)
        avg_kept = ((kept * edges).sum(axis=1)
                    / np.where(kept_mass > 0, kept_mass, 1.0))
        lb = eps * a + (1.0 - eps) * avg_kept
        return np.where((eps >= 1.0) | (kept_mass <= 0), a, lb)

    def _lbound_batch_device(self, s, a, b, N, delta):
        """Tensor top-mass drop: the in-place partial-bin scatter of the
        host path becomes a one-hot select; ``a`` / ``b`` must be Python
        numbers (the engine's pinned histogram grid)."""
        if s.hist is None:
            raise ValueError("AndersonDKW requires histogram state")
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            raise ValueError("AndersonDKW's device bound takes the pinned "
                             "histogram grid [a, b] as Python numbers")
        a = float(a) # aqplint: disable=AQP101(the pinned histogram grid edge, a Python number: no host sync)
        b = float(b) # aqplint: disable=AQP101(the pinned histogram grid edge, a Python number: no host sync)
        m = s.count
        eps = torch.sqrt(_log_ratio(1.0, delta, m) / (2.0 * m))
        hist = s.hist
        G, K = hist.shape
        k_idx = torch.arange(K, device=hist.device)
        edges = a + (b - a) * k_idx.to(torch.float64) / K
        drop = eps * m
        csum_from_top = torch.flip(torch.cumsum(torch.flip(hist, (1,)), 1),
                                   (1,))
        fully = csum_from_top <= drop[:, None]
        kept = torch.where(fully, 0.0, hist)
        surv = (~fully).to(torch.int32)
        surv_any = surv.any(dim=1)
        # argmax: the first maximal index (the highest surviving bin)
        k_hi = (K - 1) - torch.argmax(torch.flip(surv, (1,)), dim=1)
        csum_pad = torch.cat(
            [csum_from_top, torch.zeros((G, 1), dtype=hist.dtype,
                                        device=hist.device)], dim=1)
        already = torch.take_along_dim(csum_pad, (k_hi + 1)[:, None],
                                       dim=1)[:, 0]
        partial = torch.clamp(
            torch.take_along_dim(kept, k_hi[:, None], dim=1)[:, 0]
            - (drop - already), min=0.0)
        sel = (k_idx == k_hi[:, None]) & surv_any[:, None]
        kept = torch.where(sel, partial[:, None], kept)
        kept_mass = kept.sum(dim=1)
        avg_kept = ((kept * edges).sum(dim=1)
                    / torch.where(kept_mass > 0, kept_mass, 1.0))
        lb = eps * a + (1.0 - eps) * avg_kept
        return torch.where((eps >= 1.0) | (kept_mass <= 0), a, lb)


_REGISTRY = {
    "hoeffding": HoeffdingBounder(),
    "hoeffding_serfling": HoeffdingSerflingBounder(),
    "bernstein": EmpiricalBernsteinSerflingBounder(),
    "anderson_dkw": AndersonDKWBounder(),
}


def get_bounder(name: str, rangetrim: bool = False) -> Bounder:
    """Bounder factory.

    Args:
        name: one of ``'hoeffding'``, ``'hoeffding_serfling'``,
            ``'bernstein'`` (Empirical-Bernstein-Serfling) or
            ``'anderson_dkw'`` (requires histogram state).
        rangetrim: wrap the base bounder in the RangeTrim
            asymmetrization (exact Welford downdate of the sample
            extreme at bound-evaluation time).

    ``get_bounder('bernstein', rangetrim=True)`` is the paper's best
    configuration (Bernstein+RT: no PMA, no PHOS pathologies)."""
    from repro_torch.core.rangetrim import RangeTrimBounder  # cycle guard

    base = _REGISTRY[name]
    return RangeTrimBounder(inner=base) if rangetrim else base
