"""Mergeable aggregation-state algebra, host half (the paper's §2.2.2
interface at block granularity).

The port of :mod:`repro.core.state`. Kernels fold blocks of tuples into
per-group moment states ``(count, mean, m2, vmin, vmax)`` (Welford/Chan
form) on the card; the engine's *running* state, and all bound
evaluation, stay float64 numpy on the host. A state whose fields have
shape ``(G,)`` holds G independent aggregates (one per GROUP BY view).

Key identity used by RangeTrim (:mod:`repro_torch.core.rangetrim`):
removing one occurrence of the sample max from a Welford state is an
exact O(1) *downdate*:

    count' = count - 1
    mean'  = (count * mean - x) / (count - 1)
    m2'    = m2 - (x - mean) * (x - mean')
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class MomentState(NamedTuple):
    """Monoid state: masked count / Welford mean / Welford M2 / min / max.

    Fields are float32 torch tensors when a kernel emits them and
    float64 numpy arrays on the host (:func:`to_host`)."""

    count: object  # number of (masked-in) values seen
    mean: object   # running mean (0 when count == 0)
    m2: object     # sum of squared deviations from the mean
    vmin: object   # +inf when count == 0
    vmax: object   # -inf when count == 0


class HistState(NamedTuple):
    """Bucketized-CDF state for Anderson/DKW. ``hist[k]`` counts values in
    bin k of a uniform grid over the a-priori range ``[a, b]``."""

    hist: object  # (..., K) float counts


def init_moments_host(shape=()) -> MomentState:
    """Empty float64 numpy state for host-side accumulation."""
    z = np.zeros(shape, np.float64)
    return MomentState(count=z, mean=z.copy(), m2=z.copy(),
                       vmin=np.full(shape, np.inf),
                       vmax=np.full(shape, -np.inf))


def _host_f64(x) -> np.ndarray:
    """float64 numpy copy of a tensor on any device (or of an array).
    The cast to float64 happens on the host, before any arithmetic: a
    float32 tensor times a float64 0-d tensor stays float32 in torch."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def to_host(state: MomentState) -> MomentState:
    """Float64 host copy of a state whose fields may be torch tensors on
    the card (one device-to-host copy per field)."""
    return MomentState(*(_host_f64(f) for f in state))


def moments_nonfinite(state: MomentState,
                      hist: Optional[np.ndarray] = None) -> bool:
    """NaN/inf sentinel over a host fold state: True when the moments (or
    the optional histogram) carry non-finite values that a poison row
    (NaN/inf in the value column) has folded in. ``vmin``/``vmax`` are
    legitimately ±inf for empty groups, so only NaN is poison there;
    count/mean/m2 of real data are always finite."""
    count, mean, m2, vmin, vmax = (_host_f64(f) for f in state)
    bad = (~np.isfinite(count) | ~np.isfinite(mean) | ~np.isfinite(m2)
           | np.isnan(vmin) | np.isnan(vmax))
    if hist is not None:
        bad = bad | ~np.isfinite(_host_f64(hist)).all(axis=-1)
    return bool(np.any(bad))


def merge_hist_host(hist: Optional[np.ndarray], delta) -> np.ndarray:
    """Float64 histogram accumulation: fold a device-side f32 ``(G, K)``
    bin-count delta into the host's f64 running histogram (bin counts are
    integers, so f64 keeps them exact). ``hist=None`` starts a fresh
    state."""
    d = _host_f64(delta)
    return d.copy() if hist is None else hist + d


def merge_moments_host(a: MomentState, b: MomentState) -> MomentState:
    """Float64 numpy pairwise merge (Chan et al.). Kernels emit f32
    per-round partial states; the engine's *running* state accumulates on
    host in f64 so thousands of round merges do not erode precision."""
    n = a.count + b.count
    safe = np.maximum(n, 1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe)
    m2 = a.m2 + b.m2 + delta * delta * (a.count * b.count / safe)
    zero = n == 0
    return MomentState(
        count=n,
        mean=np.where(zero, 0.0, mean),
        m2=np.where(zero, 0.0, m2),
        vmin=np.minimum(a.vmin, b.vmin),
        vmax=np.maximum(a.vmax, b.vmax),
    )


# ---------------------------------------------------------------------------
# Host-side float64 snapshot used by the bound-evaluation math.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stats:
    """Float64 host snapshot of a (scalar) MomentState (+ optional hist)."""

    count: float
    mean: float
    m2: float
    vmin: float
    vmax: float
    hist: Optional[np.ndarray] = None  # float64 counts, uniform over [a, b]

    @property
    def variance(self) -> float:
        """Population-style sample variance \\hat{sigma}^2 = m2 / count."""
        return self.m2 / self.count if self.count > 0 else 0.0

    @property
    def std(self) -> float:
        return float(np.sqrt(max(self.variance, 0.0)))

    @staticmethod
    def from_state(state: MomentState, hist: Optional[HistState] = None,
                   index=()) -> "Stats":
        get = lambda x: (float(_host_f64(x)[index]) if index != ()
                         else float(_host_f64(x)))
        h = None
        if hist is not None:
            h = _host_f64(hist.hist)[index]
        return Stats(
            count=get(state.count), mean=get(state.mean), m2=get(state.m2),
            vmin=get(state.vmin), vmax=get(state.vmax), hist=h,
        )

    @staticmethod
    def of_sample(values, hist_bins: Optional[int] = None,
                  hist_range=None) -> "Stats":
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return Stats(0.0, 0.0, 0.0, np.inf, -np.inf)
        mean = float(v.mean())
        h = None
        if hist_bins is not None:
            a, b = hist_range
            idx = np.clip(((v - a) * (hist_bins / max(b - a, 1e-30))).astype(int),
                          0, hist_bins - 1)
            h = np.bincount(idx, minlength=hist_bins).astype(np.float64)
        return Stats(
            count=float(v.size), mean=mean, m2=float(((v - mean) ** 2).sum()),
            vmin=float(v.min()), vmax=float(v.max()), hist=h,
        )

    def reflect(self, a: float, b: float) -> "Stats":
        """Map x -> (a + b) - x; turns Rbound into Lbound (paper Alg. 1/3)."""
        h = None if self.hist is None else self.hist[::-1].copy()
        return Stats(
            count=self.count, mean=(a + b) - self.mean, m2=self.m2,
            vmin=(a + b) - self.vmax, vmax=(a + b) - self.vmin, hist=h,
        )


# ---------------------------------------------------------------------------
# Batched host snapshot: struct-of-arrays twin of ``Stats`` over G groups.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StatsBatch:
    """Float64 snapshot of ``G`` independent aggregates (struct-of-arrays).

    The batched twin of :class:`Stats`: every moment field is a float64
    array of shape ``(G,)`` and ``hist`` (when present) is ``(G, K)``. The
    bound-evaluation layer (:mod:`repro_torch.core.bounders`) operates on
    whole batches, so a round's CI refresh over 10k+ GROUP BY views is a
    handful of numpy kernels instead of G scalar Python calls.
    """

    count: np.ndarray
    mean: np.ndarray
    m2: np.ndarray
    vmin: np.ndarray
    vmax: np.ndarray
    hist: Optional[np.ndarray] = None  # (G, K) float64 counts over [a, b]

    def __post_init__(self):
        for f in ("count", "mean", "m2", "vmin", "vmax"):
            object.__setattr__(self, f,
                               np.atleast_1d(np.asarray(getattr(self, f),
                                                        np.float64)))
        if self.hist is not None:
            h = np.asarray(self.hist, np.float64)
            object.__setattr__(self, "hist", np.atleast_2d(h))

    def __len__(self) -> int:
        return self.count.shape[0]

    def __getitem__(self, g: int) -> Stats:
        """Scalar view of group ``g`` (copy; cheap, test/debug use)."""
        return Stats(
            count=float(self.count[g]), mean=float(self.mean[g]),
            m2=float(self.m2[g]), vmin=float(self.vmin[g]),
            vmax=float(self.vmax[g]),
            hist=None if self.hist is None else self.hist[g].copy(),
        )

    @property
    def variance(self) -> np.ndarray:
        """Per-group \\hat{sigma}^2 = m2 / count (0 where count == 0)."""
        return np.where(self.count > 0,
                        self.m2 / np.maximum(self.count, 1.0), 0.0)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(np.maximum(self.variance, 0.0))

    @staticmethod
    def from_stats(s: Stats) -> "StatsBatch":
        """Size-1 batch wrapping one scalar snapshot."""
        return StatsBatch(count=[s.count], mean=[s.mean], m2=[s.m2],
                          vmin=[s.vmin], vmax=[s.vmax],
                          hist=None if s.hist is None else s.hist[None, :])

    @staticmethod
    def from_state(state: MomentState,
                   hist: Optional[np.ndarray] = None) -> "StatsBatch":
        """Float64 snapshot of a ``(G,)``-shaped :class:`MomentState`
        (+ optional ``(G, K)`` histogram counts): the engine's per-round
        bridge from the mergeable states to the batched bound evaluator."""
        return StatsBatch(
            count=_host_f64(state.count), mean=_host_f64(state.mean),
            m2=_host_f64(state.m2), vmin=_host_f64(state.vmin),
            vmax=_host_f64(state.vmax),
            hist=None if hist is None else _host_f64(hist))

    def take(self, idx) -> "StatsBatch":
        """Sub-batch at ``idx`` (bool mask or index array); fields copied."""
        return StatsBatch(
            count=self.count[idx], mean=self.mean[idx], m2=self.m2[idx],
            vmin=self.vmin[idx], vmax=self.vmax[idx],
            hist=None if self.hist is None else self.hist[idx])

    def reflect(self, a, b) -> "StatsBatch":
        """Map x -> (a + b) - x per group; ``a``/``b`` scalar or (G,)."""
        ab = np.asarray(a, np.float64) + np.asarray(b, np.float64)
        h = None if self.hist is None else self.hist[:, ::-1].copy()
        return StatsBatch(count=self.count, mean=ab - self.mean, m2=self.m2,
                          vmin=ab - self.vmax, vmax=ab - self.vmin, hist=h)


def downdate_extreme_batch(s: StatsBatch, which: str) -> StatsBatch:
    """Batched Welford downdate: remove one occurrence of the per-group max
    (``which='max'``) or min. Groups with ``count < 2`` collapse to the
    empty state; extremes are kept (RangeTrim only needs the removed
    value itself, which becomes the trimmed range endpoint)."""
    ok = s.count >= 2.0
    x = np.where(ok, s.vmax if which == "max" else s.vmin, 0.0)
    n1 = np.where(ok, s.count - 1.0, 0.0)
    safe = np.maximum(n1, 1.0)
    mean1 = np.where(ok, (s.count * s.mean - x) / safe, 0.0)
    m21 = np.where(ok, np.maximum(s.m2 - (x - s.mean) * (x - mean1), 0.0),
                   0.0)
    h = None
    if s.hist is not None:
        h = s.hist.copy()
        pos = h > 0
        hit = pos.any(axis=1) & ok
        K = h.shape[1]
        if which == "max":
            k = (K - 1) - np.argmax(pos[:, ::-1], axis=1)
        else:
            k = np.argmax(pos, axis=1)
        rows = np.nonzero(hit)[0]
        h[rows, k[rows]] -= 1.0
    return StatsBatch(count=n1, mean=mean1, m2=m21,
                      vmin=s.vmin, vmax=s.vmax, hist=h)
