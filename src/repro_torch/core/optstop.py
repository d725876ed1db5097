"""OptStop (paper §4.2, Algorithm 5): anytime-valid optional stopping.

Rounds k = 1, 2, ... each ingest a batch of fresh without-replacement
samples; after round k the bounder is evaluated at

    delta_k = (6 / pi^2) * delta / k^2        (sum_k delta_k = delta)

and the running intersection [max_j L_j, min_j R_j] is kept.  Theorem 4:
AVG(D) lies in every [L_k, R_k] simultaneously w.p. >= 1 - delta, so any
data-dependent stopping rule over the running interval is safe.

This module provides the schedule, the running interval, the six stopping
conditions of §4.2 (with their §4.3 active-group predicates), and a simple
in-memory reference driver used by tests and benchmarks.  The production
driver lives in ``repro_torch.aqp.engine``. The port of
:mod:`repro.core.optstop`: the numpy host path, and the tensor twins of
the schedule and of each condition's active mask that the device-resident
round loop runs on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bounders import Bounder
from repro_torch.core.state import Stats

__all__ = [
    "delta_schedule",
    "delta_schedule_device",
    "RunningInterval",
    "StoppingCondition",
    "FixedSamples",
    "AbsoluteWidth",
    "RelativeWidth",
    "ThresholdSide",
    "TopKSeparated",
    "GroupsOrdered",
    "optstop_reference",
]

_SCHED_C = 6.0 / (math.pi ** 2)


def delta_schedule(delta: float, k: int) -> float:
    """delta_k for round k >= 1 (Algorithm 5 line 7)."""
    return _SCHED_C * delta / float(k * k)


def delta_schedule_device(delta: float, k) -> torch.Tensor:
    """Tensor twin of :func:`delta_schedule`: ``k`` may be a device
    scalar (the device-resident loop's round counter). The constant
    ``_SCHED_C * delta`` is taken on the host, so the result is bitwise
    the host schedule's at equal ``k``."""
    k = (k.to(torch.float64) if isinstance(k, torch.Tensor)
         else torch.tensor(float(k), dtype=torch.float64)) # aqplint: disable=AQP101(k is a Python number on this branch: no host sync)
    # tensor / tensor: a Python number over a tensor is a reciprocal
    # times the number in torch, an ulp away from the division
    return torch.full_like(k, _SCHED_C * delta) / (k * k)


@dataclasses.dataclass
class RunningInterval:
    """[max_k L_k, min_k R_k] with monotone tightening (Theorem 4)."""

    lo: float = -math.inf
    hi: float = math.inf

    def update(self, lo: float, hi: float) -> "RunningInterval":
        self.lo = max(self.lo, lo)
        self.hi = min(self.hi, hi)
        return self

    @property
    def width(self) -> float:
        return self.hi - self.lo

    def as_tuple(self) -> Tuple[float, float]:
        return (self.lo, self.hi)


# ---------------------------------------------------------------------------
# Stopping conditions ①-⑥ (§4.2) with active-group predicates (§4.3).
# Each works over a *vector* of per-group running intervals + estimates.
# ---------------------------------------------------------------------------


class StoppingCondition:
    """``active(...)`` returns the per-group ACTIVE mask (groups still
    preventing termination; §4.3); the query stops when none are active.

    ``active_device(...)`` is the tensor twin run inside the
    device-resident round loop. It cannot subset to the existing views
    without a host sync, so it also takes the per-group ``valid`` mask
    and must reproduce ``_QueryIntervals.cond_active``'s subset
    semantics: invalid (phantom composite) lanes are never active and must
    not distort order statistics (top-K midpoints, pairwise
    orderings)."""

    name = "base"

    def active(self, lo: np.ndarray, hi: np.ndarray, est: np.ndarray,
               counts: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def active_device(self, lo: torch.Tensor, hi: torch.Tensor,
                      est: torch.Tensor, counts: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def done(self, lo, hi, est, counts) -> bool:
        return not bool(self.active(lo, hi, est, counts).any())


@dataclasses.dataclass
class FixedSamples(StoppingCondition):
    """① Desired samples taken (c >= m)."""

    m: int
    name = "fixed_samples"

    def active(self, lo, hi, est, counts):
        return counts < self.m

    def active_device(self, lo, hi, est, counts, valid):
        return (counts < self.m) & valid


@dataclasses.dataclass
class AbsoluteWidth(StoppingCondition):
    """② g_r - g_l < eps."""

    eps: float
    name = "absolute_width"

    def active(self, lo, hi, est, counts):
        return (hi - lo) >= self.eps

    def active_device(self, lo, hi, est, counts, valid):
        return ((hi - lo) >= self.eps) & valid


@dataclasses.dataclass
class RelativeWidth(StoppingCondition):
    """③ max((g_r - g)/g_r, (g - g_l)/g_l) < eps  (paper's form).

    Guarded for bounds crossing zero: if an endpoint's sign is not yet
    determined the group stays active (relative error is undefined there).
    """

    eps: float
    name = "relative_width"

    def active(self, lo, hi, est, counts):
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.maximum((hi - est) / np.abs(hi), (est - lo) / np.abs(lo))
        undecided = (lo <= 0.0) & (hi >= 0.0)
        # A zero-width interval is exact: relative error is 0 no matter the
        # sign, including at 0, where the `undecided` guard below would
        # otherwise keep the view active forever (the interval [0, 0]
        # covers 0 on both sides and rel is NaN there).  Deactivate before
        # the undecided check.
        point = hi <= lo
        return ~point & (undecided | ~np.isfinite(rel) | (rel >= self.eps))

    def active_device(self, lo, hi, est, counts, valid):
        rel = torch.maximum((hi - est) / torch.abs(hi),
                            (est - lo) / torch.abs(lo))
        undecided = (lo <= 0.0) & (hi >= 0.0)
        point = hi <= lo
        return (~point & (undecided | ~torch.isfinite(rel)
                          | (rel >= self.eps))) & valid


@dataclasses.dataclass
class ThresholdSide(StoppingCondition):
    """④ v not in [g_l, g_r]: which side of a HAVING threshold."""

    threshold: float
    name = "threshold_side"

    def active(self, lo, hi, est, counts):
        return (lo <= self.threshold) & (self.threshold <= hi)

    def active_device(self, lo, hi, est, counts, valid):
        return (lo <= self.threshold) & (self.threshold <= hi) & valid


@dataclasses.dataclass
class TopKSeparated(StoppingCondition):
    """⑤ Top-K (largest=True) or bottom-K separated from the rest.

    Active groups (§4.3): sort by estimate; let mid = midpoint between the
    K-th and (K+1)-th estimates; a top-K group is active while its lower
    bound crosses mid; a non-top-K group is active while its upper bound
    crosses mid.
    """

    k: int
    largest: bool = True
    name = "topk_separated"

    def active(self, lo, hi, est, counts):
        n = est.shape[0]
        if self.k >= n:
            return np.zeros(n, dtype=bool)
        order = np.argsort(-est if self.largest else est)
        chosen = np.zeros(n, dtype=bool)
        chosen[order[: self.k]] = True
        kth = est[order[self.k - 1]]
        k1th = est[order[self.k]]
        mid = 0.5 * (kth + k1th)
        if self.largest:
            return np.where(chosen, lo <= mid, hi >= mid)
        return np.where(chosen, hi >= mid, lo <= mid)

    def active_device(self, lo, hi, est, counts, valid):
        """Order statistics over valid lanes only: invalid lanes carry an
        infinite sentinel so they sort last (a stable sort, like the
        host's subset-then-argsort) and never enter the top-K or the
        midpoint."""
        n = est.shape[0]
        if self.k >= n:  # can never separate more lanes than exist
            return torch.zeros(n, dtype=torch.bool, device=est.device)
        n_valid = valid.sum()
        sentinel = float("-inf") if self.largest else float("inf")
        key = torch.where(valid, est, sentinel)
        order = torch.argsort(-key if self.largest else key, stable=True)
        sorted_key = key[order]
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=est.device))
        chosen = valid & (rank < self.k)
        mid = 0.5 * (sorted_key[self.k - 1] + sorted_key[self.k])
        if self.largest:
            act = torch.where(chosen, lo <= mid, hi >= mid)
        else:
            act = torch.where(chosen, hi >= mid, lo <= mid)
        return (self.k < n_valid) & act & valid


@dataclasses.dataclass
class GroupsOrdered(StoppingCondition):
    """⑥ All groups' intervals pairwise disjoint (full ordering known)."""

    name = "groups_ordered"

    def active(self, lo, hi, est, counts):
        n = est.shape[0]
        # interval i intersects j  <=>  lo_i <= hi_j and lo_j <= hi_i
        inter = (lo[:, None] <= hi[None, :]) & (lo[None, :] <= hi[:, None])
        np.fill_diagonal(inter, False)
        return inter.any(axis=1)

    def active_device(self, lo, hi, est, counts, valid):
        n = est.shape[0]
        inter = (lo[:, None] <= hi[None, :]) & (lo[None, :] <= hi[:, None])
        inter = inter & valid[:, None] & valid[None, :]
        inter = inter & ~torch.eye(n, dtype=torch.bool, device=est.device)
        return inter.any(dim=1) & valid


# ---------------------------------------------------------------------------
# Reference driver (single group, in-memory data) — Algorithm 5 verbatim.
# ---------------------------------------------------------------------------


def optstop_reference(
    data: np.ndarray,
    bounder: Bounder,
    a: float,
    b: float,
    delta: float,
    should_stop: Callable[[float, float], bool],
    batch: int = 1024,
    rng: Optional[np.random.Generator] = None,
    hist_bins: Optional[int] = None,
    max_rounds: int = 10_000,
) -> Dict[str, object]:
    """Algorithm 5 over an in-memory dataset. Returns the running interval,
    rounds used, and samples consumed. Used by unit tests / benchmarks."""
    rng = rng or np.random.default_rng(0)
    N = data.shape[0]
    perm = rng.permutation(N)  # the "scramble"
    taken = 0
    interval = RunningInterval()
    hist_range = (a, b) if hist_bins else None
    for k in range(1, max_rounds + 1):
        take = min(batch, N - taken)
        taken += take
        sample = data[perm[:taken]]
        s = Stats.of_sample(sample, hist_bins=hist_bins, hist_range=hist_range)
        dk = delta_schedule(delta, k)
        lo, hi = bounder.interval(s, a, b, N, dk)
        interval.update(lo, hi)
        if should_stop(interval.lo, interval.hi) or taken >= N:
            break
    return {
        "interval": interval.as_tuple(),
        "rounds": k,
        "samples": taken,
        "exhausted": taken >= N,
    }
