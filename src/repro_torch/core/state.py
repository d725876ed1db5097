"""Mergeable aggregation-state algebra (the paper's §2.2.2 interface at
block granularity).

The port of :mod:`repro.core.state`. Kernels fold blocks of tuples into
per-group moment states ``(count, mean, m2, vmin, vmax)`` (Welford/Chan
form) on the card. The per-round host loop keeps the engine's *running*
state float64 numpy on the host (:class:`StatsBatch` and the ``*_host``
merges); the device-resident loop keeps it in float64 tensors on the
card (:class:`DevStatsBatch`, :func:`merge_moments` and the other tensor
functions, which the trainer's per-token loss states use too). A state
whose fields have shape ``(G,)`` holds G independent aggregates (one per
GROUP BY view).

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


def x64_enabled() -> bool:
    """Whether float64 tensors are available on the device: always, in
    torch (the counterpart of :func:`repro.core.state.x64_enabled`, which
    reads JAX's 64-bit switch)."""
    return True


def require_x64(feature: str = "the device bound-evaluation path",
                *tensors: Optional[torch.Tensor]) -> None:
    """Fail loudly when a state tensor of the device bound math is not
    float64.

    The bound-evaluation math (bounders, RangeTrim, COUNT/SUM CIs, the
    OptStop schedule) is float64 by design: a silent demotion to float32
    would produce intervals that are *invalid guarantees*, not merely
    imprecise ones. Torch always has float64, but it demotes quietly in
    its own way: a float32 tensor times a float64 scalar tensor stays
    float32. Every device-resident bound-eval entry point passes its state
    tensors here (``None`` entries are skipped) instead of computing on
    float32."""
    for t in tensors:
        if t is not None and t.dtype != torch.float64:
            raise RuntimeError(
                f"{feature} requires float64 state tensors, but got "
                f"{t.dtype} — the float64 bound math would be silently "
                "demoted to float32 and the resulting intervals would NOT "
                "be valid (1-delta) guarantees. Cast the state with "
                ".to(torch.float64) before any arithmetic (in torch a "
                "float32 tensor times a float64 scalar tensor stays "
                "float32), or run with EngineConfig(device_loop=False) to "
                "use the host float64 round loop instead.")


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


def init_moments(shape=(), dtype: torch.dtype = torch.float32,
                 device=None) -> MomentState:
    """Empty tensor state: zeros, with ``vmin`` / ``vmax`` at ``+inf`` /
    ``-inf``."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    return MomentState(
        count=z, mean=z.clone(), m2=z.clone(),
        vmin=torch.full(shape, float("inf"), dtype=dtype, device=device),
        vmax=torch.full(shape, float("-inf"), dtype=dtype, device=device))


def init_hist(shape=(), nbins: int = 4096,
              dtype: torch.dtype = torch.float32, device=None) -> HistState:
    return HistState(hist=torch.zeros(tuple(shape) + (nbins,), dtype=dtype,
                                      device=device))


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
    the card: one device-to-host copy of the stacked fields when they
    are tensors of one device, dtype and shape, else one copy per
    field."""
    fields = tuple(state)
    if (all(isinstance(f, torch.Tensor) for f in fields)
            and len({(f.device, f.dtype, f.shape) for f in fields}) == 1):
        h = _host_f64(torch.stack(fields))
        return MomentState(*(h[i, ...] for i in range(len(fields))))
    return MomentState(*(_host_f64(f) for f in fields))


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


def moments_of_batch(values: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, axis=None,
                     dtype: torch.dtype = torch.float32) -> MomentState:
    """One-shot masked moments of a batch of tensors on any device (the
    block-level ``update_state``), in ``dtype`` (float32 by default), as
    :func:`repro.core.state.moments_of_batch` computes them: the mean
    first, then the squared deviations from it (a guard against
    cancellation when ``|mean| >> std``). ``axis=None`` reduces over
    every element; an int reduces that axis. ``vmin`` / ``vmax`` are
    ``+inf`` / ``-inf`` where nothing is masked in."""
    values = values.to(dtype)
    if mask is None:
        mask = torch.ones_like(values, dtype=torch.bool)
    mask = mask.to(torch.bool)
    fmask = mask.to(dtype)
    dims = tuple(range(values.dim())) if axis is None else (axis,)
    count = fmask.sum(dim=dims)
    safe = torch.clamp(count, min=1.0)
    mean = (values * fmask).sum(dim=dims) / safe
    dev = (values - (mean if axis is None else mean.unsqueeze(axis))) * fmask
    m2 = (dev * dev).sum(dim=dims)
    inf = torch.tensor(float("inf"), dtype=dtype, device=values.device)
    vmin = torch.where(mask, values, inf).amin(dim=dims)
    vmax = torch.where(mask, values, -inf).amax(dim=dims)
    zero = count == 0
    z = torch.zeros((), dtype=dtype, device=values.device)
    return MomentState(count=count, mean=torch.where(zero, z, mean),
                       m2=torch.where(zero, z, m2), vmin=vmin, vmax=vmax)


def merge_moments(a: MomentState, b: MomentState) -> MomentState:
    """Chan et al. pairwise merge of two tensor states (commutative and
    associative), in their dtype on their device: the port of
    :func:`repro.core.state.merge_moments` and the twin of
    :func:`merge_moments_host`."""
    n = a.count + b.count
    safe = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe)
    m2 = a.m2 + b.m2 + delta * delta * (a.count * b.count / safe)
    zero = n == 0
    z = torch.zeros((), dtype=n.dtype, device=n.device)
    return MomentState(
        count=n,
        mean=torch.where(zero, z, mean),
        m2=torch.where(zero, z, m2),
        vmin=torch.minimum(a.vmin, b.vmin),
        vmax=torch.maximum(a.vmax, b.vmax),
    )


def merge_hist(a: HistState, b: HistState) -> HistState:
    return HistState(hist=a.hist + b.hist)


def hist_of_batch(values: torch.Tensor, mask: Optional[torch.Tensor],
                  a: float, b: float, nbins: int,
                  dtype: torch.dtype = torch.float32) -> HistState:
    """Bucketize a batch into a uniform grid over [a, b] (clipping at the
    edges), summed over every element: ``hist[k] = Σ m · 1[bin(v) = k]``
    with ``bin(v) = clip(trunc((v - a) · nbins / (b - a)), 0, nbins - 1)``
    in float32, as :func:`repro.core.state.hist_of_batch` computes it.
    The scaled value is clamped to ``[-1, nbins]`` before the truncation
    (where the reference's conversion saturates) and NaN goes to bin 0,
    so every value lands where the reference puts it."""
    if mask is None:
        mask = torch.ones_like(values, dtype=torch.bool)
    t = (values - float(a)) * (nbins / max(float(b) - float(a), 1e-30))
    t = torch.nan_to_num(torch.clamp(t, -1.0, float(nbins)), nan=0.0)
    idx = torch.clamp(t.to(torch.int64), 0, nbins - 1).reshape(-1)
    hist = torch.zeros(nbins, dtype=dtype, device=values.device)
    return HistState(hist=hist.index_add_(0, idx,
                                          mask.to(dtype).reshape(-1)))


def tree_merge_moments(state: MomentState, axis: int = 0) -> MomentState:
    """Reduce a stacked state (e.g. per-device states gathered along the
    leading axis) with a log-depth pairwise fold of
    :func:`merge_moments`, in the reference's pairing order."""
    if axis != 0:
        raise ValueError("tree_merge_moments folds along the leading axis")

    def take(s, sl):
        return MomentState(*(f[sl] for f in s))

    n = state.count.shape[0]
    while n > 1:
        half = n // 2
        merged = merge_moments(take(state, slice(0, half)),
                               take(state, slice(half, 2 * half)))
        if n % 2:
            merged = MomentState(*(
                torch.cat([m, s[2 * half:2 * half + 1]], 0)
                for m, s in zip(merged, state)))
            n = half + 1
        else:
            n = half
        state = merged
    return take(state, 0)


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


# ---------------------------------------------------------------------------
# Device-resident float64 snapshot: the tensor twin of ``StatsBatch``.
# ---------------------------------------------------------------------------


class DevStatsBatch(NamedTuple):
    """Device-resident float64 twin of :class:`StatsBatch`.

    Every moment field is a float64 ``(G,)`` tensor and ``hist`` (when
    present) is ``(G, K)`` float64, so the whole batch lives on the card
    inside the device-resident round loop, whose per-round CI refresh
    reads nothing back on the host. The device bound math refuses a
    batch whose fields are not float64 (:func:`require_x64`).
    """

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    hist: Optional[torch.Tensor] = None

    @property
    def variance(self) -> torch.Tensor:
        return torch.where(self.count > 0,
                           self.m2 / torch.clamp(self.count, min=1.0), 0.0)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.variance, min=0.0))

    def reflect(self, a, b) -> "DevStatsBatch":
        """Map x -> (a + b) - x per group (device twin of
        ``StatsBatch.reflect``); ``a`` / ``b`` scalars or ``(G,)``."""
        ab = as_f64(a, self.count) + as_f64(b, self.count)
        h = None if self.hist is None else torch.flip(self.hist, (1,))
        return DevStatsBatch(count=self.count, mean=ab - self.mean,
                             m2=self.m2, vmin=ab - self.vmax,
                             vmax=ab - self.vmin, hist=h)

    @staticmethod
    def from_state(state: MomentState,
                   hist: Optional[torch.Tensor] = None) -> "DevStatsBatch":
        """Device float64 view of a ``(G,)``-shaped tensor
        :class:`MomentState` (+ optional ``(G, K)`` histogram counts),
        cast to float64 before any arithmetic."""
        f64 = lambda x: x.to(torch.float64)
        return DevStatsBatch(
            count=f64(state.count), mean=f64(state.mean), m2=f64(state.m2),
            vmin=f64(state.vmin), vmax=f64(state.vmax),
            hist=None if hist is None else f64(hist))


def as_f64(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float64 tensor on ``like``'s device: a tensor is cast, a
    Python number is filled on the device (no host-to-device copy, so no
    host sync), an array is copied over."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float64)
    if isinstance(x, (int, float, np.floating, np.integer)):
        return torch.full((), float(x), dtype=torch.float64, # aqplint: disable=AQP101(x is a Python or numpy number on this branch: filled on the device, no host sync)
                          device=like.device)
    return torch.as_tensor(np.asarray(x, np.float64), device=like.device) # aqplint: disable=AQP101(a host array handed in by the caller, copied once; the loop passes tensors)


def downdate_extreme_batch_device(s: DevStatsBatch,
                                  which: str) -> DevStatsBatch:
    """Tensor twin of :func:`downdate_extreme_batch`: remove one
    occurrence of the per-group max (``which='max'``) or min on the
    device."""
    ok = s.count >= 2.0
    x = torch.where(ok, s.vmax if which == "max" else s.vmin, 0.0)
    n1 = torch.where(ok, s.count - 1.0, 0.0)
    safe = torch.clamp(n1, min=1.0)
    mean1 = torch.where(ok, (s.count * s.mean - x) / safe, 0.0)
    m21 = torch.where(
        ok, torch.clamp(s.m2 - (x - s.mean) * (x - mean1), min=0.0), 0.0)
    h = None
    if s.hist is not None:
        pos = (s.hist > 0).to(torch.int32)
        hit = pos.any(dim=1) & ok
        K = s.hist.shape[1]
        # argmax: the first maximal index (the first positive bin)
        if which == "max":
            k = (K - 1) - torch.argmax(torch.flip(pos, (1,)), dim=1)
        else:
            k = torch.argmax(pos, dim=1)
        onehot = torch.arange(K, device=s.hist.device) == k[:, None]
        h = s.hist - (onehot & hit[:, None]).to(s.hist.dtype)
    return DevStatsBatch(count=n1, mean=mean1, m2=m21,
                         vmin=s.vmin, vmax=s.vmax, hist=h)


def downdate_extreme(s: Stats, which: str) -> Stats:
    """Remove one occurrence of the sample max (``which='max'``) or min
    from a :class:`Stats` snapshot — the exact RangeTrim trim.

    After the downdate ``vmax`` / ``vmin`` of the *remaining* sample is
    unknown, but RangeTrim only needs the removed value itself (it
    becomes the trimmed range endpoint), so the old extremes are kept.
    """
    if s.count < 2:
        return Stats(0.0, 0.0, 0.0, s.vmin, s.vmax, s.hist)
    x = s.vmax if which == "max" else s.vmin
    n1 = s.count - 1.0
    mean1 = (s.count * s.mean - x) / n1
    m21 = s.m2 - (x - s.mean) * (x - mean1)
    h = None
    if s.hist is not None:
        h = s.hist.copy()
        nz = np.nonzero(h > 0)[0]
        if nz.size:
            k = nz[-1] if which == "max" else nz[0]
            h[k] -= 1.0
    return Stats(count=n1, mean=mean1, m2=max(m21, 0.0),
                 vmin=s.vmin, vmax=s.vmax, hist=h)
