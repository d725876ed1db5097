"""RangeTrim (paper §3, Algorithms 4 & 6): eliminate PHOS from any
range-based SSI bounder by *asymmetrizing* it.

Conceptually (paper §3.2), for the lower bound:
  1. draw S without replacement from D,
  2. compute a lower confidence bound for AVG(D_{< max S}) using
     S - {max S} as the sample and [a, max S] as the range,
  3. since AVG(D_{< max S}) <= AVG(D), that bound is valid for AVG(D).

A numpy port of the host path of :mod:`repro.core.rangetrim`.

Algorithm 4 streams ``min(v, running_max_before_v)`` into the left state.
**Multiset identity** (property-tested in ``tests/test_rangetrim.py``):
for any sequence v_1..v_m,

    {{ min(v_i, max_{j<i} v_j) : i = 2..m }}  ==  {{ v_1..v_m }} - {{ max }}

(one occurrence of the max removed). Proof sketch: whenever a new running
max arrives it contributes the *previous* max's value, i.e. each prefix-max
"pushes back" its predecessor; every non-record value contributes itself;
the final (global) max is the only value never contributed.

Consequence: the trimmed state equals an O(1) Welford *downdate* of the
plain state (remove one max instance), so RangeTrim needs **no sequential
pass and no per-device trimming** — kernels keep ordinary mergeable moment
states and the trim happens at bound-evaluation time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bounders import Bounder
from repro_torch.core.state import StatsBatch, downdate_extreme_batch

__all__ = ["RangeTrimBounder"]


@dataclasses.dataclass(frozen=True)
class RangeTrimBounder(Bounder):
    """Wraps ``inner`` per Algorithm 4:

    lbound: inner.lbound(S - {max S}, a, max S, N - 1, delta)
    rbound: inner.rbound(S - {min S}, min S, b, N - 1, delta)

    Inherits inner's PMA status; PHOS is eliminated by construction
    (lbound never reads ``b``; rbound never reads ``a``).
    """

    inner: Bounder = None  # type: ignore[assignment]
    name: str = "rangetrim"

    def __post_init__(self):
        from repro_torch.core.bounders import AndersonDKWBounder

        if isinstance(self.inner, AndersonDKWBounder):
            # DKW has no PHOS (Table 2) so RT buys nothing — and its
            # histogram bins are pinned to the engine's [a, b] grid, which a
            # trimmed range would misinterpret. Refuse loudly.
            raise ValueError("RangeTrim(Anderson/DKW) is unsupported: "
                             "DKW already has no PHOS")
        object.__setattr__(self, "name", f"{self.inner.name}+rt")
        object.__setattr__(self, "has_pma", self.inner.has_pma)
        object.__setattr__(self, "has_phos", False)

    def lbound_batch(self, s: StatsBatch, a, b, N, delta) -> np.ndarray:  # aqplint: disable=AQP201(host-only slice of the port: its device twins come with the device-loop slice)
        # NOTE: ``b`` is deliberately unused (PHOS elimination).
        a_arr = np.broadcast_to(np.asarray(a, np.float64), s.count.shape)
        ok = s.count >= 2.0  # cannot trim a 0/1-point sample
        trimmed = downdate_extreme_batch(s, "max")
        # trimmed range: [a, max S]; dead lanes get a finite placeholder so
        # the elementwise inner math stays warning-free (result discarded).
        b_trim = np.where(ok, s.vmax, a_arr + 1.0)
        n_trim = np.maximum(np.asarray(N, np.float64) - 1.0, trimmed.count)
        lb = self.inner.lbound_batch(trimmed, a_arr, b_trim, n_trim, delta)
        return np.where(ok, lb, a_arr)  # trivially valid for count < 2

    def rbound_batch(self, s: StatsBatch, a, b, N, delta) -> np.ndarray:  # aqplint: disable=AQP201(host-only slice of the port: its device twins come with the device-loop slice)
        b_arr = np.broadcast_to(np.asarray(b, np.float64), s.count.shape)
        ok = s.count >= 2.0
        trimmed = downdate_extreme_batch(s, "min")
        a_trim = np.where(ok, s.vmin, b_arr - 1.0)
        n_trim = np.maximum(np.asarray(N, np.float64) - 1.0, trimmed.count)
        rb = self.inner.rbound_batch(trimmed, a_trim, b_arr, n_trim, delta)
        return np.where(ok, rb, b_arr)
