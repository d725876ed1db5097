"""Straggler detection with the paper's own CI machinery.

The port of :mod:`repro.distributed.straggler` (numpy only). Per-host
step durations are a stream of bounded telemetry; one mergeable moment
state is kept per host, and a host is flagged when its mean-step-time CI
lies entirely above ``factor x`` the fleet median estimate — the paper's
threshold-side-determined stopping condition ④ applied to runtime
telemetry. Because the bounders are SSI, flags carry a 1-delta guarantee
per evaluation (no asymptotic assumptions on timing noise), and RangeTrim
keeps one slow outlier step from masking a genuinely slow host (PHOS on
the upper bound would inflate everyone's CI).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.bounders import get_bounder
from repro_torch.core.state import Stats

_HUGE_N = 1e18  # i.i.d. regime (rho -> 1): durations are an open stream


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    factor: float = 1.5          # flag if CI above factor * median estimate
    delta: float = 1e-9
    step_time_bound: float = 3600.0   # catalog range upper bound (s)
    bounder_name: str = "bernstein"
    rangetrim: bool = True
    min_samples: int = 8

    def __post_init__(self):
        self._bounder = get_bounder(self.bounder_name,
                                    rangetrim=self.rangetrim)
        self._times: List[List[float]] = [[] for _ in range(self.n_hosts)]

    def record(self, host_times: np.ndarray):
        """host_times: (n_hosts,) seconds for one step."""
        for h, t in enumerate(np.asarray(host_times, np.float64)):
            self._times[h].append(min(max(float(t), 0.0),
                                      self.step_time_bound))

    def intervals(self) -> np.ndarray:
        out = np.zeros((self.n_hosts, 2))
        for h, ts in enumerate(self._times):
            s = Stats.of_sample(np.asarray(ts))
            lo, hi = self._bounder.interval(
                s, 0.0, self.step_time_bound, _HUGE_N, self.delta)
            out[h] = (lo, hi)
        return out

    def flagged(self) -> List[int]:
        """Hosts whose mean step time is above factor x fleet median w.h.p."""
        counts = np.array([len(t) for t in self._times])
        if (counts < self.min_samples).any():
            return []
        est = np.array([np.mean(t) for t in self._times])
        threshold = self.factor * float(np.median(est))
        ci = self.intervals()
        return [h for h in range(self.n_hosts) if ci[h, 0] > threshold]

    def healthy_quorum(self) -> List[int]:
        flagged = set(self.flagged())
        return [h for h in range(self.n_hosts) if h not in flagged]
