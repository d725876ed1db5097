"""Threshold monitors: HAVING-style alarms on metric streams (stopping
condition ④ applied to framework telemetry).

The port of :mod:`repro.evalx.monitors`. A ThresholdMonitor consumes
mergeable MomentStates (e.g. the ``loss_ci_state`` every train step
emits, whose fields are tensors on the card) over a *stationary window*
and fires only when the windowed mean's CI clears the threshold — alarms
carry a 1-delta guarantee instead of being point-estimate noise. Typical
uses: grad-norm spike escalation, eval-loss regression gates,
data-pipeline staleness checks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.bounders import get_bounder
from repro_torch.core.optstop import delta_schedule
from repro_torch.core.state import (MomentState, Stats, init_moments_host,
                                    merge_moments_host, to_host)


@dataclasses.dataclass
class ThresholdMonitor:
    threshold: float
    value_range: Tuple[float, float]
    delta: float = 1e-9
    direction: str = "above"      # fire when mean is above/below threshold
    bounder_name: str = "bernstein"
    rangetrim: bool = True

    def __post_init__(self):
        self._bounder = get_bounder(self.bounder_name,
                                    rangetrim=self.rangetrim)
        self.reset()

    def reset(self):
        self._state = init_moments_host(())
        self._rounds = 0

    def update(self, state: MomentState) -> Optional[bool]:
        """Merge one step's MomentState (host arrays, or tensors on any
        device: one host copy, :func:`~repro_torch.core.state.to_host`);
        returns True/False when the side is determined w.h.p., None while
        undecided."""
        self._state = merge_moments_host(self._state, to_host(state))
        self._rounds += 1
        if float(self._state.count) <= 1:
            return None
        lo, hi = self.interval()
        if lo > self.threshold:
            return self.direction == "above"
        if hi < self.threshold:
            return self.direction == "below"
        return None

    def interval(self) -> Tuple[float, float]:
        """The windowed mean's CI at the last update's scheduled delta
        (the interval :meth:`update` decides on)."""
        a, b = self.value_range
        s = Stats(float(self._state.count), float(self._state.mean),
                  float(self._state.m2), float(self._state.vmin),
                  float(self._state.vmax))
        dk = delta_schedule(self.delta, max(self._rounds, 1))
        return self._bounder.interval(s, a, b, 1e18, dk)
