"""Empirical PMA / PHOS detectors (paper §2.3, Definitions 2 & 3).

The port of :mod:`repro.core.pathologies` (float64 numpy on the host,
over the host bounders and :meth:`~repro_torch.core.state.Stats.of_sample`).
They make the paper's pathology taxonomy *executable checks*, so Table 2
is a regression test rather than prose.

PHOS (Def. 3) is checked literally: fix the sample, move only ``b``; if the
*lower* bound moves, the bounder has PHOS.

PMA (Def. 2) is checked via its operational content rather than the literal
existential (which is degenerate: for a constant sample, *every* bounder
with a range term returns equal widths for S and its clamped S', including
Bernstein, contradicting the paper's intent). A PMA-free bounder's width
*adapts to the observed concentration at first order*: for a maximally
concentrated sample, Bernstein's residual range term decays as (b-a)/m
while Hoeffding's and Anderson/DKW's unseen-mass allocation keeps a
(b-a)/sqrt(m) term (the eps mass pinned at ``a`` in Figure 3). So the probe
measures the width-decay exponent on a constant sample: halving-rate
~ sqrt(m) => PMA; ~ m => no PMA.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bounders import Bounder
from repro_torch.core.state import Stats

__all__ = ["exhibits_pma", "exhibits_phos"]

_HIST_BINS = 2048


def _stats(sample: np.ndarray, bounder: Bounder, a: float, b: float) -> Stats:
    needs_hist = "anderson" in bounder.name
    return Stats.of_sample(sample, hist_bins=_HIST_BINS if needs_hist else None,
                           hist_range=(a, b))


def _width(bounder: Bounder, sample, a, b, N, delta) -> float:
    lo, hi = bounder.interval(_stats(np.asarray(sample, np.float64), bounder,
                                     a, b), a, b, N, delta)
    return hi - lo


def exhibits_pma(bounder: Bounder, delta: float = 1e-6) -> bool:
    """Width-decay-exponent probe on a fully concentrated sample.

    On S = {c}*m (all evidence says sigma = 0), the width of a PMA-free
    bounder decays ~1/m; a PMA bounder keeps an O((b-a)/sqrt(m)) term.
    Comparing m vs 16m: ratio ~4 => PMA; ratio ~16 => no PMA.
    """
    a, b = 0.0, 100.0
    c = 7.0
    N = 10_000_000.0
    m1, m2 = 512, 512 * 16
    w1 = _width(bounder, np.full(m1, c), a, b, N, delta)
    w2 = _width(bounder, np.full(m2, c), a, b, N, delta)
    ratio = w1 / max(w2, 1e-30)
    return bool(ratio < 8.0)  # sqrt-decay ~ 4, linear decay ~ 16


def exhibits_phos(bounder: Bounder, delta: float = 1e-6) -> bool:
    """Definition 3 witness: move only ``b``; does the LOWER bound move?

    For histogram-state bounders the bin grid spans [a, b], so moving ``b``
    perturbs the lower bound by up to a couple of bin widths — a
    discretization artifact, not PHOS. The tolerance accounts for it;
    genuine PHOS moves the bound by O(delta b), orders of magnitude more.
    """
    a = 0.0
    b_small, b_big = 20.0, 2000.0
    rng = np.random.default_rng(11)
    s = rng.uniform(5.0, 15.0, size=512)
    N = 1_000_000.0
    lb_small = bounder.lbound(_stats(s, bounder, a, b_small), a, b_small, N,
                              delta)
    lb_big = bounder.lbound(_stats(s, bounder, a, b_big), a, b_big, N, delta)
    needs_hist = "anderson" in bounder.name
    atol = 2.0 * (b_big - a) / _HIST_BINS if needs_hist else 1e-12
    return bool(abs(lb_small - lb_big) > atol)
