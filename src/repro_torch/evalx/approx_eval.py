"""ApproxEval: CI-guaranteed early-stopped model evaluation.

The port of :mod:`repro.evalx.approx_eval`. This is the paper's AVG query
where the "column" is produced by a neural net: the eval set is stored as
a *scramble* (pre-shuffled example order), each OptStop round runs the
model on the next batch of unseen examples, and the per-token losses
stream into a mergeable moment state. The Bernstein+RT bounder turns that
into an anytime-valid CI for the full-set mean loss; evaluation stops at
the requested absolute / relative accuracy (stopping conditions ② / ③) —
typically after a small fraction of the set.

The model runs on the card; the fold and the bound run on the host, as
in the reference: each round's losses and mask come back in one copy,
are clipped in float64 numpy and folded with
:meth:`~repro_torch.core.state.Stats.of_sample` and
:func:`~repro_torch.core.state.merge_moments_host`.

Boundedness: range-based CIs need a data range. Per-token CE over a
``V``-way softmax is clipped to [0, 2 ln V] (a fixed, model-independent
transform applied identically to every token), and the certificate is for
the mean *clipped* loss — stated on the report. With the clip at ~2x the
uniform-prediction loss, clipping is vanishingly rare in practice
(``clip_fraction`` on the report tracks it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bounders import get_bounder
from repro_torch.core.optstop import RunningInterval, delta_schedule
from repro_torch.core.state import (MomentState, Stats, init_moments_host,
                                    merge_moments_host)


@dataclasses.dataclass
class EvalReport:
    mean_estimate: float
    lo: float
    hi: float
    tokens_used: int
    examples_used: int
    total_examples: int
    rounds: int
    stopped_early: bool
    clip_fraction: float
    loss_clip: float

    @property
    def fraction_used(self) -> float:
        return self.examples_used / max(self.total_examples, 1)


def _losses_to_host(losses, mask) -> Tuple[np.ndarray, np.ndarray]:
    """Flat float64 losses and a bool mask on the host, in one
    device-to-host copy: the mask cast to the losses' dtype and stacked
    under them (tensors on any device, or arrays)."""
    flat = torch.as_tensor(losses).detach().reshape(-1)
    m = torch.as_tensor(mask, device=flat.device).reshape(-1)
    both = torch.stack([flat, m.to(flat.dtype)]).cpu().numpy()
    return both[0].astype(np.float64), both[1] > 0


class ApproxEval:
    """Evaluate ``loss_fn`` over a scrambled eval set with CI guarantees.

    loss_fn(batch) -> (per_token_losses, mask) of one shape, tensors on
    any device or arrays — typically a closure over a model on the
    card.
    """

    def __init__(self, loss_fn: Callable, vocab: int,
                 delta: float = 1e-9, bounder: str = "bernstein",
                 rangetrim: bool = True,
                 loss_clip: Optional[float] = None):
        self.loss_fn = loss_fn
        self.delta = delta
        self.bounder = get_bounder(bounder, rangetrim=rangetrim)
        self.loss_clip = loss_clip or 2.0 * math.log(max(vocab, 2))

    def run(self, batches, total_examples: int,
            target_width: Optional[float] = None,
            target_rel: Optional[float] = None,
            max_rounds: int = 10_000) -> EvalReport:
        """batches: iterable of eval batches in scramble order (each a dict
        for loss_fn); total_examples: |eval set| (for the Serfling factor —
        an upper bound is fine by dataset-size monotonicity)."""
        assert target_width or target_rel
        state = init_moments_host(())
        interval = RunningInterval()
        clipped = 0.0
        total_tok = 0.0
        examples = 0
        rounds = 0
        stopped_early = False
        # N for the without-replacement factor: token count unknown ahead of
        # time; use examples as the exchangeable unit via a conservative
        # token-level N upper bound (examples * max_tokens_seen).
        max_tok_per_ex = 1.0
        for batch in batches:
            rounds += 1
            losses, mask = _losses_to_host(*self.loss_fn(batch))
            vals = losses[mask]
            clipped += float((vals > self.loss_clip).sum())
            vals = np.clip(vals, 0.0, self.loss_clip)
            total_tok += vals.size
            bsz = int(next(iter(batch.values())).shape[0])
            examples += bsz
            max_tok_per_ex = max(max_tok_per_ex, vals.size / max(bsz, 1))
            s_new = Stats.of_sample(vals)
            state = merge_moments_host(
                state,
                MomentState(np.float64(s_new.count), np.float64(s_new.mean),
                            np.float64(s_new.m2), np.float64(s_new.vmin),
                            np.float64(s_new.vmax)))
            dk = delta_schedule(self.delta, rounds)
            s = Stats(float(state.count), float(state.mean),
                      float(state.m2), float(state.vmin),
                      float(state.vmax))
            n_upper = max(total_examples * max_tok_per_ex, s.count)
            lo, hi = self.bounder.interval(s, 0.0, self.loss_clip, n_upper,
                                           dk)
            interval.update(lo, hi)
            est = s.mean
            done = False
            if target_width is not None:
                done = interval.width < target_width
            if not done and target_rel is not None and interval.lo > 0:
                rel = max((interval.hi - est) / interval.hi,
                          (est - interval.lo) / interval.lo)
                done = rel < target_rel
            if done:
                stopped_early = examples < total_examples
                break
            if rounds >= max_rounds or examples >= total_examples:
                break
        return EvalReport(
            mean_estimate=float(state.mean), lo=interval.lo, hi=interval.hi,
            tokens_used=int(total_tok), examples_used=examples,
            total_examples=total_examples, rounds=rounds,
            stopped_early=stopped_early,
            clip_fraction=clipped / max(total_tok, 1.0),
            loss_clip=self.loss_clip)
