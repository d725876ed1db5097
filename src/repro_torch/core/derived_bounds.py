"""Derived range bounds for aggregates over expressions (paper Appendix B).

Given per-column catalog ranges ``c_i in [a_i, b_i]`` and an aggregate
``AVG(f(c_1..c_n))``, compute derived bounds [a', b'] enclosing f over the
box, to feed any range-based bounder:

* monotone f     -> evaluate at the 2 monotone corners          (exact)
* convex f       -> max at a box corner (2^n enumeration);
                    min via projected gradient descent (torch.autograd)
* concave f      -> dual of convex
* anything else  -> refused (no silently-unsound bounds).

The port of :mod:`repro.core.derived_bounds`. ``f`` takes a float32
tensor of length n, as the JAX package evaluates it in float32 with its
default 64-bit types off; the value column itself is float32 too.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["derived_range", "corner_extremes", "box_minimize"]

_MAX_CORNER_COLS = 20  # paper: "any n <= 20 or so can be handled"


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def corner_extremes(f: Callable, boxes: Sequence[Tuple[float, float]]
                    ) -> Tuple[float, float]:
    """Evaluate f on all 2^n box corners; returns (min, max) over corners."""
    n = len(boxes)
    if n > _MAX_CORNER_COLS:
        raise ValueError(f"corner enumeration over {n} > {_MAX_CORNER_COLS} "
                         "columns; decompose the expression")
    corners = np.array(list(itertools.product(*boxes)), dtype=np.float64)
    vals = np.array([float(f(_f32(c))) for c in corners])
    return float(vals.min()), float(vals.max())


def box_minimize(f: Callable, boxes: Sequence[Tuple[float, float]],
                 steps: int = 400, n_starts: int = 8,
                 seed: int = 0) -> float:
    """Projected gradient descent under box constraints (convex f => global
    minimum). Multi-start for robustness; steps sized by box diameter.

    The first start is the box centre; the other ``n_starts - 1`` are
    uniform in the box from a CPU ``torch.Generator`` seeded with
    ``seed``. They are not the JAX package's points (``jax.random``
    draws other numbers), so the two agree where the minimum is unique."""
    lo = _f32([b[0] for b in boxes])
    hi = _f32([b[1] for b in boxes])
    span = torch.clamp(hi - lo, min=1e-9)
    gen = torch.Generator().manual_seed(seed)
    starts = [lo + (hi - lo) * 0.5]
    starts += [lo + (hi - lo) * torch.rand(lo.shape, generator=gen)
               for _ in range(n_starts - 1)]
    best = math.inf
    for x in starts:
        x = x.clone()
        for i in range(steps):
            lr = 0.5 * math.exp(-3.0 * i / steps)  # annealed, scale-free
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                torch.as_tensor(f(xg), dtype=torch.float32).sum(), xg)
            gn = torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
            x = torch.minimum(torch.maximum(x - lr * span * g / gn, lo), hi)
        with torch.no_grad():
            best = min(best, float(f(x)))
    return best


def derived_range(
    f: Callable,
    boxes: Sequence[Tuple[float, float]],
    *,
    monotone: Optional[Sequence[int]] = None,
    convex: Optional[bool] = None,
) -> Tuple[float, float]:
    """Derived [a', b'] for f over the box (Appendix B).

    Args:
      f: torch-traceable function of a length-n float32 tensor.
      boxes: per-column (a_i, b_i) catalog ranges.
      monotone: per-column monotonicity signs (+1 / -1) if f is monotone.
      convex: True if f is convex, False if concave, None otherwise.
    """
    if monotone is not None:
        lo_pt = _f32([b[0] if s > 0 else b[1]
                      for b, s in zip(boxes, monotone)])
        hi_pt = _f32([b[1] if s > 0 else b[0]
                      for b, s in zip(boxes, monotone)])
        return float(f(lo_pt)), float(f(hi_pt))
    if convex is True:
        _, hi = corner_extremes(f, boxes)       # convex max at a corner
        lo = box_minimize(f, boxes)             # convex min via PGD
        return lo, hi
    if convex is False:
        lo, _ = corner_extremes(f, boxes)       # concave min at a corner
        hi = -box_minimize(lambda x: -f(x), boxes)
        return lo, hi
    raise ValueError(
        "derived_range needs a structure certificate (monotone=... or "
        "convex=...); refusing to emit unsound bounds for arbitrary f")
