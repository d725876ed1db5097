"""Holding the port's AdamW parameters against the reference's after a
few steps from the same state.

AdamW's update ``m / (sqrt(v) + eps)`` has unit size whatever the
gradient's magnitude, so at each step a parameter moves by ``lr`` at
the relative accuracy of its own element's moments, not of the leaf's
largest gradient: where a gradient is small, or a small difference of
large sums, its rounding noise reaches the parameter undamped.
:func:`close_adamw_params` therefore allows, beside ``tol`` of the
leaf's largest magnitude, ``2 * lr_t * min(rho_m + rho_v, 1)`` an
element for each step ``t``, ``rho`` that element's relative distance
from the reference's first and second moments after the step; the
moments themselves are held at ``tol`` of their leaf by the caller.
"""

import numpy as np
import torch


def _rel(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def close_adamw_params(got, want, steps, tol: float, what: str = ""
                       ) -> None:
    """``got`` (a tensor) against ``want`` (an array) element by element
    within ``tol * max|want|`` plus, for each ``(lr, m_got, m_ref, v_got,
    v_ref)`` of ``steps`` (this leaf's moments after each step),
    ``2 * lr * min(rho_m + rho_v, 1)``."""
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = np.full(got.shape, tol * max(float(np.abs(want).max()), 1e-30))
    for lr, m_got, m_ref, v_got, v_ref in steps:
        bound += 2 * lr * np.minimum(_rel(m_got, m_ref) + _rel(v_got, v_ref),
                                     1.0)
    err = np.abs(got - want)
    i = int(np.argmax(err - bound))
    assert (err <= bound).all(), f"{what}: abs {err.flat[i]} > {bound.flat[i]}"


def moments_of(opt_state) -> dict:
    """``{name: (m, v)}`` numpy copies of a port AdamW state."""
    return {n: (opt_state["m"][n].detach().to(torch.float32).numpy().copy(),
                opt_state["v"][n].detach().to(torch.float32).numpy().copy())
            for n in opt_state["m"]}
