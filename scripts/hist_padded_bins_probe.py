#!/usr/bin/env python3
"""How many rows the JAX package's Pallas fused fold keeps when the
histogram's bin count is not a multiple of 128.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/hist_padded_bins_probe.py

Folds 2,048 uniform rows on [0, 100) in 3 groups with the histogram on
(``repro.kernels.fused_scan._fold_local(..., use_hist=True)``) through
the ``ref`` path and through the Pallas kernel under the interpreter, at
100 bins (padded to 128 inside the kernel) and at 1024 bins, and prints
how many rows each histogram holds. The Pallas kernel computes its grid
from the padded bin count, so at 100 bins its top bins' rows fall into
bins that the caller slices off; the PyTorch port bins on the logical
grid, as the ``ref`` path does.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax.numpy as jnp  # noqa: E402
from repro.kernels import fused_scan  # noqa: E402


def main() -> int:
    rng = np.random.default_rng(0)
    n, groups = 2048, 3
    v = jnp.asarray(rng.uniform(0.0, 100.0, n).astype(np.float32))
    g = jnp.asarray(rng.integers(0, groups, n).astype(np.int32))
    m = jnp.ones(n, jnp.float32)
    for nbins in (100, 1024):
        counts = {}
        for impl in ("ref", "interpret"):
            hist = fused_scan._fold_local(v, g, m, 50.0, 0.0, 100.0, groups,
                                          nbins, True, impl)[3]
            counts[impl] = float(hist.sum())
        print(json.dumps(dict(rows=n, nbins=nbins, rows_in_hist=counts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
