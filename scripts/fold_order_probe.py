#!/usr/bin/env python3
"""How much the order of a fold's float32 sums moves the engine's answers.

    PYTHONPATH=src python scripts/fold_order_probe.py [--rows N]

Runs the PyTorch port's ``FastFrame.run`` on the CPU for the queries of
``chip_smoke.py`` (quickstart, F-q1..F-q9, GROUP BY (origin, airline))
twice over one FLIGHTS scramble: once with the plain fold, which adds
each group's rows in row order, and once with a two-pass fold that sums
each 1024-row tile on its own and then adds the tiles' partials in tile
order (the per-block-partial design of a GPU fold). It prints, per query,
whether the scan decisions agree and the largest relative difference of
the estimates and interval endpoints, then the worst of them.

The CUDA fold kernel keeps row order because of this: the card's run is
held to the CPU run at 1e-6 relative.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import repro_torch.aqp as T  # noqa: E402
from repro_torch.aqp import flights_queries as fq  # noqa: E402
from repro_torch.core import optstop as opt  # noqa: E402
from repro_torch.data import flights  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TILE_ROWS = 1024
_row_order = ref.block_agg_ref


def _two_pass(values, gids, mask, center, *, num_groups):
    """Per-tile partials of the plain fold, then their sum in tile order."""
    v, g, m = (t.reshape(-1) for t in (values, gids, mask))
    sums = torch.zeros((3, num_groups), dtype=torch.float32)
    vmin = torch.full((1, num_groups), float("inf"))
    vmax = torch.full((1, num_groups), float("-inf"))
    for s in range(0, v.shape[0], TILE_ROWS):
        p, lo, hi = _row_order(v[s:s + TILE_ROWS], g[s:s + TILE_ROWS],
                               m[s:s + TILE_ROWS], center,
                               num_groups=num_groups)
        sums = sums + p
        vmin, vmax = torch.minimum(vmin, lo), torch.maximum(vmax, hi)
    return sums, vmin, vmax


def _run(sc, q, fold):
    ref.block_agg_ref = fold
    try:
        return T.FastFrame(sc, T.EngineConfig(), device="cpu").run(
            q, sampling="active_peek", seed=0)
    finally:
        ref.block_agg_ref = _row_order


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="FLIGHTS rows (chip_smoke's card-vs-CPU size)")
    args = ap.parse_args(argv)
    ds = flights.generate(n_rows=args.rows, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    worst = 0.0
    for name, q in chip_smoke.main_path_queries(T, fq, opt).items():
        a, b = _run(sc, q, _row_order), _run(sc, q, _two_pass)
        same = all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in chip_smoke.DECISION_FIELDS)
        rel = 0.0
        for f in ("estimate", "lo", "hi"):
            x, y = getattr(b, f), getattr(a, f)
            fin = np.isfinite(x) & np.isfinite(y)
            if fin.any():
                rel = max(rel, float(np.max(np.abs(x[fin] - y[fin]) /
                                            np.maximum(np.abs(y[fin]),
                                                       1e-300))))
        worst = max(worst, rel)
        print(json.dumps(dict(query=name, rounds=a.rounds,
                              decisions_equal=same, ci_max_rel=rel)),
              flush=True)
    print(json.dumps(dict(rows=args.rows, worst_ci_max_rel=worst)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
