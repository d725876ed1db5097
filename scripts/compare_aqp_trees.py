#!/usr/bin/env python3
"""One source tree's AQP kernels and default-bounder path, timed by this
checkout's yardsticks, so that two commits compare within one card call.

    python3 scripts/compare_aqp_trees.py [--src DIR] [--rows N]

``--src`` names the source tree whose ``repro_torch`` runs (default:
this checkout's ``src``); another commit, unpacked beside this one,
builds its kernels into its own ``build/kernels``. Run it once per tree
in turns (parent, change, change, parent) in one call on one card.

For that tree it prints the card's name and power limit as
``nvidia-smi`` gives them, then one JSON line:

  * ``kernels``: ``chip_smoke.py``'s phase-2 checks of this checkout
    (its ``Timer``: CUDA events, L2 flushed before each call) at the
    phase-2 shapes and seeds: ``grouped_hist`` at 1,048,576 rows and
    phase 2's G (with its CUDA launches a call), ``block_agg`` and
    ``fused_fold`` at G 1,
    200 and 2800 on general data, the ``bitmap_active`` probe at W 7
    and 88 (over the 4096-row window and over all 97,657 rows), and the
    fused round's head at W 88: the tree's ``round_select`` where it
    has one, and the unfused head (the probe kernel plus the tree's
    plain selection) in every tree;
  * ``bernstein``: phase 3's default-bounder path (the quickstart,
    F-q1..F-q9 and the G 2800 GROUP BY on one frame of ``--rows``
    FLIGHTS rows) with its rounds, wall seconds and ``StepClock``
    seconds per query and summed. Every interval must cover the numpy
    truth, as in phase 3 (``--kernels-only`` skips it).

Needs CUDA and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
KEEP = ("ok", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "window_ms", "window_bound_ms", "unfused_ms", "probe_ms", "bitwise",
        "regime", "cuda_launches")


def pick(r: dict) -> dict:
    return {k: r[k] for k in KEEP if k in r}


def kernel_times(torch, smoke, timer, ref, kbit, kblock, kfused, khist,
                 fused_scan):
    out = {}
    for G in smoke.HIST_GROUPS:  # general data; the path's G on both
        for exact in (False, True)[:1 + (G == smoke.HIST_PATH_GROUPS)]:
            out[f"grouped_hist_G{G}" + "_exact" * exact] = pick(
                smoke.check_grouped_hist(
                    torch, timer, ref, khist, G, exact, rows=smoke.HIST_ROWS,
                    nbins=smoke.HIST_BINS, seed=G + 2))
    for G in (1, 200, 2800):
        out[f"block_agg_G{G}"] = pick(smoke.check_block_agg(
            torch, timer, ref, kblock, G, False, nb=8192,
            block_rows=1024, budget=64, seed=G))
        out[f"fused_fold_G{G}"] = pick(smoke.check_fused_fold(
            torch, timer, ref, kfused, kblock, G, False, nb=8192,
            block_rows=1024, budget=64, nbins=smoke.HIST_BINS, seed=G + 1))
    nb, window, budget = 97_657, 4096, 64
    for W in (7, 88):
        out[f"active_blocks_W{W}"] = pick(smoke.check_bitmap_active(
            torch, timer, ref, kbit, W, nb=nb, window=window, seed=W))
    # the round head at W 88, seed as phase 2's; a tree from before the
    # head had its selection in fused_scan
    sel = ref if hasattr(ref, "budget_select_ref") else SimpleNamespace(
        budget_select_ref=fused_scan._budget_select,
        gather_blocks_ref=fused_scan._gather_blocks)
    order_pad, static_ok, words, actives = smoke.head_inputs(
        torch, 88, nb, window, 88 + 3)
    act, pos = actives[0], nb // 3
    head = {}
    if hasattr(sel, "round_window_ref"):  # a tree with the device cursor
        cursor = (torch.tensor(pos, dtype=torch.int64, device="cuda"),
                  torch.ones((), dtype=torch.bool, device="cuda"))
        head["unfused_ms"] = timer(lambda: smoke.unfused_head(
            torch, sel, kbit, order_pad, static_ok, words, act, cursor[0],
            nb, window, budget))
    else:
        cursor = (pos,)
    if hasattr(kbit, "round_select"):
        head["ms"] = timer(lambda: kbit.round_select(
            order_pad, static_ok, words, act, *cursor, nb=nb, window=window,
            budget=budget, probe=True))
    out["round_head_W88"] = head
    return out


def bernstein_path(torch, np, smoke, T, fq, opt, flights, rows: int):
    ds = flights.generate(n_rows=rows, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    # the per-round host loop in every tree (StepClock times its steps)
    frame = T.FastFrame(sc, T.EngineConfig(device_loop=False), device="cuda")
    runs = smoke.main_path_queries(T, fq, opt)
    truths = {k: smoke.truth_of(np, ds.columns, q) for k, q, _ in runs}
    queries, misses = [], []
    t_path = time.perf_counter()
    with smoke.StepClock(T.engine) as clock:
        for name, q, sampling in runs:
            t0 = time.perf_counter()
            res = frame.run(q, sampling=sampling, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if len(smoke.uncovered(np, res, *truths[name], rtol=1e-4)):
                misses.append(name)
            queries.append(dict(query=name, rounds=res.rounds, wall_s=wall,
                                steps_s=clock.take()))
    wall = time.perf_counter() - t_path
    steps = {}
    for q in queries:
        for k, v in q["steps_s"].items():
            steps[k] = steps.get(k, 0.0) + v
    return dict(rows=rows, blocks=sc.n_blocks, wall_s=wall,
                total_rounds=sum(q["rounds"] for q in queries),
                steps_s=steps, covered=not misses, misses=misses,
                queries=queries)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="source tree whose repro_torch runs")
    ap.add_argument("--rows", type=int, default=100_000_000,
                    help="FLIGHTS rows of the path (phase 3's default)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels, skip the default-bounder path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_aqp_trees: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as smoke
    import repro_torch
    import repro_torch.aqp as T
    from repro_torch.aqp import flights_queries as fq
    from repro_torch.core import optstop as opt
    from repro_torch.data import flights
    from repro_torch.kernels import _build, fused_scan, ref
    from repro_torch.kernels import bitmap_active as kbit
    from repro_torch.kernels import block_agg as kblock
    from repro_torch.kernels import fused_fold as kfused
    from repro_torch.kernels import grouped_hist as khist

    print(smoke.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    timer = smoke.Timer(torch)
    kernels = kernel_times(torch, smoke, timer, ref, kbit, kblock, kfused,
                           khist, fused_scan)
    del timer
    torch.cuda.empty_cache()
    path = None if args.kernels_only else bernstein_path(
        torch, np, smoke, T, fq, opt, flights, args.rows)
    print(json.dumps(dict(
        src=str(Path(repro_torch.__file__).resolve().parents[1]),
        build_s=build_s, kernels=kernels, bernstein=path)), flush=True)
    # a histogram row's ok also holds the launch contract, which a tree
    # from before it does not meet: its bits decide here
    return 0 if (path is None or path["covered"]) and all(
        k.get("bitwise", k.get("ok", True)) for k in kernels.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
