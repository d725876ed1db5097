#!/usr/bin/env python3
"""The AQP round's kernels as they are and in variants, timed on the
card by CUDA events and by the profiler's device spans.

    python3 scripts/aqp_kernel_variants.py [--reps N] [--src DIR]
        [--builds current,NAME,...] [--parts head,fold,flights,hist]

Builds the port's kernel library from ``src/repro_torch/kernels/csrc``
as it is (``current``) and once per variant below (one source edit
each; the ``DROPS`` leave a part out to time it), each into a directory
of its own under ``build/aqp_variants``.
For each build, in turn and then in reverse order, it checks and times,
at ``chip_smoke.py``'s phase-2 shapes:

  * the fused round's head (``round_select``, window 4096, budget 64) at
    W 1, 7, 88 and 320, bit for bit against the plain sequence, beside
    the standalone probe (``active_blocks``) at W 88;
  * ``fused_fold`` (64 blocks of 1024 rows, 1024 bins) at G 1, 200 and
    2800 on general data, bit for bit against the plain version, beside
    ``block_agg`` at G 2800 (the ``slices*`` builds cut the lane-mode
    bins of G 2800 into 2 or 4 slices, where the plan takes one);
  * both folds at G 2800 on the main path's groups: 64 random blocks of
    a 2M-row FLIGHTS scramble grouped by (origin, airline), whose Zipf
    skew puts a third of the rows in one lane-mode bucket, in lane mode
    (the plan) and forced into warp mode;
  * ``grouped_hist`` (1,048,576 rows, 1024 bins) at phase 2's G on its
    general data, bit for bit against the plain version, and on the
    first 1,048,576 rows of that scramble grouped by airline (G 14: the
    exact sweep's F-q2) and by (origin, airline) (G 2800), dep_delay
    over [-60, 1800] (the ``hist_bucketed_all`` build counts every cell
    space in buckets, where the plan keeps private copies up to 57,344
    cells).

``--src`` names another source tree whose ``repro_torch`` runs (its own
kernels, built from its ``csrc``; another commit unpacked beside this
one, as for ``compare_aqp_trees.py``); ``--builds`` and ``--parts`` pick
the builds and the measurements.

Each time is given twice: ``chip_smoke.Timer``'s CUDA-event median (L2
flushed before each call; it counts the launch, and the wrapper's host
time where that outlasts the flush), and from a ``torch.profiler`` trace
of the same calls the median device span of a call (first kernel start
to last kernel end) and each kernel's median duration. Prints the card's
name and power limit as ``nvidia-smi`` gives them, then one JSON line a
build. Needs CUDA and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

OUT = ROOT / "build" / "aqp_variants"
_FEWEST_EXPR = "(nbins + max_bins - 1) / max_bins"
_FEWEST = f"const int slices = {_FEWEST_EXPR};"
# name: (source file, text in it, its replacement)
VARIANTS = {
    # the round head's warp-mode probe loading 4 words a lane a pass, not 8
    "word_pass4": ("bitmap_active.cu", "constexpr int kWordPass = 8;",
                   "constexpr int kWordPass = 4;"),
    # the fused walk's bins in at least 2 or 4 slices, one CTA a slice
    **{f"slices{n}": ("block_agg.cuh", _FEWEST,
                      f"const int slices = {_FEWEST_EXPR} > {n} ? "
                      f"{_FEWEST_EXPR} : {n};") for n in (2, 4)},
}
# Parts left out, to time each part: these builds give wrong results
# (their check prints ok false) and exist only for their times.
DROPS = {
    # the round head without its selection: the probe and the flag writes
    "head_probe_only": ("bitmap_active.cu",
                        "  __syncthreads();  // s_row and s_flag are written\n",
                        "  return;\n"),
    # the round head without its look-back (every CTA takes prefix 0)
    "head_no_lookback": ("bitmap_active.cu",
                         "  if (warp == 0) {  // look-back: flags of the "
                         "CTAs before this one\n",
                         "  if (t == 0) s_prefix = 0;\n  if (false) {\n"),
    # the fused walk without its histogram write, its counting, its zeroing
    "walk_no_write": ("block_agg.cuh", "    for (int j = 0; j < rows; ++j) {",
                      "    for (int j = 0; j < 0; ++j) {"),
    "walk_no_count": ("block_agg.cuh",
                      "atomicAdd(hs.counts + (kLane ? lg[u] * hs.stride : 0)"
                      " + b, 1u);", ""),
    "walk_no_zero": ("block_agg.cuh",
                     "      s_counts[i] = make_uint4(0u, 0u, 0u, 0u);", ""),
}
VARIANTS.update(DROPS)
# grouped_hist counting every cell space in buckets; the wrapper's plan
# is swapped for its bucketed regime with it
VARIANTS["hist_bucketed_all"] = ("grouped_hist.cu",
                                 "  if (cells <= kMaxCells) {",
                                 "  if (false) {")
# the wrapper's attributes that a build changes with it
PATCHES = {"hist_bucketed_all": lambda k: {"plan": k.bucketed_plan}}
# grouped_hist without a part, to time it (wrong results, as DROPS)
_PRIV_COUNT = ("      if (cell[u] != kNoCell) atomicAdd(s_counts + cell[u], "
               "1u);")
_PRIV_REDS = "    unsigned* d = counters + 4 * i;"
_PRIV_TAIL = "  grid_barrier(counters + kMaxCells);  // every CTA's adds are in"
HIST_DROPS = {
    # the private regime without its shared-memory counting
    "hist_priv_no_count": ("grouped_hist.cu", _PRIV_COUNT,
                           _PRIV_COUNT.replace("!=", "== 1u +")),
    # ... without the reductions of the pooled copies into the device
    # copy
    "hist_priv_no_reds": ("grouped_hist.cu", _PRIV_REDS,
                          _PRIV_REDS + "\n    c = make_uint4(0u, 0u, 0u, 0u);"),
    # ... without the grid barrier and the float32 writes (the cluster
    # waits for its peers' reads of its copies before it leaves)
    "hist_priv_no_tail": ("grouped_hist.cu", _PRIV_TAIL,
                          "  cluster.sync();\n  return;"),
}
VARIANTS.update(HIST_DROPS)
# grouped_hist's row loads without the streaming hint; 1024 buckets
VARIANTS["hist_ldg"] = ("grouped_hist.cu", "__ldcs(", "__ldg(")
VARIANTS["hist_buckets1024"] = ("grouped_hist.cu",
                                "constexpr int kTargetBuckets = 256;",
                                "constexpr int kTargetBuckets = 1024;")
PATCHES["hist_buckets1024"] = lambda k: {"TARGET_BUCKETS": 1024}
for _k in (1, 4):  # private CTAs pooling their copies in other clusters
    VARIANTS[f"hist_cluster{_k}"] = ("grouped_hist.cu",
                                     "constexpr int kCluster = 2;",
                                     f"constexpr int kCluster = {_k};")
    PATCHES[f"hist_cluster{_k}"] = lambda k, c=_k: {"CLUSTER": c}
HEAD_W = (1, 7, 88, 320)
FOLD_G = (1, 200, 2800)
PARTS = ("head", "fold", "flights", "hist")


def build_variant(_build, name: str):
    """The kernel library of one build, loaded with the port's
    signatures."""
    csrc = OUT / name / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    if name != "current":
        file, old, new = VARIANTS[name]
        text = (csrc / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: text not found in {file}")
        (csrc / file).write_text(text.replace(old, new))
    saved = _build.CSRC, _build.BUILD_ROOT
    _build.CSRC, _build.BUILD_ROOT = csrc, OUT / name / "kernels"
    try:
        path = _build.build()
    finally:
        _build.CSRC, _build.BUILD_ROOT = saved
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _build._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    log = (path.parent / "build.log").read_text()
    return lib, [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]


def device_spans(torch, timer, fn, reps: int):
    """Median device span of a call and median duration of each kernel,
    from a trace of ``reps`` calls, each after the timer's L2 flush."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    calls, by_name = [], collections.defaultdict(list)
    for start, end, name in events:
        if "FillFunctor" in name and end - start > 20:  # the flush
            calls.append([])
            continue
        if calls:
            calls[-1].append((start, end))
            by_name[name[:60]].append((end - start) / 1e3)
    spans = [(max(e for _, e in c) - min(s for s, _ in c)) / 1e3
             for c in calls if c]
    if not spans:  # the trace holds no device activity
        return None, {}
    return (statistics.median(spans),
            {k: statistics.median(v) for k, v in by_name.items()})


def flights_inputs(torch):
    """On a 2M-row FLIGHTS scramble: the fused round's fold inputs for the
    (origin, airline) GROUP BY (G 2800: dep_delay, the group codes, the
    valid mask and 64 random blocks), and the histogram's flat inputs of
    its first 1,048,576 rows grouped by airline (G 14) and by (origin,
    airline) (G 2800), on the card."""
    import numpy as np
    import repro_torch.aqp as T
    from repro_torch.data import flights
    ds = flights.generate(n_rows=2_000_000, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    cols = sc.columns
    gids = cols["origin"].astype(np.int64) * sc.categorical["airline"] \
        + cols["airline"]
    blk = np.random.default_rng(0).choice(sc.n_blocks, 64, replace=False)
    dev = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x)).cuda()
    values = cols["dep_delay"].astype(np.float32)
    valid = sc.valid.astype(np.float32)
    fold = [dev(x) for x in (values, gids.astype(np.int32), valid,
                             blk.astype(np.int32), np.ones(64, np.int32))]
    rows = smoke.HIST_ROWS
    hist = {G: [dev(x.reshape(-1)[:rows]) for x in (values, g, valid)]
            for G, g in ((14, cols["airline"].astype(np.int32)),
                         (2800, gids.astype(np.int32)))}
    return fold, hist


def measure_hist(torch, timer, ref, khist, reps: int, flights_hist) -> dict:
    out = {}
    nbins = smoke.HIST_BINS
    cases = [(f"hist_G{G}", G) + smoke.hist_inputs(
        torch, G, False, smoke.HIST_ROWS, nbins, G + 2)
        for G in smoke.HIST_GROUPS]
    cases += [(f"flights_hist_G{G}", G, *rows, -60.0, 1800.0)
              for G, rows in flights_hist.items()]
    for key, G, values, gids, mask, a, b in cases:
        run = lambda: khist.grouped_hist(  # noqa: E731
            values, gids, mask, a, b, G, nbins)
        want = ref.grouped_hist_ref(values.cpu(), gids.cpu(), mask.cpu(), a,
                                    b, num_groups=G, nbins=nbins)
        ok = torch.equal(run().cpu(), want)
        span, kernels = device_spans(torch, timer, run, reps)
        out[key] = dict(ok=ok, ms=timer(run, reps), span_ms=span,
                        kernels_ms=kernels)
    return out


def measure(torch, timer, ref, kbit, kblock, kfused, khist, reps: int,
            flights_in, parts) -> dict:
    out = {}
    if "hist" in parts:
        out.update(measure_hist(torch, timer, ref, khist, reps,
                                flights_in[1]))
    nb = 97_657
    for W in HEAD_W if "head" in parts else ():
        order_pad, static_ok, words, actives = smoke.head_inputs(
            torch, W, nb, 4096, W + 3)
        kw = dict(nb=nb, window=4096, budget=64, probe=True)
        pos = nb // 3
        # the device cursor and go flag where the tree's head takes them
        cursor = ((torch.tensor(pos, dtype=torch.int64, device="cuda"),
                   torch.ones((), dtype=torch.bool, device="cuda"))
                  if hasattr(ref, "round_window_ref") else (pos,))
        run = lambda: kbit.round_select(  # noqa: E731
            order_pad, static_ok, words, actives[0], *cursor, **kw)
        want = ref.round_select_ref(order_pad, static_ok, words, actives[0],
                                    *cursor, **kw)
        ok = all(torch.equal(x, y) for x, y in zip(run(), want))
        span, kernels = device_spans(torch, timer, run, reps)
        out[f"head_W{W}"] = dict(ok=ok, ms=timer(run, reps), span_ms=span,
                                 kernels_ms=kernels)
        if W == 88:
            probe = lambda: kbit.active_blocks(  # noqa: E731
                words, actives[0], order_pad[pos:pos + 4096])
            span, kernels = device_spans(torch, timer, probe, reps)
            out["probe_W88"] = dict(ms=timer(probe, reps), span_ms=span,
                                    kernels_ms=kernels)
    for G in FOLD_G if "fold" in parts else ():
        values, gids, mask, blk, tvalid, center, a, b = smoke.fold_inputs(
            torch, G, False, 8192, 1024, 64, G + 1)
        args = (values, gids, mask, blk, tvalid, center, a, b, G, 1024)
        sel = [t[blk.long()].cpu() for t in (values, gids, mask)]
        want = ref.fused_fold_ref(*sel, torch.arange(64, dtype=torch.int32),
                                  tvalid.cpu(), center, a, b, num_groups=G,
                                  nbins=1024)
        run = lambda: kfused.fused_fold(*args)  # noqa: E731
        ok = all(bool(smoke._same(torch, x, y).all())
                 for x, y in zip(run(), want))
        span, kernels = device_spans(torch, timer, run, reps)
        out[f"fused_G{G}"] = dict(ok=ok, ms=timer(run, reps), span_ms=span,
                                  kernels_ms=kernels)
        if G == 2800:
            agg = lambda: kblock.block_agg(  # noqa: E731
                values, gids, mask, blk, tvalid, center, G)
            span, kernels = device_spans(torch, timer, agg, reps)
            out["block_agg_G2800"] = dict(ms=timer(agg, reps), span_ms=span,
                                          kernels_ms=kernels)
    lane_rows = kblock.LANE_MODE_ROWS
    modes = (("lane", lane_rows), ("warp", 0)) if "flights" in parts else ()
    for mode, rows in modes:
        kblock.LANE_MODE_ROWS = rows  # 0: warp mode at any G
        try:
            for name, fn in (
                    ("block_agg", lambda: kblock.block_agg(
                        *flights_in[0], 870.0, 2800)),
                    ("fused_fold", lambda: kfused.fused_fold(
                        *flights_in[0], 870.0, -60.0, 1800.0, 2800, 1024))):
                span, kernels = device_spans(torch, timer, fn, reps)
                out[f"flights_{name}_{mode}"] = dict(
                    ms=timer(fn, reps), span_ms=span, kernels_ms=kernels)
        finally:
            kblock.LANE_MODE_ROWS = lane_rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="source tree whose repro_torch runs")
    ap.add_argument("--builds", default=",".join(["current", *VARIANTS]),
                    help="comma-separated builds (default: all)")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated measurements (default: all)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("aqp_kernel_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitmap_active as kbit
    from repro_torch.kernels import block_agg as kblock
    from repro_torch.kernels import fused_fold as kfused
    from repro_torch.kernels import grouped_hist as khist
    from repro_torch.kernels import ref

    print(smoke.nvidia_smi_line(), flush=True)
    parts = args.parts.split(",")
    libs = {}
    for n in args.builds.split(","):
        try:
            libs[n] = build_variant(_build, n)
        except RuntimeError as err:  # a variant that does not build
            if n == "current":
                raise
            print(json.dumps(dict(build=n, error=str(err)[-2000:])),
                  flush=True)
    names = list(libs)
    timer = smoke.Timer(torch)
    flights_in = flights_inputs(torch)
    for n in names + names[::-1]:
        _build._lib = libs[n][0]
        # a drop can leave the private counters dirty: each build starts
        # from zeroed ones
        getattr(khist, "_counters", {}).clear()
        patch = PATCHES[n](khist) if n in PATCHES else {}
        saved = {a: getattr(khist, a) for a in patch}
        for a, v in patch.items():
            setattr(khist, a, v)
        try:
            run = measure(torch, timer, ref, kbit, kblock, kfused, khist,
                          args.reps, flights_in, parts)
        finally:
            for a, v in saved.items():
                setattr(khist, a, v)
        print(json.dumps(dict(build=n, src=str(args.src), ptxas=libs[n][1],
                              runs=[run])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
