#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--rows N]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (into ``build/kernels/``), then runs five phases, each printing
one JSON line:

  1. environment and build: card name and power limit (also printed raw,
     as ``nvidia-smi`` gives them), library versions, build time;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: bit-for-bit equality, run-to-run identical bits,
     and CUDA-event times beside the plain version's, one PyTorch library
     call's (where one computes the same function) and the bound;
  3. the main path at full size: FLIGHTS data (``--rows``, default 100M;
     the paper's relation has 606M rows), ``FastFrame.run`` on the card
     for the quickstart query, F-q1..F-q9 and a GROUP BY
     ``(origin, airline)``; every interval must cover the numpy truth,
     and every kernel must have been launched;
  4. the port on the card against the port on the CPU on a 2M-row
     scramble: equal scan decisions, intervals within 1e-6 relative;
  5. a ``kernels`` line: each ported kernel with its main-path launches,
     worst difference from its plain version and times.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and that line is not printed. Without
CUDA, or without the rest of the repository beside it, the script exits
with code 2 before any result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the non-tensor fp32 peak
# (at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PAPER_ROWS = 606_000_000
CPU_ROWS = 2_000_000     # rows of the card-vs-CPU comparison (phase 4)
REPS = 30                # timed calls per kernel measurement


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the fp32 rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each
    call (the main path reads fresh blocks every round). The flush also
    keeps the card busy while the host enqueues the call, so host
    overhead is hidden unless the call's own launches starve the card."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        pairs = []
        for _ in range(REPS + 2):          # two warm-up calls
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs[2:])


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 2 -----------------------------------------------------------------


def _bits_equal(torch, a, b) -> bool:
    """Same float32 bits (NaN payloads included): run-to-run identity."""
    return torch.equal(a.contiguous().view(torch.int32).cpu(),
                       b.contiguous().view(torch.int32).cpu())


def _same(torch, a, b):
    """Elementwise: same float32 bits, or NaN on both sides. The card and
    the CPU make different NaN bits for inf*0 (x86's default NaN has the
    sign bit set), which is not a numerical difference."""
    a, b = a.contiguous().cpu(), b.contiguous().cpu()
    return (a.view(torch.int32) == b.view(torch.int32)) | \
        (a.isnan() & b.isnan())


def _max_abs_diff(torch, a, b) -> float:
    """Largest |a - b| over elements that differ (0.0 when all are the
    same; a NaN against a number counts as inf)."""
    a, b = a.cpu(), b.cpu()
    d = (a - b).abs().nan_to_num(nan=float("inf"))
    return float(torch.where(_same(torch, a, b), torch.zeros_like(d),
                             d).max())


def check_block_agg(torch, timer, ref, kblock, G: int, exact: bool,
                    nb: int, block_rows: int, budget: int, seed: int):
    """The fold at one shape: kernel vs the plain version on the CPU (same
    row order: bitwise on all data) and on the card (index_add_ with
    atomics: bitwise where sums are exact)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (nb, block_rows)
    if exact:
        values = torch.randint(0, 17, shape, generator=gen, device="cuda"
                               ).to(torch.float32)
        center = 8.0
    else:
        values = torch.randn(shape, generator=gen, device="cuda") * 25 + 40
        center = 870.0
    gids = torch.randint(0, G, shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    mask = (torch.rand(shape, generator=gen, device="cuda") < 0.8).to(
        torch.float32)
    blk = torch.randperm(nb, generator=gen, device="cuda")[:budget].to(
        torch.int32)
    tvalid = torch.ones(budget, dtype=torch.int32, device="cuda")
    tvalid[-3:] = 0          # ragged tail: padding lanes at block 0
    blk[-3:] = 0
    if not exact:            # poison rows fold as in the plain version
        values[blk[0], 5] = float("nan")
        values[blk[1], 7] = float("inf")
        mask[blk[1], 7] = 0.0
    args = (values, gids, mask, blk, tvalid, center, G)
    got = kblock.block_agg(*args)
    again = kblock.block_agg(*args)
    torch.cuda.synchronize()
    run_to_run = all(_bits_equal(torch, x, y) for x, y in zip(got, again))
    # plain version on the CPU over the same rows (gathered on the card)
    sel = [t[blk.long()].cpu() for t in (values, gids, mask)]
    lanes = torch.arange(budget, dtype=torch.int32)
    want_cpu = ref.block_agg_blocks_ref(*sel, lanes, tvalid.cpu(), center,
                                        num_groups=G)
    want_dev = ref.block_agg_blocks_ref(values, gids, mask, blk, tvalid,
                                        center, num_groups=G)
    cpu_bitwise = all(bool(_same(torch, x, y).all())
                      for x, y in zip(got, want_cpu))
    max_abs = max(_max_abs_diff(torch, x, y) for x, y in zip(got, want_cpu))
    dev_diff = [(x - y).abs().nan_to_num(0.0, posinf=0.0) for x, y in
                zip(got, want_dev)]
    scale = want_dev[0].abs().nan_to_num(0.0, posinf=0.0).clamp(min=1.0)
    dev_rel = float((dev_diff[0] / scale).max())
    ok = run_to_run and cpu_bitwise and (not exact or dev_rel == 0.0)
    # times
    gathered = [t[blk.long()].reshape(-1) for t in (values, gids, mask)]
    dv = gathered[0] - center
    cols = torch.stack([gathered[2], dv * gathered[2],
                        dv * dv * gathered[2]], dim=1)
    gl = gathered[1].long()
    ms = timer(lambda: kblock.block_agg(*args))
    plain_ms = timer(lambda: ref.block_agg_blocks_ref(
        values, gids, mask, blk, tvalid, center, num_groups=G))
    lib_ms = timer(lambda: torch.zeros((G, 3), device="cuda").index_add_(
        0, gl, cols))
    rows = budget * block_rows
    bound_ms, bound_by = bound(rows * 12 + budget * 8 + 5 * G * 4, rows * 9)
    return dict(G=G, exact_data=exact, budget=budget, block_rows=block_rows,
                ok=ok, run_to_run_identical=run_to_run,
                bitwise_vs_plain_cpu=cpu_bitwise, max_abs_err=max_abs,
                max_rel_vs_plain_card_atomics=dev_rel, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_bitmap_active(torch, timer, ref, kbit, W: int, nb: int,
                        window: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bits = torch.randint(0, 32, (nb, W), generator=gen, device="cuda",
                         dtype=torch.int32)
    on = torch.rand((nb, W), generator=gen, device="cuda") < 0.05
    words = torch.where(on, torch.bitwise_left_shift(
        torch.ones_like(bits), bits), torch.zeros_like(bits))
    win = torch.randint(0, nb, (window,), generator=gen, device="cuda",
                        dtype=torch.int32)
    actives = [torch.randint(-2**31, 2**31 - 1, (W,), generator=gen,
                             device="cuda", dtype=torch.int32),
               torch.full((W,), -1, dtype=torch.int32, device="cuda"),
               torch.zeros(W, dtype=torch.int32, device="cuda")]
    ok = True
    for act in actives:
        for w in (win, None):
            got = kbit.active_blocks(words, act, w)
            again = kbit.active_blocks(words, act, w)
            sel = words if w is None else words[w.long()]
            want = ref.active_blocks_ref(sel, act)
            want_cpu = ref.active_blocks_ref(sel.cpu(), act.cpu())
            ok &= bool(torch.equal(got, want) and torch.equal(got, again)
                       and torch.equal(got.cpu(), want_cpu))
    act = actives[0]
    ms = timer(lambda: kbit.active_blocks(words, act, win))
    plain_ms = timer(lambda: ref.active_blocks_ref(words[win.long()], act))
    bound_ms, bound_by = bound(window * W * 4 + window * 8 + W * 4,
                               window * W * 2)
    return dict(W=W, window=window, ok=ok, max_abs_err=0.0 if ok else None,
                ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


# -- phases 3 and 4 ----------------------------------------------------------


def main_path_queries(T, fq, opt):
    qs = {"quickstart": T.AggQuery(
        agg="avg", column="dep_delay",
        filters=(T.Filter("origin", "eq", 0),),
        stop=opt.RelativeWidth(eps=0.5), bounder="bernstein",
        rangetrim=True, delta=1e-15)}
    qs.update({name: build() for name, build in fq.ALL.items()})
    qs["groupby_origin_airline"] = T.AggQuery(
        agg="avg", column="dep_delay", group_by=("origin", "airline"),
        stop=opt.ThresholdSide(threshold=10.0))
    return qs


def truth_of(np, cols, q):
    """Per-group exact AVG in float64 from the unshuffled columns, and
    which groups exist."""
    mask = np.ones(len(cols["dep_delay"]), bool)
    for f in q.filters:
        mask &= f.evaluate(cols)
    codes = np.zeros(mask.shape, np.int64)
    G = 1
    for c in q.group_cols:
        card = int(cols[c].max()) + 1
        codes, G = codes * card + cols[c], G * card
    v = cols["dep_delay"].astype(np.float64)
    cnt = np.bincount(codes[mask], minlength=G)
    tot = np.bincount(codes[mask], weights=v[mask], minlength=G)
    return tot / np.maximum(cnt, 1), cnt > 0


def uncovered(np, res, truth, exists):
    """Groups whose interval misses the truth. f32 data path: 1e-4
    relative (examples/quickstart.py), at least 1e-4 absolute for means
    near zero."""
    tol = 1e-4 * np.maximum(np.abs(truth), 1.0)
    n = len(truth)
    ok = (res.lo[:n] - tol <= truth) & (truth <= res.hi[:n] + tol)
    return np.nonzero(~ok & exists)[0]


DECISION_FIELDS = ("count_seen", "exact", "tainted", "rows_covered",
                   "blocks_fetched", "blocks_skipped_active",
                   "blocks_skipped_static", "bitmap_probes", "rounds",
                   "stopped_early")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000,
                    help="FLIGHTS rows of the main-path run")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "the script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.aqp as T
    from repro_torch.aqp import flights_queries as fq
    from repro_torch.core import optstop as opt
    from repro_torch.data import flights
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitmap_active as kbit
    from repro_torch.kernels import block_agg as kblock
    from repro_torch.kernels import ref

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. environment and build -------------------------------------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    name, power_limit = (s.strip() for s in smi.rsplit(",", 1))
    t0 = time.perf_counter()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    log = (lib_path.parent / "build.log").read_text()
    emit(dict(phase="environment", card=name, power_limit=power_limit,
              kind=kind, count=torch.cuda.device_count(),
              python=sys.version.split()[0], torch=torch.__version__,
              cuda=torch.version.cuda, nvcc_build_s=build_s,
              ptxas=[ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]))

    # ---- 2. kernels against their plain versions ----------------------------
    timer = Timer(torch)
    agg = [check_block_agg(torch, timer, ref, kblock, G, exact,
                           nb=8192, block_rows=1024, budget=64, seed=G)
           for G in (1, 200, 2800, 10240) for exact in (True, False)]
    bit = [check_bitmap_active(torch, timer, ref, kbit, W, nb=97_657,
                               window=4096, seed=W)
           for W in (1, 7, 50, 88, 320)]
    emit(dict(phase="kernels_vs_plain", card=name, power_limit=power_limit,
              block_agg=agg, bitmap_active=bit))
    bad = [r for r in agg + bit if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")

    # ---- 3. the main path at full size --------------------------------------
    t0 = time.perf_counter()
    ds = flights.generate(n_rows=args.rows, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    t_scr = time.perf_counter() - t0
    frame = T.FastFrame(sc, T.EngineConfig(), device="cuda")
    queries = main_path_queries(T, fq, opt)
    truths = {k: truth_of(np, ds.columns, q) for k, q in queries.items()}
    kblock.block_agg.launches = 0
    kbit.active_blocks.launches = 0
    t_main = time.perf_counter()
    records, failures = [], []
    for qname, q in queries.items():
        t0 = time.perf_counter()
        res = frame.run(q, sampling="active_peek", seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        miss = uncovered(np, res, *truths[qname])
        if len(miss):
            g = int(miss[0])
            failures.append(dict(query=qname, groups=len(miss), first=g,
                                 truth=float(truths[qname][0][g]),
                                 lo=float(res.lo[g]), hi=float(res.hi[g])))
        records.append(dict(
            query=qname, groups=len(res.lo), rounds=res.rounds,
            blocks_fetched=res.blocks_fetched,
            blocks_skipped_active=res.blocks_skipped_active,
            blocks_skipped_static=res.blocks_skipped_static,
            bitmap_probes=res.bitmap_probes,
            stopped_early=bool(res.stopped_early),
            exact_views=int(res.exact.sum()),
            tainted_views=int(res.tainted.sum()),
            covered=not len(miss), wall_s=wall,
            rounds_per_s=res.rounds / wall if wall > 0 else None))
    main_wall = time.perf_counter() - t_main
    launches = {"block_agg": kblock.block_agg.launches,
                "bitmap_active": kbit.active_blocks.launches}
    emit(dict(phase="main_path", card=name, power_limit=power_limit,
              rows=args.rows, blocks=sc.n_blocks,
              reduced={"rows": f"{PAPER_ROWS / 1e6:g}M -> "
                               f"{args.rows / 1e6:g}M"},
              generate_s=t_gen, scramble_s=t_scr, queries_wall_s=main_wall,
              total_rounds=sum(r["rounds"] for r in records),
              launches=launches, peak_device_gib=torch.cuda
              .max_memory_allocated() / 2**30, queries=records))
    if failures:
        raise AssertionError(f"intervals miss the truth: {failures}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    del frame, sc, ds
    torch.cuda.empty_cache()

    # ---- 4. the port on the card against the port on the CPU ----------------
    ds = flights.generate(n_rows=CPU_ROWS, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    f_gpu = T.FastFrame(sc, T.EngineConfig(), device="cuda")
    f_cpu = T.FastFrame(sc, T.EngineConfig(), device="cpu")
    compare, mismatch = [], []
    for qname, q in queries.items():
        r_g = f_gpu.run(q, sampling="active_peek", seed=0)
        r_c = f_cpu.run(q, sampling="active_peek", seed=0)
        same = [f for f in DECISION_FIELDS
                if np.array_equal(getattr(r_g, f), getattr(r_c, f))]
        rel = 0.0
        bitwise = True
        for f in ("estimate", "lo", "hi"):
            a, b = getattr(r_g, f), getattr(r_c, f)
            bitwise &= np.array_equal(a, b)
            fin = np.isfinite(a) & np.isfinite(b)
            if not np.array_equal(np.isfinite(a), np.isfinite(b)):
                rel = np.inf
            elif fin.any():
                rel = max(rel, float(np.max(np.abs(a[fin] - b[fin])
                                            / np.maximum(np.abs(b[fin]),
                                                         1e-300))))
        compare.append(dict(query=qname, rounds=r_g.rounds,
                            decisions_equal=len(same) == len(
                                DECISION_FIELDS),
                            ci_bitwise=bool(bitwise), ci_max_rel=rel))
        if len(same) != len(DECISION_FIELDS) or rel > 1e-6:
            mismatch.append(qname)
    emit(dict(phase="card_vs_cpu", rows=CPU_ROWS, queries=compare,
              total_s=time.perf_counter() - t_start))
    if mismatch:
        raise AssertionError(f"card and CPU runs differ: {mismatch}")

    # ---- 5. the kernels line ------------------------------------------------
    a = next(r for r in agg if r["G"] == 2800 and not r["exact_data"])
    b = next(r for r in bit if r["W"] == 88)
    emit({"kernels": [
        dict(name="block_agg", route="cuda",
             source="src/repro_torch/kernels/csrc/block_agg.cu",
             replaces="src/repro/kernels/block_agg.py:92",
             launches=launches["block_agg"],
             max_abs_err=max(r["max_abs_err"] for r in agg),
             ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
             bound_by=a["bound_by"], library_ms=a["library_ms"]),
        dict(name="bitmap_active", route="cuda",
             source="src/repro_torch/kernels/csrc/bitmap_active.cu",
             replaces="src/repro/kernels/bitmap_active.py:40",
             launches=launches["bitmap_active"],
             max_abs_err=max(r["max_abs_err"] for r in bit),
             ms=b["ms"], plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
             bound_by=b["bound_by"], library_ms=None),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
