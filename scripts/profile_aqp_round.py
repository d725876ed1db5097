#!/usr/bin/env python3
"""Device view of the AQP engine's fused scan rounds, on one card.

    python3 scripts/profile_aqp_round.py [--rows N] [--src DIR]
                                         [--warmup W] [--rounds K]
                                         [--loop host|device|both]

Runs the G = 2800 GROUP BY of ``chip_smoke.py``'s phase 3 (AVG dep_delay
by (origin, airline) over FLIGHTS, ``ThresholdSide(10)``, ``active_peek``)
on the card, with the default bounder and with Anderson/DKW, through the
per-round host loop (``EngineConfig(device_loop=False)``) and through
the device-resident loop (``device_loop=True``, a CUDA graph replay a
chunk of rounds), and traces each with ``torch.profiler``. The host loop:
``K`` rounds after ``W`` untraced ones, from the start of round ``W`` to
the start of round ``W + K``, so the window holds whole round cycles (the
fused round, the host's merge and bound math); the query is then cut
short. The device loop: from the end of chunk ``ceil(W / chunk)`` to the
end of ``ceil(K / chunk)`` chunks later (each chunk a replay and the
host's one read after it), after which the query runs to its end. For
each bounder and loop it prints one JSON line: host-clock milliseconds a
round (all of it, and inside the fused round for the host loop), the
card's busy time a round (the union of its activities' intervals) and its
idle share, and device activities a round: kernel launches, memsets and
copies, with the kernels counted and their device time summed by name.

``--src`` names the source tree whose ``repro_torch`` runs (default:
this checkout's ``src``), so that another commit's code path, unpacked
beside this one, is traced by the same script: its kernels are built
into its own ``build/kernels``. The card's name and power limit come
first, as ``nvidia-smi`` prints them. Needs CUDA; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _Enough(Exception):
    """Raised at the start of the first round past the traced window."""


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_rounds(torch, engine, frame, query, warmup: int, rounds: int):
    """Run ``query`` and trace rounds ``warmup .. warmup + rounds - 1``.
    Returns (profiler, host seconds of the window, host seconds inside
    the fused round in the window, rounds traced)."""
    cls = engine._FusedScan
    inner = cls.round
    state = dict(n=0, t0=None, t1=None, in_round=0.0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)

    def stop():
        torch.cuda.synchronize()
        state["t1"] = time.perf_counter()
        prof.stop()

    def traced(self, *args, **kwargs):
        n = state["n"]
        if n == warmup:
            torch.cuda.synchronize()
            prof.start()
            state["t0"] = time.perf_counter()
        elif n == warmup + rounds:
            stop()
            raise _Enough
        state["n"] = n + 1
        t = time.perf_counter()
        try:
            return inner(self, *args, **kwargs)
        finally:
            if n >= warmup:
                state["in_round"] += time.perf_counter() - t

    cls.round = traced
    try:
        frame.run(query, sampling="active_peek", seed=0)
        if state["t0"] is not None and state["t1"] is None:
            stop()  # the query ended inside the window
    except _Enough:
        pass
    finally:
        cls.round = inner
    if state["t0"] is None:
        raise RuntimeError(f"the query ran {state['n']} rounds, fewer than "
                           f"the {warmup} untraced ones")
    traced_n = min(state["n"], warmup + rounds) - warmup
    return (prof, state["t1"] - state["t0"], state["in_round"], traced_n)


def trace_chunks(torch, engine, frame, query, warmup: int, rounds: int):
    """Run ``query`` through the device-resident loop and trace whole
    chunks (graph replays and the host read after each) from the end of
    chunk ``ceil(warmup / chunk)`` on, over ``ceil(rounds / chunk)``
    chunks; the graph is captured by a first, untraced run. Returns
    (profiler, host seconds of the window, None, rounds traced)."""
    frame.run(query, sampling="active_peek", seed=0)  # build and capture
    chunk = (frame.config.sync_every or frame.config.chunk_rounds
             or engine.GRAPH_CHUNK_ROUNDS)
    first = -(-warmup // chunk)
    last = first + -(-rounds // chunk)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    state = dict(n=0, t0=None, t1=None, r0=0, r1=0)

    def on_sync(snap):
        state["n"] += 1
        if state["n"] == first:
            torch.cuda.synchronize()
            prof.start()
            state["t0"], state["r0"] = time.perf_counter(), snap["rounds"]
        elif state["n"] == last:
            torch.cuda.synchronize()
            state["t1"], state["r1"] = time.perf_counter(), snap["rounds"]
            prof.stop()

    res = frame.run(query, sampling="active_peek", seed=0, on_sync=on_sync)
    if state["t0"] is None:
        raise RuntimeError(f"the query ran {state['n']} chunks, fewer than "
                           f"the {first} untraced ones")
    if state["t1"] is None:  # the query ended inside the window
        torch.cuda.synchronize()
        state["t1"], state["r1"] = time.perf_counter(), res.rounds
        prof.stop()
    return (prof, state["t1"] - state["t0"], None,
            state["r1"] - state["r0"])


def summarize(torch, prof, wall_s: float, in_round_s: float, n: int,
              **extra) -> dict:
    spans, kinds = [], collections.Counter()
    names, name_us = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        low = e.name.lower()
        kind = ("memset" if "memset" in low
                else "copy" if "memcpy" in low else "kernel")
        kinds[kind] += 1
        if kind == "kernel":
            names[e.name[:80]] += 1
            name_us[e.name[:80]] += e.time_range.end - e.time_range.start
    busy_ms = busy_us(spans) / 1e3
    wall_ms = wall_s * 1e3
    return dict(rounds_traced=n, wall_ms_per_round=wall_ms / n,
                fused_round_host_ms_per_round=(
                    None if in_round_s is None else in_round_s * 1e3 / n),
                device_busy_ms_per_round=busy_ms / n,
                # no device activity in the trace: not measured
                device_idle_share=(1.0 - busy_ms / wall_ms if spans
                                   else None),
                kernels_per_round=kinds["kernel"] / n,
                memsets_per_round=kinds["memset"] / n,
                copies_per_round=kinds["copy"] / n,
                kernels_by_name_per_round={k: v / n for k, v in
                                           names.most_common()},
                kernel_ms_by_name_per_round={k: v / 1e3 / n for k, v in
                                             name_us.most_common()},
                **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=20_000_000,
                    help="FLIGHTS rows (default 20M: 19,532 blocks, more "
                         "than one 4,096-block window)")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="source tree whose repro_torch runs")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--loop", choices=("host", "device", "both"),
                    default="both")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_aqp_round: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as smoke
    import repro_torch
    import repro_torch.aqp as T
    from repro_torch.aqp import engine
    from repro_torch.core import optstop as opt
    from repro_torch.data import flights

    print(smoke.nvidia_smi_line(), flush=True)
    ds = flights.generate(n_rows=args.rows, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    frame = T.FastFrame(sc, T.EngineConfig(device_loop=False),
                        device="cuda")
    loops = ("host", "device") if args.loop == "both" else (args.loop,)
    for bounder in ("bernstein", "anderson_dkw"):
        kw = ({} if bounder == "bernstein"
              else dict(bounder="anderson_dkw", rangetrim=False))
        q = T.AggQuery(agg="avg", column="dep_delay",
                       group_by=("origin", "airline"),
                       stop=opt.ThresholdSide(threshold=10.0), **kw)
        for loop in loops:
            frame.config = T.EngineConfig(device_loop=loop == "device")
            trace = trace_rounds if loop == "host" else trace_chunks
            prof, wall, in_round, n = trace(torch, engine, frame, q,
                                            args.warmup, args.rounds)
            print(json.dumps(summarize(
                torch, prof, wall, in_round, n, bounder=bounder, loop=loop,
                groups=2800, rows=args.rows, blocks=sc.n_blocks,
                src=str(Path(repro_torch.__file__).resolve().parents[1]))),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
