#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--rows N]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (into ``build/kernels/``), then runs these phases, each printing
one JSON line:

  1. environment and build: card name and power limit (also printed raw,
     as ``nvidia-smi`` gives them), library versions, build time;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (the round head also against the unfused head it
     replaced, the probe kernel plus plain selection, timed beside it):
     bit-for-bit equality, run-to-run identical bits,
     and CUDA-event times beside the plain version's, one PyTorch library
     call's (where one computes the same function) and the bound
     (``grouped_hist`` also at most two CUDA launches a call and no
     memset, read from a profiler trace, at G 1, 14 (the main path's),
     56, 57, 200 and 2800); the
     selective scan's states (hout, hseg) bit for bit, its y and its
     backward's gradients within stated tolerances of their plain
     versions (only the order of their sums differs), bitwise run to
     run; the multi-query probe at Q 1, 2 and 8 (W 7 and 88, over a
     4096-row window and all 97,657 rows) and a slot's round head (a
     stack of masks, a lap end, a wrapped window) bit for bit their
     plain versions;
  3. the main paths at full size, on one frame of FLIGHTS data
     (``--rows``, default 100M; the paper's relation has 606M rows):
     ``FastFrame.run`` on the card for the quickstart query, F-q1..F-q9
     and a GROUP BY ``(origin, airline)`` with the default bounder (the
     round head ``round_select`` and ``block_agg`` every round, the
     ``bitmap_active`` probe for static prefilters), then the
     Anderson/DKW path (``fused_fold`` and ``grouped_hist`` too): F-q1,
     F-q2, F-q5 and the GROUP BY under ``bounder="anderson_dkw"``, and
     F-q2 as an exact sweep. Every interval must cover the numpy truth,
     and each path must have launched each of its kernels and no other
     (the launch counts are zeroed before each path and read after it);
     the host seconds of the rounds (``round_s``) are printed per query
     and summed per path. These run the per-round host loop
     (``EngineConfig(device_loop=False)``), the one-sync-a-round path
     that the device loop is held against;
  3b. the device-resident round loop (``device_loop=True``, the
     default) on the same frame, for the queries of both paths but the
     exact sweep: each chunk of rounds one CUDA graph replay, captured
     once per query after an eager chunk run under
     ``torch.cuda.set_sync_debug_mode("error")``; scan decisions equal
     to phase 3's host loop, CIs within atol 1e-9 / rtol 1e-12, every
     interval covering, every chunk a replay, the round head and the
     folds launched; rounds/s of both loops per query, host syncs, graph
     replays, rounds a chunk, and the card's idle share a round for the
     G 2800 GROUP BY of both bounders through both loops (a
     ``torch.profiler`` window, ``scripts/profile_aqp_round.py``);
  3c. shared-scan serving (``repro_torch.serve``) on phase 3b's frame,
     through the device pass loop (a chunk of pass rounds one CUDA graph
     replay): the default bounder's queries with Anderson F-q5 and the
     Anderson GROUP BY in one ``run_batch`` (every interval covering,
     each query alone in its slot bit for bit its phase-3b solo run),
     then split into batches of distinct scan signatures (every query
     bit for bit its solo run); the dashboard fan-outs of
     ``benchmarks/bench_serve.py`` (8 queries on one slot, 8 on four)
     served against 8 sequential solo runs (queries/s, captures,
     replays, host syncs, a pass round's idle share); a
     ``QueryScheduler`` burst of 8 (cut from 16: ``reduced``) of
     ``benchmarks/bench_scheduler.py``'s non-probe mix, 8 slots, chunks
     of 4 rounds, a checkpoint every step, on a ``SimClock``: every
     ticket done and bit for bit its solo run at its anchor, a second
     run with the same event log, and a pass with a mid-scan join,
     resumed from a checkpoint taken after it, equal to the
     uninterrupted pass (its joiners bit for bit their solo runs);
  4. the port on the card against the port on the CPU on a 2M-row
     scramble, for the queries of both paths through the host loop:
     equal scan decisions, intervals within 1e-6 relative; then phase
     3c's batch through the host pass loop (``device_loop=False``, the
     multi-query probe once a slot a round) on the card and the CPU,
     decisions equal, intervals within 1e-6 relative;
  5. the Mamba1 serving path: falcon-mamba-7b at full width and depth
     (64 layers, bf16, random weights from a seed) serves 8 requests of
     2048 prompt tokens (one ``prefill``, the selective-scan kernel once
     a layer) and 32 greedy ``decode`` steps, twice, with finite logits
     and the same tokens both times; then, at full width and 4 layers in
     float32, prefill + decode against forward (2e-3), and the reduced
     config on the card against the CPU (1e-4);
  6. the Mamba1 training path: falcon-mamba-7b at full width, cut to 16
     layers, bf16, AdamW with float32 moments, remat, 2 microbatches of
     2 x 4096 tokens: one warm-up step and 3 timed steps on the same
     batch (``train/trainer.build_train_step``) at lr 3e-4, finite losses
     that fall at every step, no grad norm above 3x the first, and per
     step the scan kernel twice a layer a microbatch (the
     forward and remat's recompute) and its backward kernel once;
  7. a ``kernels`` line: each ported kernel with its main-path launches,
     worst difference from its plain version and times (``grouped_hist``
     at the main path's G 14, with G 2800 beside it; the multi-query
     probe at the serving host loop's window, Q 8, W 88).

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and that line is not printed. Without
CUDA, or without the rest of the repository beside it, the script exits
with code 2 before any result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
HIST_BINS = 1024         # EngineConfig.hist_bins' default
# The bitmap_active probe on the main path: the static prefilter of a
# categorical filter, over every block in order. Its widest is origin's
# (200 airports: 7 words); airline's (14) is one word.
PREFILTER_WORDS = 7
HIST_ROWS = 1024 * 1024  # one exact-sweep fold: lookahead_blocks x 1024
# grouped_hist's phase-2 groups: G 14 is the main path's (F-q2's exact
# sweep groups by airline), 56 and 57 the last private and the first
# bucketed cell space at 1024 bins (grouped_hist.plan), 200 and 2800 the
# origin and (origin, airline) GROUP BYs'
HIST_GROUPS = (1, 14, 56, 57, 200, 2800)
HIST_PATH_GROUPS = 14
# Coverage tolerance of an exact sweep's point estimates. Its folds are
# lookahead_blocks x 1024 = 1M rows each, summed in float32 about the
# catalog centre (870 for dep_delay, ~860 from most values), so a
# group's mean carries rounding that grows with the rows a fold adds;
# the sampled runs' 1e-4 is for folds of 64 blocks. Phase 3 prints the
# measured error (exact_view_max_rel_err).
EXACT_SWEEP_RTOL = 1e-3
REPS = 30                # timed calls per kernel measurement
PLAIN_SCAN_REPS = 3      # the plain scan is ~2k small launches a call
# The Mamba1 serving path (phase 5)
SERVE_BATCH = 8          # requests
PROMPT_LEN = 2048        # prompt tokens each
DECODE_STEPS = 32        # greedy decode steps after the prefill
MODEL_SEED = 0
# The Mamba1 training path (phase 6): falcon-mamba-7b at full width, cut
# to TRAIN_LAYERS layers, TRAIN_BATCH sequences of TRAIN_LEN tokens in the
# config's TRAIN_MICROBATCHES microbatches, one warm-up step (lr 0 at
# step 0) and TRAIN_STEPS timed steps on the same batch at OptConfig's
# default lr (3e-4). The loss must fall at every timed step, and no
# step's grad norm may pass TRAIN_GRAD_NORM_GROWTH times the first's: a
# run that diverges fails.
TRAIN_LAYERS = 16
TRAIN_BATCH = 4
TRAIN_LEN = 4096
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 3
TRAIN_GRAD_NORM_GROWTH = 3.0
# Selective scan vs its plain version: hout and hseg bit for bit (both
# round every product and sum of the state update alike and the
# exponential is the accurate expf in both); y within max |kernel -
# plain| over the largest |plain|: only the order of its sum over the n
# states differs, a few float32 ulps.
SCAN_RTOL = 1e-5
# (B, L, din, n, tc): one falcon-mamba prefill layer of the serving path,
# one batch row of one 128-channel tile at n = 8 over one chunk of 512
# steps and over three, then one layer of a training microbatch
TRAIN_SCAN_SHAPE = (TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_LEN, 8192, 16,
                    512)
SCAN_SHAPES = [(SERVE_BATCH, PROMPT_LEN, 8192, 16, 512),
               (1, 512, 128, 8, 512), (1, 1536, 128, 8, 512),
               TRAIN_SCAN_SHAPE]
# Selective-scan backward vs its plain version: max |kernel - plain| over
# the largest |plain| of each gradient. The recompute is the forward's own
# bits; the sums over n, over the channels (dB, dC), and over batch rows
# and chunks (dA, dD) run in other orders.
SCAN_BWD_RTOL = 1e-5
# (B, L, din, n, tc): one batch row of a falcon-mamba layer over 2
# chunks, phase 2's small shapes, then one layer of a training
# microbatch (2 batch rows, 8 chunks: the shape the training path gives)
SCAN_BWD_SHAPES = [(1, 1024, 8192, 16, 512), (1, 512, 128, 8, 512),
                   (1, 1536, 128, 8, 512), TRAIN_SCAN_SHAPE]


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
    overhead is hidden unless the call's own launches starve the card:
    1 GiB (~0.3 ms to zero) outlasts a wrapper's host time, where a
    256 MB flush (~0.08 ms) let it into a 0.01-0.02 ms kernel's time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        pairs = []
        for _ in range(reps + 2):          # two warm-up calls
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


def fold_inputs(torch, G: int, exact: bool, nb: int, block_rows: int,
                budget: int, seed: int):
    """Slabs and a round's selection at one shape: exactly-representable
    data (integers 0..16, grid [0, 16]) or general data (normal around
    40, FLIGHTS' centre and grid [-60, 1800], with a NaN row and a masked
    inf row). The last three lanes are padding (block 0, invalid)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (nb, block_rows)
    if exact:
        values = torch.randint(0, 17, shape, generator=gen, device="cuda"
                               ).to(torch.float32)
        center, a, b = 8.0, 0.0, 16.0
    else:
        values = torch.randn(shape, generator=gen, device="cuda") * 25 + 40
        center, a, b = 870.0, -60.0, 1800.0
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
    return values, gids, mask, blk, tvalid, center, a, b


def check_block_agg(torch, timer, ref, kblock, G: int, exact: bool,
                    nb: int, block_rows: int, budget: int, seed: int):
    """The fold at one shape: kernel vs the plain version on the CPU (same
    row order: bitwise on all data) and on the card (index_add_ with
    atomics: bitwise where sums are exact)."""
    values, gids, mask, blk, tvalid, center, _, _ = fold_inputs(
        torch, G, exact, nb, block_rows, budget, seed)
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
    # the scratch one call touches, against the rows' own 12 bytes each
    _, lane_mode, buckets, tiles = kblock.plan(budget, block_rows, G)
    scratch = kblock.scratch_bytes(buckets, tiles)
    ok = ok and scratch < rows * 12
    return dict(G=G, exact_data=exact, budget=budget, block_rows=block_rows,
                walk="lane" if lane_mode else "warp", scratch_bytes=scratch,
                rows_bytes=rows * 12,
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
    # the main path's shape: a static prefilter probes every row in order
    ms = timer(lambda: kbit.active_blocks(words, act))
    plain_ms = timer(lambda: ref.active_blocks_ref(words, act))
    bound_ms, bound_by = bound(nb * W * 4 + nb * 4 + W * 4, nb * W * 2)
    # the rows of one window, read through win (the per-block path's
    # lookahead; the probe the round head replaced)
    window_ms = timer(lambda: kbit.active_blocks(words, act, win))
    window_plain_ms = timer(lambda: ref.active_blocks_ref(words[win.long()],
                                                          act))
    window_bound_ms, _ = bound(window * W * 4 + window * 8 + W * 4,
                               window * W * 2)
    return dict(W=W, rows=nb, window=window, ok=ok,
                max_abs_err=0.0 if ok else None, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                window_ms=window_ms, window_plain_ms=window_plain_ms,
                window_bound_ms=window_bound_ms)



def head_inputs(torch, W: int, nb: int, window: int, seed: int):
    """The round head's inputs on the card: a scan order (a permutation,
    zero-padded by ``window``), a static prefilter passing 90 % of the
    blocks, bitmap words with a bit set in 5 % of the words, and three
    active masks (random bits, all ones, all zeros)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    order_pad = torch.zeros(nb + window, dtype=torch.int32, device="cuda")
    order_pad[:nb] = torch.randperm(nb, generator=gen, device="cuda").to(
        torch.int32)
    static_ok = torch.rand(nb, generator=gen, device="cuda") < 0.9
    bits = torch.randint(0, 32, (nb, W), generator=gen, device="cuda",
                         dtype=torch.int32)
    on = torch.rand((nb, W), generator=gen, device="cuda") < 0.05
    words = torch.where(on, torch.bitwise_left_shift(
        torch.ones_like(bits), bits), torch.zeros_like(bits))
    actives = [torch.randint(-2**31, 2**31 - 1, (W,), generator=gen,
                             device="cuda", dtype=torch.int32),
               torch.full((W,), -1, dtype=torch.int32, device="cuda"),
               torch.zeros(W, dtype=torch.int32, device="cuda")]
    return order_pad, static_ok, words, actives


def unfused_head(torch, ref, kbit, order_pad, static_ok, words, act, pos,
                 nb, window, budget):
    """The round head as the fused round ran it before it had a kernel of
    its own: the window and prefilter in eager ops, the ``bitmap_active``
    probe, then the plain selection (cumsum / argmax) and lane scatter,
    from the device cursor ``pos``."""
    dev = order_pad.device
    win, left = ref.round_window_ref(order_pad, pos, torch.ones(
        (), dtype=torch.bool, device=dev), nb=nb, window=window)
    offs = torch.arange(window, dtype=torch.int64, device=dev)
    ok = static_ok[win] & (offs < left)
    flags = ok & (kbit.active_blocks(words, act,
                                     win.to(torch.int32)) > 0)
    take, new_pos, csum = ref.budget_select_ref(flags, pos, left, window,
                                                budget)
    blk, tvalid, _ = ref.gather_blocks_ref(take, csum, win, window, budget)
    return ok, flags, new_pos, blk, tvalid


def check_round_select(torch, timer, ref, kbit, W: int, nb: int,
                       window: int, budget: int, seed: int):
    """The fused round's head (one launch) against the plain sequence on
    the card and on the CPU, bit for bit, and run to run: mid-scan with
    random, all-ones and all-zeros masks, at the end of the scan (the
    window cut by nb), without the probe, with a budget of one, and the
    rounds that do not run (``go`` false; a cursor past nb), each from
    the device cursor and ``go`` flag. Times: the kernel, the plain
    sequence, and the unfused head (the probe kernel plus the plain
    selection: what the round ran before)."""
    order_pad, static_ok, words, actives = head_inputs(torch, W, nb, window,
                                                       seed)
    pos = nb // 3

    def cur(p, go=True, dev="cuda"):
        return (torch.tensor(p, dtype=torch.int64, device=dev),
                torch.tensor(go, device=dev))

    cases = [(pos, act, budget, True, True) for act in actives]
    cases += [(nb - window // 3, actives[0], budget, True, True),
              (pos, actives[0], budget, False, True),
              (pos, actives[0], 1, True, True),
              (pos, actives[0], budget, True, False),
              (nb + 7, actives[0], budget, True, True)]
    ok = True
    for p, act, bud, probe, go in cases:
        kw = dict(nb=nb, window=window, budget=bud, probe=probe)
        got = kbit.round_select(order_pad, static_ok, words, act,
                                *cur(p, go), **kw)
        again = kbit.round_select(order_pad, static_ok, words, act,
                                  *cur(p, go), **kw)
        want = ref.round_select_ref(order_pad, static_ok, words, act,
                                    *cur(p, go), **kw)
        want_cpu = ref.round_select_ref(order_pad.cpu(), static_ok.cpu(),
                                        words.cpu(), act.cpu(),
                                        *cur(p, go, "cpu"), **kw)
        ok &= all(x.dtype == y.dtype and torch.equal(x, y)
                  and torch.equal(x, z) and torch.equal(x.cpu(), c)
                  for x, y, z, c in zip(got, want, again, want_cpu))
        if probe and go and p <= nb:
            old = unfused_head(torch, ref, kbit, order_pad, static_ok,
                               words, act, cur(p)[0], nb, window, bud)
            ok &= all(torch.equal(x, y) for x, y in zip(got, old))
    act = actives[0]
    kw = dict(nb=nb, window=window, budget=budget, probe=True)
    pos_t, go_t = cur(pos)
    got = kbit.round_select(order_pad, static_ok, words, act, pos_t, go_t,
                            **kw)
    torch.cuda.synchronize()
    flagged, covered = int(got[1].sum()), int(got[2]) - pos
    ms = timer(lambda: kbit.round_select(order_pad, static_ok, words, act,
                                         pos_t, go_t, **kw))
    plain_ms = timer(lambda: ref.round_select_ref(order_pad, static_ok,
                                                  words, act, pos_t, go_t,
                                                  **kw))
    unfused_ms = timer(lambda: unfused_head(torch, ref, kbit, order_pad,
                                            static_ok, words, act, pos_t,
                                            nb, window, budget))
    win = order_pad[pos:pos + window]
    probe_ms = timer(lambda: kbit.active_blocks(words, act, win))
    # read: the window's order_pad entries, static_ok bytes and words (all
    # positions in range), the mask; written: ok, flags, the lanes' block
    # ids and flags, new_pos. One AND and one OR a word.
    bound_ms, bound_by = bound(window * (4 + 1 + W * 4) + W * 4
                               + 2 * window + budget * 5 + 8,
                               window * W * 2)
    return dict(W=W, window=window, budget=budget, nb=nb, ok=ok,
                max_abs_err=0.0 if ok else None, flagged=flagged,
                covered=covered, ms=ms, plain_ms=plain_ms,
                unfused_ms=unfused_ms, probe_ms=probe_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)

def check_bitmap_active_multi(torch, timer, ref, kbit, W: int, Q: int,
                              nb: int, window: int, seed: int):
    """The multi-query probe (one launch for a ``(Q, W)`` stack) against
    its plain version on the card and on the CPU, bit for bit and run to
    run, over a window of ``window`` rows and over all ``nb`` rows; each
    row of the result also bit for bit the single-mask probe. Times at
    the window (the serving host loop's shape) and over all rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bits = torch.randint(0, 32, (nb, W), generator=gen, device="cuda",
                         dtype=torch.int32)
    on = torch.rand((nb, W), generator=gen, device="cuda") < 0.05
    words = torch.where(on, torch.bitwise_left_shift(
        torch.ones_like(bits), bits), torch.zeros_like(bits))
    stack = torch.randint(-2**31, 2**31 - 1, (Q, W), generator=gen,
                          device="cuda", dtype=torch.int32)
    stack[::3] = -1
    win = torch.randint(0, nb, (window,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ok = True
    for w in (win, None):
        got = kbit.active_blocks_multi(words, stack, w)
        again = kbit.active_blocks_multi(words, stack, w)
        sel = words if w is None else words[w.long()]
        want = ref.active_blocks_multi_ref(sel, stack)
        want_cpu = ref.active_blocks_multi_ref(sel.cpu(), stack.cpu())
        rows = all(torch.equal(got[q], kbit.active_blocks(words, stack[q],
                                                          w))
                   for q in range(Q))
        ok &= bool(torch.equal(got, want) and torch.equal(got, again)
                   and torch.equal(got.cpu(), want_cpu) and rows)
    out = dict(W=W, Q=Q, rows=nb, window=window, ok=ok,
               max_abs_err=0.0 if ok else None, library_ms=None)
    for tag, w, n in (("window_", win, window), ("", None, nb)):
        out[tag + "ms"] = timer(lambda: kbit.active_blocks_multi(words,
                                                                 stack, w))
        sel = words if w is None else words[w.long()]
        out[tag + "plain_ms"] = timer(
            lambda: ref.active_blocks_multi_ref(sel, stack))
        # the rows' words and the stack read once, the flags written once
        # (and the window's row ids); one AND and one OR a word a row
        out[tag + "bound_ms"], out[tag + "bound_by"] = bound(
            n * W * 4 + Q * W * 4 + Q * n * 4 + (n * 4 if w is not None
                                                 else 0),
            n * W * Q * 2)
    # the reference loops its single-mask kernel over the rows: the
    # probe kernel Q times, timed beside it
    out["window_per_row_ms"] = timer(lambda: [
        kbit.active_blocks(words, stack[q], win) for q in range(Q)])
    return out


def check_round_select_stack(torch, timer, ref, kbit, W: int, Q: int,
                             nb: int, window: int, budget: int,
                             seed: int):
    """A slot's round head (a ``(Q, W)`` stack of masks, the slot's lap
    end, a wrapped window) against its plain version on the card and on
    the CPU, bit for bit and run to run: cursors inside the lap, past
    nb, near the lap's end, at it, outside it, and with go false. Times
    at a cursor inside the lap."""
    order_pad, static_ok, words, _ = head_inputs(torch, W, nb, window,
                                                 seed)
    order_pad[nb:] = order_pad[:window]  # wrap-filled
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    stack = torch.randint(-2**31, 2**31 - 1, (Q, W), generator=gen,
                          device="cuda", dtype=torch.int32)
    anchor = nb // 2
    kw = dict(nb=nb, window=window, budget=budget, probe=True,
              lap_end=anchor + nb, wrap=True)

    def cur(p, go=True, dev="cuda"):
        return (torch.tensor(p, dtype=torch.int64, device=dev),
                torch.tensor(go, device=dev))

    ok = True
    for p, go in [(anchor, True), (anchor + 1234, True), (nb + 77, True),
                  (anchor + nb - window // 3, True), (anchor + nb, True),
                  (anchor - 1, True), (anchor + 5, False)]:
        got = kbit.round_select(order_pad, static_ok, words, stack,
                                *cur(p, go), **kw)
        again = kbit.round_select(order_pad, static_ok, words, stack,
                                  *cur(p, go), **kw)
        want = ref.round_select_ref(order_pad, static_ok, words, stack,
                                    *cur(p, go), **kw)
        want_cpu = ref.round_select_ref(order_pad.cpu(), static_ok.cpu(),
                                        words.cpu(), stack.cpu(),
                                        *cur(p, go, "cpu"), **kw)
        ok &= all(x.dtype == y.dtype and torch.equal(x, y)
                  and torch.equal(x, z) and torch.equal(x.cpu(), c)
                  for x, y, z, c in zip(got, want, again, want_cpu))
    pos_t, go_t = cur(anchor + 1234)
    ms = timer(lambda: kbit.round_select(order_pad, static_ok, words, stack,
                                         pos_t, go_t, **kw))
    plain_ms = timer(lambda: ref.round_select_ref(order_pad, static_ok,
                                                  words, stack, pos_t, go_t,
                                                  **kw))
    bound_ms, bound_by = bound(window * (4 + 1 + W * 4) + Q * W * 4
                               + 2 * window + budget * 5 + 8,
                               window * W * 2 + Q * W)
    return dict(W=W, Q=Q, window=window, budget=budget, nb=nb, ok=ok,
                max_abs_err=0.0 if ok else None, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_fused_fold(torch, timer, ref, kfused, kblock, G: int, exact: bool,
                     nb: int, block_rows: int, budget: int, nbins: int,
                     seed: int):
    """The fused fold at one shape: moments bit for bit those of
    block_agg, the histogram bit for bit the plain version's on the CPU
    and on the card (0/1 counts are exact in any order), the same bits
    run to run."""
    values, gids, mask, blk, tvalid, center, a, b = fold_inputs(
        torch, G, exact, nb, block_rows, budget, seed)
    args = (values, gids, mask, blk, tvalid, center, a, b, G, nbins)
    got = kfused.fused_fold(*args)
    again = kfused.fused_fold(*args)
    moments = kblock.block_agg(values, gids, mask, blk, tvalid, center, G)
    torch.cuda.synchronize()
    run_to_run = all(_bits_equal(torch, x, y) for x, y in zip(got, again))
    moments_bitwise = all(_bits_equal(torch, x, y)
                          for x, y in zip(got[:3], moments))
    sel = [t[blk.long()].cpu() for t in (values, gids, mask)]
    lanes = torch.arange(budget, dtype=torch.int32)
    want_cpu = ref.fused_fold_ref(*sel, lanes, tvalid.cpu(), center, a, b,
                                  num_groups=G, nbins=nbins)
    want_dev = ref.fused_fold_ref(values, gids, mask, blk, tvalid, center,
                                  a, b, num_groups=G, nbins=nbins)
    cpu_bitwise = all(bool(_same(torch, x, y).all())
                      for x, y in zip(got, want_cpu))
    hist_dev_bitwise = _bits_equal(torch, got[3], want_dev[3])
    max_abs = max(_max_abs_diff(torch, x, y) for x, y in zip(got, want_cpu))
    ok = run_to_run and moments_bitwise and cpu_bitwise and hist_dev_bitwise
    # the library yardstick: bincount of a precomputed flat (group, bin)
    # index for the histogram plus one index_add_ for the moments
    gv, gg, gm = (t[blk.long()].reshape(-1) for t in (values, gids, mask))
    gm = gm * tvalid.repeat_interleave(block_rows).to(torch.float32)
    flat = gg.long() * nbins + ref.hist_bins_ref(gv, a, b, nbins)
    dv = gv - center
    cols = torch.stack([gm, dv * gm, dv * dv * gm], dim=1)
    gl = gg.long()
    pinned = torch.empty((G, nbins), dtype=torch.float32, pin_memory=True)
    ms = timer(lambda: kfused.fused_fold(*args))
    plain_ms = timer(lambda: ref.fused_fold_ref(
        values, gids, mask, blk, tvalid, center, a, b, num_groups=G,
        nbins=nbins))
    lib_ms = timer(lambda: (
        torch.bincount(flat, weights=gm, minlength=G * nbins),
        torch.zeros((G, 3), device="cuda").index_add_(0, gl, cols)))
    d2h_ms = timer(lambda: pinned.copy_(got[3], non_blocking=True))
    rows = budget * block_rows
    bound_ms, bound_by = bound(rows * 12 + budget * 8 + 5 * G * 4
                               + G * nbins * 4, rows * 14)
    return dict(G=G, exact_data=exact, nbins=nbins, budget=budget,
                block_rows=block_rows, ok=ok,
                run_to_run_identical=run_to_run,
                moments_bitwise_vs_block_agg=moments_bitwise,
                bitwise_vs_plain_cpu=cpu_bitwise,
                hist_bitwise_vs_plain_card=hist_dev_bitwise,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                hist_d2h_pinned_ms=d2h_ms)


def cuda_activities(torch, fn):
    """Names of the device activities (kernels, memsets, copies) that one
    call of ``fn`` makes, from a ``torch.profiler`` trace."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def hist_inputs(torch, G: int, exact: bool, rows: int, nbins: int,
                seed: int):
    """``rows`` flat rows for the histogram and its grid: ``(values,
    gids, mask, a, b)``. Exact data: integers 0..16 on [0, 16]; general
    data: normal around 40 on FLIGHTS' [-60, 1800] with NaN and +-inf
    rows, every bin edge and its float32 neighbours. Groups uniform, 80
    % of the rows unmasked."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if exact:
        values = torch.randint(0, 17, (rows,), generator=gen,
                               device="cuda").to(torch.float32)
        a, b = 0.0, 16.0
    else:
        a, b = -60.0, 1800.0
        values = torch.randn(rows, generator=gen, device="cuda") * 25 + 40
        k = torch.arange(nbins + 1, device="cuda", dtype=torch.float32)
        edges = k / (nbins / (b - a)) + a
        special = torch.cat([
            edges, torch.nextafter(edges, torch.tensor(float("inf"),
                                                       device="cuda")),
            torch.nextafter(edges, torch.tensor(float("-inf"),
                                                device="cuda")),
            torch.tensor([float("nan"), float("inf"), float("-inf")] * 8,
                         device="cuda")])
        at = torch.randperm(rows, generator=gen, device="cuda")[
            :special.numel()]
        values[at] = special
    gids = torch.randint(0, G, (rows,), generator=gen, device="cuda",
                         dtype=torch.int32)
    mask = (torch.rand(rows, generator=gen, device="cuda") < 0.8).to(
        torch.float32)
    return values, gids, mask, a, b


def check_grouped_hist(torch, timer, ref, khist, G: int, exact: bool,
                       rows: int, nbins: int, seed: int):
    """The histogram of ``rows`` flat rows (one exact-sweep or recovery
    fold at the defaults; :func:`hist_inputs`): bit for bit the plain
    version's on the CPU and on the card, the same bits run to run, in
    one or two kernel launches with no memset (read from a profiler
    trace of one call)."""
    values, gids, mask, a, b = hist_inputs(torch, G, exact, rows, nbins,
                                           seed)
    args = (values, gids, mask, a, b, G, nbins)
    got = khist.grouped_hist(*args)
    again = khist.grouped_hist(*args)
    torch.cuda.synchronize()
    want_cpu = ref.grouped_hist_ref(values.cpu(), gids.cpu(), mask.cpu(),
                                    a, b, num_groups=G, nbins=nbins)
    want_dev = ref.grouped_hist_ref(values, gids, mask, a, b, num_groups=G,
                                    nbins=nbins)
    names = cuda_activities(torch, lambda: khist.grouped_hist(*args))
    bitwise = (_bits_equal(torch, got, again)
               and _bits_equal(torch, got, want_cpu)
               and _bits_equal(torch, got, want_dev))
    launches_ok = 1 <= len(names) <= 2 and not any(
        "memset" in x.lower() for x in names)
    flat = gids.long() * nbins + ref.hist_bins_ref(values, a, b, nbins)
    ms = timer(lambda: khist.grouped_hist(*args))
    plain_ms = timer(lambda: ref.grouped_hist_ref(
        values, gids, mask, a, b, num_groups=G, nbins=nbins))
    lib_ms = timer(lambda: torch.bincount(flat, weights=mask,
                                          minlength=G * nbins))
    bound_ms, bound_by = bound(rows * 12 + G * nbins * 4, rows * 5)
    plan = khist.plan(rows, G, nbins) if hasattr(khist, "plan") else None
    return dict(G=G, exact_data=exact, rows=rows, nbins=nbins,
                ok=bitwise and launches_ok, bitwise=bitwise,
                launches_ok=launches_ok, regime=plan.regime if plan else None,
                cuda_launches=len(names), cuda_activities=names,
                max_abs_err=_max_abs_diff(torch, got, want_cpu), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def scan_inputs(torch, B: int, L: int, din: int, n: int, seed: int):
    """x ~ N(0, 1), dt = softplus(N(-4.6, 0.5)) (the dt_bias init's
    0.01), B, C ~ N(0, 1), A = -(1..n) (the S4D-real init), D ~ N(1,
    0.1), h0 ~ N(0, 0.1); float32 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, mean, std):
        return torch.randn(shape, generator=gen, device="cuda") * std + mean
    x = normal((B, L, din), 0.0, 1.0)
    dt = torch.nn.functional.softplus(normal((B, L, din), -4.6, 0.5))
    b = normal((B, L, n), 0.0, 1.0)
    c = normal((B, L, n), 0.0, 1.0)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").repeat(
        din, 1)
    d = normal((din,), 1.0, 0.1)
    h0 = normal((B, din, n), 0.0, 0.1)
    return x, dt, b, c, a, d, h0


def check_selective_scan(torch, timer, ref, kscan, B: int, L: int, din: int,
                         n: int, tc: int, seed: int):
    """The scan at one shape: hout and hseg bit for bit the plain
    version's on the card (the state update rounds alike on both sides),
    y within SCAN_RTOL of it, the same bits on a second run."""
    args = scan_inputs(torch, B, L, din, n, seed)
    got = kscan.selective_scan(*args, time_chunk=tc)
    again = kscan.selective_scan(*args, time_chunk=tc)
    want = ref.selective_scan_ref(*args, time_chunk=tc)
    torch.cuda.synchronize()
    run_to_run = all(_bits_equal(torch, x, y) for x, y in zip(got, again))
    errs = {}
    for name, g, w in zip(("y", "hout", "hseg"), got, want):
        err = float((g - w).abs().max())
        errs[name] = dict(max_abs=err, max_rel=err / float(w.abs().max()))
    states_bitwise = all(_bits_equal(torch, g, w)
                         for g, w in zip(got[1:], want[1:]))
    ok = run_to_run and states_bitwise and all(
        e["max_rel"] <= SCAN_RTOL for e in errs.values())
    ms = timer(lambda: kscan.selective_scan(*args, time_chunk=tc))
    plain_ms = timer(lambda: ref.selective_scan_ref(*args, time_chunk=tc),
                     reps=PLAIN_SCAN_REPS)
    # x, dt read and y written (B, L, din); b, c read (B, L, n); a, d, h0
    # read; hout, hseg written. Per (batch, step, channel): one product
    # dt*x, then per state dt*A, exp, decay*h, (dt x)*B, +, h*C, +, and
    # D*x, + at the end: 7n + 3 operations (exp counted as one).
    f32 = 4
    bytes_moved = f32 * (3 * B * L * din + 2 * B * L * n + din * n + din
                         + 2 * B * din * n + B * (L // tc) * din * n)
    bound_ms, bound_by = bound(bytes_moved, B * L * din * (7 * n + 3))
    return dict(B=B, L=L, din=din, n=n, tc=tc, ok=ok,
                run_to_run_identical=run_to_run,
                states_bitwise=states_bitwise, tolerance_rel=SCAN_RTOL,
                plan=kscan.plan(B, L, din, n, tc)._asdict(),
                errors=errs, max_abs_err=max(e["max_abs"]
                                             for e in errs.values()),
                ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def check_selective_scan_bwd(torch, timer, ref, kscan, B: int, L: int,
                             din: int, n: int, tc: int, seed: int):
    """The scan's backward at one shape, from the plain forward's hseg and
    N(0, 1) cotangents: every gradient within SCAN_BWD_RTOL of the plain
    version on the card, the same bits on a second run."""
    args = scan_inputs(torch, B, L, din, n, seed)
    _, _, hseg = ref.selective_scan_ref(*args, time_chunk=tc)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    ybar = torch.randn((B, L, din), generator=gen, device="cuda")
    houtbar = torch.randn((B, din, n), generator=gen, device="cuda")
    bargs = (*args[:6], hseg, ybar, houtbar)
    got = kscan.selective_scan_bwd(*bargs, time_chunk=tc)
    again = kscan.selective_scan_bwd(*bargs, time_chunk=tc)
    want = ref.selective_scan_bwd_ref(*bargs, time_chunk=tc)
    torch.cuda.synchronize()
    run_to_run = all(_bits_equal(torch, x, y) for x, y in zip(got, again))
    errs = {}
    for name, g, w in zip(("dx", "ddt", "db", "dc", "da", "dd", "dh0"), got,
                          want):
        err = float((g - w).abs().max())
        errs[name] = dict(max_abs=err, max_rel=err / float(w.abs().max()))
    # the recompute is the forward's own bits, so dh0 is the plain one's
    dh0_bitwise = _bits_equal(torch, got[6], want[6])
    ok = run_to_run and dh0_bitwise and all(e["max_rel"] <= SCAN_BWD_RTOL
                                            for e in errs.values())
    ms = timer(lambda: kscan.selective_scan_bwd(*bargs, time_chunk=tc))
    plain_ms = timer(lambda: ref.selective_scan_bwd_ref(*bargs,
                                                        time_chunk=tc),
                     reps=PLAIN_SCAN_REPS)
    # read x, dt, ybar (B, L, din), b, c (B, L, n), a, d, hseg, houtbar;
    # write dx, ddt (B, L, din), dB, dC (B, L, n), dA, dD, dh0. Per
    # (batch, step, channel): the recompute's dt*x, then per state dt*A,
    # exp, decay*h, (dt x)*B, + (5); the adjoint's 4 scalar products and
    # sums, per state 15 (ybar*h, ybar*C, +, dt*A, exp, hbar*h_prev,
    # *decay, hbar*B, +, hbar*(dt x), g*dt, +, g*A, +, hbar*decay), and
    # the 4 of ddt and dx: 20n + 9 operations (exp counted as one).
    f32 = 4
    bytes_moved = f32 * (5 * B * L * din + 4 * B * L * n + 2 * din * n
                         + 2 * din + B * (L // tc) * din * n
                         + 2 * B * din * n)
    bound_ms, bound_by = bound(bytes_moved, B * L * din * (20 * n + 9))
    # the wrapper's scratch: the dB / dC partials of 128-channel clusters
    # and the (batch row, chunk) dA / dD partials; no state history
    nblk = -(-din // kscan.BWD_CHANNELS_PER_BLOCK)
    scratch = f32 * (B * L * nblk * 2 * n + B * (L // tc) * din * (n + 1))
    return dict(B=B, L=L, din=din, n=n, tc=tc, ok=ok,
                run_to_run_identical=run_to_run,
                dh0_bitwise=dh0_bitwise,
                bc_part_bytes=f32 * B * L * nblk * 2 * n,
                scratch_bytes=scratch,
                tolerance_rel=SCAN_BWD_RTOL, errors=errs,
                max_abs_err=max(e["max_abs"] for e in errs.values()),
                ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


# -- phases 3 and 4 ----------------------------------------------------------


def main_path_queries(T, fq, opt):
    """The default bounder's path: ``(name, query, sampling)`` runs."""
    qs = {"quickstart": T.AggQuery(
        agg="avg", column="dep_delay",
        filters=(T.Filter("origin", "eq", 0),),
        stop=opt.RelativeWidth(eps=0.5), bounder="bernstein",
        rangetrim=True, delta=1e-15)}
    qs.update({name: build() for name, build in fq.ALL.items()})
    qs["groupby_origin_airline"] = T.AggQuery(
        agg="avg", column="dep_delay", group_by=("origin", "airline"),
        stop=opt.ThresholdSide(threshold=10.0))
    return [(name, q, "active_peek") for name, q in qs.items()]


def anderson_queries(T, fq, opt):
    """The Anderson/DKW path (the paper's "correct but not tight"
    baseline, Table 2): F-q1 (G 1), F-q2 (G 14), F-q5 (G 200) and the
    (origin, airline) GROUP BY (G 2800) under ``active_peek``, whose
    rounds run ``fused_fold``, and F-q2 as an exact sweep, whose every
    round runs ``grouped_hist``."""
    adkw = dict(bounder="anderson_dkw", rangetrim=False)
    runs = [(f"{name}-adkw", fq.ALL[name](**adkw), "active_peek")
            for name in ("F-q1", "F-q2", "F-q5")]
    runs.append(("groupby_origin_airline-adkw", T.AggQuery(
        agg="avg", column="dep_delay", group_by=("origin", "airline"),
        stop=opt.ThresholdSide(threshold=10.0), **adkw), "active_peek"))
    runs.append(("F-q2-adkw-exact", fq.ALL["F-q2"](**adkw), "exact"))
    return runs


class StepClock:
    """Host-clock seconds inside the engine's per-round steps, summed per
    query: ``round_s`` the fused round (launches, kernels, the
    device-to-host copies and the round's one sync), ``merge_s`` the
    float64 merge of its deltas, ``host_fold_s`` a fold of the exact
    sweep or the recovery pass (materialize on the host, upload, kernels,
    merge) and ``bound_math_s`` the CI refresh. It wraps those engine
    methods while it is entered; the wrappers cost two clock reads."""

    STEPS = (("_FusedScan", "round", "round_s"),
             ("_ScanViews", "ingest_delta", "merge_s"),
             ("_ScanViews", "ingest_blocks", "host_fold_s"),
             ("_QueryIntervals", "refresh", "bound_math_s"))

    def __init__(self, engine):
        self.engine = engine
        self.totals = {}
        self.saved = []

    def _timed(self, fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.totals[key] = (self.totals.get(key, 0.0)
                                    + time.perf_counter() - t0)
        return wrapper

    def __enter__(self):
        for cls_name, meth, key in self.STEPS:
            cls = getattr(self.engine, cls_name)
            fn = getattr(cls, meth)
            self.saved.append((cls, meth, fn))
            setattr(cls, meth, self._timed(fn, key))
        return self

    def __exit__(self, *exc):
        for cls, meth, fn in self.saved:
            setattr(cls, meth, fn)
        self.saved = []

    def take(self):
        out, self.totals = self.totals, {}
        return out


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


def uncovered(np, res, truth, exists, rtol=1e-4):
    """Groups whose interval misses the truth. f32 data path: ``rtol``
    relative, 1e-4 by default (examples/quickstart.py), as absolute for
    means near zero."""
    tol = rtol * np.maximum(np.abs(truth), 1.0)
    n = len(truth)
    ok = (res.lo[:n] - tol <= truth) & (truth <= res.hi[:n] + tol)
    return np.nonzero(~ok & exists)[0]


def exact_view_error(np, res, truth, exists):
    """Largest relative error (floor 1 on |truth|) of the point estimates
    of views the run made exact; 0.0 when it made none."""
    n = len(truth)
    sel = res.exact[:n] & exists
    if not sel.any():
        return 0.0
    return float(np.max(np.abs(res.estimate[:n][sel] - truth[sel])
                        / np.maximum(np.abs(truth[sel]), 1.0)))


DECISION_FIELDS = ("count_seen", "exact", "tainted", "rows_covered",
                   "blocks_fetched", "blocks_skipped_active",
                   "blocks_skipped_static", "bitmap_probes", "rounds",
                   "stopped_early")
# The device loop against the host loop (the reference's contract):
# decisions exact, CI endpoints and estimates within these
LOOP_ATOL, LOOP_RTOL = 1e-9, 1e-12
# the profiler window over the G 2800 GROUP BY (phase 3b): rounds traced
# after untraced ones, through each loop
IDLE_WARMUP_ROUNDS, IDLE_ROUNDS = 32, 64


def _last_loop(frame):
    """The device loop the frame's last run used (its cache's most
    recently used entry)."""
    return frame.device_loops[list(frame.device_loops.keys())[-1]]


def _ci_diff(np, a_res, b_res):
    """Largest |a - b| of the finite CI endpoints and estimates, whether
    all are within ``LOOP_ATOL + LOOP_RTOL * |b|``, and whether the
    finite patterns agree."""
    worst, within, same_fin = 0.0, True, True
    for f in ("estimate", "lo", "hi"):
        a, b = getattr(a_res, f), getattr(b_res, f)
        fa, fb = np.isfinite(a), np.isfinite(b)
        same_fin &= bool(np.array_equal(fa, fb))
        fin = fa & fb
        if fin.any():
            d = np.abs(a[fin] - b[fin])
            worst = max(worst, float(d.max()))
            within &= bool(np.all(d <= LOOP_ATOL + LOOP_RTOL
                                  * np.abs(b[fin])))
    return worst, within and same_fin


def device_loop_phase(torch, np, T, sc, runs, truths, host, counters):
    """Phase 3b: every run of ``runs`` (``(path, name, query,
    sampling)``) through the device loop on a frame of scramble ``sc``,
    twice (the first builds the loop and captures its graph; the second
    only replays), held against the host loop's results ``host`` from
    phase 3. The frame is new, as phase 3's was, so each first run finds
    the static prefilters cached where phase 3's run did and counts the
    same probes; the second run finds its own cached (the one field it
    may differ from the first in). Returns ``(records, failures,
    launches, idle, captures, frame, second_runs)``, ``captures`` the loops
    whose chunk was captured as a graph (each after an eager chunk run
    under ``torch.cuda.set_sync_debug_mode("error")``), ``second_runs`` each
    run's second result (on the frame with its prefilters cached, as a
    served query finds it; phase 3c's solo runs)."""
    import profile_aqp_round as prof  # scripts/, on sys.path
    frame = T.FastFrame(sc, T.EngineConfig(device_loop=True), device="cuda")
    for c in counters.values():
        c.launches = 0
    records, failures, second_runs = [], [], {}
    for path, qname, q, sampling in runs:
        rec = dict(query=qname, path=path)
        results = []
        for attempt in ("first", "replay"):
            seen = {id(v): (v.replays, v.chunks, v.syncs)
                    for v in (frame.device_loops[k]
                              for k in frame.device_loops.keys())}
            t0 = time.perf_counter()
            res = frame.run(q, sampling=sampling, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dl = _last_loop(frame)
            r0, c0, s0 = seen.get(id(dl), (0, 0, 0))
            replays, chunks = dl.replays - r0, dl.chunks - c0
            results.append(res)
            rec[f"{attempt}_wall_s"] = wall
            rec[f"{attempt}_rounds_per_s"] = (res.rounds / wall if wall > 0
                                              else None)
            rec[f"{attempt}_graph_replays"] = replays
            rec[f"{attempt}_loop_host_syncs"] = dl.syncs - s0
            if (dl.graph is None or chunks != replays
                    or replays * dl.chunk < dl.last_rounds):
                failures.append(dict(query=qname, attempt=attempt,
                                     why="a chunk not replayed from a "
                                         "captured graph",
                                     chunks=chunks, replays=replays))
        res, again = results
        second_runs[(path, qname)] = again
        ref = host[(path, qname)]
        diff, within = _ci_diff(np, res, ref)
        same = [f for f in DECISION_FIELDS
                if np.array_equal(getattr(res, f), getattr(ref, f))]
        repeat = all(np.array_equal(getattr(res, f), getattr(again, f))
                     for f in DECISION_FIELDS + ("estimate", "lo", "hi")
                     if f != "bitmap_probes")
        miss = uncovered(np, res, *truths[qname])
        rec.update(groups=len(res.lo), rounds=res.rounds,
                   loop_rounds=dl.last_rounds, rounds_per_chunk=dl.chunk,
                   host_wall_s=host[(path, qname, "wall")],
                   host_rounds_per_s=(ref.rounds / host[(path, qname, "wall")]
                                      if host[(path, qname, "wall")] > 0
                                      else None),
                   host_syncs=ref.rounds,  # one packed copy a round
                   decisions_equal=len(same) == len(DECISION_FIELDS),
                   ci_max_abs_diff=diff, ci_within=within,
                   replay_repeats_bits=repeat, covered=not len(miss))
        records.append(rec)
        if not (rec["decisions_equal"] and within and repeat
                and not len(miss)):
            failures.append(dict(query=qname, decisions=same,
                                 ci_max_abs_diff=diff, repeat=repeat,
                                 uncovered=len(miss)))
    launches = {k: c.launches for k, c in counters.items()}
    # the card's idle share a round, G 2800 GROUP BY, both loops
    idle = {}
    for path, qname, q, sampling in runs:
        if not qname.startswith("groupby"):
            continue
        for loop in ("host", "device"):
            frame.config = T.EngineConfig(device_loop=loop == "device")
            trace = prof.trace_rounds if loop == "host" else prof.trace_chunks
            p, wall, in_round, n = trace(torch, T.engine, frame, q,
                                         IDLE_WARMUP_ROUNDS, IDLE_ROUNDS)
            if n < 1:  # the query ended before the window
                idle[f"{path}-{loop}"] = "not measured"
                continue
            summary = prof.summarize(torch, p, wall, in_round, n)
            idle[f"{path}-{loop}"] = {k: summary[k] for k in (
                "rounds_traced", "wall_ms_per_round",
                "device_busy_ms_per_round", "device_idle_share",
                "kernels_per_round", "memsets_per_round",
                "copies_per_round")}
    captures = sum(frame.device_loops[k].graph is not None
                   for k in frame.device_loops.keys())
    frame.config = T.EngineConfig(device_loop=True)
    return records, failures, launches, idle, captures, frame, second_runs


# -- phase 3c ----------------------------------------------------------------

# The dashboard workloads of benchmarks/bench_serve.py (N_QUERIES 8) and
# the non-probe query mix of benchmarks/bench_scheduler.py, built from the
# port's classes (those scripts import the JAX package).
SERVE_QUERIES = 8
# the scheduler's burst: 16 queries cut to 8 (the phase's time: each
# query's refresh runs every pass round, and every ticket is held
# against a solo run)
SCHED_BURST, SCHED_SLOTS, SCHED_CHUNK, SCHED_SEED = 8, 8, 4, 13
# the burst's queries at i % 4 == 1 and i % 4 == 3 take two more scan
# signatures of benchmarks/bench_serve.py's multi-slot workload, without
# its filter, so the burst's pass holds three slots that retire apart
SCHED_EXTRA = {1: ("dep_time", None, 30.0), 3: ("dep_delay", "airline", 6.0)}
PASS_TRACE_WARM, PASS_TRACE_CHUNKS = 1, 2   # chunks untraced, traced
# the Anderson/DKW queries that join the default bounder's in phase 3c's
# batch
SERVE_ADKW = ("F-q5-adkw", "groupby_origin_airline-adkw")
RESULT_FIELDS = ("group_codes", "estimate", "lo", "hi", "count_seen",
                 "nonempty", "exact", "tainted", "rows_covered",
                 "blocks_fetched", "blocks_skipped_active",
                 "blocks_skipped_static", "bitmap_probes", "rounds",
                 "stopped_early")


def shared_sig_workload(T, opt, n: int = SERVE_QUERIES):
    """n queries, one scan signature: grouped AVG, different stopping
    conditions and deltas."""
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            stop = opt.AbsoluteWidth(eps=2.0 + 0.5 * i)
        elif kind == 1:
            stop = opt.ThresholdSide(threshold=float(5 * i))
        else:
            stop = opt.TopKSeparated(k=2 + i % 3, largest=True)
        out.append(T.AggQuery(agg="avg", column="dep_delay",
                              group_by="origin", stop=stop,
                              delta=10.0 ** -(6 + i % 4)))
    return out


def multi_slot_workload(T, opt, n: int = SERVE_QUERIES):
    """n queries under shared filters over 4 (column, group-by) slots."""
    slots = [("dep_delay", "origin"), ("dep_delay", "airline"),
             ("dep_time", "origin"), ("dep_time", "airline")]
    out = []
    for i in range(n):
        col, grp = slots[i % len(slots)]
        out.append(T.AggQuery(agg="avg", column=col, group_by=grp,
                              filters=(T.Filter("day_of_week", "le", 5),),
                              stop=opt.AbsoluteWidth(eps=3.0 + i),
                              delta=1e-9))
    return out


def scheduler_query(T, opt, rng, i: int):
    """The burst's ``i``-th query: benchmarks/bench_scheduler.py's
    non-probe mix (no GROUP BY), or at ``SCHED_EXTRA``'s indices an AVG
    of another scan signature (a grouped one is a probe slot)."""
    if i % 4 in SCHED_EXTRA:
        col, grp, eps = SCHED_EXTRA[i % 4]
        return T.AggQuery(agg="avg", column=col, group_by=grp,
                          stop=opt.AbsoluteWidth(eps=eps * (1 + i // 4)),
                          delta=1e-9)
    agg = ["avg", "sum", "count"][int(rng.integers(3))]
    eps = {"avg": float(rng.uniform(0.5, 3.0)),
           "sum": float(rng.uniform(1e5, 1e6)),
           "count": float(rng.uniform(1e3, 1e4))}[agg]
    return T.AggQuery(agg=agg, column="dep_delay",
                      stop=opt.AbsoluteWidth(eps=eps), delta=1e-9)


def truth_of_column(np, cols, q, memo=None):
    """:func:`truth_of` for the query's own value column; ``memo`` (a
    dict) keeps one truth a (column, group-by, filters)."""
    key = q.scan_signature()
    if memo is not None and key in memo:
        return memo[key]
    if q.column in (None, "dep_delay"):
        out = truth_of(np, cols, q)
    else:
        out = truth_of(np, dict(cols, dep_delay=cols[q.column]), q)
    if memo is not None:
        memo[key] = out
    return out


class LaunchTally:
    """Kernel launches made inside ``with tally:`` blocks alone, summed
    over the blocks: the counts of one kind of call (a shared pass's,
    or the solo runs it is held against) among others."""

    def __init__(self, counters):
        self._counters = counters
        self.counts = {k: 0 for k in counters}

    def __enter__(self):
        self._before = {k: c.launches for k, c in self._counters.items()}
        return self

    def __exit__(self, *exc):
        for k, c in self._counters.items():
            self.counts[k] += c.launches - self._before[k]


def same_result(np, a, b) -> bool:
    """Bit for bit over the reference's RESULT_FIELDS."""
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in RESULT_FIELDS)


def _pass_loops(frame):
    return {id(v): v for v in (frame.device_loops[k]
                               for k in frame.device_loops.keys()
                               if k[0] == "pass")}


def _loop_stats(frame, before):
    """Builds (and the most slots of one), captures (with their host
    seconds), chunks, replays and host syncs of the pass loops since
    ``before`` (a previous
    ``_pass_loops``-keyed snapshot of ``(chunks, replays, syncs,
    capture_s)``)."""
    out = dict(loops_built=0, most_slots=0, captures=0, capture_s=0.0,
               build_s=0.0, chunks=0, replays=0, host_syncs=0)
    slots = {id(frame.device_loops[k]): len(k[2])
             for k in frame.device_loops.keys() if k[0] == "pass"}
    for k, v in _pass_loops(frame).items():
        c0, r0, s0, cap0 = before.get(k, (0, 0, 0, 0.0))
        if k not in before:
            out["loops_built"] += 1
            out["most_slots"] = max(out["most_slots"], slots[k])
            out["build_s"] += v.build_s
            out["captures"] += int(v.graph.graph is not None)
        out["capture_s"] += v.graph.capture_s - cap0
        out["chunks"] += v.chunks - c0
        out["replays"] += v.graph.replays - r0
        out["host_syncs"] += v.syncs - s0
    return out


def _loop_snapshot(frame):
    return {k: (v.chunks, v.graph.replays, v.syncs, v.graph.capture_s)
            for k, v in _pass_loops(frame).items()}


def _timed_solo_runs(torch, frame, queries, **kw):
    """Solo device-loop runs of ``queries`` on ``frame``, one after
    another: ``(results, wall seconds, seconds of graph captures among
    them)``."""
    out, capture = [], 0.0
    t0 = time.perf_counter()
    for q in queries:
        seen = {id(v): v._graph.capture_s
                for v in (frame.device_loops[k]
                          for k in frame.device_loops.keys()
                          if k[0] == "run")}
        out.append(frame.run(q, **kw))
        dl = _last_loop(frame)
        capture += dl._graph.capture_s - seen.get(id(dl), 0.0)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, capture


def trace_pass(torch, prof, server, queries, filters):
    """The card's view of a pass's rounds: a pass of ``queries`` runs
    ``PASS_TRACE_WARM`` chunks untraced, then ``PASS_TRACE_CHUNKS``
    chunks in a ``torch.profiler`` window (each chunk a graph replay and
    its packed writeback, as ``SharedPass.step`` runs them)."""
    p = server.open_pass(filters, seed=1, start_block=0)
    p.admit(queries)
    for _ in range(PASS_TRACE_WARM):
        p.step()
    torch.cuda.synchronize()
    r0 = p.rounds
    # device activity only: host-op tracing would add its own cost to
    # each of a step's ~1,000 host-side tensor ops
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as pr:
        t0 = time.perf_counter()
        for _ in range(PASS_TRACE_CHUNKS):
            if p.can_step:
                p.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = p.rounds - r0
    if n < 1:
        return "not measured"
    summary = prof.summarize(torch, pr, wall, None, n)
    return {k: summary[k] for k in (
        "rounds_traced", "wall_ms_per_round", "device_busy_ms_per_round",
        "device_idle_share", "kernels_per_round", "memsets_per_round",
        "copies_per_round")}


def serving_phase(torch, np, T, opt, frame, batch, solo, truths, cols,
                  counters):
    """Phase 3c: shared-scan serving on phase 3b's frame through the
    device pass loop. ``batch`` is ``(path, name, query)`` of the
    queries of one ``run_batch``; ``solo`` their solo device-loop
    results on this frame (seed 0). Returns ``(record, failures,
    pass_launches, solo_launches)``: the kernel launches of the shared
    passes alone, and those of the solo runs they are held against."""
    import profile_aqp_round as prof  # scripts/, on sys.path
    from repro_torch.serve import FrameServer, QueryScheduler, SimClock
    server = FrameServer(frame)
    failures = []
    nb = frame.scramble.n_blocks
    rec = {}
    passes, solos = LaunchTally(counters), LaunchTally(counters)
    memo = {}

    # 1. one run_batch of the whole batch: the reference plans queries of
    # one scan signature (quickstart and F-q1, F-q2 and F-q9, ...) into
    # one slot, whose selection is the union over them, so a query alone
    # in its slot is bit for bit its solo run and every query covers the
    # truth; then the batch split into run_batch calls of distinct
    # signatures (every query alone in its slot, passes of several
    # slots), every result bit for bit its solo run
    queries = [q for _, _, q in batch]
    sigs = [q.scan_signature() for q in queries]
    splits, seen = [], {}
    for i, sig in enumerate(sigs):
        k = seen.get(sig, 0)
        seen[sig] = k + 1
        if k == len(splits):
            splits.append([])
        splits[k].append(i)
    for part, groups in (("run_batch", [list(range(len(batch)))]),
                         ("run_batch_split", splits)):
        snap = _loop_snapshot(frame)
        rows = []
        t0 = time.perf_counter()
        for idx in groups:
            with passes:
                res = server.run_batch([queries[i] for i in idx], seed=0)
            for i, r in zip(idx, res):
                path, name, _ = batch[i]
                shared = part == "run_batch" and sigs.count(sigs[i]) > 1
                miss = uncovered(np, r, *truths[name])
                bitwise = (None if shared
                           else same_result(np, r, solo[(path, name)]))
                rows.append(dict(query=name, path=path, shared_slot=shared,
                                 rounds=r.rounds, groups=len(r.lo),
                                 bitwise_to_solo=bitwise,
                                 covered=not len(miss)))
                if len(miss) or bitwise is False:
                    failures.append(dict(part=part, query=name,
                                         uncovered=len(miss),
                                         bitwise=bitwise))
        torch.cuda.synchronize()
        rec[part] = dict(
            queries=rows, wall_s=time.perf_counter() - t0,
            batches=len(groups),
            passes=sum(len(server.plan([queries[i] for i in idx]))
                       for idx in groups),
            slots=sum(len({sigs[i] for i in idx}) for idx in groups),
            **_loop_stats(frame, snap))

    # 2. the dashboard fan-out: served against 8 sequential solo runs
    fan = {}
    for wname, qs in (("shared_sig", shared_sig_workload(T, opt)),
                      ("multi_slot", multi_slot_workload(T, opt))):
        kw = dict(sampling="active_peek", seed=1, start_block=0)
        with solos:
            seq, seq_wall, seq_capture = _timed_solo_runs(torch, frame, qs,
                                                          **kw)
        snap = _loop_snapshot(frame)
        t0 = time.perf_counter()
        with passes:
            served = server.run_batch(qs, **kw)
            torch.cuda.synchronize()
        srv_wall = time.perf_counter() - t0
        stats = _loop_stats(frame, snap)
        t0 = time.perf_counter()
        bad = [i for i, (q, r) in enumerate(zip(qs, served))
               if len(uncovered(np, r, *truth_of_column(np, cols, q,
                                                        memo)))]
        truth_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with passes:
            idle = trace_pass(torch, prof, server, qs, qs[0].filters)
        trace_s = time.perf_counter() - t0
        fan[wname] = dict(
            queries=len(qs), pass_rounds=max(r.rounds for r in served),
            sequential_wall_s=seq_wall, sequential_capture_s=seq_capture,
            sequential_qps=len(qs) / seq_wall,
            served_wall_s=srv_wall, served_qps=len(qs) / srv_wall,
            sequential_qps_replay=len(qs) / max(seq_wall - seq_capture,
                                                1e-9),
            served_qps_replay=len(qs) / max(srv_wall - stats["capture_s"]
                                            - stats["build_s"], 1e-9),
            sequential_rounds=sum(r.rounds for r in seq),
            uncovered=bad, truth_s=truth_s, trace_s=trace_s,
            pass_window=idle, **stats)
        if bad:
            failures.append(dict(part=wname, uncovered=bad))
    rec["fan_out"] = fan

    # 3. the scheduler on a SimClock: a burst, bitwise to solo at each
    # slot's anchor, replayed to the same event log
    rng = np.random.default_rng(SCHED_SEED)
    burst = [scheduler_query(T, opt, rng, i) for i in range(SCHED_BURST)]

    def run_sched():
        sched = QueryScheduler(FrameServer(frame), SimClock(), seed=1,
                               round_cost_s=1e-3, max_slots=SCHED_SLOTS,
                               chunk_rounds=SCHED_CHUNK, checkpoint_every=1)
        for q in burst:
            sched.submit(q, at=0.0)
        sched.run_until_idle()
        return sched

    snap = _loop_snapshot(frame)
    t0 = time.perf_counter()
    with passes:
        a = run_sched()
        torch.cuda.synchronize()
    sched_wall = time.perf_counter() - t0
    stats = _loop_stats(frame, snap)
    t0 = time.perf_counter()
    with passes:
        b = run_sched()
        torch.cuda.synchronize()
    rerun_wall = time.perf_counter() - t0
    not_done = [i for i, tk in enumerate(a.tickets) if tk.status != "done"]
    not_solo = []
    anchors = set()
    t0 = time.perf_counter()
    for i, (tk, q) in enumerate(zip(a.tickets, burst)):
        if tk.status != "done":
            continue
        anchor = tk._qc.slot.anchor
        anchors.add(int(anchor))
        with solos:
            want = frame.run(q, sampling="active_peek", seed=1,
                             start_block=(a.start_block + anchor) % nb)
        if not same_result(np, tk.result, want):
            not_solo.append(i)
    solo_wall = time.perf_counter() - t0
    same_log = [tuple(e) for e in a.log] == [tuple(e) for e in b.log]
    admits = sum(1 for e in a.log if e[2] == "admit")
    retires = sum(1 for e in a.log if e[2] == "retire")
    # one pass with a mid-scan join, resumed from a checkpoint taken
    # after it and held to the uninterrupted pass; the joiners also to
    # their solo runs at their anchor
    kw = dict(seed=1, start_block=0, chunk_rounds=SCHED_CHUNK)
    t0 = time.perf_counter()
    with passes:
        p = server.open_pass((), **kw)
        p.admit(burst[:2])
        for _ in range(2):
            p.step()
        late = p.admit(burst[2:4])
        p.step()
        cp = p.checkpoint()
        while p.can_step:
            p.step()
        p.finish()
        q_ = server.resume_pass(cp, chunk_rounds=SCHED_CHUNK)
        while q_.can_step:
            q_.step()
        q_.finish()
    resume_wall = time.perf_counter() - t0
    resumed_equal = all(same_result(np, q_.result_of(q), p.result_of(q))
                        for q in burst[:4])
    late_anchor = int(late[0].slot.anchor)
    with solos:
        late_solo = all(same_result(np, p.result_of(q), frame.run(
            q, sampling="active_peek", seed=1,
            start_block=late_anchor % nb)) for q in burst[2:4])
    rec["scheduler"] = dict(
        burst=SCHED_BURST, max_slots=SCHED_SLOTS, chunk_rounds=SCHED_CHUNK,
        wall_s=sched_wall, rerun_wall_s=rerun_wall, solo_wall_s=solo_wall,
        resume_wall_s=resume_wall,
        signatures=len({q.scan_signature() for q in burst}),
        checkpoints=sum(1 for e in a.log if e[2] == "checkpoint"),
        admits=admits, retires=retires,
        events=len(a.log), anchors=sorted(anchors), not_done=not_done,
        not_bitwise_to_solo=not_solo, same_event_log=same_log,
        resumed_equals_uninterrupted=resumed_equal,
        late_join_anchor=late_anchor, late_joiners_bitwise_to_solo=late_solo,
        **stats)
    # the burst must have run a pass of several slots through several
    # membership epochs (loops)
    if (not_done or not_solo or not same_log or not resumed_equal
            or not late_solo or late_anchor == 0
            or stats["most_slots"] < 2 or stats["loops_built"] < 2):
        failures.append(dict(part="scheduler", not_done=not_done,
                             not_solo=not_solo, same_log=same_log,
                             resumed=resumed_equal, late_solo=late_solo,
                             late_anchor=late_anchor,
                             most_slots=stats["most_slots"],
                             loops_built=stats["loops_built"]))
    return rec, failures, passes.counts, solos.counts


def serving_host_loop(torch, np, T, sc, batch):
    """Phase 3c's host pass loop (``device_loop=False``): the batch on
    the card and on the CPU, decisions equal and CIs within 1e-6
    relative (the multi-query probe runs once a slot a round here)."""
    from repro_torch.serve import FrameServer
    cfg = T.EngineConfig(device_loop=False)
    queries = [q for _, _, q in batch]
    t0 = time.perf_counter()
    r_g = FrameServer(T.FastFrame(sc, cfg, device="cuda")).run_batch(
        queries, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r_c = FrameServer(T.FastFrame(sc, cfg, device="cpu")).run_batch(
        queries, seed=0)
    rows, bad = [], []
    for (_, name, _), a, b in zip(batch, r_g, r_c):
        same = all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in DECISION_FIELDS)
        rel = 0.0
        for f in ("estimate", "lo", "hi"):
            x, y = getattr(a, f), getattr(b, f)
            if not np.array_equal(np.isfinite(x), np.isfinite(y)):
                rel = np.inf
                continue
            fin = np.isfinite(x)
            if fin.any():
                rel = max(rel, float(np.max(np.abs(x[fin] - y[fin])
                                            / np.maximum(np.abs(y[fin]),
                                                         1e-300))))
        rows.append(dict(query=name, rounds=a.rounds, decisions_equal=same,
                         ci_max_rel=rel))
        if not same or rel > 1e-6:
            bad.append(name)
    return dict(queries=rows, card_wall_s=wall), bad


# -- phase 5 -----------------------------------------------------------------


def serving_model(torch, np):
    """falcon-mamba-7b at full width and depth, bf16, ``ssm_impl="pallas"``,
    its weights initialised on the card from MODEL_SEED, and the
    SERVE_BATCH x PROMPT_LEN prompt tokens. Returns (model, lm, tokens,
    init_s)."""
    from repro_torch.configs import get as get_config
    from repro_torch.models import build as build_model

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("falcon_mamba_7b"),
                              ssm_impl="pallas")
    model = build_model(cfg)
    lm = model.init(MODEL_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(MODEL_SEED).integers(
        0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN))).cuda()
    return model, lm, tokens, init_s


def prefill_once(torch, model, lm, tokens):
    """One prefill of ``tokens`` between two syncs. Returns (last logits,
    cache, host seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(lm, {"tokens": tokens})
    torch.cuda.synchronize()
    return logits, cache, time.perf_counter() - t0


def decode_steps(torch, model, lm, cache, tok, pos: int, steps: int):
    """``steps`` greedy decode steps from ``tok`` at position ``pos``, each
    feeding back the argmax on the card (no host sync inside). Returns
    (generated tokens (B, steps), every logit finite (a card tensor),
    cache, host seconds)."""
    out, finite = [], torch.ones((), dtype=torch.bool, device=tok.device)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode(lm, cache, {"token": tok,
                                                 "pos": pos + i})
        finite &= torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize()
    return torch.cat(out, dim=1), finite, cache, time.perf_counter() - t0


def serve_once(torch, model, lm, tokens, steps: int):
    """One prefill of ``tokens`` and ``steps`` greedy decode steps. Returns
    the generated tokens, whether every logit was finite and the times."""
    logits, cache, prefill_s = prefill_once(torch, model, lm, tokens)
    prefill_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tok = logits[:, -1].argmax(-1, keepdim=True)
    gen, finite, _, decode_s = decode_steps(torch, model, lm, cache, tok,
                                            tokens.shape[1], steps)
    finite &= torch.isfinite(logits).all()
    return dict(tokens=torch.cat([tok, gen], dim=1).cpu(),
                finite=bool(finite), prefill_s=prefill_s, decode_s=decode_s,
                prefill_peak_gib=prefill_peak_gib)


def check_prefill_decode(torch, np, model, lm, B: int, T: int, seed: int):
    """tests/test_models_smoke.py's contract on the card: prefill(T-1
    tokens) + decode(token T-1) against forward(T) at positions T-2 and
    T-1, ``|a - b| <= 2e-3 + 2e-3 |b|``."""
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T))).cuda()
    with torch.inference_mode():
        full, _ = model.forward(lm, {"tokens": toks})
    pre, cache = model.prefill(lm, {"tokens": toks[:, :T - 1]})
    dec, _ = model.decode(lm, cache, {"token": toks[:, T - 1:],
                                      "pos": T - 1})
    pairs = ((pre[:, -1], full[:, T - 2]), (dec[:, 0], full[:, T - 1]))
    worst = max(float(((g - w).abs() - 2e-3 * w.abs()).max())
                for g, w in pairs)
    return dict(B=B, T=T, n_layers=cfg.n_layers, d_model=cfg.d_model,
                param_dtype=cfg.param_dtype,
                max_abs_err=max(float((g - w).abs().max()) for g, w in pairs),
                ok=worst <= 2e-3)


def check_card_vs_cpu_model(torch, np, model, B: int, T: int, seed: int):
    """The same weights on the CPU and on the card: forward, prefill and
    decode logits within 1e-4 of their largest magnitude."""
    lm_cpu = model.init(seed, device="cpu")
    lm_gpu = model.init(seed, device="cuda")
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (B, T)))
    outs = []
    for lm, dev in ((lm_cpu, "cpu"), (lm_gpu, "cuda")):
        t = toks.to(dev)
        with torch.inference_mode():
            full, _ = model.forward(lm, {"tokens": t})
        pre, cache = model.prefill(lm, {"tokens": t[:, :T - 1]})
        dec, _ = model.decode(lm, cache, {"token": t[:, T - 1:],
                                          "pos": T - 1})
        outs.append((full, pre, dec))
    rel = {name: float((g.cpu() - w).abs().max()) / float(w.abs().max())
           for name, g, w in zip(("forward", "prefill", "decode"), outs[1],
                                 outs[0])}
    return dict(B=B, T=T, n_layers=model.cfg.n_layers,
                d_model=model.cfg.d_model, max_rel=rel,
                ok=all(v <= 1e-4 for v in rel.values()))


def serve_phase(torch, np, counters):
    """Phase 5: falcon-mamba-7b serving at full width and depth, then the
    two consistency checks. Returns (record, launches on the serving
    path)."""
    from repro_torch.configs import get as get_config
    from repro_torch.models import build as build_model

    torch.cuda.reset_peak_memory_stats()
    model, lm, tokens, init_s = serving_model(torch, np)
    cfg = model.cfg
    weights_gib = torch.cuda.memory_allocated() / 2**30
    n_params = sum(p.numel() for p in lm.parameters())
    for c in counters.values():
        c.launches = 0
    first = serve_once(torch, model, lm, tokens, DECODE_STEPS)
    launches = {k: c.launches for k, c in counters.items()}
    second = serve_once(torch, model, lm, tokens, DECODE_STEPS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    runs = [dict(prefill_s=r["prefill_s"],
                 prefill_tokens_per_s=SERVE_BATCH * PROMPT_LEN
                 / r["prefill_s"],
                 decode_ms_per_step=r["decode_s"] / DECODE_STEPS * 1e3,
                 decode_tokens_per_s=SERVE_BATCH * DECODE_STEPS
                 / r["decode_s"],
                 peak_gib_after_prefill=r["prefill_peak_gib"],
                 finite=r["finite"]) for r in (first, second)]
    repeatable = torch.equal(first["tokens"], second["tokens"])
    del lm
    torch.cuda.empty_cache()

    # prefill + decode = forward at full width, 4 layers, float32
    cfg4 = dataclasses.replace(cfg, n_layers=4, param_dtype="float32",
                               compute_dtype="float32")
    model4 = build_model(cfg4)
    lm4 = model4.init(MODEL_SEED, device="cuda")
    consistency = check_prefill_decode(torch, np, model4, lm4, B=2, T=512,
                                       seed=1)
    del lm4
    torch.cuda.empty_cache()
    # the reduced config on the card against the CPU, float32
    small = dataclasses.replace(get_config("falcon_mamba_7b", reduced=True),
                                param_dtype="float32",
                                compute_dtype="float32", ssm_impl="pallas")
    card_vs_cpu = check_card_vs_cpu_model(torch, np, build_model(small),
                                          B=2, T=64, seed=2)

    stray = [k for k, v in launches.items()
             if k != "selective_scan" and v]
    ok = (all(r["finite"] for r in runs) and repeatable
          and launches["selective_scan"] == cfg.n_layers and not stray
          and consistency["ok"] and card_vs_cpu["ok"])
    record = dict(
        model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_inner=cfg.d_inner, ssm_state=cfg.ssm_state, vocab=cfg.vocab,
        param_dtype=cfg.param_dtype, params=n_params, init_s=init_s,
        requests=SERVE_BATCH, prompt_tokens=PROMPT_LEN,
        decode_steps=DECODE_STEPS, runs=runs, tokens_repeat=repeatable,
        launches=launches, weights_gib=weights_gib,
        peak_device_gib=peak_gib,
        reduced={"prefill_32k": "32 x 32768 -> 8 x 2048 (a (32, 32768, "
                                "8192) f32 activation alone is 34 GB)",
                 "decode_32k": "batch 128 after a 32K context -> batch 8 "
                               "after 2048 tokens"},
        prefill_decode_vs_forward=consistency, card_vs_cpu=card_vs_cpu,
        ok=ok)
    return record, launches


def training_setup(torch):
    """Phase 6's model, optimizer, state, batch and step:
    falcon-mamba-7b at full width, TRAIN_LAYERS layers, bf16 parameters,
    AdamW with float32 moments (the config's own), remat and
    TRAIN_MICROBATCHES microbatches, random weights from MODEL_SEED on the
    card. Returns ``(cfg, ocfg, state, batch, step, init_s)``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs import get as get_config
    from repro_torch.data.tokens import train_batch
    from repro_torch.models import build as build_model
    from repro_torch.train import OptConfig, build_train_step, init_state

    cfg = dataclasses.replace(get_config("falcon_mamba_7b"),
                              ssm_impl="pallas", n_layers=TRAIN_LAYERS)
    if not (cfg.remat and cfg.remat_policy == "nothing"
            and cfg.microbatches == TRAIN_MICROBATCHES
            and cfg.optimizer == "adamw" and cfg.moment_dtype == "float32"):
        raise AssertionError(f"falcon-mamba-7b's training settings moved: "
                             f"{cfg}")
    model = build_model(cfg)
    # lr_at(step 0) is 0 whatever the warmup: the warm-up step moves
    # nothing, the timed steps train at the default lr
    ocfg = OptConfig.for_arch(cfg, warmup_steps=1)
    t0 = time.perf_counter()
    state = init_state(model, MODEL_SEED, ocfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = ShapeConfig("train_4k", TRAIN_LEN, TRAIN_BATCH, "train")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_batch(cfg, shape, 0, seed=MODEL_SEED).items()}
    return cfg, ocfg, state, batch, build_train_step(model, ocfg), init_s


def train_step_once(torch, step, state, batch):
    """One training step between two syncs: ``(state, record)`` with its
    host-clock seconds and metrics as floats."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ci = met["loss_ci_state"]
    return state, dict(
        step=int(state["step"]) - 1, loss=float(met["loss"]),
        total_loss=float(met["total_loss"]),
        z_loss=float(met["z_loss"]), grad_norm=float(met["grad_norm"]),
        lr=float(met["lr"]), tokens=float(met["tokens"]),
        loss_ci_count=float(ci.count), loss_ci_mean=float(ci.mean),
        seconds=secs, tokens_per_s=TRAIN_BATCH * TRAIN_LEN / secs)


def train_phase(torch, np, counters):
    """Phase 6: :func:`training_setup`, one warm-up step, then
    TRAIN_STEPS timed steps with the launch counts zeroed before them.
    Returns (record, launches on the training path)."""
    torch.cuda.reset_peak_memory_stats()
    cfg, ocfg, state, batch, step, init_s = training_setup(torch)
    state_gib = torch.cuda.memory_allocated() / 2**30
    n_params = sum(p.numel() for p in state["params"].parameters())
    state, warm = train_step_once(torch, step, state, batch)
    for c in counters.values():
        c.launches = 0
    timed = []
    for _ in range(TRAIN_STEPS):
        state, rec = train_step_once(torch, step, state, batch)
        timed.append(rec)
    launches = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del state, step, batch
    torch.cuda.empty_cache()

    passes = TRAIN_STEPS * cfg.microbatches * cfg.n_layers
    want = {"selective_scan": 2 * passes, "selective_scan_bwd": passes}
    stray = [k for k, v in launches.items() if k not in want and v]
    losses = [r["loss"] for r in timed]
    norms = [r["grad_norm"] for r in timed]
    finite = all(np.isfinite([r[k] for r in [warm] + timed
                              for k in ("loss", "grad_norm")]))
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    norm_bounded = max(norms) <= TRAIN_GRAD_NORM_GROWTH * norms[0]
    ok = (finite and falls and norm_bounded and not stray
          and all(launches[k] == v for k, v in want.items()))
    record = dict(
        model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_inner=cfg.d_inner, ssm_state=cfg.ssm_state, vocab=cfg.vocab,
        param_dtype=cfg.param_dtype, optimizer=ocfg.name,
        moment_dtype=ocfg.moment_dtype, lr=ocfg.lr,
        remat=cfg.remat_policy, microbatches=cfg.microbatches,
        params=n_params, init_s=init_s, state_gib=state_gib,
        batch=TRAIN_BATCH, seq_len=TRAIN_LEN,
        same_batch_every_step=True, warmup_step=warm, steps=timed,
        mean_step_s=statistics.mean(r["seconds"] for r in timed),
        tokens_per_s=TRAIN_BATCH * TRAIN_LEN * TRAIN_STEPS
        / sum(r["seconds"] for r in timed),
        loss_falls_every_step=falls, grad_norm_bounded=norm_bounded,
        grad_norm_growth_limit=TRAIN_GRAD_NORM_GROWTH, launches=launches,
        launches_expected=want, peak_device_gib=peak_gib,
        reduced={"n_layers": "64 -> 16 (16 bytes a parameter: bf16 param "
                             "and grad, f32 grad accumulator, two f32 "
                             "moments; 7.27 G parameters need ~116 GB, "
                             "one H100 has 80 GB)",
                 "train_4k": "batch 256 x 4096 -> 4 x 4096 in 2 "
                             "microbatches of 2 (time limit)"},
        ok=ok)
    return record, launches


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
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "scripts")]
    import repro_torch.aqp as T
    from repro_torch.aqp import flights_queries as fq
    from repro_torch.core import optstop as opt
    from repro_torch.data import flights
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitmap_active as kbit
    from repro_torch.kernels import block_agg as kblock
    from repro_torch.kernels import fused_fold as kfused
    from repro_torch.kernels import grouped_hist as khist
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as kscan

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
    # the fused round's head at the engine's defaults: window 4096 (the
    # cover cap), budget 64 (round_blocks)
    head = [check_round_select(torch, timer, ref, kbit, W, nb=97_657,
                               window=4096, budget=64, seed=W + 3)
            for W in (1, 7, 50, 88, 320)]
    # shared-scan serving: the multi-query probe at Q 1, 2, 8 over one
    # window and over every row, and a slot's head with a stack of
    # masks over a wrapped lap
    multi = [check_bitmap_active_multi(torch, timer, ref, kbit, W, Q,
                                       nb=97_657, window=4096,
                                       seed=100 + W + Q)
             for W in (7, 88) for Q in (1, 2, 8)]
    stacked = [check_round_select_stack(torch, timer, ref, kbit, W, Q,
                                        nb=97_657, window=4096, budget=64,
                                        seed=200 + W + Q)
               for W in (7, 88) for Q in (1, 8)]
    fus = [check_fused_fold(torch, timer, ref, kfused, kblock, G, exact,
                            nb=8192, block_rows=1024, budget=64,
                            nbins=HIST_BINS, seed=G + 1)
           for G in (1, 200, 2800) for exact in (True, False)]
    hst = [check_grouped_hist(torch, timer, ref, khist, G, exact,
                              rows=HIST_ROWS, nbins=HIST_BINS, seed=G + 2)
           for G in HIST_GROUPS for exact in (True, False)]
    # the falcon-mamba layer's serving shape (B 8, L 2048, d_inner 8192,
    # n 16), small uneven ones, then its training shape (B 2, L 4096)
    scn = [check_selective_scan(torch, timer, ref, kscan, *shape, seed=i)
           for i, shape in enumerate(SCAN_SHAPES)]
    # its backward at one batch row, small shapes, then the training shape
    sbw = [check_selective_scan_bwd(torch, timer, ref, kscan, *shape,
                                    seed=10 + i)
           for i, shape in enumerate(SCAN_BWD_SHAPES)]
    emit(dict(phase="kernels_vs_plain", card=name, power_limit=power_limit,
              block_agg=agg, bitmap_active=bit, round_select=head,
              bitmap_active_multi=multi, round_select_stack=stacked,
              fused_fold=fus, grouped_hist=hst, selective_scan=scn,
              selective_scan_bwd=sbw))
    bad = [r for r in agg + bit + head + multi + stacked + fus + hst + scn
           + sbw if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    del timer  # its 1 GiB flush buffer: not part of any later peak
    torch.cuda.empty_cache()

    # ---- 3. the main paths at full size -------------------------------------
    t0 = time.perf_counter()
    ds = flights.generate(n_rows=args.rows, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    t_scr = time.perf_counter() - t0
    # the per-round host loop; phase 3b runs the device loop on this frame
    frame = T.FastFrame(sc, T.EngineConfig(device_loop=False),
                        device="cuda")
    paths = {"bernstein": main_path_queries(T, fq, opt),
             "anderson_dkw": anderson_queries(T, fq, opt)}
    # the kernels each path must launch, and no others: every fused round
    # runs the round head and a fold; the standalone probe runs for the
    # static prefilter of a categorical filter the frame has not seen
    # (F-q1's, F-q3's and F-q9's on the default bounder's path; the
    # Anderson/DKW path's only one, F-q1's, is cached on the frame by then)
    must = {"bernstein": ("block_agg", "round_select", "bitmap_active"),
            "anderson_dkw": ("block_agg", "round_select", "fused_fold",
                             "grouped_hist")}
    counters = {"block_agg": kblock.block_agg,
                "bitmap_active": kbit.active_blocks,
                "bitmap_active_multi": kbit.active_blocks_multi,
                "round_select": kbit.round_select,
                "fused_fold": kfused.fused_fold,
                "grouped_hist": khist.grouped_hist,
                "selective_scan": kscan.selective_scan,
                "selective_scan_bwd": kscan.selective_scan_bwd}
    path_launches = {}
    truths, host_results = {}, {}
    for path, runs in paths.items():
        truths.update({k: truth_of(np, ds.columns, q) for k, q, _ in runs})
        for c in counters.values():
            c.launches = 0
        t_main = time.perf_counter()
        records, failures = [], []
        with StepClock(T.engine) as clock:
            for qname, q, sampling in runs:
                t0 = time.perf_counter()
                res = frame.run(q, sampling=sampling, seed=0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                host_results[(path, qname)] = res
                host_results[(path, qname, "wall")] = wall
                rtol = EXACT_SWEEP_RTOL if sampling == "exact" else 1e-4
                miss = uncovered(np, res, *truths[qname], rtol=rtol)
                if len(miss):
                    g = int(miss[0])
                    failures.append(dict(
                        query=qname, groups=len(miss), first=g,
                        truth=float(truths[qname][0][g]),
                        lo=float(res.lo[g]), hi=float(res.hi[g])))
                records.append(dict(
                    query=qname, sampling=sampling, groups=len(res.lo),
                    rounds=res.rounds, blocks_fetched=res.blocks_fetched,
                    blocks_skipped_active=res.blocks_skipped_active,
                    blocks_skipped_static=res.blocks_skipped_static,
                    bitmap_probes=res.bitmap_probes,
                    stopped_early=bool(res.stopped_early),
                    exact_views=int(res.exact.sum()),
                    tainted_views=int(res.tainted.sum()),
                    covered=not len(miss), coverage_rtol=rtol,
                    exact_view_max_rel_err=exact_view_error(
                        np, res, *truths[qname]),
                    wall_s=wall,
                    rounds_per_s=res.rounds / wall if wall > 0 else None,
                    steps_s=clock.take()))
        main_wall = time.perf_counter() - t_main
        launches = {k: c.launches for k, c in counters.items()}
        path_launches[path] = launches
        emit(dict(phase="main_path", path=path, card=name,
                  power_limit=power_limit, rows=args.rows,
                  blocks=sc.n_blocks,
                  reduced={"rows": f"{PAPER_ROWS / 1e6:g}M -> "
                                   f"{args.rows / 1e6:g}M"},
                  generate_s=t_gen, scramble_s=t_scr,
                  queries_wall_s=main_wall,
                  total_rounds=sum(r["rounds"] for r in records),
                  total_round_s=sum(r["steps_s"].get("round_s", 0.0)
                                    for r in records),
                  launches=launches, peak_device_gib=torch.cuda
                  .max_memory_allocated() / 2**30, queries=records))
        if failures:
            raise AssertionError(f"{path}: intervals miss the truth: "
                                 f"{failures}")
        idle = [k for k in must[path] if launches[k] == 0]
        stray = [k for k in launches if k not in must[path] and launches[k]]
        if idle or stray:
            raise AssertionError(f"{path}: kernels of the path never "
                                 f"launched {idle}, or kernels off the "
                                 f"path launched {stray}: {launches}")

    # ---- 3b. the device-resident round loop on the same frame -------------
    t0 = time.perf_counter()
    loop_runs = [(path, qname, q, sampling)
                 for path, runs in paths.items()
                 for qname, q, sampling in runs if sampling != "exact"]
    del frame  # phase 3b builds its own, from the same scramble
    torch.cuda.empty_cache()
    records, failures, launches, idle, captures, loop_frame, solo = \
        device_loop_phase(torch, np, T, sc, loop_runs, truths,
                          host_results, counters)
    path_launches["device_loop"] = launches
    emit(dict(phase="device_loop", card=name, power_limit=power_limit,
              rows=args.rows, blocks=sc.n_blocks,
              rounds_per_chunk=T.engine.GRAPH_CHUNK_ROUNDS,
              sync_checked_captures=captures,
              launches=launches, idle_share_g2800=idle,
              host_loop_rounds=sum(r["rounds"] for r in records),
              graph_replays=sum(r["first_graph_replays"]
                                + r["replay_graph_replays"]
                                for r in records),
              phase_s=time.perf_counter() - t0, queries=records))
    if failures:
        raise AssertionError(f"device loop: {failures}")
    idle_k = [k for k in ("round_select", "block_agg", "fused_fold")
              if launches[k] == 0]
    if idle_k:
        raise AssertionError(f"device loop: kernels never launched "
                             f"{idle_k}: {launches}")

    # ---- 3c. shared-scan serving on phase 3b's frame ----------------------
    t0 = time.perf_counter()
    serve_batch = [(path, qname, q) for path, runs in paths.items()
                   for qname, q, sampling in runs
                   if path == "bernstein" or qname in SERVE_ADKW]
    for c in counters.values():
        c.launches = 0
    serving, failures, launches, solo_launches = serving_phase(
        torch, np, T, opt, loop_frame, serve_batch, solo, truths,
        ds.columns, counters)
    path_launches["serving"] = launches
    emit(dict(phase="serving", card=name, power_limit=power_limit,
              rows=args.rows, blocks=sc.n_blocks, launches=launches,
              solo_launches=solo_launches,
              phase_s=time.perf_counter() - t0,
              reduced={"rows": f"{PAPER_ROWS / 1e6:g}M -> "
                               f"{args.rows / 1e6:g}M",
                       "scheduler_burst": f"16 -> {SCHED_BURST}"},
              **serving))
    if failures:
        raise AssertionError(f"serving: {failures}")
    idle_k = [k for k in ("round_select", "block_agg", "fused_fold")
              if launches[k] == 0]
    if idle_k:
        raise AssertionError(f"serving: kernels never launched {idle_k}: "
                             f"{launches}")
    del loop_frame, solo, sc, ds
    torch.cuda.empty_cache()

    # ---- 4. the port on the card against the port on the CPU ----------------
    ds = flights.generate(n_rows=CPU_ROWS, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    f_gpu = T.FastFrame(sc, T.EngineConfig(device_loop=False), device="cuda")
    f_cpu = T.FastFrame(sc, T.EngineConfig(device_loop=False), device="cpu")
    compare, mismatch = [], []
    for qname, q, sampling in paths["bernstein"] + paths["anderson_dkw"]:
        r_g = f_gpu.run(q, sampling=sampling, seed=0)
        r_c = f_cpu.run(q, sampling=sampling, seed=0)
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
    del f_gpu, f_cpu

    # ---- 3c, host pass loop: the serving batch on the card and the CPU ------
    for c in counters.values():
        c.launches = 0
    host_serving, mismatch = serving_host_loop(torch, np, T, sc, serve_batch)
    launches = {k: c.launches for k, c in counters.items()}
    path_launches["serving_host_loop"] = launches
    emit(dict(phase="serving_host_loop", rows=CPU_ROWS, launches=launches,
              **host_serving, total_s=time.perf_counter() - t_start))
    if mismatch:
        raise AssertionError(f"served card and CPU runs differ: {mismatch}")
    idle_k = [k for k in ("bitmap_active_multi", "round_select", "block_agg",
                          "fused_fold") if launches[k] == 0]
    if idle_k:
        raise AssertionError(f"serving host loop: kernels never launched "
                             f"{idle_k}: {launches}")

    del sc, ds
    torch.cuda.empty_cache()

    # ---- 5. the Mamba1 serving path -----------------------------------------
    serve, launches = serve_phase(torch, np, counters)
    path_launches["mamba1_serve"] = launches
    emit(dict(phase="mamba1_serve", card=name, power_limit=power_limit,
              **serve, total_s=time.perf_counter() - t_start))
    if not serve["ok"]:
        raise AssertionError(f"the Mamba1 serving path failed: {serve}")

    # ---- 6. the Mamba1 training path ----------------------------------------
    train, launches = train_phase(torch, np, counters)
    path_launches["mamba1_train"] = launches
    emit(dict(phase="mamba1_train", card=name, power_limit=power_limit,
              **train, total_s=time.perf_counter() - t_start))
    if not train["ok"]:
        raise AssertionError(f"the Mamba1 training path failed: {train}")

    # ---- 7. the kernels line ------------------------------------------------
    a = next(r for r in agg if r["G"] == 2800 and not r["exact_data"])
    b = next(r for r in bit if r["W"] == PREFILTER_WORDS)
    rs = next(r for r in head if r["W"] == 88)
    mp = next(r for r in multi if r["W"] == 88 and r["Q"] == 8)
    st1 = next(r for r in stacked if r["W"] == 88 and r["Q"] == 1)
    st8 = next(r for r in stacked if r["W"] == 88 and r["Q"] == 8)
    f = next(r for r in fus if r["G"] == 2800 and not r["exact_data"])
    h = next(r for r in hst
             if r["G"] == HIST_PATH_GROUPS and not r["exact_data"])
    h2800 = next(r for r in hst if r["G"] == 2800 and not r["exact_data"])
    sf = scn[0]  # the falcon-mamba layer's serving shape
    sb = next(r for r in sbw  # the shape the training path gives it
              if (r["B"], r["L"], r["din"], r["n"], r["tc"])
              == TRAIN_SCAN_SHAPE)
    launches = path_launches["bernstein"]
    adkw = path_launches["anderson_dkw"]
    emit({"kernels": [
        dict(name="block_agg", route="cuda",
             source="src/repro_torch/kernels/csrc/block_agg.cu",
             replaces="src/repro/kernels/block_agg.py:92",
             launches=launches["block_agg"],
             device_loop_launches=path_launches["device_loop"]["block_agg"],
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
        dict(name="round_select", route="cuda",
             source="src/repro_torch/kernels/csrc/bitmap_active.cu",
             replaces="src/repro/kernels/bitmap_active.py:40",
             launches=launches["round_select"],
             device_loop_launches=path_launches["device_loop"]["round_select"],
             max_abs_err=max(r["max_abs_err"] for r in head),
             ms=rs["ms"], plain_ms=rs["plain_ms"], bound_ms=rs["bound_ms"],
             bound_by=rs["bound_by"], library_ms=None,
             unfused_ms=rs["unfused_ms"], probe_ms=rs["probe_ms"],
             serving_launches=path_launches["serving"]["round_select"],
             stack_q8_ms=st8["ms"], stack_q1_ms=st1["ms"]),
        dict(name="active_blocks_multi", route="cuda",
             source="src/repro_torch/kernels/csrc/bitmap_active.cu",
             replaces="src/repro/kernels/bitmap_active.py:40",
             launches=path_launches["serving_host_loop"][
                 "bitmap_active_multi"],
             max_abs_err=max(r["max_abs_err"] for r in multi),
             ms=mp["window_ms"], plain_ms=mp["window_plain_ms"],
             bound_ms=mp["window_bound_ms"],
             bound_by=mp["window_bound_by"], library_ms=None,
             Q=mp["Q"], W=mp["W"], rows=mp["window"],
             per_row_loop_ms=mp["window_per_row_ms"]),
        dict(name="fused_fold", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_fold.cu",
             replaces="src/repro/kernels/fused_scan.py:148",
             launches=adkw["fused_fold"],
             device_loop_launches=path_launches["device_loop"]["fused_fold"],
             max_abs_err=max(r["max_abs_err"] for r in fus),
             ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
             bound_by=f["bound_by"], library_ms=f["library_ms"]),
        dict(name="grouped_hist", route="cuda",
             source="src/repro_torch/kernels/csrc/grouped_hist.cu",
             replaces="src/repro/kernels/hist.py:73",
             launches=adkw["grouped_hist"],
             max_abs_err=max(r["max_abs_err"] for r in hst),
             ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
             bound_by=h["bound_by"], library_ms=h["library_ms"],
             G=h["G"], cuda_launches_per_call=h["cuda_launches"],
             g2800=dict((k, h2800[k]) for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "cuda_launches"))),
        dict(name="selective_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/selective_scan.cu",
             replaces="src/repro/kernels/selective_scan.py:102",
             launches=path_launches["mamba1_serve"]["selective_scan"],
             max_abs_err=max(r["max_abs_err"] for r in scn),
             ms=sf["ms"], plain_ms=sf["plain_ms"], bound_ms=sf["bound_ms"],
             bound_by=sf["bound_by"], library_ms=None),
        dict(name="selective_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
             replaces="src/repro/kernels/selective_scan.py:223",
             launches=path_launches["mamba1_train"]["selective_scan_bwd"],
             max_abs_err=max(r["max_abs_err"] for r in sbw),
             ms=sb["ms"], plain_ms=sb["plain_ms"], bound_ms=sb["bound_ms"],
             bound_by=sb["bound_by"], library_ms=None),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
