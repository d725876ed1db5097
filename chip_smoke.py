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
     ticket done; one alone in its slot or in a non-probe slot bit for
     bit its solo run at its anchor; tickets that share a probe slot
     (one grouped signature: the slot selects with the union of their
     activity flags, the reference's contract) covering the truth and
     bit for bit both the second run's and a served batch of the slot's
     queries from its anchor (``shared_probe_slot``); a second
     run with the same event log, and a pass with a mid-scan join,
     resumed from a checkpoint taken after it, equal to the
     uninterrupted pass (its joiners bit for bit their solo runs);
  3d. seeded faults (``repro_torch.testing.faults``) on phase 3c's
     scheduler burst, the same frame and settings, phase 3c's fault-free
     tickets the oracle: transient dispatch / transfer / shard faults and
     a clock skew, retried (every ticket bit for bit its fault-free
     run); a NaN-poisoned slot quarantined (the survivors bit for bit);
     a real ``torch.OutOfMemoryError`` (the card asked for twice its
     memory) taking the chunk-halving rung; injected OOMs down the
     ladder to the host-loop rung (the pass ends on the host pass loop,
     the multi-query probe launched) and a ladder exhausted (partial
     intervals covering the truth); a seeded trace over all six kinds,
     run twice to the same event log;
  3e. the sharded scan (``EngineConfig(shard_rows=True)``) on the first
     blocks of phase 3b's scramble that hold 5M rows (``SHARD_ROWS``,
     cut for the smoke's time): the main process runs the Bernstein and
     the Anderson/DKW G 2,800 GROUP BY and phase 3c's ``shared_sig``
     batch through phases 3b / 3c's single-device paths and writes the
     blocks to files once; 2 spawned processes, each a rank of a gloo
     group (a ``FileStore``) on the same card, load them, confirm that
     gloo all-reduces the card's tensors, and run the same at
     ``merge_every`` 1 and 4, each rank folding its half of every
     block's rows with ``block_agg`` / ``fused_fold`` after the round
     head (launches counted per rank); both ranks' results the same
     bits; at K 1 the exact fields equal to the single-device results
     and CIs within 1e-3 of ``max(|x|, 1)``; every interval covering the
     truth; on an
     integer-valued frame (exact per-rank sums) K 1 bit for bit the
     single-device loop and K 4 within 1e-5; wall s, rounds/s,
     all-reduces a round and the seconds inside gloo. Then under NCCL in
     a group of one rank: ``make_sharded_fold`` captured in a CUDA graph
     and replayed, bit for bit ``ops.grouped_moments``, and the sharded
     device loop captured with its all-reduces, bit for bit the
     unsharded loop (with >= 2 cards the NCCL sharded loop also runs at
     that world size, up to 4);
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
  5b. ``evalx.ApproxEval`` of the same model (64 layers, bf16) over a
     scrambled eval set of 48 x 2048 tokens (cut from 512 for the
     smoke's time) (``data.tokens.
     make_eval_scramble``), batches of 8, delta 1e-6, target width 0.1:
     it must stop early with a certificate covering the full set's mean
     clipped loss (one forward a batch over all 6 batches, float64),
     each forward launching the scan kernel once a layer; then at full
     width, 4 layers, float32, 16 examples of 256 tokens, card against
     CPU (per-token losses within 1e-4, the same rounds and examples);
  5c. the dense, vlm and MoE families (plain PyTorch, no kernel):
     qwen2.5-3b at full width and 18 of its 36 layers, pixtral-12b at 20
     of 40, dbrx-132b at 4 of 40 (``DENSE_SERVE``; bf16, random
     weights from a seed) each serve 8 requests of 2048 positions
     (pixtral's first 512 its stubbed frontend's patch embeddings) and 16
     greedy decode steps from a cache with room for them, twice, with
     finite logits and the same tokens both times; then prefill + decode
     against forward (2e-3) at full width in float32 (qwen3-0.6b at 4
     layers, dbrx at 2, dropless), the seven ids' reduced configs on the
     card against the CPU (1e-4), and no kernel counter moved;
  5d. the hybrid and enc-dec families (plain PyTorch, no kernel):
     zamba2-7b (42 of its 81 Mamba2 layers: 7 groups, the shared
     attention block every 6) and seamless-m4t-large-v2 (24 + 24
     layers) at full width (``HYBRID_SERVE``; bf16, random weights from
     a seed) each serve 8
     requests of 2048 positions (seamless: 1024 frame embeddings for its
     encoder and 1024 text tokens; zamba2's prefill KV copied into a
     cache with room) and 16 greedy decode steps (seamless's from each
     request's first token at position 0 against its encoder memory),
     twice, with finite logits and the same tokens both times; then at
     full width in float32: zamba2's prefill + decode against forward
     at 7 layers (2e-3), seamless's teacher-forced decode against
     ``decode_train`` at 2 + 2 layers (2e-3), zamba2's ring cache (a
     64-token window, 96 steps at a card tensor position) against a
     full cache past the wrap (2e-3); both reduced configs on the card
     against the CPU (1e-4); and no kernel counter moved;
  6. the Mamba1 training path: falcon-mamba-7b at full width, cut to 16
     layers, bf16, AdamW with float32 moments, remat, 2 microbatches of
     2 x 4096 tokens: one warm-up step and 3 timed steps on the same
     batch (``train/trainer.build_train_step``) at lr 3e-4, finite losses
     that fall at every step, no grad norm above 3x the first, and per
     step the scan kernel twice a layer a microbatch (the
     forward and remat's recompute) and its backward kernel once;
  6b. ``launch/train.py``'s monitors fed phase 6's steps: the loss CI
     states to a ``ThresholdMonitor`` (3 ln V, range [0, 4 ln V]), whose
     interval must hold the steps' mean loss, the step times to a
     ``StragglerMonitor``; their decisions printed;
  6c. the dense, MoE, hybrid and enc-dec families' training path (plain
     PyTorch, no kernel), bf16 at full width: qwen2.5-3b (18 of 36, 2 x
     4096 tokens, AdamW), dbrx-132b (2 of 40 layers, 4 x 4096 in its 4
     microbatches, Adafactor over its stacked experts), zamba2-7b (7 of
     81 layers, a group and a tail layer, 2 x 4096 in 2 microbatches)
     and seamless-m4t-large-v2 (24 + 24 layers, train_4k's frames and
     tokens for 2 sequences); each a warm-up and 2 timed steps on one
     batch with phase 6's checks (finite, the loss falls every step, no
     grad norm above 3x the first), no kernel counter moved; seamless's
     loss and gradient again under the ``"dots"`` remat policy, its loss
     and grad norm bit for bit the ``"nothing"`` policy's;
  6d. the Mamba1 ``xla`` path's chunked associative scan:
     falcon-mamba-7b at full width, 4 layers, float32 weights, 1 x 4096
     tokens, one loss and gradient with the scan in float32 (against the
     ``pallas`` path's kernels: loss 1e-5, each gradient 1e-4) and in
     bfloat16 (against float32: 1.5e-2), times and peaks of the three;
  6e. ``launch/train.py``'s driver (``repro_torch.launch.train.main``)
     for qwen3-0.6b at full width and 2 of its 28 layers: 4 steps of 8 x
     1024 tokens, a checkpoint every 2, the eval after step 4 (its
     certificate must cover the eval set's full mean); the step-4
     checkpoint deleted and the run resumed from step 2 to step 4: the
     same losses and state bit for bit;
     ``compress_roundtrip`` of one step's gradients on the card bit for
     bit on the CPU; the SIGTERM handler put back; no kernel counter
     moved;
  6f. the multi-card layout (``distributed/sharding.py``, the sharded
     train step, the elastic checkpoint, the dry runs): qwen3-0.6b at
     full width, 2 of 28 layers, float32, AdamW, 8 x 512 tokens; one
     single-card step here, written to a file; four spawned gloo ranks
     on the card on a (2, 2) ("data", "model") mesh: one
     ``build_sharded_train_step`` step from the same state and batch
     held to it (loss 1e-4; each rank's shards of the parameters within
     rtol 2e-4, atol 2e-5, of the moments within 2e-4 of their leaf's
     largest), every replica the same bits, each rank's bytes of
     parameters and moments equal to ``launch.dryrun``'s accounting; the
     state saved with its specs, restored onto (4, 1), one more step on
     each layout (losses 1e-4). Beside the ranks a spawned process in a
     ``fake`` group of 256, then 512 ranks runs ``dryrun_aqp`` on the
     card (``block_agg`` launched) and ``LAYOUT_DRYRUN_CELLS`` at full
     size on both production meshes (every cell ``ok``, every id and
     shape, every record per device: the serving cells through the
     sharded prefill / decode), each record with its ``step_cost``, after
     ``launch/step_cost.py``'s predictions on meta, as rank 0 of fake
     groups of 4 and 1: the ranks' sharded step (rank 0's collective
     calls and bytes must equal its prediction exactly) and NCCL's
     below; ``dryrun_aqp``'s ``block_agg`` report must carry phase 2's
     bound bytes for its shape. A fresh single-card step on the card
     under ``step_cost`` with ``FlopCounterMode`` inside: the two FLOP
     counts equal. Then NCCL in a group of one rank: the sharded step on
     a (1, 1) mesh against the single-card step (bit for bit or not,
     printed), its ``max_memory_allocated`` (peak reset just before it,
     less the process's other tensors) within 10 % of the predicted
     ``peak_bytes``;
  6g. the sharded serving steps (``models/zoo.build_sharded_serve``: the
     prefill and decode, tensor parallel over "model", on one held copy
     of each rank's "model" cut of the weights), float32 at full width:
     qwen2.5-3b at 4 of 36 layers on (2, 2) (its 2 kv heads over
     "model": the heads rule) and (1, 4) (the sequence rule),
     falcon-mamba-7b at 4 of 64 on (2, 2) (Mamba1 channels over "model";
     the selective-scan kernel on d_inner / 2 of them in each rank's
     prefill), zamba2-7b at 7 of 81 on (1, 4) (Mamba2 heads, the shared
     attention's heads) and dbrx-132b at 2 of 40 on (1, 4) (4 of its 16
     experts a rank), each a batch of 8 x 2048 prompt positions and 32
     teacher-forced decode steps at a card-tensor position. The
     single-card prefill + decode here, written to a file; four spawned
     gloo ranks on the card run every config (drawing the weights in
     turns, prefilling together): each rank's held parameter bytes equal
     to its "model" cut by ``param_specs`` and loaded by all-gathers over
     "data" (and an all-to-all over "model" a leaf cut over both) alone,
     its logits within 1e-4 of the largest of the single card's, its
     cache shards of their local shapes and within 1e-4 of the single
     card's slices, replicas the same bits, rank 0's collectives by kind
     of its prefill and a decode step equal to
     ``dryrun.sharded_serve_cost``'s meta prediction (made here in a
     fake group of 4 while the ranks run; the scan kernel's outputs
     stand for it on meta), rank 0's peak of each
     (``max_memory_allocated`` less its other tensors) within 10 % of
     the prediction's; then NCCL in a group of one rank: the sharded
     steps bit for bit the single card's. Prints the load s, the prefill
     s and the decode ms a step, sharded and single-card, and the
     collective calls and bytes of each;
  7. a ``kernels`` line: each ported kernel with its main-path launches,
     worst difference from its plain version and times (``grouped_hist``
     at the main path's G 14, with G 2800 beside it; the multi-query
     probe at the serving host loop's window, Q 8, W 88).

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and that line is not printed. Every
wait on a spawned process and every process group's timeout ends by
SMOKE_DEADLINE_S after the start; a phase stopped by it records
``{"check": "smoke deadline", "phase", "elapsed_s"}`` and fails. Without
CUDA, or without the rest of the repository beside it, the script exits
with code 2 before any result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Optional
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
REPS = 15                # timed calls per kernel measurement (cut from
#                          30 for the smoke's time: a median of 15)
PLAIN_SCAN_REPS = 3      # the plain scan is ~2k small launches a call
# The Mamba1 serving path (phase 5)
SERVE_BATCH = 8          # requests
PROMPT_LEN = 2048        # prompt tokens each
DECODE_STEPS = 32        # greedy decode steps after the prefill
# 5c / 5d's (dense, vlm, MoE, hybrid, enc-dec): cut from 32 for the
# smoke's time; each model still serves twice (the same tokens twice)
FAMILY_DECODE_STEPS = 16
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


def kernel_counters() -> dict:
    """Every kernel wrapper by name; each counts its launches in
    ``.launches``."""
    from repro_torch.kernels import bitmap_active as kbit
    from repro_torch.kernels import block_agg as kblock
    from repro_torch.kernels import fused_fold as kfused
    from repro_torch.kernels import grouped_hist as khist
    from repro_torch.kernels import selective_scan as kscan
    return {"block_agg": kblock.block_agg,
            "bitmap_active": kbit.active_blocks,
            "bitmap_active_multi": kbit.active_blocks_multi,
            "round_select": kbit.round_select,
            "fused_fold": kfused.fused_fold,
            "grouped_hist": khist.grouped_hist,
            "selective_scan": kscan.selective_scan,
            "selective_scan_bwd": kscan.selective_scan_bwd}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: the whole run's own limit, counted from ``main``'s start: every wait on
#: a spawned process and every process group's timeout ends by then, so
#: that a stalled phase fails inside the caller's time limit and names
#: itself instead of being cut with the rest of the run
SMOKE_DEADLINE_S = 1100
_CLOCK = {"start": None, "deadline": float("inf")}


def set_deadline(at: float, start: Optional[float] = None) -> None:
    """Put the run's deadline at ``time.perf_counter()`` value ``at``
    (``main``: its start plus SMOKE_DEADLINE_S)."""
    _CLOCK["start"] = time.perf_counter() if start is None else start
    _CLOCK["deadline"] = at


def time_left() -> float:
    """Seconds until the run's deadline (``inf`` when none is set)."""
    return _CLOCK["deadline"] - time.perf_counter()


def capped(limit_s: float) -> float:
    """``limit_s``, cut to the time left before the deadline (at least
    one second, so that a wait or a group timeout is never zero)."""
    return max(min(limit_s, time_left()), 1.0)


def deadline_fail(phase: str) -> dict:
    """The failure a phase records when the run's deadline stopped it."""
    start = _CLOCK["start"]
    return dict(check="smoke deadline", phase=phase,
                elapsed_s=None if start is None
                else time.perf_counter() - start)


def join_all(procs, timeout_s: float, phase: str, fails: list) -> list:
    """Join ``procs`` within ``capped(timeout_s)`` in all; a process still
    running then is stopped (:func:`_stop`), and where the deadline was
    the cause, :func:`deadline_fail` joins ``fails``. Returns the exit
    codes (a stopped process's is its signal's, negative)."""
    until = time.perf_counter() + capped(timeout_s)
    stopped = False
    for p in procs:
        p.join(max(until - time.perf_counter(), 0.1))
        if p.is_alive():
            stopped = True
            _stop(p)
    if stopped and time_left() <= 0:
        fails.append(deadline_fail(phase))
    return [p.exitcode for p in procs]


def bound(bytes_moved: float, ops: float):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the fp32 rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_bytes(rows: int, budget: int, G: int) -> int:
    """Bytes a fold of ``rows`` rows in ``budget`` blocks must move: each
    row's value, group id and mask (12 B) and each lane's block id and
    flag read once, the (5, G) float32 result written once."""
    return rows * 12 + budget * 8 + 5 * G * 4


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
    bound_ms, bound_by = bound(fold_bytes(rows, budget, G), rows * 9)
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
    bound_ms, bound_by = bound(fold_bytes(rows, budget, G)
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


PROFILER_TRACES = 3      # traces of one call before an empty one stands


def cuda_activities(torch, fn):
    """Names of the device activities (kernels, memsets, copies) that one
    call of ``fn`` makes, from a ``torch.profiler`` trace, and how many
    traces that took. ``fn`` always launches (its caller checks the
    result), so a trace with no device activity at all is a window the
    profiler missed (seen on the H100 beside bitwise results): the call
    is traced again, up to PROFILER_TRACES times; an empty list after
    that stands and fails the caller."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for traces in range(1, PROFILER_TRACES + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names, traces


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
    names, traces = cuda_activities(torch,
                                    lambda: khist.grouped_hist(*args))
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
                profiler_traces=traces,
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


# The truths' group sums run on the card: at 100M rows numpy's int64 codes
# and float64 bincounts took ~3 s a query (~55 s for phase 3's sixteen).
# The card adds the float64 values in another order (atomics), ~1e-13
# relative, far under every coverage tolerance (1e-4). Host columns are
# copied to the card once and kept until ``release_card_columns``.
_CARD_COLUMNS = {}


def _card_column(np, arr):
    import torch
    hit = _CARD_COLUMNS.get(id(arr))
    if hit is None or hit[0] is not arr:
        hit = (arr, torch.from_numpy(np.ascontiguousarray(arr)).to("cuda"))
        _CARD_COLUMNS[id(arr)] = hit
    return hit[1]


def release_card_columns() -> None:
    _CARD_COLUMNS.clear()


def group_sums(np, cols, value: str, group_cols, mask=None):
    """``(count, float64 sum)`` of ``cols[value]`` per group code (the
    group columns' mixed radix) over the rows ``mask`` keeps, as host
    arrays, computed on the card."""
    import torch
    codes, G = None, 1
    for c in group_cols:
        col = _card_column(np, cols[c]).long()
        card = int(col.max()) + 1
        codes, G = (col if codes is None else codes * card + col), G * card
    v = _card_column(np, cols[value]).double()
    if codes is None:
        codes = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    if mask is not None:
        keep = torch.from_numpy(mask).to(v.device)
        codes, v = codes[keep], v[keep]
    cnt = torch.bincount(codes, minlength=G).double()
    tot = torch.bincount(codes, weights=v, minlength=G)
    return cnt.cpu().numpy(), tot.cpu().numpy()


def truth_of(np, cols, q):
    """Per-group exact AVG in float64 from the unshuffled columns, and
    which groups exist."""
    mask = np.ones(len(cols["dep_delay"]), bool)
    for f in q.filters:
        mask &= f.evaluate(cols)
    cnt, tot = group_sums(np, cols, "dep_delay", q.group_cols, mask)
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


def check_tickets(np, frame, server, burst, a, b, cols):
    """Phase 3c's hold on the burst's done tickets (scheduler runs ``a``
    and ``b`` of ``burst``): one alone in its slot, or in a non-probe
    slot, against its solo run at the slot's anchor; one that shares a
    probe slot (a grouped signature under skipping sampling: the slot
    selects with the union of its queries' activity flags, the
    reference's contract) against the truth, its bits in ``b`` and those
    of a served batch of the slot's queries from its anchor. Returns
    ``(not bitwise to solo, shared-slot rows, anchors)``."""
    nb = frame.scramble.n_blocks
    mates, unions, truths = {}, {}, {}
    for i, tk in enumerate(a.tickets):
        mates.setdefault(id(tk._qc.slot), []).append(i)
    not_solo, shared, anchors = [], [], set()
    for i, (tk, q) in enumerate(zip(a.tickets, burst)):
        if tk.status != "done":
            continue
        slot = tk._qc.slot              # the slot's fold state
        anchors.add(int(slot.anchor))
        start = (a.start_block + slot.anchor) % nb
        group = mates[id(slot)]
        if slot.group_bm is None or len(group) == 1:
            want = frame.run(q, sampling="active_peek", seed=1,
                             start_block=start)
            if not same_result(np, tk.result, want):
                not_solo.append(i)
            continue
        if id(slot) not in unions:
            unions[id(slot)] = server.run_batch(
                [burst[j] for j in group], sampling="active_peek", seed=1,
                start_block=start)
        miss = uncovered(np, tk.result,
                         *scheduler_truth(np, cols, q, truths))
        shared.append(dict(
            ticket=i, slot_tickets=group, anchor=int(slot.anchor),
            uncovered=len(miss),
            rerun_bitwise=same_result(np, tk.result, b.tickets[i].result),
            union_bitwise=same_result(np, tk.result,
                                      unions[id(slot)][group.index(i)])))
    return not_solo, shared, anchors


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

    # 3. the scheduler on a SimClock: a burst replayed to the same event
    # log; a ticket alone in its slot, or in a non-probe slot, bitwise
    # its solo run at the slot's anchor; tickets that share a probe slot
    # (a grouped signature: the slot selects with the union of their
    # activity flags) held to coverage, to the rerun's bits and to the
    # bits of a served batch of the slot's queries from its anchor
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
    t0 = time.perf_counter()
    with solos:
        not_solo, shared, anchors = check_tickets(np, frame, server, burst,
                                                  a, b, cols)
    shared_bad = [r for r in shared if r["uncovered"] or not (
        r["rerun_bitwise"] and r["union_bitwise"])]
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
        not_bitwise_to_solo=not_solo,
        shared_probe_slot=shared, same_event_log=same_log,
        resumed_equals_uninterrupted=resumed_equal,
        late_join_anchor=late_anchor, late_joiners_bitwise_to_solo=late_solo,
        **stats)
    # the burst must have run a pass of several slots through several
    # membership epochs (loops)
    if (not_done or not_solo or shared_bad or not same_log
            or not resumed_equal or not late_solo or late_anchor == 0
            or stats["most_slots"] < 2 or stats["loops_built"] < 2):
        failures.append(dict(part="scheduler", not_done=not_done,
                             not_solo=not_solo, shared_probe_slot=shared_bad,
                             same_log=same_log,
                             resumed=resumed_equal, late_solo=late_solo,
                             late_anchor=late_anchor,
                             most_slots=stats["most_slots"],
                             loops_built=stats["loops_built"]))
    return rec, failures, passes.counts, solos.counts, (burst, a)


# -- phase 3d ----------------------------------------------------------------

# the replay run's fault trace: fault_schedule(seed, W, rate) over all
# six kinds, W the fault-free run's steps and the rate CHAOS_EVENTS / W
# (at most 0.9), for the first seed from CHAOS_SEED whose events cover
# every kind with one NaN, the last event: every event before it comes
# while the pass still runs (a retry adds an attempt, never a round)
CHAOS_SEED, CHAOS_EVENTS, CHAOS_RETRIES = 0, 10, 3
# the transient run's faults: (attempt, kind, arg)
CHAOS_TRANSIENT = ((1, "dispatch", 0.0), (3, "transfer", 0.0),
                   (5, "shard", 0.0), (6, "skew", 0.5))
CHAOS_EXHAUST_FROM = 2   # the exhausted ladder's clean attempts


def scheduler_truth(np, cols, q, memo):
    """Per-group truth of a burst query's own aggregate (AVG, SUM or
    COUNT of its column by its group-by; the burst has no filters) and
    which groups exist."""
    key = (q.agg, q.scan_signature())
    if key not in memo:
        if q.filters:
            raise AssertionError(f"a burst query has filters: {q}")
        cnt, tot = group_sums(np, cols, q.column, q.group_cols)
        memo[key] = ({"avg": tot / np.maximum(cnt, 1), "sum": tot,
                      "count": cnt}[q.agg], cnt > 0)
    return memo[key]


class OOMUntilHostLoop:
    """A fault hook: an injected OOM on every step attempt until the
    scheduler's log shows the host-loop rung, then none."""

    def __init__(self, oom):
        self.oom, self.fired, self.seen = oom, 0, 0

    def before_step(self, sched, pas, t):
        for ev in sched.log[self.seen:]:
            if ev[2] == "degrade" and ev[3] == ("host-loop",):
                self.oom = None
        self.seen = len(sched.log)
        if self.oom is not None:
            self.fired += 1
            raise self.oom(f"attempt {self.fired}")

    def after_step(self, sched, pas, t):
        return None


def chaos_schedule(faults, steps: int):
    """The replay run's trace (see CHAOS_SEED): ``(seed, rate,
    events)``."""
    rate = min(0.9, CHAOS_EVENTS / steps)
    for seed in range(CHAOS_SEED, CHAOS_SEED + 100_000):
        ev = faults.fault_schedule(seed, steps, rate=rate)
        kinds = [e.kind for e in ev]
        if (set(kinds) == set(faults.KINDS) and kinds.count("nan") == 1
                and kinds[-1] == "nan"):
            return seed, rate, ev
    raise AssertionError(f"no seed gives every fault kind in {steps} "
                         f"steps")


def chaos_phase(torch, np, frame, burst, clean, cols, counters):
    """Phase 3d: seeded faults on phase 3c's scheduler burst (the same
    frame, device pass loop, burst and scheduler settings; ``clean`` is
    phase 3c's fault-free run, the oracle). Returns ``(record,
    failures, launches)``, the launches counted around the scheduler
    runs alone."""
    from repro_torch.serve import FrameServer, QueryScheduler, SimClock
    from repro_torch.testing import faults
    tally = LaunchTally(counters)
    memo, failures, runs = {}, [], {}

    def run(name, hook, **over):
        kw = dict(seed=1, round_cost_s=1e-3, max_slots=SCHED_SLOTS,
                  chunk_rounds=SCHED_CHUNK, checkpoint_every=1,
                  fault_hook=hook)
        kw.update(over)
        sched = QueryScheduler(FrameServer(frame), SimClock(), **kw)
        for q in burst:
            sched.submit(q, at=0.0)
        before = dict(tally.counts)
        t0 = time.perf_counter()
        with tally:
            sched.run_until_idle()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = [e[2] for e in sched.log]
        statuses = [tk.status + ("-partial" if tk.partial else "")
                    for tk in sched.tickets]
        runs[name] = dict(
            wall_s=wall, faults=[list(e[3]) for e in sched.log
                                 if e[2] == "fault"],
            retries=log.count("retry"),
            degradations=[e[3][0] for e in sched.log if e[2] == "degrade"],
            statuses={k: statuses.count(k) for k in sorted(set(statuses))},
            skews=[e[3][0] for e in sched.log if e[2] == "skew"],
            quarantined=log.count("quarantine"), events=len(log),
            launches={k: tally.counts[k] - before[k] for k in counters
                      if tally.counts[k] - before[k]})
        return sched

    def bitwise_to_clean(sched, name):
        bad = [i for i, (tc, tf) in enumerate(zip(clean.tickets,
                                                  sched.tickets))
               if tf.status == "done"
               and (tf.partial or not same_result(np, tf.result, tc.result))]
        runs[name]["not_bitwise_to_fault_free"] = bad
        return bad

    def not_covering(sched, name):
        bad = [i for i, tk in enumerate(sched.tickets)
               if tk.status == "done" and len(uncovered(
                   np, tk.result, *scheduler_truth(np, cols, tk.query,
                                                   memo)))]
        runs[name]["not_covering"] = bad
        return bad

    def check(name, ok, **detail):
        runs[name]["ok"] = bool(ok)
        if not ok:
            failures.append(dict(run=name, **runs[name], **detail))

    Ev = faults.FaultEvent
    # 1. transient faults, retried from the checkpoint
    s = run("transient", faults.FaultInjector(
        [Ev(*e) for e in CHAOS_TRANSIENT]), max_retries=10)
    kinds = [f[0] for f in runs["transient"]["faults"]]
    check("transient", kinds == ["dispatch", "transfer", "shard"]
          and len(runs["transient"]["skews"]) == 1
          and all(tk.status == "done" for tk in s.tickets)
          and not bitwise_to_clean(s, "transient"))
    # 2. a poisoned slot, quarantined; the survivors bit for bit
    s = run("poison", faults.FaultInjector([Ev(1, "nan", 0.0)]))
    st = [tk.status for tk in s.tickets]
    check("poison", st.count("quarantined") >= 1
          and st.count("done") + st.count("quarantined") == len(st)
          and st.count("done") >= 1 and not bitwise_to_clean(s, "poison"))
    # 3. a real torch.OutOfMemoryError: the card asked for twice its memory
    hook = faults.DeviceOOMHook([1, 2], device=frame.device)
    s = run("real_oom", hook, max_retries=1)
    check("real_oom", runs["real_oom"]["faults"] == [["oom", 1], ["oom", 2]]
          and runs["real_oom"]["degradations"] == [f"chunk_rounds="
                                                   f"{SCHED_CHUNK // 2}"]
          and all(tk.status == "done" and not tk.partial
                  for tk in s.tickets)
          and not not_covering(s, "real_oom"), fired=hook.fired)
    # 4. down to the host loop (injected OOMs until its rung), then the
    # ladder exhausted (dispatch faults from attempt CHAOS_EXHAUST_FROM)
    multi = counters["bitmap_active_multi"].launches
    s = run("host_loop_rung", OOMUntilHostLoop(faults.InjectedOOM),
            max_retries=1)
    multi = counters["bitmap_active_multi"].launches - multi
    runs["host_loop_rung"]["multi_probe_launches"] = multi
    rungs = [f"chunk_rounds={c}" for c in (2, 1)] + ["host-loop"]
    check("host_loop_rung", runs["host_loop_rung"]["degradations"] == rungs
          and multi > 0 and all(tk.status == "done" and not tk.partial
                                for tk in s.tickets)
          and not not_covering(s, "host_loop_rung"))
    s = run("ladder_exhausted", faults.FaultInjector(
        [Ev(CHAOS_EXHAUST_FROM + i, "dispatch", 0.0) for i in range(64)]),
        max_retries=2)
    check("ladder_exhausted",
          "ladder-exhausted" in [e[2] for e in s.log]
          and all(tk.status == "done" for tk in s.tickets)
          and any(tk.partial for tk in s.tickets)
          and not not_covering(s, "ladder_exhausted"))
    # 5. a seeded chaos trace over all six kinds, run twice
    steps = sum(1 for e in clean.log if e[2] == "checkpoint")
    seed, rate, events = chaos_schedule(faults, steps)
    injectors = [faults.FaultInjector(events) for _ in range(2)]
    a = run("replay", injectors[0], max_retries=CHAOS_RETRIES)
    b = run("replay_again", injectors[1], max_retries=CHAOS_RETRIES)
    fired = sorted({e.kind for e in injectors[0].fired})
    done = [tk for tk in a.tickets if tk.status == "done"]
    finishes = sum(1 for e in a.log if e[2] in ("finish", "finish-partial"))
    same_log = [tuple(e) for e in a.log] == [tuple(e) for e in b.log]
    runs["replay"].update(
        seed=seed, rate=rate, schedule_steps=steps,
        scheduled={k: sum(e.kind == k for e in events) for k in faults.KINDS},
        fired={k: sum(e.kind == k for e in injectors[0].fired)
               for k in faults.KINDS},
        same_event_log=same_log, finish_events=finishes, done=len(done))
    check("replay", fired == sorted(faults.KINDS) and same_log
          and finishes == len(done) and len(done) >= 1
          and not not_covering(a, "replay"))
    rec = dict(burst=len(burst), max_slots=SCHED_SLOTS,
               chunk_rounds=SCHED_CHUNK, fault_free_steps=steps,
               runs=runs, launches=tally.counts)
    return rec, failures, tally.counts


# -- phase 3e ----------------------------------------------------------------

# The sharded scan (EngineConfig(shard_rows=True)) on the card: SHARD_RANKS
# processes (spawned), each a rank of a gloo group through a FileStore,
# all on cuda:0, at merge_every 1 and 4: the Bernstein and the
# Anderson/DKW G 2,800 GROUP BY and phase 3c's shared_sig batch, on the
# first blocks of phase 3b's scramble that hold SHARD_ROWS rows (written
# once by the main process, memory-mapped by the ranks). The cut: at
# 100M rows the phase took 230 s alone (scripts/smoke_sharded_phase.py),
# over its ~150 s budget, and 161 s at 40M inside the smoke, which then
# took 942 s of its 1200; under gloo every K = 1 round waits for its two
# staged all-reduces, so a round runs at ~19-80 rounds/s. 20M rows took
# 69 s inside the whole smoke; cut to 10M for the training phases 6c-6e,
# then to 5M for the multi-card layout (phase 6f).
SHARD_ROWS = 5_000_000
SHARD_RANKS = 2
SHARD_MERGE_EVERY = (1, 4)
SHARD_RUNS = ("groupby_origin_airline", "groupby_origin_airline-adkw")
SHARD_GROUP_TIMEOUT_S = 300     # a collective no rank joins fails then
SHARD_JOIN_TIMEOUT_S = 600      # a rank still running then is killed
# the reference's tolerances (tests/helpers/sharded_scenarios.py): the
# merge reorders the float32 row sum of general data (1e-3), the cadence
# pools deltas in float64 (1e-5), each relative to max(|x|, 1): a mean
# near zero is folded about the catalog centre (870 for dep_delay), so
# its float32 error is absolute, ~1e-4 (the smoke's coverage convention)
SHARD_CI_RTOL, SHARD_CADENCE_TOL = 1e-3, 1e-5
SHARD_EXACT_FIELDS = ("group_codes", "count_seen", "nonempty", "exact",
                      "tainted", "rows_covered", "blocks_fetched",
                      "blocks_skipped_active", "blocks_skipped_static",
                      "bitmap_probes", "rounds", "stopped_early")
# the integer-valued frame: every rank's float32 partial sums exact
SHARD_INT_ROWS, SHARD_INT_GROUPS = 4_000_000, 8


def _save_result(np, out, prefix, res):
    for f in RESULT_FIELDS:
        out[f"{prefix}/{f}"] = np.asarray(getattr(res, f))


def _load_result(data, prefix):
    import types
    return types.SimpleNamespace(**{f: data[f"{prefix}/{f}"][()]
                                    for f in RESULT_FIELDS})


def _shard_ci_gap(np, a, b):
    """Largest gap of the finite CI endpoints and estimates, relative to
    ``max(|b|, 1)``, and whether the finite patterns agree."""
    worst, same_fin = 0.0, True
    for f in ("estimate", "lo", "hi"):
        x, y = getattr(a, f), getattr(b, f)
        same_fin &= bool(np.array_equal(np.isfinite(x), np.isfinite(y)))
        fin = np.isfinite(x) & np.isfinite(y)
        if fin.any():
            d = np.abs(x[fin] - y[fin])
            worst = max(worst, float(np.max(d / np.maximum(
                np.abs(y[fin]), 1.0))))
    return worst, same_fin


def _exact_fields_equal(np, a, b):
    return [f for f in SHARD_EXACT_FIELDS
            if not np.array_equal(getattr(a, f), getattr(b, f))]


def _cadence_faults(np, got, k1):
    """The collective cadence's contract against the per-round merge on
    the same ranks: never fewer rounds (termination waits for a merge);
    where the rounds and the blocks fetched are equal, the same rows
    folded (``count_seen``, ``rows_covered``), which a lost pending delta
    or a skipped flush would break. The intervals have no order here: a
    group that goes inactive freezes its interval, and under the cadence
    it does so at a later merge, on more rows (the integer frame, whose
    exhaustion keeps every group active, holds K 4's intervals to K 1's
    within ``SHARD_CADENCE_TOL``). Returns what broke."""
    faults = []
    if got.rounds < k1.rounds:
        faults.append("fewer rounds")
    elif (got.rounds == k1.rounds
          and got.blocks_fetched == k1.blocks_fetched):
        faults += [f for f in ("count_seen", "rows_covered")
                   if not np.array_equal(getattr(got, f), getattr(k1, f))]
    return faults


def _integer_scramble(np, T, n, groups):
    g = (np.arange(n) % groups).astype(np.int32)
    v = (((np.arange(n) * 7) // 5 + g) % 5).astype(np.float32)
    return T.build_scramble({"g": g, "v": v}, catalog={"v": (0.0, 4.0)},
                            seed=1)


def shard_rank_main(a: dict) -> None:
    """Phase 3e's rank ``a["rank"]`` of ``a["world"]`` (spawned): joins the
    group, confirms that gloo all-reduces the card's tensors, runs the
    sharded scan on the scramble in ``a["data"]`` at every
    ``SHARD_MERGE_EVERY`` and the integer-valued frame's checks, and
    writes its record (JSON) and results (npz) to ``a["out"]``."""
    import datetime
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path[:0] = [p for p in a["sys_path"] if p not in sys.path]
    import repro_torch.aqp as T
    from repro_torch.core import optstop as opt
    from repro_torch.aqp import flights_queries as fq
    from repro_torch.kernels import (bitmap_active as kbit, block_agg as kblock,
                                     fused_fold as kfused_fold,
                                     fused_scan as kscan_loop,
                                     grouped_hist as khist)
    from repro_torch.serve import FrameServer
    rank, world = a["rank"], a["world"]
    dev = torch.device("cuda", a["device_index"])
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    dist.init_process_group(
        a["backend"], store=dist.FileStore(a["store"], world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=a["group_timeout_s"]))
    rec = dict(rank=rank, world=world, backend=a["backend"],
               device=str(dev), init_s=time.perf_counter() - t_start)
    # gloo takes the card's tensors by staging them through host memory
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    y = torch.full((4,), -float(rank + 1), device=dev)
    dist.all_reduce(y, op=dist.ReduceOp.MIN)
    want = float(sum(range(1, world + 1)))
    rec["cuda_all_reduce"] = dict(
        sum_ok=bool((x.cpu() == want).all()),
        min_ok=bool((y.cpu() == -float(world)).all()),
        device=str(x.device))
    t0 = time.perf_counter()
    meta = json.loads(Path(a["data"], "meta.json").read_text())
    cols = {c: np.load(Path(a["data"], f"{c}.npy"), mmap_mode="r")
            for c in meta["columns"]}
    sc = T.scramble_from_arrays(
        cols, np.load(Path(a["data"], "valid.npy"), mmap_mode="r"),
        meta["n_rows"], meta["block_rows"],
        {k: tuple(v) for k, v in meta["catalog"].items()},
        meta["categorical"], meta["seed"])
    rec["load_s"] = time.perf_counter() - t0
    runs = {name: q for name, q, _ in main_path_queries(T, fq, opt)
            + anderson_queries(T, fq, opt) if name in SHARD_RUNS}
    counters = {"block_agg": kblock.block_agg,
                "bitmap_active": kbit.active_blocks,
                "bitmap_active_multi": kbit.active_blocks_multi,
                "round_select": kbit.round_select,
                "fused_fold": kfused_fold.fused_fold,
                "grouped_hist": khist.grouped_hist}
    coll = kscan_loop.COLLECTIVES
    out, records = {}, []
    only = a.get("only")
    for K in a["merge_every"]:
        frame = T.FastFrame(sc, T.EngineConfig(shard_rows=True,
                                               merge_every=K), device=dev)
        jobs = [(name, "run") for name in SHARD_RUNS
                if only is None or name in only]
        if only is None:
            jobs.append(("shared_sig", "batch"))
        for name, how in jobs:
            for c in counters.values():
                c.launches = 0
            c0 = dict(coll)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if how == "run":
                res = [frame.run(runs[name], sampling="active_peek", seed=0)]
            else:
                res = FrameServer(frame).run_batch(
                    shared_sig_workload(T, opt), sampling="active_peek",
                    seed=1, start_block=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rounds = max(r.rounds for r in res)
            calls = coll["calls"] - c0["calls"]
            loop = frame.device_loops[list(frame.device_loops.keys())[-1]]
            records.append(dict(
                run=name, merge_every=K, wall_s=wall, rounds=rounds,
                rounds_per_s=rounds / wall if wall > 0 else None,
                all_reduces=calls,
                all_reduces_per_round=calls / rounds if rounds else None,
                all_reduce_mb=(coll["bytes"] - c0["bytes"]) / 1e6,
                gloo_s=coll["seconds"] - c0["seconds"],
                captured=bool(getattr(loop, "graph", None) is not None),
                launches={k: c.launches for k, c in counters.items()}))
            for i, r in enumerate(res):
                _save_result(np, out, f"{name}/K{K}/{i}", r)
        del frame
        torch.cuda.empty_cache()
    if only is None:
        # the integer-valued frame: sharded (K 1) bit for bit the
        # single-device loop, early stop and exhaustion; at K 4 the
        # exhaustion's exact fields equal, CIs within SHARD_CADENCE_TOL
        isc = _integer_scramble(np, T, SHARD_INT_ROWS, SHARD_INT_GROUPS)
        qs = {"exhaustion": T.AggQuery(agg="avg", column="v", group_by="g",
                                       stop=opt.AbsoluteWidth(eps=1e-9),
                                       delta=1e-9),
              "early_stop": T.AggQuery(agg="avg", column="v", group_by="g",
                                       stop=opt.ThresholdSide(threshold=2.0),
                                       delta=1e-6)}
        ints = []
        for qname, q in qs.items():
            oracle = T.FastFrame(isc, T.EngineConfig(shard_rows=False),
                                 device=dev).run(q, seed=1, start_block=0)
            for K in a["merge_every"]:
                if K > 1 and qname != "exhaustion":
                    continue
                r = T.FastFrame(isc, T.EngineConfig(
                    shard_rows=True, merge_every=K), device=dev).run(
                    q, seed=1, start_block=0)
                gap, same_fin = _shard_ci_gap(np, r, oracle)
                ints.append(dict(
                    query=qname, merge_every=K, rounds=r.rounds,
                    exact_fields_differ=_exact_fields_equal(np, r, oracle),
                    ci_bitwise=all(np.array_equal(getattr(r, f),
                                                  getattr(oracle, f))
                                   for f in ("estimate", "lo", "hi")),
                    ci_max_rel=gap, same_finite=same_fin))
        rec["integer_frame"] = dict(rows=SHARD_INT_ROWS,
                                    groups=SHARD_INT_GROUPS, runs=ints)
    rec["runs"] = records
    rec["rank_s"] = time.perf_counter() - t_start
    np.savez(Path(a["out"], f"rank{rank}.npz"), **out)
    Path(a["out"], f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def nccl_world1_main(a: dict) -> None:
    """Phase 3e's NCCL check (spawned): a group of one rank under NCCL.
    ``make_sharded_fold`` captured in a CUDA graph and replayed, with and
    without the histogram, bit for bit ``ops.grouped_moments`` /
    ``ops.grouped_hist`` on exact data. (The sharded loop needs a group
    of >= 2 ranks, and NCCL one card a rank.)"""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path[:0] = [p for p in a["sys_path"] if p not in sys.path]
    from repro_torch.aqp import distributed as adist
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", store=dist.FileStore(a["store"], 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=a["group_timeout_s"]))
    rec = dict(world=1, backend=dist.get_backend())
    rng = np.random.default_rng(7)
    G, nb, br, center = 2800, 64, 1024, 2.0
    v = torch.from_numpy(rng.integers(0, 5, (nb, br)).astype(np.float32))
    g = torch.from_numpy(rng.integers(0, G, (nb, br)).astype(np.int32))
    m = torch.from_numpy((rng.random((nb, br)) < 0.8).astype(np.float32))
    v, g, m = (t.to(dev) for t in (v, g, m))
    ref = ops.grouped_moments(v, g, m, G, center)
    ref_h = ops.grouped_hist(v, g, m, G, 0.0, 5.0, nbins=HIST_BINS).hist
    checks = {}
    for with_hist in (False, True):
        fold = adist.make_sharded_fold(None, G, center, with_hist=with_hist,
                                       hist_bins=HIST_BINS,
                                       hist_range=(0.0, 5.0))
        eager = fold(v, g, m)                  # the communicator, eagerly
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fold(v, g, m)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = fold(v, g, m)
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        st, hist = (got if with_hist else (got, None))
        est = eager[0] if with_hist else eager
        ok = all(torch.equal(getattr(st, f).view(torch.int32),
                             getattr(ref, f).view(torch.int32))
                 and torch.equal(getattr(est, f).view(torch.int32),
                                 getattr(ref, f).view(torch.int32))
                 for f in ("count", "mean", "m2", "vmin", "vmax"))
        if with_hist:
            ok = ok and torch.equal(hist, ref_h)
        checks["with_hist" if with_hist else "moments"] = ok
    rec["fold_captured_bitwise"] = checks
    Path(a["out"], "nccl1.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def _spawn_ranks(ctx, target, argss, timeout_s, phase: str, fails: list):
    """Start one process per argument, join them within the time limit,
    cut to the run's deadline (:func:`join_all`); a process still
    running then is stopped. Returns the exit codes (a stopped
    process's is negative); a stop at the deadline joins ``fails``,
    under ``phase``."""
    procs = [ctx.Process(target=target, args=(a,)) for a in argss]
    for p in procs:
        p.start()
    return join_all(procs, timeout_s, phase, fails)


def _cut_scramble(np, T, sc, rows: int):
    """The first blocks of ``sc`` that hold at least ``rows`` valid rows,
    as a scramble of their own (the blocks are a uniform shuffle, so a
    prefix of them is a sample of the table), and its valid rows as flat
    columns (the truth's input)."""
    nb = int(np.searchsorted(np.cumsum(sc.valid.sum(axis=1)), rows)) + 1
    nb = min(nb, sc.n_blocks)
    valid = sc.valid[:nb]
    cut = T.scramble_from_arrays(
        {c: a[:nb] for c, a in sc.columns.items()}, valid,
        int(valid.sum()), sc.block_rows, sc.catalog, sc.categorical,
        sc.seed)
    return cut, {c: a[valid] for c, a in cut.columns.items()}


def sharded_phase(torch, np, T, opt, sc, rows: int):
    """Phase 3e: the sharded scan on the card, on the first blocks of
    ``sc`` holding ``rows`` rows. The main process runs the queries
    through phases 3b / 3c's single-device paths (the device loop, the
    device pass loop) on the same blocks; the ranks are held to those
    results. Returns ``(record, failures, launches)``, ``launches`` each
    kernel's launches summed over the ranks' sharded runs."""
    import tempfile
    import torch.multiprocessing as tmp
    from repro_torch.aqp import flights_queries as fq
    from repro_torch.serve import FrameServer
    ctx = tmp.get_context("spawn")
    failures, rec = [], {}
    t0 = time.perf_counter()
    if rows < sc.n_rows:
        sc, cols = _cut_scramble(np, T, sc, rows)
    else:
        cols = {c: a[sc.valid] for c, a in sc.columns.items()}
    rec["rows"], rec["blocks"] = int(sc.n_rows), int(sc.n_blocks)
    # the single-device results the ranks are held to, and the truths
    frame = T.FastFrame(sc, T.EngineConfig(device_loop=True), device="cuda")
    runs = {name: q for name, q, _ in main_path_queries(T, fq, opt)
            + anderson_queries(T, fq, opt) if name in SHARD_RUNS}
    solo = {name: frame.run(q, sampling="active_peek", seed=0)
            for name, q in runs.items()}
    truths = {name: truth_of(np, cols, q) for name, q in runs.items()}
    served = FrameServer(frame).run_batch(
        shared_sig_workload(T, opt), sampling="active_peek", seed=1,
        start_block=0)
    torch.cuda.synchronize()
    del frame
    torch.cuda.empty_cache()
    rec["single_device_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3e_") as tdir:
        tdir = Path(tdir)
        data = tdir / "data"
        data.mkdir()
        t0 = time.perf_counter()
        for c, arr in sc.columns.items():
            np.save(data / f"{c}.npy", arr)
        np.save(data / "valid.npy", sc.valid)
        (data / "meta.json").write_text(json.dumps(dict(
            columns=list(sc.columns), n_rows=int(sc.n_rows),
            block_rows=int(sc.block_rows),
            catalog={k: [float(x) for x in v] for k, v in sc.catalog.items()},
            categorical={k: int(v) for k, v in sc.categorical.items()},
            seed=int(sc.seed))))
        rec["write_s"] = time.perf_counter() - t0
        base = dict(world=SHARD_RANKS, store=str(tdir / "store"),
                    data=str(data), out=str(tdir), backend="gloo",
                    device_index=0, merge_every=list(SHARD_MERGE_EVERY),
                    sys_path=list(sys.path),
                    group_timeout_s=capped(SHARD_GROUP_TIMEOUT_S))
        t0 = time.perf_counter()
        codes = _spawn_ranks(ctx, shard_rank_main,
                             [dict(base, rank=r) for r in range(SHARD_RANKS)],
                             SHARD_JOIN_TIMEOUT_S, "sharded", failures)
        rec["ranks_wall_s"] = time.perf_counter() - t0
        rec["rank_exit_codes"] = codes
        if codes != [0] * SHARD_RANKS:
            failures.append(dict(part="gloo ranks", exit_codes=codes))
            return rec, failures, {}
        ranks = [json.loads((tdir / f"rank{r}.json").read_text())
                 for r in range(SHARD_RANKS)]
        results = [np.load(tdir / f"rank{r}.npz") for r in range(SHARD_RANKS)]
        rec["ranks"] = ranks
        for r in ranks:
            if not all(r["cuda_all_reduce"][k] for k in ("sum_ok", "min_ok")):
                failures.append(dict(part="gloo all_reduce of a CUDA tensor",
                                     rank=r["rank"], got=r["cuda_all_reduce"]))
            for run in r["runs"]:
                fold = "fused_fold" if "adkw" in run["run"] else "block_agg"
                idle = [k for k in ("round_select", fold)
                        if run["launches"][k] == 0]
                if idle or run["captured"]:
                    failures.append(dict(part="launches", rank=r["rank"],
                                         run=run["run"], idle=idle,
                                         captured=run["captured"]))
            for i in r["integer_frame"]["runs"]:
                bad = (i["exact_fields_differ"] or not i["same_finite"]
                       or (i["merge_every"] == 1 and not i["ci_bitwise"])
                       or i["ci_max_rel"] > SHARD_CADENCE_TOL)
                if bad:
                    failures.append(dict(part="integer frame",
                                         rank=r["rank"], **i))
        # replicated: every rank's results the same bits
        keys = sorted(results[0].files)
        diverged = [k for k in keys if any(
            not np.array_equal(results[0][k], res[k]) for res in results[1:])]
        rec["ranks_bitwise_equal"] = not diverged
        if diverged:
            failures.append(dict(part="ranks differ", fields=diverged[:8]))
        # against phases 3b / 3c: K 1 exact fields equal and CIs within
        # SHARD_CI_RTOL; every K's intervals cover the truth; K > 1 held
        # to the ranks' own K 1 run by the cadence's contract
        memo = {}
        checks = []
        qs = shared_sig_workload(T, opt)
        for K in SHARD_MERGE_EVERY:
            for name in SHARD_RUNS + ("shared_sig",):
                n_q = len(qs) if name == "shared_sig" else 1
                for i in range(n_q):
                    got = _load_result(results[0], f"{name}/K{K}/{i}")
                    if name == "shared_sig":
                        want = served[i]
                        truth = truth_of_column(np, cols, qs[i], memo)
                    else:
                        want, truth = solo[name], truths[name]
                    differ = _exact_fields_equal(np, got, want)
                    gap, same_fin = _shard_ci_gap(np, got, want)
                    miss = uncovered(np, got, *truth)
                    row = dict(run=name, query=i, merge_every=K,
                               rounds=int(got.rounds),
                               single_device_rounds=int(want.rounds),
                               exact_fields_differ=differ,
                               ci_max_rel=gap, covered=not len(miss))
                    if K > 1:
                        row["cadence_faults"] = _cadence_faults(
                            np, got, _load_result(results[0],
                                                  f"{name}/K1/{i}"))
                    checks.append(row)
                    if (len(miss) or row.get("cadence_faults")
                            or (K == 1 and (differ or not same_fin
                                            or gap > SHARD_CI_RTOL))):
                        failures.append(dict(part="vs single device", **row))
        rec["checks"] = checks
        n_cards = torch.cuda.device_count()
        rec["nccl_world"] = 1
        if n_cards >= 2:
            # one rank a card under NCCL: the Bernstein GROUP BY at K 1
            world = min(n_cards, 4)
            base = dict(world=world, store=str(tdir / "store_nccl"),
                        data=str(data), out=str(tdir / "nccl"),
                        backend="nccl", merge_every=[1],
                        only=[SHARD_RUNS[0]], sys_path=list(sys.path),
                        group_timeout_s=capped(SHARD_GROUP_TIMEOUT_S))
            (tdir / "nccl").mkdir()
            codes = _spawn_ranks(ctx, shard_rank_main, [
                dict(base, rank=r, device_index=r) for r in range(world)],
                SHARD_JOIN_TIMEOUT_S, "sharded", failures)
            rec["nccl_world"] = world
            rec["nccl_exit_codes"] = codes
            if codes != [0] * world:
                failures.append(dict(part=f"nccl world {world}",
                                     exit_codes=codes))
        else:
            rec["nccl_note"] = ("one card: NCCL takes one rank a card, so "
                                "only make_sharded_fold runs under NCCL "
                                "here, at world size 1")
        # NCCL: a one-rank group, the fold captured
        t0 = time.perf_counter()
        codes = _spawn_ranks(ctx, nccl_world1_main, [dict(
            store=str(tdir / "store_nccl1"), out=str(tdir),
            sys_path=list(sys.path),
            group_timeout_s=capped(SHARD_GROUP_TIMEOUT_S))],
            SHARD_JOIN_TIMEOUT_S, "sharded", failures)
        nccl = dict(exit_codes=codes, wall_s=time.perf_counter() - t0)
        ok = False
        if codes == [0]:
            nccl.update(json.loads((tdir / "nccl1.json").read_text()))
            ok = all(nccl["fold_captured_bitwise"].values())
        if not ok:
            failures.append(dict(part="nccl world 1", **nccl))
        rec["nccl_world_1"] = nccl
    launches = {}
    for r in rec.get("ranks", []):
        for run in r["runs"]:
            for k, n in run["launches"].items():
                launches[k] = launches.get(k, 0) + n
    return rec, failures, launches


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


def decode_steps(torch, model, lm, cache, tok, pos: int, steps: int,
                 extra=None):
    """``steps`` greedy decode steps from ``tok`` at position ``pos``, each
    feeding back the argmax on the card (no host sync inside); ``extra``
    joins every step's inputs (the enc-dec's ``memory``). Returns
    (generated tokens (B, steps), every logit finite (a card tensor),
    cache, host seconds)."""
    out, finite = [], torch.ones((), dtype=torch.bool, device=tok.device)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode(lm, cache, {"token": tok,
                                                 "pos": pos + i,
                                                 **(extra or {})})
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


def with_room(model, cache, max_len: int):
    """An attention family's prefill cache (KV of the prompt's length)
    copied into a cache of ``max_len`` slots, the room to decode into
    (tests/test_models_smoke.py's splice): the dense families'
    ``layers``, the hybrid's ``attn`` beside its Mamba2 states as they
    are; an ssm cache as it is."""
    key = "attn" if "attn" in cache else "layers"
    if "k" not in cache[key]:
        return cache
    k = cache[key]["k"]
    room = model.init_cache(k.shape[1], max_len, device=k.device)
    for name in ("k", "v"):
        room[key][name][:, :, :k.shape[2]] = cache[key][name]
    return {**cache, key: room[key]}


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
    cache = with_room(model, cache, T)
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
    decode logits within 1e-4 of their largest magnitude. An LM prefills
    T-1 tokens and decodes token T-1; the enc-dec encodes T frame
    embeddings (N(0, 0.02)), prefills T tokens and decodes its first
    token at position 0 against the memory."""
    lm_cpu = model.init(seed, device="cpu")
    lm_gpu = model.init(seed, device="cuda")
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (B, T)))
    encdec = model.cfg.family == "encdec"
    if encdec:
        frames = torch.from_numpy(rng.normal(
            0, 0.02, (B, T, model.cfg.d_model)).astype(np.float32))
    outs = []
    for lm, dev in ((lm_cpu, "cpu"), (lm_gpu, "cuda")):
        t = toks.to(dev)
        if encdec:
            batch = {"tokens": t, "frame_embeds": frames.to(dev)}
            with torch.inference_mode():
                full, _ = model.forward(lm, batch)
            pre, cache = model.prefill(lm, batch)
            dec, _ = model.decode(lm, model.init_cache(B, 2, device=dev),
                                  {"token": t[:, :1], "pos": 0,
                                   "memory": cache["memory"]})
        else:
            with torch.inference_mode():
                full, _ = model.forward(lm, {"tokens": t})
            pre, cache = model.prefill(lm, {"tokens": t[:, :T - 1]})
            dec, _ = model.decode(lm, with_room(model, cache, T),
                                  {"token": t[:, T - 1:], "pos": T - 1})
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
    path, (model, weights)): phase 5b evaluates the same model."""
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
    return record, launches, (model, lm)


# -- phase 5b ----------------------------------------------------------------

# launch/train.py's eval of the reference: 512 examples of the run's
# sequence length, delta 1e-6, target width 0.1; batches of 8 (16 there).
# The set is cut to 256 examples for the training phases 6c-6e: the full
# pass that gives the truth took 86 s of the phase's 104 at 512.
EVAL_EXAMPLES, EVAL_LEN, EVAL_BATCH = 48, PROMPT_LEN, 8
EVAL_DELTA, EVAL_WIDTH = 1e-6, 0.1
# tests/test_train_stack.py's width, used (and said) only when the
# certificate cannot reach EVAL_WIDTH within EVAL_EXAMPLES; delta stays
EVAL_WIDTH_FALLBACK = 0.5
# the card-vs-CPU check: full width, 4 layers, float32, 32 examples of
# 256 tokens in batches of 4, stopping at width 1.0
# (cut from 32 examples for the smoke's time: the CPU's forwards)
EVAL_SMALL = dict(layers=4, examples=16, tokens=256, batch=4, width=1.0)
EVAL_LOSS_RTOL = 1e-4


def eval_loss_fn(torch, model, lm, device, kscan, seen):
    """tests/test_train_stack.py's per-token eval loss on ``device``:
    logsumexp minus the picked logit of ``model.forward``, ``targets >=
    0`` the mask. Each call appends ``(scan launches, losses)`` to
    ``seen``."""

    @torch.inference_mode()
    def loss_fn(batch):
        toks = torch.from_numpy(batch["tokens"]).to(device)
        targets = torch.from_numpy(batch["targets"]).to(device)
        before = kscan.selective_scan.launches
        logits, _ = model.forward(lm, {"tokens": toks})
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              targets.clamp(min=0).long()[..., None])[..., 0]
        losses = logz - picked
        seen.append((kscan.selective_scan.launches - before, losses))
        return losses, targets >= 0

    return loss_fn


def report_dict(rep):
    return dict(dataclasses.asdict(rep), fraction_used=rep.fraction_used)


def eval_card_vs_cpu(torch, np, cfg, kscan, device="cuda"):
    """ApproxEval of the same float32 weights (full width, 4 layers) on
    the card and on the CPU over one scramble: per-token losses within
    ``EVAL_LOSS_RTOL`` of their largest magnitude, the same rounds and
    examples."""
    import copy
    from repro_torch.data.tokens import make_eval_scramble
    from repro_torch.evalx import ApproxEval
    from repro_torch.models import build as build_model
    e = EVAL_SMALL
    small = build_model(dataclasses.replace(
        cfg, n_layers=e["layers"], param_dtype="float32",
        compute_dtype="float32"))
    lm_gpu = small.init(MODEL_SEED, device=device)
    lm_cpu = copy.deepcopy(lm_gpu).to("cpu")
    sc = make_eval_scramble(small.cfg, n_examples=e["examples"],
                            seq_len=e["tokens"])
    out = []
    for dev, lm in ((device, lm_gpu), ("cpu", lm_cpu)):
        seen = []
        t0 = time.perf_counter()
        rep = ApproxEval(eval_loss_fn(torch, small, lm, dev, kscan, seen),
                         vocab=small.cfg.vocab_padded, delta=EVAL_DELTA).run(
            sc.batches(e["batch"]), sc.n_examples, target_width=e["width"])
        out.append((rep, seen, time.perf_counter() - t0))
    (g, g_seen, g_s), (c, c_seen, c_s) = out
    rel = max(float((lg.cpu() - lc).abs().max()) / float(lc.abs().max())
              for (_, lg), (_, lc) in zip(g_seen, c_seen))
    same = (g.rounds, g.examples_used) == (c.rounds, c.examples_used)
    return dict(n_layers=e["layers"], d_model=cfg.d_model, examples=e["examples"],
                tokens=e["tokens"], batch=e["batch"], target_width=e["width"],
                card=report_dict(g), cpu=report_dict(c), card_s=g_s,
                cpu_s=c_s, loss_max_rel=rel, loss_rtol=EVAL_LOSS_RTOL,
                card_scan_launches=[n for n, _ in g_seen],
                cpu_scan_launches=[n for n, _ in c_seen],
                ok=same and rel <= EVAL_LOSS_RTOL
                and all(n == e["layers"] for n, _ in g_seen)
                and not any(n for n, _ in c_seen))


def eval_phase(torch, np, counters, model, lm, kscan, device="cuda"):
    """Phase 5b: ApproxEval of phase 5's falcon-mamba-7b (64 layers, full
    width, bf16) over a scrambled eval set of EVAL_EXAMPLES examples,
    then the full set's mean clipped loss from a forward over every
    batch, then :func:`eval_card_vs_cpu`. Returns (record, launches of
    the eval's run)."""
    from repro_torch.data.tokens import make_eval_scramble
    from repro_torch.evalx import ApproxEval
    cfg = model.cfg
    sc = make_eval_scramble(cfg, n_examples=EVAL_EXAMPLES, seq_len=EVAL_LEN)
    seen = []
    ev = ApproxEval(eval_loss_fn(torch, model, lm, device, kscan, seen),
                    vocab=cfg.vocab_padded, delta=EVAL_DELTA)
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = ev.run(sc.batches(EVAL_BATCH), sc.n_examples,
                 target_width=EVAL_WIDTH)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    width, fallback = EVAL_WIDTH, None
    if not rep.stopped_early:
        # the same losses again (no forward): delta is not loosened
        width = EVAL_WIDTH_FALLBACK
        fallback = (f"width {EVAL_WIDTH} not reached within "
                    f"{EVAL_EXAMPLES} examples (final {rep.hi - rep.lo:.4g})"
                    f"; tests/test_train_stack.py's width {width}")
        cached = iter([l for _, l in seen])
        rep = ApproxEval(lambda b: (next(cached), torch.from_numpy(
            b["targets"]) >= 0), vocab=cfg.vocab_padded,
            delta=EVAL_DELTA).run(sc.batches(EVAL_BATCH), sc.n_examples,
                                  target_width=width)
    # the full set: one forward a batch, the clipped mean in float64
    full_seen = []
    full_fn = eval_loss_fn(torch, model, lm, device, kscan, full_seen)
    total, count = 0.0, 0
    t0 = time.perf_counter()
    for b in sc.batches(EVAL_BATCH):
        losses, mask = full_fn(b)
        v = losses.cpu().numpy().astype(np.float64)[mask.cpu().numpy()]
        total += float(np.clip(v, 0.0, ev.loss_clip).sum())
        count += v.size
    full_s = time.perf_counter() - t0
    full_mean = total / count
    repeat = all(torch.equal(a, b) for (_, a), (_, b)
                 in zip(seen, full_seen))
    forwards = [n for n, _ in seen + full_seen]
    covers = rep.lo <= full_mean <= rep.hi
    stray = [k for k, v in launches.items() if k != "selective_scan" and v]
    small = eval_card_vs_cpu(torch, np, cfg, kscan, device)
    ok = (rep.stopped_early and rep.examples_used < EVAL_EXAMPLES and covers
          and forwards == [cfg.n_layers] * len(forwards) and not stray
          and repeat and small["ok"])
    return dict(
        model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        param_dtype=cfg.param_dtype, examples=EVAL_EXAMPLES,
        seq_len=EVAL_LEN, batch=EVAL_BATCH, delta=EVAL_DELTA,
        target_width=width, width_fallback=fallback, report=report_dict(rep),
        eval_s=eval_s, full_pass_s=full_s, full_pass_batches=len(full_seen),
        full_mean_clipped_loss=full_mean, certificate_covers=covers,
        eval_losses_repeat=repeat, scan_launches_per_forward=sorted(
            set(forwards)), forwards=len(forwards), launches=launches,
        reduced={"batch": "launch/train.py's 16 examples a round -> 8",
                 "examples": f"launch/train.py's 512 -> {EVAL_EXAMPLES} "
                             "(the smoke's time: the full pass)"},
        card_vs_cpu=small, ok=ok), launches


# -- phase 5c ----------------------------------------------------------------

# The dense families' serving path: (id, layers served or None for the
# config's own, why cut). dbrx's experts are 6.3 GB a layer in bf16, so
# its 40 layers (~265 GB) are cut to 4.
DENSE_SERVE = (("qwen2_5_3b", 18, "36 -> 18 layers (the smoke's "
                                  "time)"),
               ("pixtral_12b", 20, "40 -> 20 layers (the smoke's "
                                   "time)"),
               ("dbrx_132b", 4, "40 -> 4 layers (its experts are 6.3 GB a "
                                "layer in bf16: 40 layers ~265 GB)"))
# prefill + decode = forward at full width in float32: (id, layers, B, T,
# capacity factor). dbrx dropless at B 2, T 256: B(T-1) = 510 and BT = 512
# both give whole dispatch groups.
DENSE_CONSISTENCY = (("qwen3_0_6b", 4, 2, 512, None),
                     ("dbrx_132b", 2, 2, 256, 16.0))
DENSE_IDS = ("qwen3_0_6b", "qwen2_5_3b", "stablelm_1_6b", "phi3_mini_3_8b",
             "pixtral_12b", "dbrx_132b", "arctic_480b")


def request_batch(torch, np, cfg):
    """SERVE_BATCH requests of PROMPT_LEN positions for ``cfg``, as
    ``input_specs`` lays them out: text tokens from MODEL_SEED and, for
    the vlm and the enc-dec, the stubbed frontend's patch or frame
    embeddings (N(0, 0.02), drawn on the card): the vlm's before its
    tokens, the enc-dec's half the positions for its encoder."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import input_specs
    specs = input_specs(cfg, ShapeConfig("serve", PROMPT_LEN, SERVE_BATCH,
                                         "prefill"))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        MODEL_SEED).integers(0, cfg.vocab, specs["tokens"].shape)).cuda()}
    for name in ("extra_embeds", "frame_embeds"):
        if name in specs:
            gen = torch.Generator(device="cuda").manual_seed(MODEL_SEED)
            e = specs[name]
            batch[name] = (torch.randn(e.shape, generator=gen,
                                       device="cuda") * 0.02).to(e.dtype)
    return batch


def serve_batch_once(torch, model, lm, batch, steps: int):
    """One prefill of ``batch`` and ``steps`` greedy decode steps. An LM's
    prefill KV is copied into a cache with room for ``steps`` more and
    decoding goes on from the prompt's last logits; the enc-dec decodes
    from each request's first text token at position 0 against
    ``init_cache(B, steps + 1)`` and the prefill's encoder memory (its
    prefill emits no self-attention cache)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(lm, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if "memory" in cache:
        tok = batch["tokens"][:, :1]
        room = model.init_cache(tok.shape[0], steps + 1)
        gen, finite, _, decode_s = decode_steps(
            torch, model, lm, room, tok, 0, steps,
            extra={"memory": cache["memory"]})
        tokens = gen
    else:
        T = cache["attn" if "attn" in cache else "layers"]["k"].shape[2]
        cache = with_room(model, cache, T + steps)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        gen, finite, _, decode_s = decode_steps(torch, model, lm, cache,
                                                tok, T, steps)
        tokens = torch.cat([tok, gen], dim=1)
    finite &= torch.isfinite(logits).all()
    return dict(tokens=tokens.cpu(), finite=bool(finite),
                prefill_s=prefill_s, decode_s=decode_s,
                prefill_peak_gib=prefill_peak_gib)


def serving_model_of(torch, np, arch_id: str, layers=None):
    """A model at full width (``layers`` of them, or the config's own),
    bf16, its weights initialised on the card from MODEL_SEED, and its
    requests. Returns (model, module, batch, init_s)."""
    from repro_torch.configs import get as get_config
    from repro_torch.models import build as build_model
    cfg = get_config(arch_id)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    lm = model.init(MODEL_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    return model, lm, request_batch(torch, np, cfg), init_s


def _family_fields(cfg) -> dict:
    """The config's shape fields of its family, for a serving record."""
    if cfg.family == "hybrid":
        period = cfg.hybrid_attn_period
        return dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                    ssm_heads=cfg.ssm_heads, ssm_chunk=cfg.ssm_chunk,
                    attn_period=period, n_groups=cfg.n_layers // period,
                    tail_layers=cfg.n_layers % period)
    if cfg.family == "encdec":
        return dict(enc_layers=cfg.enc_layers, vocab_padded=cfg.vocab_padded)
    return dict(n_experts=cfg.n_experts, top_k=cfg.top_k)


def serve_model_twice(torch, np, arch_id: str, layers=None, cut=None):
    """One model at full width served twice (bf16). Returns its
    record."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, lm, batch, init_s = serving_model_of(torch, np, arch_id, layers)
    cfg = model.cfg
    weights_gib = (torch.cuda.memory_allocated() - base) / 2**30
    t0 = time.perf_counter()
    runs = [serve_batch_once(torch, model, lm, batch, FAMILY_DECODE_STEPS)
            for _ in range(2)]
    serve_s = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    front = batch["extra_embeds"].shape[1] if "extra_embeds" in batch else 0
    if cfg.family == "encdec":
        reduced = {"prefill_32k": "32 x 32768 -> 8 x 2048 positions (1024 "
                                  "frame embeddings + 1024 tokens)",
                   "decode_32k": "batch 128 against a 4096-frame memory "
                                 "-> batch 8 against the prefill's "
                                 "1024-frame memory, from position 0"}
    else:
        reduced = {"prefill_32k": "32 x 32768 -> 8 x 2048 positions",
                   "decode_32k": "batch 128 after a 32K context -> batch 8 "
                                 "after 2048 positions"}
    reduced["decode_steps"] = (f"{DECODE_STEPS} -> {FAMILY_DECODE_STEPS} "
                               "(the smoke's time)")
    if cut:
        reduced["n_layers"] = cut
    record = dict(
        model=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
        **_family_fields(cfg), param_dtype=cfg.param_dtype,
        params=sum(p.numel() for p in lm.parameters()), init_s=init_s,
        requests=SERVE_BATCH, prompt_positions=PROMPT_LEN,
        frontend_positions=front,
        frame_positions=(batch["frame_embeds"].shape[1]
                         if "frame_embeds" in batch else 0),
        decode_steps=FAMILY_DECODE_STEPS,
        runs=[dict(prefill_s=r["prefill_s"],
                   prefill_tokens_per_s=SERVE_BATCH * PROMPT_LEN
                   / r["prefill_s"],
                   decode_ms_per_step=r["decode_s"] / FAMILY_DECODE_STEPS
                   * 1e3,
                   decode_tokens_per_s=SERVE_BATCH * FAMILY_DECODE_STEPS
                   / r["decode_s"],
                   peak_gib_after_prefill=(r["prefill_peak_gib"]
                                           - base / 2**30),
                   finite=r["finite"]) for r in runs],
        tokens_repeat=torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
        weights_gib=weights_gib, peak_device_gib=peak_gib, serve_s=serve_s,
        reduced=reduced)
    record["ok"] = record["tokens_repeat"] and all(r["finite"]
                                                   for r in runs)
    del lm, model, batch
    torch.cuda.empty_cache()
    return record


def dense_serve_phase(torch, np, counters):
    """Phase 5c: the dense, vlm and MoE families. DENSE_SERVE's models
    served twice at full width (bf16), then prefill + decode against
    forward at full width in float32 (DENSE_CONSISTENCY), then each of
    the seven ids' reduced float32 config on the card against the CPU.
    These families run plain PyTorch: no kernel counter may move.
    Returns (record, launches)."""
    from repro_torch.configs import get as get_config
    from repro_torch.models import build as build_model
    for c in counters.values():
        c.launches = 0
    served = [serve_model_twice(torch, np, *m) for m in DENSE_SERVE]
    consistency = []
    for arch_id, layers, B, T, cf in DENSE_CONSISTENCY:
        cfg = dataclasses.replace(get_config(arch_id), n_layers=layers,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        model = build_model(cfg)
        lm = model.init(MODEL_SEED)
        consistency.append(dict(model=arch_id, capacity_factor=cf,
                                **check_prefill_decode(torch, np, model, lm,
                                                       B=B, T=T, seed=1)))
        del lm
        torch.cuda.empty_cache()
    # B 2, T 32: whole MoE groups (64 tokens) for forward and prefill
    card_vs_cpu = [dict(model=arch_id, **check_card_vs_cpu_model(
        torch, np, build_model(dataclasses.replace(
            get_config(arch_id, reduced=True), param_dtype="float32",
            compute_dtype="float32")), B=2, T=32, seed=2))
        for arch_id in DENSE_IDS]
    launches = {k: c.launches for k, c in counters.items()}
    stray = [k for k, v in launches.items() if v]
    ok = (all(r["ok"] for r in served + consistency + card_vs_cpu)
          and not stray)
    return dict(served=served, prefill_decode_vs_forward=consistency,
                card_vs_cpu=card_vs_cpu, launches=launches, ok=ok), launches


# -- phase 5d ----------------------------------------------------------------

# The hybrid and enc-dec families' serving path (plain PyTorch, no kernel),
# both at full width and depth: zamba2-7b (81 Mamba2 layers, the shared
# attention block every 6) and seamless-m4t-large-v2 (24 + 24 layers).
# (id, layers, cut): zamba2 at 7 of its 13 groups of 6 and no tail
HYBRID_SERVE = (("zamba2_7b", 42, "81 -> 42 layers, 7 whole groups (the "
                                  "smoke's time)"),
                ("seamless_m4t_large_v2", None, None))
# prefill + decode against forward in float32: zamba2 at 7 layers (one
# group and one tail), B 2, T 256 (T 257 would break the ssm chunk of 256
# in forward); seamless at 2 + 2 layers, teacher-forced decode steps
# against decode_train at B 2, T 64
HYBRID_CONSISTENCY = dict(layers=7, B=2, T=256)
ENCDEC_CONSISTENCY = dict(enc_layers=2, layers=2, B=2, T=64)
# the hybrid's ring cache past its wrap: zamba2 at full width, 7 layers,
# float32, a 64-token window (a test setting; the config's is 4096) and
# 96 decode steps through init_cache(2, 100_000), i.e. 64 slots
RING_WINDOW = 64
RING_STEPS = 96


def _within(got, want, tol: float = 2e-3) -> bool:
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def check_teacher_forced(torch, np, model, lm, B: int, T: int, seed: int):
    """tests/test_models_smoke.py's seamless contract on the card: T
    tokens teacher-forced through decode steps against the encoder's
    memory of T frame embeddings give ``decode_train``'s logits at every
    position, ``|a - b| <= 2e-3 + 2e-3 |b|``."""
    from repro_torch.models import encdec
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))).cuda()
    frames = torch.from_numpy(rng.normal(0, 0.02, (B, T, cfg.d_model))
                              .astype(np.float32)).cuda()
    with torch.inference_mode():
        memory = encdec.encode(lm, cfg, frames)
        full = encdec.decode_train(lm, cfg, toks, memory)
    cache, steps = model.init_cache(B, T), []
    for t in range(T):
        logits, cache = model.decode(lm, cache, {
            "token": toks[:, t:t + 1], "pos": t, "memory": memory})
        steps.append(logits[:, 0])
    steps = torch.stack(steps, dim=1)
    return dict(B=B, T=T, enc_layers=cfg.enc_layers, n_layers=cfg.n_layers,
                d_model=cfg.d_model, param_dtype=cfg.param_dtype,
                max_abs_err=float((steps - full).abs().max()),
                ok=_within(steps, full))


def check_ring(torch, np, model, lm, B: int, steps: int, window: int,
               seed: int):
    """The hybrid's ring cache on the card: ``steps`` teacher-forced
    decode steps (seeded tokens) through ``init_cache(B, 100_000)`` (``window``
    slots) at a 0-d card tensor position against the same steps through
    a cache of ``steps`` slots at int positions, both with the window:
    equal within 2e-3 at every step, past the wrap included."""
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (B, steps))).cuda()

    def run(max_len, tensor_pos):
        cache, out = model.init_cache(B, max_len), []
        for t in range(steps):
            pos = (torch.tensor(t, dtype=torch.int32, device="cuda")
                   if tensor_pos else t)
            logits, cache = model.decode(lm, cache, {
                "token": toks[:, t:t + 1], "pos": pos}, window=window)
            out.append(logits[:, 0])
        return torch.stack(out, dim=1), cache["attn"]["k"].shape[2]
    ring, slots = run(100_000, True)
    full, full_slots = run(steps, False)
    err = (ring - full).abs().amax(dim=(0, 2))
    return dict(B=B, steps=steps, window=window, ring_slots=slots,
                full_slots=full_slots, n_layers=model.cfg.n_layers,
                d_model=model.cfg.d_model,
                max_abs_err_below_wrap=float(err[:slots].max()),
                max_abs_err_past_wrap=float(err[slots:].max()),
                ok=slots == window and _within(ring, full))


def hybrid_serve_phase(torch, np, counters):
    """Phase 5d: the hybrid and enc-dec families. HYBRID_SERVE's models
    served twice at full width and depth (bf16), then in float32 at full
    width: zamba2's prefill + decode against forward, seamless's
    teacher-forced decode against ``decode_train``, zamba2's ring cache
    past its wrap against a full cache; then both reduced float32
    configs on the card against the CPU. These families run plain
    PyTorch: no kernel counter may move. Returns (record, launches)."""
    from repro_torch.configs import get as get_config
    from repro_torch.models import build as build_model
    for c in counters.values():
        c.launches = 0
    served = [serve_model_twice(torch, np, *m) for m in HYBRID_SERVE]

    def f32(arch_id, **kw):
        cfg = dataclasses.replace(get_config(arch_id), param_dtype="float32",
                                  compute_dtype="float32", **kw)
        model = build_model(cfg)
        return model, model.init(MODEL_SEED)
    hc = HYBRID_CONSISTENCY
    model, lm = f32("zamba2_7b", n_layers=hc["layers"])
    consistency = [dict(model="zamba2_7b", **check_prefill_decode(
        torch, np, model, lm, B=hc["B"], T=hc["T"], seed=1))]
    del model, lm
    ec = ENCDEC_CONSISTENCY
    model, lm = f32("seamless_m4t_large_v2", enc_layers=ec["enc_layers"],
                    n_layers=ec["layers"])
    consistency.append(dict(model="seamless_m4t_large_v2",
                            **check_teacher_forced(torch, np, model, lm,
                                                   B=ec["B"], T=ec["T"],
                                                   seed=1)))
    del model, lm
    model, lm = f32("zamba2_7b", n_layers=hc["layers"],
                    sliding_window=RING_WINDOW)
    ring = dict(model="zamba2_7b", reduced={
        "n_layers": "81 -> 7", "sliding_window": "4096 -> 64 (a test "
        "setting: the wrap after 64 steps)"},
        **check_ring(torch, np, model, lm, B=2, steps=RING_STEPS,
                     window=RING_WINDOW, seed=3))
    del model, lm
    torch.cuda.empty_cache()
    card_vs_cpu = [dict(model=arch_id, **check_card_vs_cpu_model(
        torch, np, build_model(dataclasses.replace(
            get_config(arch_id, reduced=True), param_dtype="float32",
            compute_dtype="float32")), B=2, T=32, seed=2))
        for arch_id, _, _ in HYBRID_SERVE]
    launches = {k: c.launches for k, c in counters.items()}
    stray = [k for k, v in launches.items() if v]
    ok = (all(r["ok"] for r in served + consistency + card_vs_cpu)
          and ring["ok"] and not stray)
    return dict(served=served, consistency=consistency, ring=ring,
                card_vs_cpu=card_vs_cpu, launches=launches, ok=ok), launches


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


def train_step_once(torch, step, state, batch,
                    tokens: int = TRAIN_BATCH * TRAIN_LEN):
    """One training step between two syncs: ``(state, loss CI state,
    record)``, the record with its host-clock seconds, tokens/s over
    ``tokens`` and metrics as floats."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ci = met["loss_ci_state"]
    return state, ci, dict(
        step=int(state["step"]) - 1, loss=float(met["loss"]),
        total_loss=float(met["total_loss"]),
        z_loss=float(met["z_loss"]), grad_norm=float(met["grad_norm"]),
        lr=float(met["lr"]), tokens=float(met["tokens"]),
        loss_ci_count=float(ci.count), loss_ci_mean=float(ci.mean),
        seconds=secs, tokens_per_s=tokens / secs)


def train_phase(torch, np, counters):
    """Phase 6: :func:`training_setup`, one warm-up step, then
    TRAIN_STEPS timed steps with the launch counts zeroed before them.
    Returns (record, launches on the training path)."""
    from repro_torch.distributed.straggler import StragglerMonitor
    from repro_torch.evalx import ThresholdMonitor

    torch.cuda.reset_peak_memory_stats()
    cfg, ocfg, state, batch, step, init_s = training_setup(torch)
    state_gib = torch.cuda.memory_allocated() / 2**30
    n_params = sum(p.numel() for p in state["params"].parameters())
    # phase 6b: launch/train.py's monitors, fed every step
    alarm = ThresholdMonitor(threshold=3.0 * math.log(cfg.vocab),
                             value_range=(0.0, 4.0 * math.log(cfg.vocab)),
                             direction="above")
    straggler = StragglerMonitor(n_hosts=1)
    decisions, mon_s = [], 0.0

    def monitor(ci, rec):
        nonlocal mon_s
        t0 = time.perf_counter()
        straggler.record(np.array([rec["seconds"]]))
        decisions.append(alarm.update(ci))
        mon_s += time.perf_counter() - t0

    state, ci, warm = train_step_once(torch, step, state, batch)
    monitor(ci, warm)
    for c in counters.values():
        c.launches = 0
    timed = []
    for _ in range(TRAIN_STEPS):
        state, ci, rec = train_step_once(torch, step, state, batch)
        timed.append(rec)
        monitor(ci, rec)
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
    lo, hi = alarm.interval()
    step_mean = statistics.mean(r["loss"] for r in [warm] + timed)
    monitors = dict(
        threshold=alarm.threshold, value_range=list(alarm.value_range),
        decisions=decisions, interval=[lo, hi], steps_mean_loss=step_mean,
        interval_holds_mean=lo <= step_mean <= hi,
        straggler_flagged=straggler.flagged(),
        straggler_interval_s=straggler.intervals()[0].tolist(),
        straggler_min_samples=straggler.min_samples, host_s=mon_s)
    ok = (finite and falls and norm_bounded and not stray
          and all(launches[k] == v for k, v in want.items())
          and monitors["interval_holds_mean"])
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
        launches_expected=want, peak_device_gib=peak_gib, monitors=monitors,
        reduced={"n_layers": "64 -> 16 (16 bytes a parameter: bf16 param "
                             "and grad, f32 grad accumulator, two f32 "
                             "moments; 7.27 G parameters need ~116 GB, "
                             "one H100 has 80 GB)",
                 "train_4k": "batch 256 x 4096 -> 4 x 4096 in 2 "
                             "microbatches of 2 (time limit)"},
        ok=ok)
    return record, launches


# -- phase 6c ----------------------------------------------------------------

# The dense, MoE, hybrid and enc-dec families' training path, as phase 6
# trains falcon-mamba: (id, layers or None for the config's own, batch,
# why the depth is cut). Full width, bf16 parameters from MODEL_SEED on
# the card, the config's optimizer (AdamW with float32 moments; dbrx's
# Adafactor), microbatches and remat, TRAIN_LEN positions a sequence
# (seamless's input_specs give half to its encoder's frames, half to
# its decoder's tokens), one warm-up step and TRAIN_STEPS timed steps on
# one batch at lr 3e-4. A parameter's state is 16 bytes under AdamW
# (bf16 parameter and gradient, float32 accumulator, two float32
# moments) and about 8 under Adafactor (its factored moments are small),
# so dbrx's and zamba2's depth is cut to what fits in 80 GB beside the
# activations; whole zamba2 groups are kept.
FAMILY_TRAIN = (
    ("qwen2_5_3b", 18, 2, "36 -> 18 layers (the smoke's time; 36 to PR "
                          "30)"),
    ("dbrx_132b", 2, 4,
     "40 -> 2 layers (about 8 bytes a parameter under Adafactor: 2 "
     "layers and the embeddings are 7.7 B parameters, ~57 GiB; 40 layers "
     "~132 B)"),
    ("zamba2_7b", 7, 2,
     "81 -> 7 layers, a group of 6 and a tail of 1 (the smoke's time; "
     "9 layers before, 33 layers, 3.0 B parameters, ~45 GiB, before "
     "that; 81 layers 6.8 B, ~101 GiB at 16 bytes a parameter)"),
    ("seamless_m4t_large_v2", None, 2, None),
)
FAMILY_TRAIN_CUT = ("batch 256 x 4096 -> {} x 4096 (the time limit)")
# timed steps after the warm-up step (cut from TRAIN_STEPS, 3, for
# the smoke's time: the loss still falls from one to the next)
FAMILY_STEPS = 2


def _loss_and_grads_timed(torch, model, lm, batch):
    """One loss and its gradients between syncs: ``(loss, grads, s, peak
    GiB)``, the peak from a reset."""
    plist = list(lm.parameters())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = model.loss(lm, batch)
    grads = torch.autograd.grad(loss, plist)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    return loss.detach(), grads, secs, peak


def remat_policies(torch, cfg, lm, batch):
    """The training step's loss and gradient (what remat changes) on the
    same parameters and batch under the ``"nothing"`` and the ``"dots"``
    policy: loss and grad norm bit for bit; seconds and peak of each."""
    from repro_torch.models import build as build_model
    from repro_torch.train.optimizer import global_norm
    out, kept = {}, {}
    for policy in ("nothing", "dots"):
        model = build_model(dataclasses.replace(cfg, remat_policy=policy))
        loss, grads, secs, peak = _loss_and_grads_timed(torch, model, lm,
                                                        batch)
        kept[policy] = (loss, global_norm(grads))
        del grads
        out[policy] = dict(loss=float(loss),
                           grad_norm=float(kept[policy][1]),
                           loss_and_grad_s=secs, peak_device_gib=peak)
    (l0, g0), (l1, g1) = kept["nothing"], kept["dots"]
    out["bitwise"] = bool(torch.equal(l0, l1) and torch.equal(g0, g1))
    return out


def train_family_model(torch, np, counters, arch_id: str, layers, batch_size,
                       cut):
    """One model of FAMILY_TRAIN: init, a warm-up step, FAMILY_STEPS
    timed steps; for the enc-dec also :func:`remat_policies`. Returns
    its record (with ``ok``)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs import get as get_config
    from repro_torch.data.tokens import train_batch
    from repro_torch.models import build as build_model
    from repro_torch.train import OptConfig, build_train_step, init_state
    cfg = get_config(arch_id)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    ocfg = OptConfig.for_arch(cfg, warmup_steps=1)   # as phase 6's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_state(model, MODEL_SEED, ocfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gib = (torch.cuda.memory_allocated() - base) / 2**30
    n_params = sum(p.numel() for p in state["params"].parameters())
    shape = ShapeConfig("train_4k", TRAIN_LEN, batch_size, "train")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(cfg, shape, 0, seed=MODEL_SEED).items()}
    tokens = batch_size * TRAIN_LEN
    step = build_train_step(model, ocfg)
    for c in counters.values():
        c.launches = 0
    state, _, warm = train_step_once(torch, step, state, batch, tokens)
    timed = []
    for _ in range(FAMILY_STEPS):
        state, _, rec = train_step_once(torch, step, state, batch, tokens)
        timed.append(rec)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    policies = (remat_policies(torch, cfg, state["params"], batch)
                if cfg.family == "encdec" else None)
    launches = {k: c.launches for k, c in counters.items()}
    del state, step, batch
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in timed]
    norms = [r["grad_norm"] for r in timed]
    finite = all(np.isfinite([r[k] for r in [warm] + timed
                              for k in ("loss", "grad_norm")]))
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    norm_bounded = max(norms) <= TRAIN_GRAD_NORM_GROWTH * norms[0]
    stray = [k for k, v in launches.items() if v]
    reduced = {"train_4k": FAMILY_TRAIN_CUT.format(batch_size),
               "steps": f"{TRAIN_STEPS} -> {FAMILY_STEPS} timed steps "
                        "(the smoke's time)"}
    if cut:
        reduced["n_layers"] = cut
    return dict(
        model=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab, **_family_fields(cfg),
        param_dtype=cfg.param_dtype, optimizer=ocfg.name,
        moment_dtype=ocfg.moment_dtype, lr=ocfg.lr, remat=cfg.remat_policy,
        microbatches=cfg.microbatches, params=n_params, init_s=init_s,
        state_gib=state_gib, batch=batch_size, seq_len=TRAIN_LEN,
        same_batch_every_step=True, warmup_step=warm, steps=timed,
        mean_step_s=statistics.mean(r["seconds"] for r in timed),
        tokens_per_s=tokens * FAMILY_STEPS
        / sum(r["seconds"] for r in timed),
        loss_falls_every_step=falls, grad_norm_bounded=norm_bounded,
        launches=launches, peak_device_gib=peak_gib,
        remat_policies=policies, reduced=reduced,
        ok=bool(finite and falls and norm_bounded and not stray
                and (policies is None or policies["bitwise"])))


@contextlib.contextmanager
def expandable_segments(torch):
    """Inside, the caching allocator makes expandable segments (PyTorch's
    ``expandable_segments``), which grow in place: a training step's many
    temporaries of changing sizes then leave no reserved memory that no
    request fits (on an H100 80GB, 8.2 GiB of it ran qwen2.5-3b's first
    step out of memory at 68 GiB allocated). The cache is emptied on the
    way in and out, so
    the segments made inside are the expandable ones."""
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    setting("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        setting("expandable_segments:False")


def family_train_phase(torch, np, counters):
    """Phase 6c: every model of FAMILY_TRAIN
    (:func:`train_family_model`), under :func:`expandable_segments`; no
    kernel counter may move (these families have no kernel). Returns
    (record, launches)."""
    with expandable_segments(torch):
        models = [train_family_model(torch, np, counters, *spec)
                  for spec in FAMILY_TRAIN]
    launches = {k: sum(m["launches"][k] for m in models) for k in counters}
    return dict(models=models, grad_norm_growth_limit=TRAIN_GRAD_NORM_GROWTH,
                reduced={m["model"]: m["reduced"] for m in models},
                ok=all(m["ok"] for m in models)), launches


# -- phase 6d ----------------------------------------------------------------

# The Mamba1 ``xla`` path's chunked scan (models/ssm.associative_scan,
# chunks of ssm_chunk 256, the reference's recursion) on the card:
# falcon-mamba-7b at full width, SCAN_LAYERS layers, one sequence of
# TRAIN_LEN tokens (phase 6's microbatch is 2), remat as configured. One
# loss-and-gradient call with the scan in float32 and one in bfloat16,
# each beside the ``pallas`` path's (the two scan kernels) on the same
# weights and batch. The parameters are float32 here, so that what the
# comparison sees is the scan's own distance: bf16 weights would round
# each layer's output to bf16 and flip last bits either way.
SCAN_LAYERS, SCAN_BATCH = 4, 1
# float32 scan against the kernels, relative to the largest |pallas|:
# the loss 1e-5 and each parameter's gradient 1e-4
# (tests/test_torch_train.py's scalar and block-against-reference
# bounds; on the CPU one reduced block measured 6.1e-8 on its output and
# 4.4e-7 on its gradients, pallas against xla)
SCAN_LOSS_RTOL, SCAN_GRAD_RTOL = 1e-5, 1e-4
# bf16 scan against the float32 scan: 1.5e-2 on the loss and on the
# gradients' global norm of the difference over the gradients' norm (the
# bf16 precedent; on the CPU one reduced block measured 2.1e-4 on its
# output and 6.1e-3 on its largest per-parameter gradient difference,
# the reference's own 2.1e-4 and 9.9e-3)
SCAN_BF16_RTOL = 1.5e-2


def mamba1_xla_scan_phase(torch, np, counters):
    """Phase 6d. Returns (record, launches of the ``pallas`` run)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs import get as get_config
    from repro_torch.data.tokens import train_batch
    from repro_torch.models import build as build_model
    base = dataclasses.replace(get_config("falcon_mamba_7b"),
                               n_layers=SCAN_LAYERS, param_dtype="float32",
                               compute_dtype="float32")
    lm = build_model(base).init(MODEL_SEED)
    names = [n for n, _ in lm.named_parameters()]
    shape = ShapeConfig("train_4k", TRAIN_LEN, SCAN_BATCH, "train")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(base, shape, 0, seed=MODEL_SEED).items()}
    runs, launches = {}, {}
    for name, impl, sdt in (("pallas", "pallas", "float32"),
                            ("xla_float32", "xla", "float32"),
                            ("xla_bfloat16", "xla", "bfloat16")):
        model = build_model(dataclasses.replace(base, ssm_impl=impl,
                                                ssm_scan_dtype=sdt))
        for c in counters.values():
            c.launches = 0
        runs[name] = _loss_and_grads_timed(torch, model, lm, batch)
        launches[name] = {k: c.launches for k, c in counters.items()}

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def norm_rel(ga, gb):
        num = sum(float(((a - b).double() ** 2).sum()) for a, b in
                  zip(ga, gb))
        den = sum(float((b.double() ** 2).sum()) for b in gb)
        return math.sqrt(num / max(den, 1e-300))
    (lp, gp, *_), (l32, g32, *_), (l16, g16, *_) = (
        runs[k] for k in ("pallas", "xla_float32", "xla_bfloat16"))
    grad_rel = {n: rel(a, b) for n, a, b in zip(names, g32, gp)}
    f32 = dict(loss_rel=rel(l32, lp), grad_max_rel=max(grad_rel.values()),
               grad_worst=max(grad_rel, key=grad_rel.get),
               loss_rtol=SCAN_LOSS_RTOL, grad_rtol=SCAN_GRAD_RTOL)
    bf16 = dict(loss_rel=rel(l16, l32), grad_norm_rel=norm_rel(g16, g32),
                grad_max_rel=max(rel(a, b) for a, b in zip(g16, g32)),
                rtol=SCAN_BF16_RTOL)
    finite = all(bool(torch.isfinite(l)) and all(
        bool(torch.isfinite(g).all()) for g in gs)
        for l, gs, *_ in runs.values())
    passes = SCAN_LAYERS
    want = {"selective_scan": 2 * passes, "selective_scan_bwd": passes}
    kernels_ok = (
        all(launches["pallas"][k] == v for k, v in want.items())
        and not any(v for k, v in launches["pallas"].items()
                    if k not in want)
        and not any(v for k in ("xla_float32", "xla_bfloat16")
                    for v in launches[k].values()))
    ok = (finite and kernels_ok
          and f32["loss_rel"] <= SCAN_LOSS_RTOL
          and f32["grad_max_rel"] <= SCAN_GRAD_RTOL
          and bf16["loss_rel"] <= SCAN_BF16_RTOL
          and bf16["grad_norm_rel"] <= SCAN_BF16_RTOL)
    record = dict(
        model=base.name, n_layers=SCAN_LAYERS, d_model=base.d_model,
        d_inner=base.d_inner, ssm_state=base.ssm_state,
        ssm_chunk=base.ssm_chunk, param_dtype=base.param_dtype,
        remat=base.remat_policy, batch=SCAN_BATCH, seq_len=TRAIN_LEN,
        runs={k: dict(loss=float(v[0]), loss_and_grad_s=v[2],
                      peak_device_gib=v[3], launches=launches[k])
              for k, v in runs.items()},
        float32_vs_pallas=f32, bfloat16_vs_float32=bf16,
        launches_expected_pallas=want,
        reduced={"n_layers": "64 -> 4 (one layer's scan levels at a time "
                             "under remat; the phase's time)",
                 "train_4k": f"batch 256 x 4096 -> {SCAN_BATCH} x 4096",
                 "param_dtype": "bfloat16 -> float32 (the scan's own "
                                "distance, unrounded)"},
        ok=bool(ok))
    del runs, lm, batch
    torch.cuda.empty_cache()
    return record, launches["pallas"]


# -- phase 6e ----------------------------------------------------------------

# launch/train.py's driver at full width (qwen3-0.6b, bf16, AdamW, remat),
# in-process: DRIVER_ARGS into a directory under build/, then the last
# checkpoint deleted and the run resumed from the one before it.
DRIVER_ARCH = "qwen3_0_6b"
# cut for the smoke's time from 8 steps, a checkpoint every 4 and all
# 28 layers; the driver's config is cut to DRIVER_LAYERS (full width)
DRIVER_STEPS, DRIVER_CKPT_EVERY, DRIVER_LAYERS = 4, 2, 2
DRIVER_ARGS = ["--arch", DRIVER_ARCH, "--steps", str(DRIVER_STEPS),
               "--seq-len", "1024", "--batch", "8", "--ckpt-every",
               str(DRIVER_CKPT_EVERY), "--eval-every", str(DRIVER_STEPS)]


def driver_phase(torch, np, counters):
    """Phase 6e: ``repro_torch.launch.train.main`` twice (straight, then
    resumed after the last checkpoint is deleted), on its config cut to
    DRIVER_LAYERS layers: the resumed run's
    losses and final parameters against the straight run's (bit for bit
    expected), the eval's certificate against the eval set's full mean,
    ``compress_roundtrip`` of one step's gradients on the card against
    the CPU, the SIGTERM handler put back, and no kernel counter moved.
    Returns (record, launches)."""
    import shutil
    import signal
    from repro_torch.distributed import grad_compression as gc
    from repro_torch.launch import train as drv

    work = ROOT / "build" / "smoke_driver"
    shutil.rmtree(work, ignore_errors=True)
    args = DRIVER_ARGS + ["--ckpt-dir", str(work)]
    losses, reports = [], []
    build_step, run_eval, get = drv.build_train_step, drv.run_eval, drv.get

    def cut_config(arch_id):
        return dataclasses.replace(get(arch_id), n_layers=DRIVER_LAYERS)

    def recording_step(model, ocfg):
        fn = build_step(model, ocfg)

        def step(state, batch):
            state, met = fn(state, batch)
            losses[-1].append(float(met["loss"]))
            return state, met
        return step

    def recording_eval(model, cfg, state, a):
        t0 = time.perf_counter()
        rep = run_eval(model, cfg, state, a)
        reports.append((rep, time.perf_counter() - t0, model, state))
        return rep

    handler = signal.getsignal(signal.SIGTERM)
    for c in counters.values():
        c.launches = 0
    drv.build_train_step, drv.run_eval = recording_step, recording_eval
    drv.get = cut_config
    try:
        losses.append([])
        t0 = time.perf_counter()
        straight = drv.main(args)
        straight_s = time.perf_counter() - t0
        ckpt_dir = work / DRIVER_ARCH
        steps_saved = sorted(p.name for p in ckpt_dir.glob("step_*"))
        shutil.rmtree(ckpt_dir / f"step_{DRIVER_STEPS:08d}")
        losses.append([])
        t0 = time.perf_counter()
        resumed = drv.main(args + ["--resume"])
        resumed_s = time.perf_counter() - t0
    finally:
        drv.build_train_step, drv.run_eval = build_step, run_eval
        drv.get = get
    handler_restored = signal.getsignal(signal.SIGTERM) is handler
    launches = {k: c.launches for k, c in counters.items()}
    a = dict(straight["params"].named_parameters())
    b = dict(resumed["params"].named_parameters())
    param_max_diff = max(float((a[n] - b[n]).detach().float().abs().max())
                         for n in a)
    bitwise = all(torch.equal(a[n], b[n]) for n in a) and all(
        torch.equal(straight["opt"][k][n], resumed["opt"][k][n])
        for k in ("m", "v") for n in a)
    del resumed, b
    # the eval: its certificate against the set's full mean clipped loss
    rep, eval_s, model, _ = reports[0]
    full = full_eval_mean(torch, np, model, straight["params"],
                          rep.loss_clip, int(args[args.index("--seq-len")
                                                   + 1]))
    covers = rep.lo <= full["mean"] <= rep.hi
    # one step's gradients through compress_roundtrip, card and CPU
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.tokens import train_batch
    cfg = model.cfg
    lm = straight["params"]
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        cfg, ShapeConfig("cli", 1024, 8, "train"), 0).items()}
    loss, _ = model.loss(lm, batch)
    names = [n for n, _ in lm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        lm.parameters()))))
    del loss, batch
    t0 = time.perf_counter()
    dq, fb = gc.compress_roundtrip(grads, gc.init_error_feedback(grads))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = {n: g.cpu() for n, g in grads.items()}
    t0 = time.perf_counter()
    dq_c, fb_c = gc.compress_roundtrip(cpu, gc.init_error_feedback(cpu))
    cpu_s = time.perf_counter() - t0
    differ = [n for n in names if not (torch.equal(dq[n].cpu(), dq_c[n])
                                       and torch.equal(fb[n].cpu(), fb_c[n]))]
    compress_bitwise = not differ
    del grads, dq, fb, cpu, dq_c, fb_c, straight, lm, reports
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    stray = [k for k, v in launches.items() if v]
    ok = (bitwise and losses[0][-1] == losses[1][-1] and covers
          and rep.stopped_early and handler_restored and compress_bitwise
          and steps_saved == [f"step_{DRIVER_CKPT_EVERY * i:08d}" for i in
                              (1, 2)]
          and len(losses[0]) == DRIVER_STEPS
          and len(losses[1]) == DRIVER_STEPS - DRIVER_CKPT_EVERY
          and all(np.isfinite(losses[0])) and not stray)
    return dict(
        arch=DRIVER_ARCH, argv=args, straight_s=straight_s,
        resumed_s=resumed_s, steps_saved=steps_saved,
        straight_losses=losses[0], resumed_losses=losses[1],
        resumed_param_max_abs_diff=param_max_diff,
        resumed_state_bitwise=bitwise,
        eval=dict(report_dict(rep), eval_s=eval_s, full_mean=full["mean"],
                  full_pass_s=full["seconds"], certificate_covers=covers),
        compress=dict(bitwise=compress_bitwise, card_s=card_s, cpu_s=cpu_s,
                      leaves=len(names), leaves_differing=differ[:8]),
        sigterm_handler_restored=handler_restored, launches=launches,
        reduced={"n_layers": f"28 -> {DRIVER_LAYERS} (the smoke's time)",
                 "steps": f"a run of 200 (the driver's default) -> "
                          f"{DRIVER_STEPS} (8 before), a checkpoint "
                          f"every {DRIVER_CKPT_EVERY}, and "
                          f"{DRIVER_STEPS - DRIVER_CKPT_EVERY} resumed"},
        ok=bool(ok)), launches


# Phase 6f: the multi-card layout. qwen3-0.6b at full width, cut to
# LAYOUT_LAYERS of its 28 layers, float32 (as the reference's
# distributed worker runs), AdamW at that worker's lr 1e-2 (warm-up 2 of
# 20 steps), LAYOUT_BATCH x LAYOUT_LEN tokens (of train_4k's 256 x 4096:
# the phase's time and four ranks' memory on one card).
LAYOUT_ARCH = "qwen3_0_6b"
LAYOUT_LAYERS = 2      # cut from 4 for the smoke's time
LAYOUT_BATCH, LAYOUT_LEN = 8, 512
LAYOUT_RANKS = 4
LAYOUT_MESHES = ((2, 2), (4, 1))
LAYOUT_JOIN_TIMEOUT_S = 400
# the reference worker's tolerances (tests/helpers/dist_train_worker.py):
# loss 1e-4; parameters rtol 2e-4, atol 2e-5; the moments within 2e-4 of
# their leaf's largest
LAYOUT_LOSS_TOL, LAYOUT_RTOL, LAYOUT_ATOL = 1e-4, 2e-4, 2e-5
# full-size dry-run cells (both production meshes), run beside the gloo
# ranks: every id's decode_32k, both long_500k, four prefill_32k (the
# enc-dec's tensor-parallel encoder and decoder; dbrx's experts; arctic's
# 56 q heads over 16 "model" ranks, blocks of whole and split heads) and
# one train_4k, the cells whose meta step takes seconds (it is
# host-bound: zamba2's and falcon-mamba's train_4k and prefill_32k take
# 4-6 min)
LAYOUT_DRYRUN_CELLS = (
    ("qwen3_0_6b", "train_4k"),
    ("qwen3_0_6b", "prefill_32k"), ("seamless_m4t_large_v2", "prefill_32k"),
    ("dbrx_132b", "prefill_32k"), ("arctic_480b", "prefill_32k"),
    ("zamba2_7b", "long_500k"), ("falcon_mamba_7b", "long_500k")) + tuple(
    (a, "decode_32k") for a in (
        "seamless_m4t_large_v2", "stablelm_1_6b", "qwen2_5_3b",
        "phi3_mini_3_8b", "qwen3_0_6b", "dbrx_132b", "arctic_480b",
        "zamba2_7b", "pixtral_12b", "falcon_mamba_7b"))


def layout_setup(torch):
    """Phase 6f's config, model, optimizer settings and batch shape."""
    from repro_torch.configs import ShapeConfig, get
    from repro_torch.models import build
    from repro_torch.train import OptConfig
    cfg = dataclasses.replace(get(LAYOUT_ARCH), n_layers=LAYOUT_LAYERS,
                              param_dtype="float32", compute_dtype="float32",
                              remat=False)
    ocfg = OptConfig.for_arch(cfg, lr=1e-2, warmup_steps=2, total_steps=20)
    shape = ShapeConfig("layout", LAYOUT_LEN, LAYOUT_BATCH, "train")
    return cfg, build(cfg), ocfg, shape


# step_cost's peak prediction against the card's max_memory_allocated
LAYOUT_PEAK_TOL = 0.10


def layout_meta_step(torch, mshape):
    """``(run, inputs)`` of the sharded step of phase 6f's config on meta
    tensors, as rank 0 of the default group (a ``fake`` one) on a mesh
    of shape ``mshape``: the prediction's program."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_batch
    from repro_torch.train import abstract_state
    from repro_torch.train.trainer import build_sharded_train_step
    cfg, model, ocfg, shape = layout_setup(torch)
    mesh = make_host_mesh(mshape, ("data", "model"), device_type="cpu")
    abstract = abstract_state(model, ocfg)
    spec = dryrun.state_spec(cfg, mesh, abstract, ocfg)
    state = sh.distribute(mesh, spec, abstract)
    batch = make_batch(cfg, shape, seed=0, device="meta")
    step = build_sharded_train_step(model, ocfg, mesh, spec,
                                    sh.batch_specs(cfg, mesh, shape, batch))
    return (lambda: step(state, batch)), (state, batch)


def storage_bytes(torch, tree) -> int:
    """Bytes of the distinct storages under a state / batch tree (a
    DTensor by its shard)."""
    seen = {}
    for _, t in _layout_leaves(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        st = t.untyped_storage()
        seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def _layout_leaves(state) -> list:
    """``[(name, tensor)]`` of a train state: ``params/<n>``, ``opt/m/<n>``,
    ``opt/v/<n>``, ``step``."""
    out = []

    def walk(t, prefix):
        if hasattr(t, "named_parameters"):
            t = dict(t.named_parameters())
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            out.append((prefix[:-1], t))
    walk(state, "")
    return out


def _hold_to_single(torch, ref, name, got, fails, worst, idx):
    """This rank's shard ``got`` (slices ``idx``) of one leaf of the
    sharded state against the single-card step's: parameters within
    rtol / atol, moments within ``LAYOUT_RTOL`` of the leaf's largest."""
    whole = ref[name]
    want = whole[idx].to(got.device)
    if name == "step":
        if not torch.equal(got.to(want.dtype), want):
            fails.append(name)
        return
    err = float((got.float() - want.float()).abs().max())
    top = max(float(whole.float().abs().max()), 1e-30)
    if name.startswith("params/"):
        ok = bool(torch.allclose(got.float(), want.float(), rtol=LAYOUT_RTOL,
                                 atol=LAYOUT_ATOL))
    else:
        ok = err <= LAYOUT_RTOL * top
    key = name.split("/")[0] if name.startswith("params") else name[:5]
    worst[key] = max(worst.get(key, 0.0), err / top)
    if not ok:
        fails.append(dict(leaf=name, max_abs=err, leaf_max=top))


def _shard_crcs(torch, sh, state, mesh) -> dict:
    """``{leaf: [slice bounds, crc32]}`` of this rank's shards."""
    import zlib
    out = {}
    for name, t in _layout_leaves(state):
        spec = sh.spec_of(mesh, t.placements, t.dim())
        idx = sh.shard_slices(mesh, spec.padded(t.dim()), t.shape,
                              mesh.get_coordinate())
        loc = t.to_local().detach().reshape(-1).contiguous()
        out[name] = [[[x.start, x.stop] for x in idx], zlib.crc32(
            loc.view(torch.uint8).cpu().numpy().tobytes())]
    return out


def layout_rank_main(a: dict) -> None:
    """Phase 6f's gloo rank ``a["rank"]`` of ``LAYOUT_RANKS`` on the card
    (spawned): the sharded step on a (2, 2) mesh held to the single-card
    step (``a["ref"]``, rank 0 compares), its shards' checksums and
    bytes, the elastic checkpoint onto (4, 1) and one more step on each
    layout. Writes its record to ``a["out"]``."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path[:0] = [p for p in a["sys_path"] if p not in sys.path]
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_batch
    from repro_torch.train import abstract_state, init_state
    from repro_torch.train.trainer import build_sharded_train_step
    rank = a["rank"]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    dist.init_process_group(
        "gloo", store=dist.FileStore(a["store"], LAYOUT_RANKS), rank=rank,
        world_size=LAYOUT_RANKS,
        timeout=datetime.timedelta(seconds=a["group_timeout_s"]))
    rec = dict(rank=rank, fails=[])
    cfg, model, ocfg, shape = layout_setup(torch)
    batch = make_batch(cfg, shape, seed=0, device=dev)
    abstract = abstract_state(model, ocfg)
    states, steps, specs = {}, {}, {}
    for mshape in LAYOUT_MESHES:
        mesh = make_host_mesh(mshape, ("data", "model"))
        specs[mshape] = (mesh, dryrun.state_spec(cfg, mesh, abstract, ocfg))
    mesh, spec = specs[LAYOUT_MESHES[0]]
    state = sh.distribute(mesh, spec, init_state(model, MODEL_SEED, ocfg,
                                                 device=dev))
    torch.cuda.empty_cache()
    bspec = sh.batch_specs(cfg, mesh, shape, batch)
    step = build_sharded_train_step(model, ocfg, mesh, spec, bspec)
    rec["init_s"] = time.perf_counter() - t_start
    c0 = coll.tally()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    rec["step_s"] = time.perf_counter() - t0
    rec["collectives"] = coll.tally(since=c0)
    rec["loss"], rec["grad_norm"] = float(met["loss"]), float(
        met["grad_norm"])
    # each rank holds its shards to the same slices of the single-card
    # step's state (no gather)
    t0 = time.perf_counter()
    ref = torch.load(a["ref"], mmap=True)
    worst = {}
    for name, t in _layout_leaves(state):
        leaf_spec = sh.spec_of(mesh, t.placements, t.dim())
        idx = sh.shard_slices(mesh, leaf_spec.padded(t.dim()), t.shape,
                              mesh.get_coordinate())
        _hold_to_single(torch, ref, name, t.to_local(), rec["fails"], worst,
                        idx)
    d = abs(rec["loss"] - float(ref["metrics/loss"]))
    rec["loss_diff"], rec["max_rel_err"] = d, worst
    if d >= LAYOUT_LOSS_TOL:
        rec["fails"].append(dict(check="loss", diff=d))
    del ref
    rec["compare_s"] = time.perf_counter() - t0
    rec["crc_22"] = _shard_crcs(torch, sh, state, mesh)
    # bytes: this rank's shards against the dry run's accounting
    local = dryrun.tree_bytes({k: state[k] for k in ("params", "opt")})
    want = (dryrun.device_bytes(mesh, spec["params"], abstract["params"])
            + dryrun.device_bytes(mesh, spec["opt"], abstract["opt"]))
    rec["bytes_22"] = dict(local=local, dryrun=want)
    # the elastic checkpoint: saved from (2, 2) (rank 0 writes on a
    # thread while the ranks take the next (2, 2) step), restored onto
    # (4, 1)
    t0 = time.perf_counter()
    join = ckpt.save_checkpoint(a["ckpt"], 1, state, spec_tree=spec,
                                async_write=True)
    rec["save_gather_s"] = time.perf_counter() - t0
    state, m1 = step(state, batch)
    join()
    rec["save_s"] = time.perf_counter() - t0
    mesh2, spec2 = specs[LAYOUT_MESHES[1]]
    t0 = time.perf_counter()
    restored, _ = ckpt.restore_checkpoint(a["ckpt"], 1, abstract,
                                          mesh=mesh2, spec_tree=spec2)
    rec["restore_s"] = time.perf_counter() - t0
    local2 = dryrun.tree_bytes({k: restored[k] for k in ("params", "opt")})
    want2 = (dryrun.device_bytes(mesh2, spec2["params"], abstract["params"])
             + dryrun.device_bytes(mesh2, spec2["opt"], abstract["opt"]))
    rec["bytes_41"] = dict(local=local2, dryrun=want2)
    step2 = build_sharded_train_step(model, ocfg, mesh2, spec2,
                                     sh.batch_specs(cfg, mesh2, shape, batch))
    t0 = time.perf_counter()
    restored, m2 = step2(restored, batch)
    torch.cuda.synchronize()
    rec["step_41_s"] = time.perf_counter() - t0
    rec["elastic_losses"] = [float(m1["loss"]), float(m2["loss"])]
    rec["crc_41"] = _shard_crcs(torch, sh, restored, mesh2)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["rank_s"] = time.perf_counter() - t_start
    Path(a["out"], f"layout{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def layout_nccl_world1(torch, host: dict, store: str) -> dict:
    """Phase 6f's NCCL check, in this process: the sharded step in a
    group of one rank on a (1, 1) mesh against the single-card step's
    state (``host``), leaf by leaf; the group is left after."""
    import datetime
    import torch.distributed as dist
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_batch
    from repro_torch.train import abstract_state, init_state
    from repro_torch.train.trainer import build_sharded_train_step
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(store, 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=capped(SHARD_GROUP_TIMEOUT_S)))
    try:
        cfg, model, ocfg, shape = layout_setup(torch)
        batch = make_batch(cfg, shape, seed=0, device=dev)
        mesh = make_host_mesh((1, 1), ("data", "model"))
        spec = dryrun.state_spec(cfg, mesh, abstract_state(model, ocfg),
                                 ocfg)
        state = sh.distribute(mesh, spec, init_state(model, MODEL_SEED,
                                                     ocfg, device=dev))
        step = build_sharded_train_step(model, ocfg, mesh, spec,
                                        sh.batch_specs(cfg, mesh, shape,
                                                       batch))
        inputs = storage_bytes(torch, {"state": state, "batch": batch})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        rec = dict(world=1, backend=dist.get_backend(),
                   step_s=time.perf_counter() - t0, loss=float(met["loss"]),
                   memory=dict(max_memory_allocated=peak,
                               allocated_before=base, input_bytes=inputs,
                               # the process's other tensors on the card
                               other_bytes=base - inputs,
                               step_peak_bytes=peak - (base - inputs)))
        differ, worst = [], 0.0
        for name, t in _layout_leaves(state):
            got = t.to_local()
            want = host[name].to(dev)
            if not torch.equal(got.reshape(want.shape).to(want.dtype),
                               want):
                differ.append(name)
                worst = max(worst, float((got.float() - want.float())
                                         .abs().max()))
        rec["loss_bitwise"] = rec["loss"] == float(host["metrics/loss"])
        rec["leaves_differing"], rec["max_abs_diff"] = differ[:8], worst
        rec["bitwise"] = not differ and rec["loss_bitwise"]
        del state, step, batch
        torch.cuda.empty_cache()
        return rec
    finally:
        dist.destroy_process_group()


def layout_flops_on_card(torch, model, ocfg, cfg, shape) -> dict:
    """One single-card step of phase 6f's config from a fresh state,
    under :func:`step_cost.analyze` with ``FlopCounterMode`` inside it:
    both counts and the step's seconds (under both modes)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import step_cost
    from repro_torch.models import make_batch
    from repro_torch.train import build_train_step, init_state
    state = init_state(model, MODEL_SEED, ocfg, device="cuda")
    batch = make_batch(cfg, shape, seed=0, device="cuda")
    step = build_train_step(model, ocfg)
    counted = {}

    def run():
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
        counted["flops"] = int(fc.get_total_flops())
    t0 = time.perf_counter()
    cost = step_cost.analyze(run, inputs=(state, batch))
    torch.cuda.synchronize()
    out = dict(step_cost=cost["flops"], flop_counter_mode=counted["flops"],
               s=time.perf_counter() - t0, peak_bytes=cost["peak_bytes"])
    del state, batch, step
    torch.cuda.empty_cache()
    return out


def layout_dryrun_main(a: dict) -> None:
    """Phase 6f's dry runs (spawned: a ``fake``-backend group of 256, then
    512 ranks): ``LAYOUT_DRYRUN_CELLS`` at full size on both meshes, on
    meta, then ``dryrun_aqp`` on both meshes on the card (``block_agg``
    launched): the card is touched last, once ``a["card_free"]`` is set
    (phase 6c, which runs beside it, has freed it)."""
    t_begin = time.perf_counter()
    import torch
    sys.path[:0] = [p for p in a["sys_path"] if p not in sys.path]
    from repro_torch.launch import dryrun, dryrun_aqp, step_cost
    # step_cost's predictions of the ranks' and NCCL's sharded steps, on
    # meta in fake groups of their sizes, as rank 0
    t0 = time.perf_counter()
    pred = {}
    for world, mshape in ((LAYOUT_RANKS, LAYOUT_MESHES[0]), (1, (1, 1))):
        dryrun.join_fake_group(world)
        run, inputs = layout_meta_step(torch, mshape)
        pred[world] = step_cost.analyze(run, inputs=inputs)
        del run, inputs
    pred_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cells = dryrun.run_cells(list(LAYOUT_DRYRUN_CELLS), [False, True],
                             log=lambda s: None)
    for c in cells:
        c.pop("trace", None)
        c.pop("null_reason", None)
    cells_s = time.perf_counter() - t0
    left = a["wait_s"] - (time.perf_counter() - t_begin)
    if not a["card_free"].wait(None if left == float("inf")
                               else max(left, 1.0)):
        raise RuntimeError("the card was not freed by the deadline")
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    aqp = [dryrun_aqp.run(mp, device="cuda") for mp in (False, True)]
    aqp_s = time.perf_counter() - t0
    Path(a["out"], "layout_dryrun.json").write_text(json.dumps(dict(
        aqp=aqp, aqp_s=aqp_s, cells=cells, pred=pred, pred_s=pred_s,
        cells_s=cells_s)))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _stop(proc) -> None:
    """End a spawned process that is still running."""
    if proc.is_alive():
        proc.terminate()
        proc.join(10)
        if proc.is_alive():
            proc.kill()
            proc.join()


def start_layout_dryruns(card_free: bool = True):
    """Phase 6f's dry-run process (host-bound: meta steps), spawned ahead
    of the phase (before phase 5) so that it runs beside the phases
    before it too. It touches the card only once the returned event is
    set (at once with ``card_free``), waiting no later than the run's
    deadline. Returns ``(process, its start time, the event)``."""
    import shutil
    import torch.multiprocessing as tmp
    work = ROOT / "build" / "smoke_layout"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = tmp.get_context("spawn")
    free = ctx.Event()
    if card_free:
        free.set()
    dry = ctx.Process(
        target=layout_dryrun_main,
        args=(dict(out=str(work), sys_path=list(sys.path), card_free=free,
                   wait_s=time_left()),))
    dry.start()
    return dry, time.perf_counter(), free


def layout_phase(torch, np, counters, dry=None):
    """Phase 6f: the multi-card layout on one card. The single-card step
    here (its result written for the ranks), then four spawned gloo ranks
    (the sharded step, replicas, bytes, the elastic checkpoint) beside a
    spawned dry-run process (``dry``, from :func:`start_layout_dryruns`,
    started here when not given), then NCCL in a group of one rank here.
    Returns (record, launches): ``launches`` the dry-run process's
    ``block_agg`` launches (this process moves no kernel counter)."""
    import shutil
    import torch.multiprocessing as tmp
    from repro_torch.models import make_batch
    from repro_torch.train import build_train_step, init_state
    ctx = tmp.get_context("spawn")
    work = ROOT / "build" / "smoke_layout"
    # the dry runs (host-bound) start first and run beside everything
    dry, t_dry, _ = dry or start_layout_dryruns()
    fails, rec = [], {}
    for c in counters.values():
        c.launches = 0
    base = dict(store=str(work / "store"), out=str(work),
                ref=str(work / "single_step.pt"), ckpt=str(work / "ckpt"),
                sys_path=list(sys.path))
    try:
        t0 = time.perf_counter()
        cfg, model, ocfg, shape = layout_setup(torch)
        state = init_state(model, MODEL_SEED, ocfg, device="cuda")
        batch = make_batch(cfg, shape, seed=0, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, met = build_train_step(model, ocfg)(state, batch)
        torch.cuda.synchronize()
        rec["single_step_s"] = time.perf_counter() - t1
        rec["single_loss"] = float(met["loss"])
        rec["params"] = sum(p.numel()
                            for p in state["params"].parameters())
        host = {n: t.detach().cpu() for n, t in _layout_leaves(state)}
        host["metrics/loss"] = met["loss"].detach().cpu()
        torch.save(host, work / "single_step.pt")
        del state, met, batch
        torch.cuda.empty_cache()
        rec["single_s"] = time.perf_counter() - t0
        # step_cost's FLOPs of a fresh single-card step on the card
        # against FlopCounterMode's count of the same call
        rec["flops_on_card"] = layout_flops_on_card(torch, model, ocfg,
                                                    cfg, shape)
        if rec["flops_on_card"]["step_cost"] != \
                rec["flops_on_card"]["flop_counter_mode"]:
            fails.append(dict(check="step_cost FLOPs on the card",
                              **rec["flops_on_card"]))
        # the gloo ranks, beside the dry runs
        t0 = time.perf_counter()
        codes = _spawn_ranks(
            ctx, layout_rank_main,
            [dict(base, rank=r, group_timeout_s=capped(SHARD_GROUP_TIMEOUT_S))
             for r in range(LAYOUT_RANKS)],
            LAYOUT_JOIN_TIMEOUT_S, "layout", fails)
        rec["ranks_wall_s"] = time.perf_counter() - t0
    except BaseException:   # stopped, whatever ended the phase
        _stop(dry)
        raise
    join_all([dry], LAYOUT_JOIN_TIMEOUT_S - (time.perf_counter() - t_dry),
             "layout", fails)
    rec["dryrun_wall_s"] = time.perf_counter() - t_dry
    rec["rank_exit_codes"], rec["dryrun_exit_code"] = codes, dry.exitcode
    shutil.rmtree(work / "ckpt", ignore_errors=True)
    if codes != [0] * LAYOUT_RANKS:
        fails.append(dict(part="gloo ranks", exit_codes=codes))
    else:
        ranks = [json.loads((work / f"layout{r}.json").read_text())
                 for r in range(LAYOUT_RANKS)]
        for r in ranks:
            fails += [dict(rank=r["rank"], fail=f) for f in r["fails"]]
            for key in ("bytes_22", "bytes_41"):
                if r[key]["local"] != r[key]["dryrun"]:
                    fails.append(dict(rank=r["rank"], bytes=key, **r[key]))
        a, b = ranks[0]["elastic_losses"]
        if abs(a - b) >= LAYOUT_LOSS_TOL:
            fails.append(dict(check="elastic losses", losses=[a, b]))
        rank0 = next(r for r in ranks if r["rank"] == 0)
        for key in ("crc_22", "crc_41"):
            seen = {}
            for r in ranks:
                for leaf, (bounds, crc) in r[key].items():
                    seen.setdefault((leaf, str(bounds)), set()).add(crc)
            drift = [k for k, v in seen.items() if len(v) > 1]
            rec[f"replicas_{key[4:]}"] = dict(
                slices=len(seen), held_by_more_than_one=sum(
                    1 for r in ranks for _ in r[key]) - len(seen),
                differing=len(drift))
            if drift:
                fails.append(dict(check=f"replicas {key}", leaves=drift[:4]))
        if len({tuple(r["elastic_losses"]) for r in ranks}) != 1 or len(
                {r["loss"] for r in ranks}) != 1:
            fails.append(dict(check="ranks report the same losses"))
        rec["ranks"] = [{k: v for k, v in r.items()
                         if not k.startswith("crc_")} for r in ranks]
    pred = None
    if dry.exitcode != 0:
        fails.append(dict(part="dry runs", exit_code=dry.exitcode))
    else:
        d = json.loads((work / "layout_dryrun.json").read_text())
        rec["dryrun_aqp"] = d["aqp"]
        rec["dryrun_aqp_s"], rec["dryrun_cells_s"] = d["aqp_s"], d["cells_s"]
        pred, rec["predictions_s"] = d["pred"], d["pred_s"]
        rec["dryrun_cells"] = [
            {k: c.get(k) for k in ("arch", "shape", "mesh", "ok", "error",
                                   "flops", "step_s", "layout_s",
                                   "collective_bytes")}
            | {k: c.get("memory", {}).get(k) for k in (
                "state_bytes_per_device", "temp_bytes",
                "peak_bytes_per_device")}
            | {"step_cost_scope": c.get("step_cost", {}).get("scope")}
            for c in d["cells"]]
        # every cell per device: the serving cells through the sharded
        # prefill / decode
        bad = [c for c in d["cells"] if not c["ok"] or c.get(
            "step_cost", {}).get("scope") != "per_device" or any(
            c["memory"].get(k) is None
            for k in ("temp_bytes", "peak_bytes_per_device"))
            or c.get("collective_bytes") is None]
        covered = ({c["arch"] for c in d["cells"]},
                   {c["shape"] for c in d["cells"]})
        if bad or len(covered[0]) != 10 or len(covered[1]) != 4:
            fails.append(dict(check="dry-run cells", failed=bad[:3],
                              ids=len(covered[0]), shapes=len(covered[1])))
        if any(r["block_agg_launches"] < 1 for r in d["aqp"]):
            fails.append(dict(check="dryrun_aqp launched no block_agg"))
        # block_agg's report carries phase 2's bound bytes for its shape
        # (one block of the rank's rows, every lane valid)
        reports = [dict(mesh=r["mesh"], want=fold_bytes(
            r["rows_per_device"], 1, r["groups"]),
            got=r["step_cost"]["kernels"].get("block_agg", {}).get("bytes"))
            for r in d["aqp"]]
        rec["block_agg_report"] = reports
        if any(x["got"] != x["want"] for x in reports):
            fails.append(dict(check="block_agg report bytes", rows=reports))
        # the gloo ranks' collectives against the meta prediction
        if codes == [0] * LAYOUT_RANKS:
            p4 = pred[str(LAYOUT_RANKS)]
            got = {k: rank0["collectives"][k] for k in ("calls", "bytes")}
            want = dict(calls=sum(c["count"] for c in
                                  p4["collectives"].values()),
                        bytes=p4["collective_bytes"])
            rec["collectives_predicted"] = dict(
                rank0=got, step_cost=want, kinds=p4["collectives"])
            if got != want:
                fails.append(dict(check="collectives against step_cost",
                                  rank0=got, step_cost=want))
    launches = {k: 0 for k in counters}
    launches["block_agg"] = sum(r["block_agg_launches"]
                                for r in rec.get("dryrun_aqp", []))
    # NCCL in a group of one rank (this process)
    t0 = time.perf_counter()
    rec["nccl_world1"] = layout_nccl_world1(torch, host,
                                            str(work / "store_nccl"))
    rec["nccl_wall_s"] = time.perf_counter() - t0
    if pred is not None:
        # step_cost's peak of the same step on meta (fake group of one)
        mem = rec["nccl_world1"]["memory"]
        want = pred["1"]["peak_bytes"]
        gap = want / mem["step_peak_bytes"] - 1.0
        rec["peak_predicted"] = dict(
            step_cost_peak_bytes=want,
            step_cost_temp_bytes=pred["1"]["temp_bytes"],
            card_step_peak_bytes=mem["step_peak_bytes"],
            card_max_memory_allocated=mem["max_memory_allocated"],
            gap=gap, tol=LAYOUT_PEAK_TOL)
        if abs(gap) > LAYOUT_PEAK_TOL:
            fails.append(dict(check="peak against step_cost",
                              **rec["peak_predicted"]))
    del host
    stray = [k for k in counters if counters[k].launches]
    if stray:
        fails.append(dict(check="kernel counters moved here", kernels=stray))
    shutil.rmtree(work, ignore_errors=True)
    rec["fails"] = fails
    rec["reduced"] = {
        "layers": f"28 -> {LAYOUT_LAYERS}",
        "tokens": f"train_4k's 256 x 4096 -> {LAYOUT_BATCH} x {LAYOUT_LEN}",
        "why": "the phase's time and four ranks' memory on one card",
        "dryrun_cells": f"{len(LAYOUT_DRYRUN_CELLS)} of the 32 (arch, "
                        "shape) cells: every id and shape once or more"}
    rec["ok"] = not fails
    return rec, launches


# -- phase 6g ----------------------------------------------------------------

# Phase 6g: the sharded serving steps, tensor parallel over "model".
# Each run: (arch, layers, mesh), float32 at full width (cut in depth),
# a batch of SERVE_SHARD_BATCH x SERVE_SHARD_LEN prompt positions, then
# SERVE_SHARD_STEPS teacher-forced decode steps at a card-tensor
# position. qwen2.5-3b's 2 kv heads divide the (2, 2) mesh's 2 "model"
# ranks (the heads rule) and not the (1, 4) mesh's 4 (the sequence
# rule: its kv projections whole, its q heads cut); falcon-mamba-7b cuts
# its Mamba1 channels and launches the selective-scan kernel on
# d_inner / 2 of them in each rank's prefill; zamba2-7b cuts its Mamba2
# heads and its shared attention's 32 kv heads; dbrx-132b cuts its 16
# experts four ways (expert parallel) and its 8 kv heads.
SERVE_SHARD_RUNS = (("qwen2_5_3b", 4, (2, 2)), ("qwen2_5_3b", 4, (1, 4)),
                    ("falcon_mamba_7b", 4, (2, 2)), ("zamba2_7b", 7, (1, 4)),
                    ("dbrx_132b", 2, (1, 4)))
SERVE_SHARD_BATCH, SERVE_SHARD_LEN, SERVE_SHARD_STEPS = 8, 2048, 32
SERVE_SHARD_RANKS = 4
SERVE_SHARD_JOIN_TIMEOUT_S = 600
# logits against the single-card run, relative to the largest: float32
# on the card; a sharded step differs from the single-card one only in
# the order of some sums (the heads' matmuls of other shapes, the
# sequence rule's softmax merged from four partials)
SERVE_SHARD_TOL = 1e-4
SERVE_SHARD_PEAK_TOL = 0.10


def serve_shard_wide_matmul(torch) -> dict:
    """A tensor-parallel rank's bfloat16 partial product
    (``layers.wide_matmul``: a bf16 GEMM accumulating and writing
    float32) at qwen2.5-3b's ``w_down`` cut on (1, 4), 8 x 2048 rows,
    against the same product of float32 copies of the operands: within
    1e-5 of the largest, with the time and the peak above the inputs of
    each (Timer: median of 5 calls)."""
    from repro_torch.configs import get
    from repro_torch.models.layers import wide_matmul
    cfg = get("qwen2_5_3b")
    g = torch.Generator(device="cuda").manual_seed(MODEL_SEED)
    ff = cfg.d_ff // 4
    x = torch.randn((SERVE_SHARD_BATCH, SERVE_SHARD_LEN, ff), generator=g,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn((ff, cfg.d_model), generator=g, device="cuda")
         / ff ** 0.5).to(torch.bfloat16)
    fns = {"wide": lambda: wide_matmul(x, w),
           "widened": lambda: x.float() @ w.float()}
    out, got = {}, {}
    timer = Timer(torch)
    for name, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got[name] = fn()
        torch.cuda.synchronize()
        out[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        out[f"{name}_ms"] = timer(fn, reps=5)
    del timer
    err = float((got["wide"] - got["widened"]).abs().max())
    largest = float(got["widened"].abs().max())
    out.update(shape=[list(x.shape), list(w.shape)],
               out_dtype=str(got["wide"].dtype), max_abs_err=err,
               largest=largest,
               ok=got["wide"].dtype == torch.float32
               and err <= 1e-5 * largest)
    del x, w, got
    torch.cuda.empty_cache()
    return out


def serve_shard_model(torch, arch: str, layers: int):
    """A 6g run's float32 config (the Mamba1 scan on its kernel) and
    model."""
    from repro_torch.configs import get
    from repro_torch.models import build
    cfg = dataclasses.replace(get(arch), n_layers=layers,
                              param_dtype="float32", compute_dtype="float32")
    if cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, ssm_impl="pallas")
    return cfg, build(cfg)


def serve_shard_inputs(torch, np, cfg, dev):
    """The prompt batch ``{"tokens"}`` (B, SERVE_SHARD_LEN) and the
    decode steps' tokens (B, SERVE_SHARD_STEPS), from MODEL_SEED."""
    rng = np.random.default_rng(MODEL_SEED)
    shape = (SERVE_SHARD_BATCH, SERVE_SHARD_LEN + SERVE_SHARD_STEPS)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, shape)).to(dev)
    return {"tokens": toks[:, :SERVE_SHARD_LEN]}, toks[:, SERVE_SHARD_LEN:]


def serve_shard_steps(torch, decode, toks, cache, start: int = 0):
    """Decode steps ``start`` .. SERVE_SHARD_STEPS - 1 of ``decode(cache,
    batch)`` (token ``toks[:, i]`` at position SERVE_SHARD_LEN + i, a
    0-d card tensor: no host read). Returns (logits (B, steps, V), cache,
    each step's seconds)."""
    out, secs = [], []
    for i in range(start, SERVE_SHARD_STEPS):
        pos = torch.tensor(SERVE_SHARD_LEN + i, dtype=torch.int32,
                           device=toks.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(cache, {"token": toks[:, i:i + 1],
                                       "pos": pos})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out.append(logits)
    return torch.cat(out, dim=1), cache, secs


def serve_shard_single(torch, np, arch: str, layers: int, path) -> dict:
    """The single-card prefill (with room for the steps) and the decode
    steps of ``arch`` at ``layers``: its logits and final cache written
    to ``path`` for the ranks; returns the times and, on the host, the
    logits and cache for the NCCL check."""
    from repro_torch.models.zoo import cache_with_room
    cfg, model = serve_shard_model(torch, arch, layers)
    lm = model.init(MODEL_SEED, device="cuda")
    pre, toks = serve_shard_inputs(torch, np, cfg, "cuda")
    model.prefill(lm, pre)     # warm-up: the first kernels of these shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(lm, pre)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache = cache_with_room(cfg, cache, SERVE_SHARD_LEN + SERVE_SHARD_STEPS)
    steps, cache, secs = serve_shard_steps(
        torch, lambda c, b: model.decode(lm, c, b), toks, cache)
    host = {"logits": torch.cat([logits, steps], dim=1).cpu(),
            "cache": {k: ({n: t.cpu() for n, t in v.items()}
                          if isinstance(v, dict) else v.cpu())
                      for k, v in cache.items()}}
    torch.save(host, path)
    del lm, cache, logits, steps
    torch.cuda.empty_cache()
    return dict(prefill_s=prefill_s, decode_ms=1e3 * statistics.median(
        secs[1:]), first_decode_ms=1e3 * secs[0], host=host)


def _tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _serve_inputs_bytes(torch, trees) -> int:
    """Bytes of the distinct storages of DTensor shards, tensors and
    modules in ``trees``."""
    seen = {}
    for tree in trees:
        if hasattr(tree, "parameters"):
            leaves = list(tree.parameters())
        elif isinstance(tree, dict):
            leaves = [v for _, v in _tree_leaves(tree)]
        else:
            leaves = [tree]
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            t = t.to_local() if hasattr(t, "to_local") else t
            st = t.untyped_storage()
            seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def model_cut_bytes(torch, cfg, mesh_shape, pspec) -> dict:
    """What a rank of a ``("data", "model")`` mesh of ``mesh_shape``
    holds and moves to hold it, from ``param_specs`` (``pspec``): the
    bytes of its leaves' ``"model"`` cuts (``held``), the all-gathers
    over ``"data"`` of the leaves ``"data"`` cuts (their shards' bytes)
    and the all-to-alls over ``"model"`` of the leaves with a dim cut
    over both (their cuts' bytes): ``[count, bytes]`` each."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build
    rows, cols = mesh_shape
    sizes = {"data": rows, "model": cols}
    out = {"held": 0, "all-gather": [0, 0], "all-to-all": [0, 0]}
    for name, p in build(cfg).init(0, device="meta").named_parameters():
        axes = [sh._axes(e) for e in pspec[name]]
        n = p.numel() * p.element_size()
        cut = n // math.prod(cols for a in axes if "model" in a)
        out["held"] += cut
        if rows > 1 and any("data" in a for a in axes):
            out["all-gather"][0] += 1
            out["all-gather"][1] += n // math.prod(
                sizes[x] for a in axes for x in a)
        if rows > 1 and cols > 1 and any({"data", "model"} <= set(a)
                                         for a in axes):
            out["all-to-all"][0] += 1
            out["all-to-all"][1] += cut
    return out


def _peak_of(torch, call, inputs) -> tuple:
    """``call()`` with the card's peak reset just before: (its result,
    the peak less the process's other tensors, i.e. the peak that the
    call's inputs and temporaries reached)."""
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - inputs
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - other


def serve_shard_rank_main(a: dict) -> None:
    """Phase 6g's gloo rank ``a["rank"]`` of ``SERVE_SHARD_RANKS`` on the
    card (spawned): each run of SERVE_SHARD_RUNS, its weights drawn (the
    ranks in turns: one card's memory holds one whole model at a time)
    and laid out by their specs, its ``"model"`` cut loaded, then its
    sharded prefill (the ranks together: their partial sums meet in
    all-reduces) and decode steps held to the single-card run's file.
    Writes its record to ``a["out"]``."""
    import datetime
    import zlib
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path[:0] = [p for p in a["sys_path"] if p not in sys.path]
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as kscan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_batch
    from repro_torch.models.zoo import build_sharded_serve
    rank = a["rank"]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(a["store"], SERVE_SHARD_RANKS),
        rank=rank, world_size=SERVE_SHARD_RANKS,
        timeout=datetime.timedelta(seconds=a["group_timeout_s"]))
    runs = []

    def crc(t):
        return zlib.crc32(t.detach().contiguous().reshape(-1).view(
            torch.uint8).cpu().numpy().tobytes())

    def kinds(c0):
        return coll.tally(since=c0)["by_kind"]
    for i, (arch, layers, mshape) in enumerate(SERVE_SHARD_RUNS):
        t_run = time.perf_counter()
        rec = dict(arch=arch, layers=layers, mesh=list(mshape), fails=[])
        cfg, model = serve_shard_model(torch, arch, layers)
        mesh = make_host_mesh(mshape, ("data", "model"))
        S = SERVE_SHARD_LEN + SERVE_SHARD_STEPS
        pspec = sh.param_specs(cfg, mesh, model.init(0, device="meta"))
        rec["card_free_gib_at_start"] = torch.cuda.mem_get_info(dev)[0] \
            / 2**30
        t0 = time.perf_counter()
        for r in range(SERVE_SHARD_RANKS):
            if r == rank:
                lm = model.init(MODEL_SEED, device=dev)
                params = sh.distribute(mesh, pspec, lm)
                del lm
                torch.cuda.empty_cache()
            dist.barrier()
        rec["init_s"] = time.perf_counter() - t0
        pre, toks = serve_shard_inputs(torch, np, cfg, dev)
        pshape = ShapeConfig("6g", SERVE_SHARD_LEN, SERVE_SHARD_BATCH,
                             "prefill")
        dshape = ShapeConfig("6g", S, SERVE_SHARD_BATCH, "decode")
        bspec = sh.batch_specs(cfg, mesh, pshape, pre)
        dbatch = make_batch(cfg, dshape, device="meta")
        cspec = sh.cache_specs(cfg, mesh, dshape,
                               model.init_cache(SERVE_SHARD_BATCH, S,
                                                device="meta"))
        prefill, decode = build_sharded_serve(
            model, mesh, pspec,
            {**bspec, **sh.batch_specs(cfg, mesh, dshape, dbatch)}, cspec,
            max_len=S)
        # this rank's "model" cut: gathered over "data" only
        c0 = coll.tally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module = prefill.load(params)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        rec["load_collectives"] = kinds(c0)
        rec["held_bytes"] = sum(t.numel() * t.element_size()
                                for t in module.parameters())
        want = model_cut_bytes(torch, cfg, mshape, pspec)
        rec["model_cut_bytes"] = want["held"]
        got = [[rec["load_collectives"][k][f] for f in ("count", "bytes")]
               for k in ("all-gather", "all-to-all")]
        if rec["held_bytes"] != want["held"] or got != [
                want["all-gather"], want["all-to-all"]] or \
                rec["load_collectives"]["all-reduce"]["count"]:
            rec["fails"].append(dict(check="held parameters", got=got,
                                     held=rec["held_bytes"], want=want))
        if cfg.family == "moe":
            rec["experts_held"] = int(module.layers[0].moe.w_gate.shape[0])
            if rec["experts_held"] * mshape[1] != cfg.n_experts:
                rec["fails"].append(dict(check="experts held",
                                         got=rec["experts_held"]))
        del module
        rows = sh.shard_slices(mesh, sh.P(*bspec["tokens"]).padded(2),
                               pre["tokens"].shape, mesh.get_coordinate())[0]
        rows = [rows.start or 0, SERVE_SHARD_BATCH if rows.stop is None
                else rows.stop]
        rec["rows"] = rows
        # the prefill, every rank at once (its partial sums meet the
        # other "model" ranks' in all-reduces); no warm-up call (the
        # smoke's time: a prefill of staged all-reduces takes seconds)
        dist.barrier()
        c0 = coll.tally()
        scans = kscan.selective_scan.launches
        reports = []

        def seen(name, read, write, stand_in):
            if name == "selective_scan" and not stand_in:
                reports.append(read)
        _build.LAUNCH_REPORTS.append(seen)
        inputs = _serve_inputs_bytes(torch, (params, pre, prefill.module))
        t0 = time.perf_counter()
        try:
            (logits, cache), peak = _peak_of(
                torch, lambda: prefill(params, pre), inputs)
        finally:
            _build.LAUNCH_REPORTS.remove(seen)
        rec["prefill_s"] = time.perf_counter() - t0
        rec["prefill_peak_bytes"] = peak
        rec["prefill_collectives"] = kinds(c0)
        rec["scan_launches"] = kscan.selective_scan.launches - scans
        if cfg.family == "ssm":
            # the kernel ran on this rank's d_inner / n_model channels
            rec["scan_d_inner"] = cfg.d_inner // mshape[1]
            want = kscan.traffic(rows[1] - rows[0], SERVE_SHARD_LEN,
                                 rec["scan_d_inner"], cfg.ssm_state, 512)[0]
            if not reports or any(r != want for r in reports):
                rec["fails"].append(dict(check="selective_scan shape",
                                         read_bytes=reports, want=want))
        torch.cuda.empty_cache()
        dist.barrier()
        # the first step alone: its collectives and peak
        c0 = coll.tally()
        pos = torch.tensor(SERVE_SHARD_LEN, dtype=torch.int32, device=dev)
        inputs = _serve_inputs_bytes(torch, (params, cache, prefill.module))
        (first, cache), peak = _peak_of(torch, lambda: decode(
            params, cache, {"token": toks[:, :1], "pos": pos}), inputs)
        rec["decode_peak_bytes"] = peak
        rec["decode_collectives"] = kinds(c0)
        rest, cache, secs = serve_shard_steps(
            torch, lambda c, b: decode(params, c, b), toks, cache, start=1)
        got = torch.cat([logits, first, rest], dim=1)
        rec["decode_ms"] = 1e3 * statistics.median(secs)
        ref = torch.load(a["refs"][i], mmap=True)
        want = ref["logits"][rows[0]:rows[1]].to(dev)
        rec["max_abs_err"] = float((got - want).abs().max())
        rec["logits_max"] = float(want.abs().max())
        if rec["max_abs_err"] > SERVE_SHARD_TOL * rec["logits_max"]:
            rec["fails"].append(dict(check="logits", err=rec["max_abs_err"],
                                     scale=rec["logits_max"]))
        rec["finite"] = bool(torch.isfinite(got).all())
        rec["logits_crc"] = crc(got)
        flat_spec = dict(_tree_leaves(cspec))
        flat_ref = dict(_tree_leaves(ref["cache"]))
        rec["shard_crcs"], worst = {}, 0.0
        for name, t in _tree_leaves(cache):
            spec = sh.P(*flat_spec[name]).padded(t.dim())
            idx = sh.shard_slices(mesh, spec, t.shape, mesh.get_coordinate())
            loc = t.to_local()
            if tuple(loc.shape) != sh.local_shape(mesh, spec, t.shape):
                rec["fails"].append(dict(check="local shape", leaf=name))
                continue
            w = flat_ref[name][idx].to(dev)
            err = float((loc.float() - w.float()).abs().max())
            top = max(float(flat_ref[name].float().abs().max()), 1e-30)
            worst = max(worst, err / top)
            if err > SERVE_SHARD_TOL * top:
                rec["fails"].append(dict(check="cache shard", leaf=name,
                                         err=err, leaf_max=top))
            rec["shard_crcs"][name] = [[[x.start, x.stop] for x in idx],
                                       crc(loc)]
        rec["cache_max_rel_err"] = worst
        rec["run_s"] = time.perf_counter() - t_run
        runs.append(rec)
        del params, cache, logits, first, rest, got, prefill, decode, ref
        torch.cuda.empty_cache()
        dist.barrier()
    Path(a["out"], f"serve{rank}.json").write_text(json.dumps(runs))
    dist.destroy_process_group()


def serve_shard_predictions(torch) -> dict:
    """``dryrun.sharded_serve_cost`` of each run's steady prefill and
    decode step on meta, as rank 0 of a ``fake`` group of
    SERVE_SHARD_RANKS: ``{run index: {"prefill", "decode"}}``."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    dryrun.join_fake_group(SERVE_SHARD_RANKS)
    out = {}
    try:
        S = SERVE_SHARD_LEN + SERVE_SHARD_STEPS
        for i, (arch, layers, mshape) in enumerate(SERVE_SHARD_RUNS):
            cfg, model = serve_shard_model(torch, arch, layers)
            mesh = make_host_mesh(mshape, ("data", "model"),
                                  device_type="cpu")
            out[i] = {}
            for kind, shape, room in (
                    ("prefill", ShapeConfig("6g", SERVE_SHARD_LEN,
                                            SERVE_SHARD_BATCH, "prefill"),
                     S),
                    ("decode", ShapeConfig("6g", S, SERVE_SHARD_BATCH,
                                           "decode"), None)):
                trees, _ = dryrun.step_trees(model, shape, "meta")
                trees["batch"].pop("targets", None)
                cell = dryrun.Cell(arch, "6g", cfg, kind, trees, None, {},
                                   0.0)
                out[i][kind] = dryrun.sharded_serve_cost(cell, mesh, shape,
                                                         max_len=room)
    finally:
        dist.destroy_process_group()
    return out


def serve_shard_nccl_world1(torch, np, singles: dict, store: str) -> list:
    """Phase 6g's NCCL check, in this process: each arch's sharded prefill
    and decode steps in a group of one rank on a (1, 1) mesh against its
    single-card run, bit for bit; the group is left after."""
    import datetime
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_batch
    from repro_torch.models.zoo import build_sharded_serve
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(store, 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=capped(SHARD_GROUP_TIMEOUT_S)))
    out = []
    try:
        S = SERVE_SHARD_LEN + SERVE_SHARD_STEPS
        for (arch, layers), single in singles.items():
            cfg, model = serve_shard_model(torch, arch, layers)
            mesh = make_host_mesh((1, 1), ("data", "model"))
            lm = model.init(MODEL_SEED, device=dev)
            pspec = sh.param_specs(cfg, mesh, lm)
            params = sh.distribute(mesh, pspec, lm)
            del lm
            pre, toks = serve_shard_inputs(torch, np, cfg, dev)
            dshape = ShapeConfig("6g", S, SERVE_SHARD_BATCH, "decode")
            cspec = sh.cache_specs(cfg, mesh, dshape, model.init_cache(
                SERVE_SHARD_BATCH, S, device="meta"))
            pshape = ShapeConfig("6g", SERVE_SHARD_LEN, SERVE_SHARD_BATCH,
                                 "prefill")
            prefill, decode = build_sharded_serve(
                model, mesh, pspec,
                {**sh.batch_specs(cfg, mesh, pshape, pre),
                 **sh.batch_specs(cfg, mesh, dshape, make_batch(
                     cfg, dshape, device="meta"))}, cspec, max_len=S)
            logits, cache = prefill(params, pre)
            steps, cache, _ = serve_shard_steps(
                torch, lambda c, b: decode(params, c, b), toks, cache)
            got = torch.cat([logits, steps], dim=1).cpu()
            differ = [name for name, t in _tree_leaves(cache)
                      if not torch.equal(t.to_local().cpu(), dict(
                          _tree_leaves(single["host"]["cache"]))[name])]
            out.append(dict(arch=arch, layers=layers, world=1,
                            backend=dist.get_backend(),
                            logits_bitwise=bool(torch.equal(
                                got, single["host"]["logits"])),
                            cache_leaves_differing=differ))
            del params, cache, logits, steps, prefill, decode
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def serve_shard_phase(torch, np, counters):
    """Phase 6g: the sharded serving steps on one card. Each arch's
    single-card run here (its logits and cache written for the ranks),
    then four spawned gloo ranks running SERVE_SHARD_RUNS while this
    process makes the meta predictions in a fake group, then NCCL in a
    group of one rank here. Returns (record, launches): ``launches`` the
    ranks' selective-scan launches in their sharded prefills."""
    import shutil
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    work = ROOT / "build" / "smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fails, rec = [], {}
    singles = {}
    t0 = time.perf_counter()
    for arch, layers, _ in SERVE_SHARD_RUNS:
        if (arch, layers) not in singles:
            singles[(arch, layers)] = serve_shard_single(
                torch, np, arch, layers, work / f"{arch}.pt")
    rec["single_s"] = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    base = dict(store=str(work / "store"), out=str(work),
                refs=[str(work / f"{a}.pt") for a, _, _ in SERVE_SHARD_RUNS],
                sys_path=list(sys.path),
                group_timeout_s=capped(SHARD_GROUP_TIMEOUT_S))
    t0 = time.perf_counter()
    procs = [ctx.Process(target=serve_shard_rank_main,
                         args=(dict(base, rank=r),))
             for r in range(SERVE_SHARD_RANKS)]
    for p in procs:
        p.start()
    try:
        t1 = time.perf_counter()
        pred = serve_shard_predictions(torch)
        rec["predictions_s"] = time.perf_counter() - t1
    finally:
        codes = join_all(procs, SERVE_SHARD_JOIN_TIMEOUT_S
                         - (time.perf_counter() - t0), "serve_sharded", fails)
    rec["ranks_wall_s"] = time.perf_counter() - t0
    rec["rank_exit_codes"] = codes
    launches = {k: 0 for k in counters}
    if codes != [0] * SERVE_SHARD_RANKS:
        fails.append(dict(part="gloo ranks", exit_codes=codes))
        rec["runs"] = []
    else:
        ranks = [json.loads((work / f"serve{r}.json").read_text())
                 for r in range(SERVE_SHARD_RANKS)]
        rec["runs"] = []
        for i, (arch, layers, mshape) in enumerate(SERVE_SHARD_RUNS):
            per = [r[i] for r in ranks]
            r0 = per[0]
            single = singles[(arch, layers)]
            p = pred[i]
            run = dict(arch=arch, layers=layers, mesh=list(mshape),
                       single_prefill_s=single["prefill_s"],
                       single_decode_ms=single["decode_ms"],
                       init_s=r0["init_s"],
                       load_s=[x["load_s"] for x in per],
                       held_bytes=[x["held_bytes"] for x in per],
                       model_cut_bytes=r0["model_cut_bytes"],
                       load_collectives=r0["load_collectives"],
                       prefill_s=[x["prefill_s"] for x in per],
                       decode_ms=[x["decode_ms"] for x in per],
                       max_abs_err=max(x["max_abs_err"] for x in per),
                       logits_max=r0["logits_max"],
                       cache_max_rel_err=max(x["cache_max_rel_err"]
                                             for x in per),
                       scan_launches=[x["scan_launches"] for x in per],
                       prefill_collectives=r0["prefill_collectives"],
                       decode_step_collectives=r0["decode_collectives"])
            for key in ("experts_held", "scan_d_inner"):
                if key in r0:
                    run[key] = [x[key] for x in per]
            for k, x in enumerate(per):
                fails += [dict(run=i, rank=k, fail=f) for f in x["fails"]]
                if not x["finite"]:
                    fails.append(dict(run=i, rank=k, check="finite"))
            # replicas: the ranks of one dp coordinate hold the same bits
            by_rows, by_slice = {}, {}
            for x in per:
                by_rows.setdefault(str(x["rows"]), set()).add(
                    x["logits_crc"])
                for leaf, (bounds, c) in x["shard_crcs"].items():
                    by_slice.setdefault((leaf, str(bounds)), set()).add(c)
            run["replicas_differing"] = sum(
                len(v) > 1 for v in list(by_rows.values())
                + list(by_slice.values()))
            if run["replicas_differing"]:
                fails.append(dict(run=i, check="replicas"))
            # rank 0's collectives against the meta prediction
            for kind in ("prefill", "decode"):
                got = r0[f"{kind}_collectives"]
                want = {k: p[kind]["collectives"][k] for k in got}
                others = sum(v["count"] for k, v in
                             p[kind]["collectives"].items() if k not in got)
                run[f"{kind}_collectives_predicted"] = got == want \
                    and not others
                if got != want or others:
                    fails.append(dict(run=i, check=f"{kind} collectives",
                                      rank0=got, step_cost=want))
            # the card's peak against the prediction (on meta the Mamba1
            # scan kernel's outputs stand for it)
            for kind in ("prefill", "decode"):
                want = p[kind]["peak_bytes"]
                gap = want / r0[f"{kind}_peak_bytes"] - 1.0
                run[f"{kind}_peak"] = dict(card=r0[f"{kind}_peak_bytes"],
                                           step_cost=want, gap=gap)
                if abs(gap) > SERVE_SHARD_PEAK_TOL:
                    fails.append(dict(run=i, check=f"{kind} peak",
                                      **run[f"{kind}_peak"]))
            if arch == "falcon_mamba_7b":
                if min(run["scan_launches"]) < 1:
                    fails.append(dict(run=i, check="no selective_scan "
                                      "launch in a rank's prefill"))
                launches["selective_scan"] += sum(run["scan_launches"])
            rec["runs"].append(run)
    t0 = time.perf_counter()
    rec["nccl_world1"] = serve_shard_nccl_world1(torch, np, singles,
                                                 str(work / "store_nccl"))
    rec["nccl_wall_s"] = time.perf_counter() - t0
    for r in rec["nccl_world1"]:
        if not r["logits_bitwise"] or r["cache_leaves_differing"]:
            fails.append(dict(check="NCCL world 1 bit for bit", **r))
    rec["wide_matmul_bf16"] = serve_shard_wide_matmul(torch)
    if not rec["wide_matmul_bf16"]["ok"]:
        fails.append(dict(check="bf16 partial product",
                          **rec["wide_matmul_bf16"]))
    stray = [k for k in counters if counters[k].launches
             and k != "selective_scan"]
    if stray:
        fails.append(dict(check="kernel counters moved here", kernels=stray))
    del singles
    shutil.rmtree(work, ignore_errors=True)
    rec["fails"] = fails
    rec["reduced"] = {
        "layers": {f"{a} {m[0]}x{m[1]}": f"{n} layers"
                   for a, n, m in SERVE_SHARD_RUNS},
        "dtype": "float32 (a sharded step is held to the single card's)",
        "why": "four ranks' weights, caches and prefills and one whole "
               "model at a time (the single card's, a rank's draw) on "
               "one card"}
    rec["ok"] = not fails
    return rec, launches


def full_eval_mean(torch, np, model, lm, clip: float, seq_len: int):
    """The driver's eval set's mean clipped per-token loss over every
    example (its scramble, batches of its size, float64 on the host)."""
    from repro_torch.data.tokens import make_eval_scramble
    from repro_torch.launch import train as drv
    sc = make_eval_scramble(model.cfg, n_examples=drv.EVAL_EXAMPLES,
                            seq_len=seq_len)
    total, count = 0.0, 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b in sc.batches(drv.EVAL_BATCH):
            toks = torch.from_numpy(b["tokens"]).cuda()
            targets = torch.from_numpy(b["targets"]).cuda()
            logits, _ = model.forward(lm, {"tokens": toks})
            losses = torch.logsumexp(logits, dim=-1) - torch.gather(
                logits, -1, targets.clamp(min=0).long()[..., None])[..., 0]
            v = losses[targets >= 0].double().cpu().numpy()
            total += float(np.clip(v, 0.0, clip).sum())
            count += v.size
            del logits, losses
    return dict(mean=total / count, seconds=time.perf_counter() - t0)


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
    set_deadline(t_start + SMOKE_DEADLINE_S, t_start)
    kind = torch.cuda.get_device_name(0)

    # ---- 1. environment and build -------------------------------------------
    t_phase = time.perf_counter()
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
                     if "registers" in ln or "spill" in ln],
              phase_s=time.perf_counter() - t_phase,
              total_s=time.perf_counter() - t_start))

    # ---- 2. kernels against their plain versions ----------------------------
    t_phase = time.perf_counter()
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
              reduced={"reps": f"30 -> {REPS} timed calls a measurement "
                                "(the smoke's time)"},
              block_agg=agg, bitmap_active=bit, round_select=head,
              bitmap_active_multi=multi, round_select_stack=stacked,
              fused_fold=fus, grouped_hist=hst, selective_scan=scn,
              selective_scan_bwd=sbw, phase_s=time.perf_counter() - t_phase,
              total_s=time.perf_counter() - t_start))
    bad = [r for r in agg + bit + head + multi + stacked + fus + hst + scn
           + sbw if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    del timer  # its 1 GiB flush buffer: not part of any later peak
    torch.cuda.empty_cache()

    # ---- 3. the main paths at full size -------------------------------------
    t_phase = t0 = time.perf_counter()
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
    counters = kernel_counters()
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
                  .max_memory_allocated() / 2**30, queries=records,
                  phase_s=time.perf_counter() - t_phase,
                  total_s=time.perf_counter() - t_start))
        t_phase = time.perf_counter()
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
    serving, failures, launches, solo_launches, (burst, clean) = \
        serving_phase(torch, np, T, opt, loop_frame, serve_batch, solo,
                      truths, ds.columns, counters)
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

    # ---- 3d. seeded faults on phase 3c's scheduler burst -------------------
    t0 = time.perf_counter()
    chaos, failures, launches = chaos_phase(torch, np, loop_frame, burst,
                                            clean, ds.columns, counters)
    path_launches["chaos"] = launches
    emit(dict(phase="chaos", card=name, power_limit=power_limit,
              rows=args.rows, phase_s=time.perf_counter() - t0,
              reduced={"rows": f"{PAPER_ROWS / 1e6:g}M -> "
                               f"{args.rows / 1e6:g}M",
                       "scheduler_burst": f"16 -> {SCHED_BURST}"},
              **chaos))
    if failures:
        raise AssertionError(f"chaos: {failures}")
    idle_k = [k for k in ("round_select", "block_agg", "bitmap_active_multi")
              if launches[k] == 0]
    if idle_k:
        raise AssertionError(f"chaos: kernels never launched {idle_k}: "
                             f"{launches}")
    del loop_frame, burst, clean
    torch.cuda.empty_cache()

    # ---- 3e. the sharded scan: gloo ranks on the card ----------------------
    del solo
    t0 = time.perf_counter()
    shard_rows = min(SHARD_ROWS, args.rows)
    sharded, failures, launches = sharded_phase(torch, np, T, opt, sc,
                                                shard_rows)
    path_launches["sharded"] = launches
    emit(dict(phase="sharded", card=name, power_limit=power_limit,
              world=SHARD_RANKS, backend="gloo",
              merge_every=list(SHARD_MERGE_EVERY),
              phase_s=time.perf_counter() - t0,
              reduced={"rows": f"{PAPER_ROWS / 1e6:g}M -> "
                               f"{shard_rows / 1e6:g}M (phase 3b's first "
                               "blocks)"},
              **sharded))
    if failures:
        raise AssertionError(f"sharded: {failures}")
    del sc, ds
    release_card_columns()
    torch.cuda.empty_cache()

    # ---- 4. the port on the card against the port on the CPU ----------------
    t_phase = time.perf_counter()
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
              phase_s=time.perf_counter() - t_phase,
              total_s=time.perf_counter() - t_start))
    if mismatch:
        raise AssertionError(f"card and CPU runs differ: {mismatch}")
    del f_gpu, f_cpu

    # ---- 3c, host pass loop: the serving batch on the card and the CPU ------
    t_phase = time.perf_counter()
    for c in counters.values():
        c.launches = 0
    host_serving, mismatch = serving_host_loop(torch, np, T, sc, serve_batch)
    launches = {k: c.launches for k, c in counters.items()}
    path_launches["serving_host_loop"] = launches
    emit(dict(phase="serving_host_loop", rows=CPU_ROWS, launches=launches,
              **host_serving, phase_s=time.perf_counter() - t_phase,
              total_s=time.perf_counter() - t_start))
    if mismatch:
        raise AssertionError(f"served card and CPU runs differ: {mismatch}")
    idle_k = [k for k in ("bitmap_active_multi", "round_select", "block_agg",
                          "fused_fold") if launches[k] == 0]
    if idle_k:
        raise AssertionError(f"serving host loop: kernels never launched "
                             f"{idle_k}: {launches}")

    del sc, ds
    torch.cuda.empty_cache()

    # phase 6f's dry runs (meta steps on the host) start here, beside
    # phases 5 to 6e; they touch the card only once 6c has freed it
    layout_dry = start_layout_dryruns(card_free=False)
    try:
        # ---- 5. the Mamba1 serving path -------------------------------------
        t_phase = time.perf_counter()
        serve, launches, (model, lm) = serve_phase(torch, np, counters)
        path_launches["mamba1_serve"] = launches
        emit(dict(phase="mamba1_serve", card=name, power_limit=power_limit,
                  **serve, phase_s=time.perf_counter() - t_phase,
                  total_s=time.perf_counter() - t_start))
        if not serve["ok"]:
            raise AssertionError(f"the Mamba1 serving path failed: {serve}")

        # ---- 5b. CI-guaranteed early-stopped eval of the same model ---------
        t0 = time.perf_counter()
        ev, launches = eval_phase(torch, np, counters, model, lm, kscan)
        path_launches["mamba1_eval"] = launches
        del model, lm
        torch.cuda.empty_cache()
        emit(dict(phase="mamba1_eval", card=name, power_limit=power_limit,
                  **ev, phase_s=time.perf_counter() - t0,
                  total_s=time.perf_counter() - t_start))
        if not ev["ok"]:
            raise AssertionError(f"the Mamba1 eval path failed: {ev}")

        # ---- 5c. the dense, vlm and MoE families' serving path --------------
        t0 = time.perf_counter()
        dense, launches = dense_serve_phase(torch, np, counters)
        path_launches["dense_serve"] = launches
        emit(dict(phase="dense_serve", card=name, power_limit=power_limit,
                  **dense, phase_s=time.perf_counter() - t0,
                  total_s=time.perf_counter() - t_start))
        if not dense["ok"]:
            raise AssertionError(f"the dense serving path failed: {dense}")

        # ---- 5d. the hybrid and enc-dec families' serving path --------------
        t0 = time.perf_counter()
        hybrid, launches = hybrid_serve_phase(torch, np, counters)
        path_launches["hybrid_serve"] = launches
        emit(dict(phase="hybrid_serve", card=name, power_limit=power_limit,
                  **hybrid, phase_s=time.perf_counter() - t0,
                  total_s=time.perf_counter() - t_start))
        if not hybrid["ok"]:
            raise AssertionError(f"the hybrid / enc-dec serving path failed: "
                                 f"{hybrid}")

        # ---- 6. the Mamba1 training path ------------------------------------
        t_phase = time.perf_counter()
        train, launches = train_phase(torch, np, counters)
        path_launches["mamba1_train"] = launches
        emit(dict(phase="mamba1_train", card=name, power_limit=power_limit,
                  **train, phase_s=time.perf_counter() - t_phase,
                  total_s=time.perf_counter() - t_start))
        if not train["ok"]:
            raise AssertionError(f"the Mamba1 training path failed: {train}")
        # ---- 6b. the monitors' decisions over phase 6's steps ---------------
        emit(dict(phase="monitors", card=name, power_limit=power_limit,
                  steps=TRAIN_STEPS + 1, **train["monitors"]))

        # ---- 6c. the dense, MoE, hybrid and enc-dec families' training --
        t0 = time.perf_counter()
        fam, launches = family_train_phase(torch, np, counters)
        path_launches["family_train"] = launches
        emit(dict(phase="family_train", card=name, power_limit=power_limit,
                  **fam, phase_s=time.perf_counter() - t0,
                  total_s=time.perf_counter() - t_start))
        if not fam["ok"]:
            raise AssertionError(f"the families' training path failed: "
                                 f"{fam}")
        torch.cuda.empty_cache()
        layout_dry[2].set()     # the card is free for the dry runs' end

        # ---- 6d. the Mamba1 xla path's chunked scan against the kernels ---
        t0 = time.perf_counter()
        scan, launches = mamba1_xla_scan_phase(torch, np, counters)
        emit(dict(phase="mamba1_xla_scan", card=name,
                  power_limit=power_limit,
                  **scan, phase_s=time.perf_counter() - t0,
                  total_s=time.perf_counter() - t_start))
        if not scan["ok"]:
            raise AssertionError(f"the chunked scan failed: {scan}")

        # ---- 6e. launch/train.py's driver: checkpoints, resume, eval ------
        t0 = time.perf_counter()
        drive, launches = driver_phase(torch, np, counters)
        path_launches["train_driver"] = launches
        emit(dict(phase="train_driver", card=name, power_limit=power_limit,
                  **drive, phase_s=time.perf_counter() - t0,
                  total_s=time.perf_counter() - t_start))
        if not drive["ok"]:
            raise AssertionError(f"the training driver failed: {drive}")
    except BaseException:   # the dry-run process is stopped, then re-raise
        _stop(layout_dry[0])
        raise

    # ---- 6f. the multi-card layout: sharded step, checkpoint, dry runs ---
    t0 = time.perf_counter()
    layout, launches = layout_phase(torch, np, counters, layout_dry)
    path_launches["layout"] = launches
    emit(dict(phase="layout", card=name, power_limit=power_limit,
              **layout, phase_s=time.perf_counter() - t0,
              total_s=time.perf_counter() - t_start))
    if not layout["ok"]:
        raise AssertionError(f"the multi-card layout failed: "
                             f"{layout['fails']}")

    # ---- 6g. the sharded serving steps: prefill and decode on a mesh -----
    t0 = time.perf_counter()
    serve_sh, launches = serve_shard_phase(torch, np, counters)
    path_launches["serve_sharded"] = launches
    emit(dict(phase="serve_sharded", card=name, power_limit=power_limit,
              **serve_sh, phase_s=time.perf_counter() - t0,
              total_s=time.perf_counter() - t_start))
    if not serve_sh["ok"]:
        raise AssertionError(f"the sharded serving steps failed: "
                             f"{serve_sh['fails']}")

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
             chaos_launches=path_launches["chaos"]["block_agg"],
             sharded_launches=path_launches["sharded"]["block_agg"],
             layout_launches=path_launches["layout"]["block_agg"],
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
             chaos_launches=path_launches["chaos"]["round_select"],
             sharded_launches=path_launches["sharded"]["round_select"],
             stack_q8_ms=st8["ms"], stack_q1_ms=st1["ms"]),
        dict(name="active_blocks_multi", route="cuda",
             source="src/repro_torch/kernels/csrc/bitmap_active.cu",
             replaces="src/repro/kernels/bitmap_active.py:40",
             launches=path_launches["serving_host_loop"][
                 "bitmap_active_multi"],
             chaos_launches=path_launches["chaos"]["bitmap_active_multi"],
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
             sharded_launches=path_launches["sharded"]["fused_fold"],
             max_abs_err=max(r["max_abs_err"] for r in fus),
             ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
             bound_by=f["bound_by"], library_ms=f["library_ms"]),
        dict(name="grouped_hist", route="cuda",
             source="src/repro_torch/kernels/csrc/grouped_hist.cu",
             replaces="src/repro/kernels/hist.py:73",
             launches=adkw["grouped_hist"],
             sharded_launches=path_launches["sharded"]["grouped_hist"],
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
             eval_launches=path_launches["mamba1_eval"]["selective_scan"],
             serve_sharded_launches=path_launches["serve_sharded"][
                 "selective_scan"],
             serve_sharded_d_inner=sorted({d for r in serve_sh["runs"]
                                           for d in r.get("scan_d_inner",
                                                          [])}),
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
