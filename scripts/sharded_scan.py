#!/usr/bin/env python3
"""Run the port's sharded scan (``EngineConfig(shard_rows=True)``) across
ranks, and hold it to the single-device run of the same query.

On one host, with gloo ranks that this script starts (spawned):

    PYTHONPATH=src python scripts/sharded_scan.py --ranks 2 --device cpu
    PYTHONPATH=src python scripts/sharded_scan.py --ranks 2 --device cuda

(``--device cuda`` puts every rank on ``cuda:0``; gloo stages the card's
tensors through host memory, so the chunks are enqueued, not captured.)
Under ``torchrun``, one rank a card with NCCL (each chunk one captured
CUDA graph, collectives included):

    torchrun --nproc-per-node=N scripts/sharded_scan.py --backend nccl \\
        --device cuda

Every rank builds the same FLIGHTS scramble from the seed, answers a
GROUP BY ``(origin, airline)`` AVG divided over the ranks and again on
its own device, and checks that the scan decisions are equal and the
intervals within 1e-3 of ``max(|x|, 1)``; rank 0 prints one JSON line.
Exits non-zero on a mismatch. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("count_seen", "exact", "tainted", "rows_covered", "blocks_fetched",
         "blocks_skipped_active", "blocks_skipped_static", "bitmap_probes",
         "rounds", "stopped_early")


def rank_main(rank: int, world: int, args, store: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    import repro_torch.aqp as T
    from repro_torch.core.optstop import ThresholdSide
    from repro_torch.data import flights
    from repro_torch.kernels import fused_scan
    if args.device == "cuda":
        index = int(os.environ.get("LOCAL_RANK", 0)) \
            if args.backend == "nccl" else 0
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=args.timeout)
    if store is None:   # torchrun: its rendezvous in the environment
        dist.init_process_group(args.backend, timeout=timeout)
    else:
        dist.init_process_group(args.backend,
                                store=dist.FileStore(store, world),
                                rank=rank, world_size=world, timeout=timeout)
    ds = flights.generate(n_rows=args.rows, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    q = T.AggQuery(agg="avg", column="dep_delay",
                   group_by=("origin", "airline"),
                   stop=ThresholdSide(threshold=10.0))
    frame = T.FastFrame(sc, T.EngineConfig(
        shard_rows=True, merge_every=args.merge_every), device=dev)
    calls = fused_scan.COLLECTIVES["calls"]
    t0 = time.perf_counter()
    res = frame.run(q, seed=0)
    wall = time.perf_counter() - t0
    calls = fused_scan.COLLECTIVES["calls"] - calls
    one = T.FastFrame(sc, T.EngineConfig(shard_rows=False),
                      device=dev).run(q, seed=0)
    differ = [f for f in EXACT
              if not np.array_equal(getattr(res, f), getattr(one, f))]
    gap = max(float(np.max(np.abs(getattr(res, f) - getattr(one, f))
                           / np.maximum(np.abs(getattr(one, f)), 1.0),
                           initial=0.0, where=np.isfinite(getattr(one, f))))
              for f in ("estimate", "lo", "hi"))
    ok = (not differ or args.merge_every > 1) and (
        gap <= 1e-3 or args.merge_every > 1)
    if rank == 0:
        print(json.dumps(dict(
            ranks=world, backend=dist.get_backend(), device=str(dev),
            rows=args.rows, merge_every=args.merge_every,
            shard_rows=frame.block_shards().shard_rows, rounds=res.rounds,
            wall_s=wall, all_reduces=calls,
            single_device_rounds=one.rounds, exact_fields_differ=differ,
            ci_max_rel=gap, ok=ok)), flush=True)
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


def _spawned(rank, world, args, store):
    rank_main(rank, world, args, store)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2,
                    help="local gloo ranks to start (without torchrun)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--merge-every", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="the group's collective time limit, seconds")
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        rank_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                  args, None)
        return 0
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        # a rank that fails raises here; one stuck in a collective fails
        # at the group's time limit
        mp.spawn(_spawned, args=(args.ranks, args, str(Path(tmp, "store"))),
                 nprocs=args.ranks, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
