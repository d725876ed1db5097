"""Dry run of the paper's own workload on the production meshes: one
round of the divided scan's collective fold.

The port of :mod:`repro.launch.dryrun_aqp`. This process joins a
``fake``-backend group of 256 or 512 ranks as rank 0 and runs that
rank's :func:`repro_torch.aqp.distributed.make_sharded_fold` (the
grouped moments of its rows about the centre, merged across the ranks
in one SUM and one MIN all-reduce) on ``--rows`` rows a device (64K),
``--groups`` groups (1024), on the device asked for (the card by
default, where the fold launches ``block_agg``; ``--device cpu`` runs
its plain version). A fake group's collectives move nothing, so the
record holds shapes and byte counts, never merged values:

  * the per-device bytes of the round's inputs (values f32, group ids
    i32, mask f32);
  * the bytes handed to collectives in the round
    (:data:`repro_torch.kernels.fused_scan.COLLECTIVES`): O(groups),
    whatever the rows;
  * ``step_cost``: :func:`repro_torch.launch.step_cost.analyze` of a
    second call of the round (on the card ``block_agg``'s launch with
    the bytes it reports, on the CPU its plain version's ops; the two
    all-reduces by kind);
  * three hand terms at the NVIDIA H100 SXM data sheet's rates (700 W),
    each named beside it: memory (input bytes over HBM3's 3.35e12 B/s),
    compute (``OPS_PER_ROW`` float32 operations a row over 67e12 op/s,
    the non-tensor fp32 peak) and collective (the all-reduce bytes over
    one direction of NVLink's 450e9 B/s); ``card`` is the name and power
    limit that ``nvidia-smi`` gives for the card the round ran on
    (``None`` on the CPU): a card set below 700 W runs slower than the
    terms;
  * the fold's kernel launches and its host seconds (the first call).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_aqp [--multi-pod |
      --both] [--device cpu] [--out build/dryrun/dryrun_aqp.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.aqp.distributed import make_sharded_fold
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import mesh_dp_axes
from repro_torch.kernels import block_agg as kblock
from repro_torch.kernels import fused_scan
from repro_torch.launch import step_cost
from repro_torch.launch.dryrun import join_fake_group, mesh_name
from repro_torch.launch.mesh import make_production_mesh

# NVIDIA H100 SXM data sheet (700 W): HBM3, non-tensor fp32, NVLink 4
# (900 GB/s both directions)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
NVLINK_BYTES_PER_S = 450e9
# the fold's float32 operations a row: d = v - c, m * d, (m * d) * d and
# three adds into count, dsum and dsq
OPS_PER_ROW = 6
CENTER = 870.0


def card_line(dev: torch.device):
    """``nvidia-smi``'s name and power limit of the card, ``None`` off
    the card."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(dev.index or 0)],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def run(multi_pod: bool, rows_per_device: int = 64 * 1024,
        groups: int = 1024, device=None) -> dict:
    """One rank's round on the production mesh (a fake group of its
    size, joined here)."""
    dev = resolve_device(device)
    join_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    dp = mesh_dp_axes(mesh)
    n_dp = int(np.prod([mesh.shape[mesh.mesh_dim_names.index(a)]
                        for a in dp]))
    rng = np.random.default_rng(0)
    values = torch.from_numpy(rng.normal(CENTER, 40.0, rows_per_device)
                              .astype(np.float32)).to(dev)
    gids = torch.from_numpy(rng.integers(0, groups, rows_per_device)
                            .astype(np.int32)).to(dev)
    mask = torch.ones(rows_per_device, dtype=torch.float32, device=dev)
    fold = make_sharded_fold(None, groups, CENTER)
    coll = fused_scan.COLLECTIVES
    c0, launches0 = dict(coll), kblock.block_agg.launches
    t0 = time.perf_counter()
    state = fold(values, gids, mask)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fold_s = time.perf_counter() - t0
    calls, coll_bytes = (coll["calls"] - c0["calls"],
                         coll["bytes"] - c0["bytes"])
    launches = kblock.block_agg.launches - launches0
    cost = step_cost.analyze(lambda: fold(values, gids, mask),
                             inputs=(values, gids, mask))
    in_bytes = sum(t.numel() * t.element_size() for t in (values, gids, mask))
    ops = OPS_PER_ROW * rows_per_device
    return {
        "cell": "aqp_scan_round", "mesh": mesh_name(multi_pod),
        "n_devices": int(mesh.size()), "dp_devices": n_dp,
        "device": str(dev), "rows_per_device": rows_per_device,
        "total_rows": rows_per_device * n_dp, "groups": groups,
        "input_bytes_per_device": in_bytes,
        "collective_calls": calls,
        "collective_bytes": coll_bytes,
        "block_agg_launches": launches,
        "fold_s": fold_s, "step_cost": cost, "card": card_line(dev),
        "out_shape": list(state.count.shape),
        "terms_s": {
            "memory": {"s": in_bytes / HBM_BYTES_PER_S,
                       "rate": "HBM3 3.35e12 B/s"},
            "compute": {"s": ops / FP32_OPS_PER_S, "ops": ops,
                        "rate": "fp32 67e12 op/s"},
            "collective": {"s": coll_bytes / NVLINK_BYTES_PER_S,
                           "rate": "NVLink 450e9 B/s a direction"}},
        "note": ("a fake group's collectives move nothing: shapes and "
                 "byte counts only, never merged values"),
        "ok": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    ap.add_argument("--rows", type=int, default=64 * 1024)
    ap.add_argument("--groups", type=int, default=1024)
    ap.add_argument("--out", default="build/dryrun/dryrun_aqp.json")
    args = ap.parse_args(argv)
    recs = []
    for mp in ([False, True] if args.both else [args.multi_pod]):
        rec = run(mp, args.rows, args.groups, args.device)
        print(json.dumps(rec, indent=1), flush=True)
        recs.append(rec)
    if dist.is_initialized():
        dist.destroy_process_group()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
