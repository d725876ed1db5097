#!/usr/bin/env python3
"""Where the time of the port's Mamba1 training step goes, on one card.

    python3 scripts/profile_mamba1_train.py

Trains as ``chip_smoke.py``'s phase 6 does, through its own functions
(``training_setup``, ``train_step_once``): falcon-mamba-7b at full width
cut to ``TRAIN_LAYERS`` layers (bf16, random weights from
``MODEL_SEED``, ``ssm_impl="pallas"``, remat, 2 microbatches, AdamW with
float32 moments), ``TRAIN_BATCH`` x ``TRAIN_LEN`` tokens. One untimed
step warms up, as in phase 6, then one step is traced with
``torch.profiler``. It prints the card's name and power limit as
``nvidia-smi`` gives them, then one JSON line: the step's host-clock wall
time, the card's busy time (the union of its kernels' intervals) and idle
share, the kernel count, the kernel time by kind (``gemm``: cuBLAS's
matrix products; ``selective_scan`` and ``selective_scan_bwd``: the
port's CUDA scan kernels; ``elementwise``: every other kernel) with the
ten longest kernels by name, and the span of the optimizer update on the
card (the trainer's ``optimizer.apply`` range). Needs CUDA; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke as smoke  # noqa: E402
import profile_mamba1_serve as serve_profile  # noqa: E402

OPT_RANGE = "optimizer.apply"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mamba1_train: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    cfg, _, state, batch, step, _ = smoke.training_setup(torch)
    state, _, _ = smoke.train_step_once(torch, step, state, batch)  # warm up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _, rec = smoke.train_step_once(torch, step, state, batch)
    # the optimizer's range is traced on the card too (a user annotation
    # spanning its kernels): keep it out of the kernel counts and sums
    events = prof.events()
    opt_ms = sum(e.time_range.end - e.time_range.start for e in events
                 if e.name == OPT_RANGE
                 and e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out = serve_profile.summarize([e for e in events if e.name != OPT_RANGE],
                                  rec["seconds"], "train_step",
                                  layers=cfg.n_layers,
                                  batch=smoke.TRAIN_BATCH,
                                  seq_len=smoke.TRAIN_LEN,
                                  microbatches=cfg.microbatches,
                                  loss=rec["loss"])
    out["optimizer_span_ms"] = opt_ms
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
