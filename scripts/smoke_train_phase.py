#!/usr/bin/env python3
"""``chip_smoke.py``'s training phases 6c (the dense, MoE, hybrid and
enc-dec families trained at full width), 6d (the Mamba1 ``xla`` path's
chunked scan against the scan kernels) and 6e (``launch/train.py``'s
driver: checkpoints, resume, eval, gradient compression) alone.

    python3 scripts/smoke_train_phase.py [--phases cde]

Builds the scan kernels (phase 6d runs them), prints the card's
``nvidia-smi`` line and one JSON record a phase; exits 1 when a check
failed. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="cde",
                    help="which of the phases c, d, e to run")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("smoke_train_phase: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    counters = cs.kernel_counters()
    phases = {"c": ("family_train", cs.family_train_phase),
              "d": ("mamba1_xla_scan", cs.mamba1_xla_scan_phase),
              "e": ("train_driver", cs.driver_phase)}
    ok = True
    for key in args.phases:
        name, run = phases[key]
        t0 = time.perf_counter()
        rec, _ = run(torch, np, counters)
        print(json.dumps(dict(phase=name, phase_s=time.perf_counter() - t0,
                              **rec)), flush=True)
        ok &= rec["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
