#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 3e (the sharded scan on gloo ranks, and
NCCL at world size 1) alone, on a FLIGHTS scramble of ``--rows`` rows.

    python3 scripts/smoke_sharded_phase.py [--rows N]

Builds the kernels, generates the data as phase 3 does (seed 0,
scramble seed 1), runs ``chip_smoke.sharded_phase`` on all of it and
prints the card's ``nvidia-smi`` line and the phase's JSON record; exits
1 when a check of the phase failed. Needs the card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("smoke_sharded_phase: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch.aqp as T
    from repro_torch.core import optstop as opt
    from repro_torch.data import flights
    from repro_torch.kernels import _build
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    _build.library()
    t0 = time.perf_counter()
    ds = flights.generate(n_rows=args.rows, seed=0)
    sc = T.build_scramble(ds.columns, catalog=ds.catalog, seed=1)
    data_s = time.perf_counter() - t0
    del ds
    t0 = time.perf_counter()
    rec, failures, launches = cs.sharded_phase(torch, np, T, opt, sc,
                                               args.rows)
    print(json.dumps(dict(phase="sharded", data_s=data_s,
                          phase_s=time.perf_counter() - t0,
                          failures=failures, launches=launches, **rec)),
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
