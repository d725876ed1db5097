#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 6g (the sharded serving steps: prefill and
decode on four gloo ranks of one card against the single-card run, the
meta prediction of their collectives and peak, the NCCL rank of a group
of one) alone.

    python3 scripts/smoke_serve_phase.py

Builds the kernels (falcon-mamba's prefill launches the selective scan),
prints the card's ``nvidia-smi`` line and the phase's JSON record; exits
1 when a check failed. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("smoke_serve_phase: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    t0 = time.perf_counter()
    rec, launches = cs.serve_shard_phase(torch, np, cs.kernel_counters())
    print(json.dumps(dict(phase="serve_sharded",
                          phase_s=time.perf_counter() - t0,
                          launches=launches, **rec)), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
