#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 5d (the hybrid zamba2-7b and the enc-dec
seamless-m4t-large-v2 served at full width and depth on the card, the
float32 consistency checks, the ring cache past its wrap, card against
CPU) alone.

    python3 scripts/smoke_hybrid_phase.py

Prints the card's ``nvidia-smi`` line and the phase's JSON record; exits
1 when a check of the phase failed. Needs the card (no kernel is built:
these families run plain PyTorch); imports nothing of JAX.
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
        print("smoke_hybrid_phase: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    rec, _ = cs.hybrid_serve_phase(torch, np, cs.kernel_counters())
    print(json.dumps(dict(phase="hybrid_serve",
                          phase_s=time.perf_counter() - t0, **rec)),
          flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
