#!/usr/bin/env python3
"""Issue and SFU floors of the selective-scan forward kernel on one card.

    python3 scripts/scan_issue_floor.py

Builds the port's kernels (``repro_torch.kernels._build``), disassembles
``csrc/selective_scan.cu``'s n = 16 kernel with ``cuobjdump -sass`` and
finds its scan loop: the backward branch whose body holds the most
``MUFU.EX2`` (one accurate ``expf``, so one state-step, each). Its
instructions over its ``MUFU.EX2`` are the instructions a state-step.
With the card's SM count and maximum SM clock (``nvidia-smi``), it prints
for the training (2, 4096) and serving (8, 2048) calls at d_inner 8192:

  * ``issue_floor_ms``: the loop's instructions for every state-step, a
    warp-instruction a clock on each of an SM's 4 schedulers;
  * ``sfu_floor_ms``: one ``MUFU.EX2`` a state-step at 16 a clock an SM;
  * ``bytes_ms``: x, dt read and y written (B, L, din), B, C read (B, L,
    n), the states written, at 3.35 TB/s (``chip_smoke.bound``'s count).

It prints the card's name and power limit as ``nvidia-smi`` gives them,
then one JSON line. Needs CUDA and the toolkit's ``cuobjdump``; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

SHAPES = {"train": smoke.TRAIN_SCAN_SHAPE,
          "serve": (smoke.SERVE_BATCH, smoke.PROMPT_LEN, 8192, 16, 512)}
SCHEDULERS_PER_SM = 4
EX2_PER_CLOCK_PER_SM = 16
KERNEL = "selective_scan_fwdILi16E"
_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"^(?:@!?U?P\w+\s+)?BRA\s+(?:`\()?0x([0-9a-f]+)")


def scan_loop(sass: str):
    """(instructions, MUFU.EX2) of the kernel's scan loop: of its
    innermost loops (no backward branch inside), the one with the most
    MUFU.EX2."""
    start = sass.index(KERNEL)
    end = sass.find("Function :", start)
    insns = [(int(m.group(1), 16), m.group(2))
             for m in map(_INSN.match, sass[start:end].splitlines()) if m]
    loops = [(int(m.group(1), 16), addr) for addr, text in insns
             for m in [_BRA.match(text)]
             if m and int(m.group(1), 16) < addr]
    best = (0, 0)
    for lo, hi in loops:
        if any(lo <= lo2 and hi2 < hi for lo2, hi2 in loops):
            continue  # holds an inner loop
        body = [t for a, t in insns if lo <= a <= hi]
        ex2 = sum("MUFU.EX2" in t for t in body)
        if ex2 > best[1]:
            best = (len(body), ex2)
    return best


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_issue_floor: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    print(smoke.nvidia_smi_line(), flush=True)
    lib = _build.build()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    n_insn, n_ex2 = scan_loop(sass)
    if not n_ex2:
        raise RuntimeError(f"no scan loop found in {KERNEL}'s SASS")
    per_state_step = n_insn / n_ex2
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = mhz * 1e6
    out = dict(kernel=KERNEL, loop_instructions=n_insn, loop_ex2=n_ex2,
               instructions_per_state_step=per_state_step, sms=sms,
               max_sm_mhz=mhz, shapes={})
    for name, (B, L, din, n, tc) in SHAPES.items():
        steps = B * L * din * n
        f32 = 4
        bytes_moved = f32 * (3 * B * L * din + 2 * B * L * n + din * n
                             + din + 2 * B * din * n
                             + B * (L // tc) * din * n)
        out["shapes"][name] = dict(
            shape=[B, L, din, n, tc], state_steps=steps,
            issue_floor_ms=steps * per_state_step / 32
            / (sms * SCHEDULERS_PER_SM * clock) * 1e3,
            sfu_floor_ms=steps / (sms * EX2_PER_CLOCK_PER_SM * clock) * 1e3,
            bytes_ms=bytes_moved / smoke.HBM_BYTES_PER_S * 1e3)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
