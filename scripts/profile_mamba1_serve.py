#!/usr/bin/env python3
"""Where the time of the port's Mamba1 serving path goes, on one card.

    python3 scripts/profile_mamba1_serve.py

Serves as ``chip_smoke.py``'s phase 5 does, through its own functions:
falcon-mamba-7b at full width and depth (64 layers, bf16, random weights
from ``MODEL_SEED``, ``ssm_impl="pallas"``) on the card, one untimed
prefill of ``SERVE_BATCH`` x ``PROMPT_LEN`` tokens and two decode steps
to warm up, then one prefill and ``PROFILE_DECODE_STEPS`` greedy decode
steps, each window traced with ``torch.profiler``. For each window it
prints one JSON line: the host-clock wall time, the card's busy time
(the union of its kernels' intervals) and idle share, the kernel count
and the kernel time by kind (``gemm``: cuBLAS's matrix products,
``nvjet`` / ``xmma`` / CUTLASS kernels and split-K reductions;
``selective_scan``: the port's CUDA scan; ``elementwise``: every other
kernel) with the ten longest kernels by name. The card's name and power
limit come first, as ``nvidia-smi`` prints them. Needs CUDA; imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

PROFILE_DECODE_STEPS = 8


def kind_of(name: str) -> str:
    low = name.lower()
    if "selective_scan_bwd" in low:
        return "selective_scan_bwd"
    if "selective_scan" in low:
        return "selective_scan"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
        return "gemm"
    return "elementwise"


def summarize(events, wall_s: float, what: str, **extra) -> dict:
    """Kernel intervals of a trace's events: busy time as their union,
    idle share against the host-clock window, time by kind and name."""
    spans, by_name = [], collections.Counter()
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] += end - start
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_kind = collections.Counter()
    for name, us in by_name.items():
        by_kind[kind_of(name)] += us
    top = [dict(name=n[:90], ms=us / 1e3)
           for n, us in by_name.most_common(10)]
    return dict(window=what, wall_ms=wall_s * 1e3,
                device_busy_ms=busy_us / 1e3,
                device_idle_share=(1.0 - busy_us / 1e3 / (wall_s * 1e3))
                if spans else None,
                kernels=len(spans),
                ms_by_kind={k: v / 1e3 for k, v in by_kind.items()},
                top_kernels=top, **extra)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mamba1_serve: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    model, lm, tokens, _ = smoke.serving_model(torch, np)
    smoke.serve_once(torch, model, lm, tokens, 2)           # warm up

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        logits, cache, wall = smoke.prefill_once(torch, model, lm, tokens)
    layers = model.cfg.n_layers
    print(json.dumps(summarize(prof.events(), wall, "prefill",
                               layers=layers,
                               batch=smoke.SERVE_BATCH,
                               prompt=smoke.PROMPT_LEN)), flush=True)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    with torch.profiler.profile(activities=acts) as prof:
        *_, wall = smoke.decode_steps(torch, model, lm, cache, tok,
                                      smoke.PROMPT_LEN, PROFILE_DECODE_STEPS)
    print(json.dumps(summarize(prof.events(), wall, "decode",
                               layers=layers,
                               batch=smoke.SERVE_BATCH,
                               steps=PROFILE_DECODE_STEPS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
