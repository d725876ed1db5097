#!/usr/bin/env python3
"""Where the time of the port's dense, hybrid and enc-dec serving paths
goes, on one card.

    python3 scripts/profile_dense_serve.py [--models qwen2_5_3b,...]

Serves as ``chip_smoke.py``'s phases 5c and 5d do, through its own
functions: each model of its ``DENSE_SERVE`` (qwen2.5-3b and pixtral-12b
at full width and depth, dbrx-132b at full width and 4 layers) and
``HYBRID_SERVE`` (zamba2-7b and seamless-m4t-large-v2 at full width and
depth; bf16, random weights from ``MODEL_SEED``) on the card, one
untimed prefill of ``SERVE_BATCH`` x ``PROMPT_LEN`` positions and two
decode steps to warm up, then one prefill and ``PROFILE_DECODE_STEPS``
greedy decode steps (the enc-dec's from each request's first token at
position 0 against its encoder memory), each window traced with
``torch.profiler``. For each window it prints one JSON line as
``scripts/profile_mamba1_serve.py`` does: host-clock wall time, the
card's busy time and idle share, the kernel count, the time by kind
(``gemm``, ``elementwise``) and the ten longest kernels.
The card's name and power limit come first, as ``nvidia-smi`` prints
them. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke as smoke  # noqa: E402
from profile_mamba1_serve import (PROFILE_DECODE_STEPS,  # noqa: E402
                                  summarize)


def profile_model(arch_id: str, layers) -> None:
    model, lm, batch, _ = smoke.serving_model_of(torch, np, arch_id, layers)
    smoke.serve_batch_once(torch, model, lm, batch, 2)      # warm up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill(lm, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    info = dict(model=arch_id, layers=model.cfg.n_layers,
                batch=smoke.SERVE_BATCH)
    print(json.dumps(summarize(prof.events(), wall, "prefill",
                               positions=smoke.PROMPT_LEN, **info)),
          flush=True)
    if "memory" in cache:   # the enc-dec: from the first token at 0
        tok, T, extra = batch["tokens"][:, :1], 0, {"memory":
                                                    cache["memory"]}
        cache = model.init_cache(tok.shape[0], PROFILE_DECODE_STEPS + 1)
    else:
        T = cache["attn" if "attn" in cache else "layers"]["k"].shape[2]
        cache = smoke.with_room(model, cache, T + PROFILE_DECODE_STEPS)
        tok, extra = logits[:, -1].argmax(-1, keepdim=True), None
    with torch.profiler.profile(activities=acts) as prof:
        *_, wall = smoke.decode_steps(torch, model, lm, cache, tok, T,
                                      PROFILE_DECODE_STEPS, extra=extra)
    print(json.dumps(summarize(prof.events(), wall, "decode",
                               steps=PROFILE_DECODE_STEPS, **info)),
          flush=True)
    del model, lm, batch, logits, cache
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    served = list(smoke.DENSE_SERVE) + [(m, None, None)
                                        for m in smoke.HYBRID_SERVE]
    ap.add_argument("--models", default=",".join(m for m, _, _ in served))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_dense_serve: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    wanted = args.models.split(",")
    for arch_id, layers, _ in served:
        if arch_id in wanted:
            profile_model(arch_id, layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
