#!/usr/bin/env python3
"""The selective-scan forward kernel against variants of its own layout,
on one card.

    python3 scripts/scan_variants.py [--extra NAME=PATH ...]

Builds ``csrc/selective_scan.cu`` as it is and with one launch constant
changed at a time (two states a lane instead of four, three CTAs an SM
instead of two, 16-step stages instead of 32, the scan loop unrolled 4 or
16 steps instead of 8), plus any other source given with ``--extra`` (a
file with the same ``repro_selective_scan`` C entry point, e.g. an
earlier commit's kernel), each with the port's ``nvcc`` flags into a
library of its own. Each is checked against the plain version on the card
(``hout`` and ``hseg`` bit for bit, ``y`` within ``chip_smoke.SCAN_RTOL``)
at small uneven shapes and the training shape, then timed at the
training (2, 4096) and serving (8, 2048) shapes at d_inner 8192 with
``chip_smoke.Timer`` (CUDA events, L2 flushed before each call), the
variants in turn and then in reverse order. It prints the card's name and
power limit as ``nvidia-smi`` gives them, then one JSON line: each
variant's registers and spills (``-Xptxas -v``), its check and its
times. Needs CUDA and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/selective_scan.cu"
OUT = ROOT / "build" / "scan_variants"
_UNROLL = "#pragma unroll 8\n      for (int s = 0; s < kSeg; ++s)"
# name: (text in the source, its replacement)
VARIANTS = {
    "states2": ("constexpr int kStates = 4;", "constexpr int kStates = 2;"),
    "ctas3": ("constexpr int kMinCtas = 2;", "constexpr int kMinCtas = 3;"),
    "seg16": ("constexpr int kSeg = 32;", "constexpr int kSeg = 16;"),
    "unroll4": (_UNROLL, _UNROLL.replace("unroll 8", "unroll 4")),
    "unroll16": (_UNROLL, _UNROLL.replace("unroll 8", "unroll 16")),
}
CHECK_SHAPES = [(2, 96, 200, 16, 32), (3, 100, 128, 16, 25),
                (2, 96, 200, 8, 32), (1, 64, 130, 16, 32),
                smoke.TRAIN_SCAN_SHAPE]
TIME_SHAPES = {"train": smoke.TRAIN_SCAN_SHAPE,
               "serve": (smoke.SERVE_BATCH, smoke.PROMPT_LEN, 8192, 16,
                         512)}
TIME_REPS = 15


def build(sources: dict, nvcc: str, flags: list) -> dict:
    """Compile every source into OUT/<name>.so at once; returns
    {name: (rc, ptxas lines)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(OUT / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        logs[name] = (p.returncode, [
            ln.strip() for ln in out.splitlines()
            if "registers" in ln or "spill" in ln or "error" in ln])
    return logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another source with the same C entry point")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    print(smoke.nvidia_smi_line(), flush=True)
    text = SOURCE.read_text()
    sources = {"kernel": text}
    for name, (old, new) in VARIANTS.items():
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"{SOURCE.name}")
        sources[name] = text.replace(old, new)
    for item in args.extra:
        name, path = item.split("=", 1)
        sources[name] = Path(path).read_text()
    logs = build(sources, _build._nvcc(), _build.NVCC_FLAGS)
    fns = {}
    for name, (rc, _) in logs.items():
        if rc == 0:
            fn = ctypes.CDLL(str(OUT / f"{name}.so")).repro_selective_scan
            fn.argtypes, fn.restype = _build._SIGNATURES[
                "repro_selective_scan"]
            fns[name] = fn

    def run(fn, inputs, tc):
        x, b = inputs[0], inputs[2]
        B, L, din = x.shape
        n = b.shape[-1]
        outs = (torch.empty((B, L, din), device="cuda"),
                torch.empty((B, din, n), device="cuda"),
                torch.empty((B, L // tc, din, n), device="cuda"))
        rc = fn(*(t.data_ptr() for t in inputs), B, L, din, n, tc,
                *(t.data_ptr() for t in outs), 0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return outs

    checks = {name: [] for name in fns}
    for i, (B, L, din, n, tc) in enumerate(CHECK_SHAPES):
        inputs = smoke.scan_inputs(torch, B, L, din, n, seed=i)
        want = ref.selective_scan_ref(*inputs, time_chunk=tc)
        for name, fn in fns.items():
            got = run(fn, inputs, tc)
            torch.cuda.synchronize()
            y_rel = float((got[0] - want[0]).abs().max()
                          / want[0].abs().max())
            states = all(smoke._bits_equal(torch, g, w)
                         for g, w in zip(got[1:], want[1:]))
            checks[name].append(dict(
                shape=[B, L, din, n, tc], y_max_rel=y_rel,
                states_bitwise=states,
                ok=states and y_rel <= smoke.SCAN_RTOL))
    timer = smoke.Timer(torch)
    times = {name: {} for name in fns}
    for label, (B, L, din, n, tc) in TIME_SHAPES.items():
        inputs = smoke.scan_inputs(torch, B, L, din, n, seed=0)
        order = list(fns)
        for name in order + order[::-1]:
            times[name].setdefault(label, []).append(timer(
                lambda: run(fns[name], inputs, tc), reps=TIME_REPS))
    out = {name: dict(build_rc=logs[name][0], ptxas=logs[name][1],
                      ok=name in fns and all(c["ok"] for c in checks[name]),
                      checks=checks.get(name), ms=times.get(name))
           for name in sources}
    print(json.dumps(dict(time_shapes=TIME_SHAPES, variants=out)),
          flush=True)
    return 0 if all(v["ok"] for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
