"""End-to-end training driver: train an LM with checkpoint / restart, a
preemption flush, a CI-guaranteed eval, straggler monitoring and a
threshold alarm on the loss.

The port of :mod:`repro.launch.train`, flag for flag, plus ``--device``
(the card unless ``--device cpu``). On the CPU, at ~5M parameters and
64 tokens a sequence:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --smoke --device cpu

On the card, at full width (``--smoke`` off):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --steps 8 --seq-len 1024 --batch 8 --ckpt-every 4 --eval-every 8

The step is :func:`repro_torch.train.build_train_step`, run eagerly.
Every ``--ckpt-every`` steps the state is checkpointed
(:mod:`repro_torch.distributed.checkpoint`, written on a thread while
training goes on); ``--resume`` starts from the newest committed step
under ``--ckpt-dir/<arch>``. On SIGTERM the step in flight finishes, a
checkpoint is written and the driver returns; :func:`main` puts the
previous SIGTERM handler back when it returns.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import signal
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import tokens as data_tokens
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.evalx import ApproxEval, ThresholdMonitor
from repro_torch.models import build
from repro_torch.train import OptConfig, build_train_step, init_state

EVAL_EXAMPLES, EVAL_BATCH = 512, 16


def smoke_overrides(cfg):
    return dataclasses.replace(
        cfg, n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=2048, microbatches=1, remat=False,
        param_dtype="float32", compute_dtype="float32")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.smoke:
        cfg = smoke_overrides(cfg)
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    model = build(cfg)
    ocfg = OptConfig.for_arch(cfg, lr=args.lr, warmup_steps=20,
                              total_steps=args.steps)
    step_fn = build_train_step(model, ocfg)

    state = init_state(model, 0, ocfg, device=device)
    start_step = 0
    ckpt_dir = Path(args.ckpt_dir) / cfg.name
    if args.resume:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state, meta = ckpt.restore_checkpoint(ckpt_dir, latest, state)
            start_step = latest
            print(f"resumed from step {latest} ({meta})")

    # paper-integrated monitors
    loss_alarm = ThresholdMonitor(threshold=3.0 * math.log(cfg.vocab),
                                  value_range=(0.0,
                                               4.0 * math.log(cfg.vocab)),
                                  direction="above")
    straggler = StragglerMonitor(n_hosts=1)

    # preemption: flush a checkpoint on SIGTERM, then return
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True
    previous = signal.signal(signal.SIGTERM, _on_term)
    try:
        join = lambda: None
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in
                     data_tokens.train_batch(cfg, shape, step).items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            straggler.record(np.array([dt]))
            if loss_alarm.update(metrics["loss_ci_state"]):
                print(f"[ALARM] loss CI above threshold at step {step}")
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"dt {dt*1e3:.0f}ms flagged={straggler.flagged()}",
                      flush=True)
            if (step + 1) % args.ckpt_every == 0 or preempted["flag"]:
                join()  # previous async write
                join = ckpt.save_checkpoint(
                    ckpt_dir, step + 1, state,
                    meta={"arch": cfg.name, "loss": loss}, async_write=True)
            if preempted["flag"]:
                print("preemption flush complete; exiting", flush=True)
                break
            if (step + 1) % args.eval_every == 0:
                run_eval(model, cfg, state, args)
        join()
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("done", flush=True)
    return state


def run_eval(model, cfg, state, args):
    """:class:`ApproxEval` of the state's model over a scrambled eval set
    of ``EVAL_EXAMPLES`` sequences of ``--seq-len`` tokens, batches of
    ``EVAL_BATCH``, delta 1e-6, target width 0.1. Returns the report."""
    device = next(state["params"].parameters()).device
    scramble = data_tokens.make_eval_scramble(cfg, n_examples=EVAL_EXAMPLES,
                                              seq_len=args.seq_len)

    @torch.inference_mode()
    def loss_fn(batch):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        logits, _ = model.forward(state["params"], batch)
        targets = batch["targets"]
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              targets.clamp(min=0).long()[..., None])[..., 0]
        return logz - picked, targets >= 0

    ev = ApproxEval(loss_fn, vocab=cfg.vocab_padded, delta=1e-6)
    rep = ev.run(scramble.batches(batch_size=EVAL_BATCH),
                 scramble.n_examples, target_width=0.1)
    print(f"[eval] loss in [{rep.lo:.4f}, {rep.hi:.4f}] "
          f"using {rep.examples_used}/{rep.total_examples} examples "
          f"({rep.fraction_used:.0%}), early_stop={rep.stopped_early}",
          flush=True)
    return rep


if __name__ == "__main__":
    main()
