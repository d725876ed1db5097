"""Model zoo facade: one uniform API over all the architectures.

  model = build(cfg)
  lm = model.init(seed)                          # the module, on the card
  loss, metrics = model.loss(lm, batch)          # train
  logits, cache = model.prefill(lm, batch)       # inference-prefill
  logits, cache = model.decode(lm, cache, batch) # one decode step
  logits, aux = model.forward(lm, batch)         # teacher-forced forward

The port of :mod:`repro.models.zoo`: the callables keep the reference's
names and argument order, with the module (an ``LM``, or an ``EncDec``
for the enc-dec family) in place of the params pytree. ``init`` and
``init_cache`` take ``device=None``, meaning the card
(:func:`repro_torch.device.resolve_device`), and raise without CUDA
unless ``device="cpu"`` (or ``"meta"``, shapes only) is passed; the
other calls run where the module lives. ``prefill`` and ``decode`` run under ``torch.inference_mode()``.

``loss`` returns the cross-entropy plus the z-loss and the aux term, and
in its metrics the per-token loss *moment state* (count / mean / m2 /
min / max, :func:`repro_torch.core.state.moments_of_batch`): the mergeable
CI state that :class:`repro_torch.evalx.ThresholdMonitor` takes. For the
ssm family its gradient runs through the selective-scan backward kernel
on the ``"pallas"`` path; the dense, vlm, moe, hybrid and enc-dec
families run plain PyTorch (the reference has no kernel there either).
The enc-dec's ``prefill`` returns ``{"memory": ...}`` and its ``decode``
takes ``batch["memory"]`` and returns ``{"self": ...}``.

``input_specs(cfg, shape)`` returns ``(shape, dtype)`` stand-ins for every
model input of a workload shape; ``make_batch`` materializes small
concrete batches from a numpy RNG, the same numbers as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.state import moments_of_batch
from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import compute_dtype

# copies of the reference's coefficients (repro.models.zoo)
Z_LOSS_COEF = 1e-4
MOE_AUX_COEF = 1e-2


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable          # (seed, device=None) -> LM / EncDec module
    loss: Callable          # (module, batch) -> (loss, metrics)
    forward: Callable       # (module, batch) -> (logits, aux)
    prefill: Callable       # (module, batch) -> (logits, cache)
    init_cache: Callable    # (batch_size, max_len, device=None) -> cache
    decode: Callable        # (module, cache, batch) -> (logits, cache)


def _front_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.frontend is None or cfg.family == "encdec":
        return 0
    fl = int(seq_len * cfg.frontend_len_frac) // 16 * 16
    return int(min(max(fl, 16), seq_len // 2))


def window_for(cfg: ArchConfig, seq_len: int) -> Optional[int]:
    """Sub-quadratic rule: the hybrid's shared attention switches to a
    sliding window at long-context shapes (DESIGN.md §4.1)."""
    if cfg.family == "hybrid" and cfg.sliding_window and \
            seq_len > 4 * cfg.sliding_window:
        return cfg.sliding_window
    return None


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor, aux: torch.Tensor,
             cfg: ArchConfig):
    """logits f32 (B, T, V); targets int (B, T), -1 = ignore. Returns
    ``(total, metrics)``: the mean token cross-entropy plus the z-loss and
    the aux term, as the reference computes them; the metrics (loss,
    z_loss, aux_loss, tokens and the per-token loss state
    ``loss_ci_state``) are detached."""
    mask = (targets >= 0).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = targets.clamp(min=0).long()
    picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - picked) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    z_loss = Z_LOSS_COEF * ((logz * mask) ** 2).sum() / denom
    total = loss + z_loss + MOE_AUX_COEF * aux
    # the paper's integration: a mergeable CI state over per-token losses
    ci_state = moments_of_batch(nll.detach().reshape(-1),
                                mask.reshape(-1) > 0)
    metrics = {"loss": loss.detach(), "z_loss": z_loss.detach(),
               "aux_loss": aux.detach(), "loss_ci_state": ci_state,
               "tokens": denom}
    return total, metrics


def build(cfg: ArchConfig) -> Model:
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    return _build_lm(cfg)


def _initializer(make, cfg: ArchConfig):
    def init(seed: int = 0, device=None):
        """The module with weights drawn from a generator seeded with
        ``seed`` on ``device`` (the same seed gives other numbers on the
        card than on the CPU). On ``"meta"`` the weights have shapes and
        dtypes only and nothing is drawn."""
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        return make(cfg, gen, dev)
    return init


def _build_lm(cfg: ArchConfig) -> Model:
    init = _initializer(lm_mod.lm_init, cfg)

    def forward(params, batch, window=None):
        return lm_mod.lm_forward(params, cfg, batch["tokens"],
                                 extra_embeds=batch.get("extra_embeds"),
                                 window=window)

    def loss(params, batch, window=None):
        logits, aux = forward(params, batch, window)
        return _ce_loss(logits, batch["targets"], aux, cfg)

    @torch.inference_mode()
    def prefill(params, batch, window=None):
        return lm_mod.lm_prefill(params, cfg, batch["tokens"],
                                 extra_embeds=batch.get("extra_embeds"),
                                 window=window)

    def init_cache(batch_size, max_len, device=None):
        return lm_mod.lm_init_cache(cfg, batch_size, max_len,
                                    resolve_device(device))

    @torch.inference_mode()
    def decode(params, cache, batch, window=None):
        return lm_mod.lm_decode_step(params, cfg, batch["token"],
                                     batch["pos"], cache, window=window)

    return Model(cfg, init, loss, forward, prefill, init_cache, decode)


def _build_encdec(cfg: ArchConfig) -> Model:
    init = _initializer(encdec_mod.encdec_init, cfg)

    def forward(params, batch, window=None):
        return encdec_mod.encdec_forward(params, cfg, batch["frame_embeds"],
                                         batch["tokens"])

    def loss(params, batch, window=None):
        logits, aux = forward(params, batch)
        return _ce_loss(logits, batch["targets"], aux, cfg)

    @torch.inference_mode()
    def prefill(params, batch, window=None):
        """The last position's logits and ``{"memory": encode(...)}``.
        The reference computes the logits of every position and slices
        the last; the head here sees the last position only, which gives
        the same numbers (the norm and the head act a position at a time)
        without the (B, T, vocab) float32 logits: 8.4 GB at 8 x 1024
        positions of seamless-m4t's 256,256-token vocabulary."""
        memory = encdec_mod.encode(params, cfg, batch["frame_embeds"])
        logits = encdec_mod.decode_train(params, cfg, batch["tokens"],
                                         memory, last_only=True)
        return logits, {"memory": memory}

    def init_cache(batch_size, max_len, device=None):
        return encdec_mod.encdec_init_cache(cfg, batch_size, max_len,
                                            resolve_device(device))

    @torch.inference_mode()
    def decode(params, cache, batch, window=None):
        return encdec_mod.encdec_decode_step(params, cfg, batch["token"],
                                             batch["pos"], cache,
                                             batch["memory"])

    return Model(cfg, init, loss, forward, prefill, init_cache, decode)


# -- input specs / batches ----------------------------------------------------


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the reference's
    ``jax.ShapeDtypeStruct`` stand-in; no allocation)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """Stand-ins for the step inputs of a workload shape.

    Modality frontends are stubs: the spec supplies precomputed frame /
    patch embeddings directly."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cdt = compute_dtype(cfg)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            half = S // 2
            return {"frame_embeds": TensorSpec((B, half, cfg.d_model), cdt),
                    "tokens": TensorSpec((B, half), i32),
                    "targets": TensorSpec((B, half), i32)}
        fl = _front_len(cfg, S)
        spec = {"tokens": TensorSpec((B, S - fl), i32),
                "targets": TensorSpec((B, S), i32)}
        if fl:
            spec["extra_embeds"] = TensorSpec((B, fl, cfg.d_model), cdt)
        return spec
    # decode: one new token against a seq_len-deep cache
    spec = {"token": TensorSpec((B, 1), i32), "pos": TensorSpec((), i32)}
    if cfg.family == "encdec":
        spec["memory"] = TensorSpec((B, cfg.decode_memory_len, cfg.d_model),
                                    cdt)
    return spec


def make_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """Concrete random batch matching :func:`input_specs`, drawn from
    ``np.random.default_rng(seed)`` in the reference's order, so both
    packages get the same tokens. ``device=None`` means the card; on
    ``"meta"`` the batch is shapes and dtypes only, with no draw."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return {k: torch.empty(s.shape, dtype=s.dtype, device=dev)
                for k, s in input_specs(cfg, shape).items()}
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32 and k in ("tokens", "targets", "token"):
            arr = rng.integers(0, cfg.vocab, size=s.shape).astype(np.int32)
            fl = _front_len(cfg, shape.seq_len)
            if k == "targets" and fl:
                arr[:, :fl] = -1   # no loss on frontend positions
            out[k] = torch.from_numpy(arr).to(dev)
        elif k == "pos":
            out[k] = torch.tensor(shape.seq_len // 2, dtype=torch.int32,
                                  device=dev)
        else:
            out[k] = torch.from_numpy(
                rng.normal(0, 0.02, size=s.shape).astype(np.float32)
            ).to(device=dev, dtype=s.dtype)
    return out
