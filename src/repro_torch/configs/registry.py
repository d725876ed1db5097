"""Arch registry: ``get("<id>")`` returns the full assigned config,
``get("<id>", reduced=True)`` a smoke-test-sized config of the same family.

The port of :mod:`repro.configs.registry`: every id and alias of the
reference, each with its config module here.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "seamless_m4t_large_v2",
    "stablelm_1_6b",
    "qwen2_5_3b",
    "phi3_mini_3_8b",
    "qwen3_0_6b",
    "dbrx_132b",
    "arctic_480b",
    "zamba2_7b",
    "pixtral_12b",
    "falcon_mamba_7b",
)

# every family is ported: the ssm (Mamba1), dense, vlm, moe, hybrid
# (Mamba2) and enc-dec
PORTED_ARCH_IDS = ARCH_IDS

# accept dashed ids from the assignment table too
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "dbrx-132b": "dbrx_132b",
    "arctic-480b": "arctic_480b",
    "zamba2-7b": "zamba2_7b",
    "pixtral-12b": "pixtral_12b",
    "falcon-mamba-7b": "falcon_mamba_7b",
})


def get(arch_id: str, reduced: bool = False) -> ArchConfig:
    key = _ALIASES.get(arch_id, arch_id)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    cfg: ArchConfig = mod.CONFIG
    return reduce_config(cfg) if reduced else cfg


def all_configs(reduced: bool = False) -> Dict[str, ArchConfig]:
    return {i: get(i, reduced) for i in ARCH_IDS}


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test-sized config of the same family: small widths/layers, few
    experts, tiny vocab — runs a forward/train step on CPU in seconds."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family not in ("hybrid",) else 7),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        microbatches=1,
    )
    if cfg.family == "moe":
        changes.update(n_experts=min(cfg.n_experts, 8),
                       top_k=min(cfg.top_k, 2), moe_group_size=64)
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=32,
                       ssm_chunk=32)
    if cfg.family == "hybrid":
        changes.update(hybrid_attn_period=3)
    if cfg.family == "encdec":
        changes.update(enc_layers=2)
    return dataclasses.replace(cfg, **changes)
