"""stablelm-1.6b [dense] [hf:stabilityai/stablelm-2-1_6b; unverified]:
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm_1_6b", family="dense",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, act="swiglu", norm="layernorm",
)
