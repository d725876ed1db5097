"""phi3-mini-3.8b [dense] [arXiv:2404.14219; unverified]: 32L d_model=3072
32H (kv=32) d_ff=8192 vocab=32064, RoPE SwiGLU."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3_mini_3_8b", family="dense",
    source="arXiv:2404.14219; unverified",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, act="swiglu",
)
