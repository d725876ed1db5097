"""qwen3-0.6b [dense] [hf:Qwen/Qwen3-8B; hf]: 28L d_model=1024 16H (kv=8)
d_ff=3072 vocab=151936, qk-norm."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_0_6b", family="dense", source="hf:Qwen/Qwen3-8B; hf",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab=151936, qk_norm=True, act="swiglu",
)
