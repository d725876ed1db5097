"""dbrx-132b [moe] [hf:databricks/dbrx-base; unverified]: 40L d_model=6144
48H (kv=8) d_ff=10752, MoE 16 experts top-4, vocab=100352."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx_132b", family="moe", source="hf:databricks/dbrx-base; unverified",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352, n_experts=16, top_k=4, act="swiglu",
    optimizer="adafactor", microbatches=4,
)
