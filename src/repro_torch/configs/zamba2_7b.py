"""zamba2-7b [hybrid] [arXiv:2411.15242; unverified]: 81 Mamba2 layers
d_model=3584 + one SHARED attention block (32H kv=32 d_ff=14336) applied
every 6 layers on concat(hidden, embeddings); ssm_state=64, vocab=32000.
At long_500k the shared attention uses a 4096-token sliding window
(sub-quadratic; DESIGN.md §4.1)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_7b", family="hybrid", source="arXiv:2411.15242; unverified",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, ssm_kind="mamba2", ssm_state=64,
    ssm_head_dim=64, hybrid_attn_period=6, sliding_window=4096,
    act="swiglu", microbatches=2,
)
