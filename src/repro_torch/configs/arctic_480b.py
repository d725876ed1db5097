"""arctic-480b [moe] [hf:Snowflake/snowflake-arctic-base; hf]: 35L
d_model=7168 56H (kv=8) d_ff=4864, MoE 128 experts top-2 + dense residual
FFN, vocab=32000.

TP-divisibility note (DESIGN.md §8): 56 q-heads are padded to 64 so the
head axis shards over the 16-way model axis (head_dim 128 preserved;
n_heads_logical retained below for accounting)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic_480b", family="moe",
    source="hf:Snowflake/snowflake-arctic-base; hf",
    n_layers=35, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000, n_experts=128, top_k=2,
    moe_dense_residual=True, act="swiglu",
    optimizer="adafactor", moment_dtype="bfloat16", microbatches=8,
)

N_HEADS_LOGICAL = 56
