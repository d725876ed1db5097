"""pixtral-12b [vlm] [hf:mistralai/Pixtral-12B-2409; unverified]: 40L
d_model=5120 32H (kv=8) d_ff=14336 vocab=131072; pixtral-ViT frontend is a
STUB: input_specs() supplies precomputed patch embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral_12b", family="vlm",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, act="swiglu", frontend="vision",
    microbatches=2,
)
