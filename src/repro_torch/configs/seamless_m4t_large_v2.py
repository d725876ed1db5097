"""seamless-m4t-large-v2 [audio]: enc-dec multimodal backbone
[arXiv:2308.11596; hf]. 24L (per stack) d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206. Audio frontend is a STUB: input_specs() supplies
precomputed frame embeddings (assignment rule)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_large_v2", family="encdec",
    source="arXiv:2308.11596; hf",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, act="gelu", norm="layernorm",
    cross_attention=True, frontend="audio",
    microbatches=1,
)
