"""falcon-mamba-7b [ssm] [arXiv:2410.05355; unverified]: 64L Mamba1
d_model=4096 (attention-free) ssm_state=16 vocab=65024."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon_mamba_7b", family="ssm",
    source="arXiv:2410.05355; unverified",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=0, vocab=65024, ssm_kind="mamba1", ssm_state=16,
    microbatches=2,
)
