"""Architecture + shape config schema for the assigned model pool.

The port of :mod:`repro.configs.base`: the same dataclasses, fields,
defaults and derived properties, so a port config can be built from
``dataclasses.asdict`` of a reference config. Every architecture is
selectable by id (see :mod:`repro_torch.configs.registry`); each carries
its own shape set (train_4k / prefill_32k / decode_32k / long_500k).

``ssm_impl`` picks the Mamba1 scan: ``"xla"`` is the reference's
associative scan chunk by chunk in plain PyTorch, ``"pallas"`` the hand-written selective-scan kernel — CUDA
on the card, its plain version on the CPU
(:func:`repro_torch.kernels.ops.selective_scan`). The names are the
reference's, kept so that configs carry over unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assignment block): seq_len x global_batch per workload kind.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"   # dense | moe | ssm | hybrid | encdec | vlm | audio
    source: str = ""        # public provenance tag from the assignment

    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None       # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    act: str = "swiglu"                  # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False     # arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    moe_group_size: int = 512            # GShard dispatch group (DESIGN §Perf)
    moe_fsdp_axis: str = "d"             # which expert-weight dim dp-shards

    # SSM
    ssm_kind: Optional[str] = None       # mamba1 | mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64               # mamba2
    ssm_chunk: int = 256
    ssm_scan_dtype: str = "float32"      # bf16: halve in-chunk scan traffic
    ssm_impl: str = "xla"                # xla | pallas (hand-written scan)

    # hybrid (zamba2): one shared attention block applied every N ssm blocks
    hybrid_attn_period: int = 0
    sliding_window: Optional[int] = None # used by hybrid attn at long_500k

    # enc-dec (seamless)
    enc_layers: int = 0
    cross_attention: bool = False
    decode_memory_len: int = 4_096       # encoder memory kept during decode

    # modality frontend stub: input_specs() supplies embeddings directly
    frontend: Optional[str] = None       # None | 'audio' | 'vision'
    frontend_len_frac: float = 0.25      # fraction of seq taken by frontend

    # numerics / training
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"             # adamw | adafactor
    moment_dtype: str = "float32"        # adamw moments (bf16 for giants)
    microbatches: int = 1                # grad-accumulation splits
    remat: bool = True
    remat_policy: str = "nothing"        # nothing | dots (save matmul outs)
    shard_activations: bool = False      # residual-stream TP sharding (perf)
    attn_chunk: int = 0                  # q-chunked attention (0 = off)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    # -- derived -----------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up for TP-16 sharding (only seamless needs it)."""
        return -(-self.vocab // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def shapes(self) -> Tuple[str, ...]:
        """Shape set for this arch per the assignment rules:
        long_500k only for sub-quadratic families (skip recorded in
        DESIGN.md §4.1); every family here has a decode step."""
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.family in SUBQUADRATIC_FAMILIES:
            names.append("long_500k")
        return tuple(names)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_padded
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp_mult = 3 if self.act == "swiglu" else 2
        dense_mlp = mlp_mult * d * ff
        if self.family == "ssm":  # mamba1 block
            din, n = self.d_inner, self.ssm_state
            blk = (d * 2 * din            # in_proj (x, z)
                   + din * self.ssm_conv  # conv
                   + din * (2 * n + 1)    # B, C, dt via x_proj (+ dt rank~1)
                   + din * n + din        # A, D
                   + din * d)             # out_proj
            return self.n_layers * blk + emb
        if self.family == "hybrid":  # mamba2 blocks + one shared attn block
            din, n = self.d_inner, self.ssm_state
            nh = self.ssm_heads
            blk = (d * (2 * din + 2 * n + nh)  # in_proj: x,z,B,C,dt
                   + (din + 2 * n) * self.ssm_conv
                   + nh + nh + din            # A, D, norm
                   + din * d)
            shared = 2 * d * d + attn + dense_mlp  # concat-proj + attn + mlp
            return self.n_layers * blk + shared + emb
        blk = attn + dense_mlp
        if self.family == "moe":
            moe_mlp = self.n_experts * mlp_mult * d * ff
            blk = attn + moe_mlp + d * self.n_experts
            if self.moe_dense_residual:
                blk += dense_mlp
        total = self.n_layers * blk + emb
        if self.family == "encdec":
            total += self.enc_layers * (attn + dense_mlp) \
                + self.n_layers * (attn)  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp_mult = 3 if self.act == "swiglu" else 2
        full = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * \
            mlp_mult * d * ff
        return full - inactive
