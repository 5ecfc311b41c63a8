"""Model / run configuration schema (port of ``repro.configs.base``).

One ``ModelConfig`` per assigned architecture lives in
``repro_torch/configs/<id>.py``; reduced variants (``.reduced()``) power the
CPU smoke tests.  ``RunConfig`` carries the execution-level knobs
(sharding, remat, HE-aggregation, compression) consumed by the launcher.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- attention variants ---
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (sums to head_dim/2)
    sliding_window: int = 0  # >0: local attention window
    local_global_alternate: bool = False  # gemma2: odd layers local
    attn_softcap: float = 0.0  # gemma2: 50.0
    logit_softcap: float = 0.0  # gemma2: 30.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_shared_expert: bool = False  # llama4: shared expert alongside routed
    moe_every: int = 1  # llama4: every 2nd layer is MoE (interleaved dense)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # --- hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0
    # --- enc-dec (seamless): n_layers encoder + n_layers decoder ---
    # --- modality frontend stub: model consumes embeddings directly ---
    frontend: str = ""  # "" | "vision" | "audio"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256 so the vocab dim
        shards evenly on the 16-way mesh axes (logits are sliced back to
        ``vocab`` in unembed)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Same family/topology, laptop-scale: used by smoke tests."""
        scale = dict(
            n_layers=min(self.n_layers, 4 if self.shared_attn_every else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            sliding_window=16 if self.sliding_window else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
        )
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution-level knobs."""

    model: ModelConfig
    remat: bool = True
    remat_group: int = 1  # checkpoint every k-th layer boundary (sqrt-depth memory)
    grad_accum_steps: int = 1  # microbatch accumulation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # distributed-optimization tricks
    grad_compression: str = ""  # "" | "int8"  (cross-pod hop)
    he_aggregation: bool = False  # BFV-encrypted cross-pod gradient sum
    # fault tolerance
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
