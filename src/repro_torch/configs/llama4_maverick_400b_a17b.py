"""llama4-maverick-400b-a17b — 48L d_model=5120 40H (GQA kv=8) vocab=202048,
MoE 128 experts top-1 with shared expert, interleaved dense/MoE layers
(moe_every=2, dense layers use 2x d_ff).  Early-fusion multimodal backbone;
text path modeled.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    n_experts=128,
    top_k=1,
    moe_shared_expert=True,
    moe_every=2,
    rope_theta=500_000.0,
)
