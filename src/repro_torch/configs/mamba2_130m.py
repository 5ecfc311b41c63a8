"""mamba2-130m — 24L d_model=768, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,  # unused (attention-free); kept for schema completeness
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
)
