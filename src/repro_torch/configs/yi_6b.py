"""yi-6b — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
)
