"""seamless-m4t-medium — enc-dec, 12L(+12L) d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206; speech frontend stubbed to frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,  # encoder layers; decoder mirrors with cross-attention
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    frontend="audio",
)
