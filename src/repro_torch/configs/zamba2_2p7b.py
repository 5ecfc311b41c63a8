"""zamba2-2.7b — 54L hybrid: Mamba2 backbone (ssm_state=64) + ONE shared
attention/MLP block (32H, kv=32) applied every 6 layers, d_model=2560,
d_ff=10240, vocab=32000.  [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    shared_attn_every=6,
)
