"""qwen2-vl-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
M-RoPE, dynamic resolution; vision frontend stubbed to patch embeddings.
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # sums to head_dim/2 = 64
    frontend="vision",
)
