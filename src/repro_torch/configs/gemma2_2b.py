"""gemma2-2b — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local(4096)/global alternating attention, attn softcap 50, final logit
softcap 30, tied embeddings, head_dim 256.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256000,
    head_dim=256,
    sliding_window=4096,
    local_global_alternate=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
)
