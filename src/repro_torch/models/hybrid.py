"""Zamba2-style hybrid (port of ``repro.models.hybrid``): a Mamba2 backbone
with ONE shared transformer block (attention + MLP, weights reused)
applied every ``shared_attn_every`` layers (arXiv:2411.15242), with the
reference's simplification (DESIGN.md): no concatenated embedding
re-injection and no per-application LoRA deltas.

The shared block runs after each group of ``shared_attn_every`` mamba
layers, with its own KV-cache slot per application.  Its attention is K7
on the card, at zamba2-2.7b's head dim 80 too (K7 pads it to 128 columns
inside the kernel).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm


def _groups(cfg: ModelConfig) -> int:
    k = cfg.shared_attn_every
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.n_layers} layers are not groups of {k}")
    return cfg.n_layers // k


def init_params(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "embed": L.weight_init(gen, (cfg.padded_vocab, d), scale=0.02),
        "mamba_layers": [{"ln": L.rmsnorm_init(d, gen.device),
                          "mixer": ssm.mamba2_init(gen, cfg)}
                         for _ in range(cfg.n_layers)],
        "shared": tfm.block_init(gen, cfg),
        "final_norm": L.rmsnorm_init(d, gen.device),
        "lm_head": L.weight_init(gen, (d, cfg.padded_vocab)),
    }


def _mamba_block(lp, x, cfg, ssm_state=None, conv_state=None):
    h, states = ssm.mamba2_apply(
        lp["mixer"], L.rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
        ssm_state=ssm_state, conv_state=conv_state,
    )
    return x + h, states


def forward(params, cfg: ModelConfig, batch, *, remat: bool = False, last_only: bool = False):
    """``remat`` is the reference's training knob, unused until the
    training slice."""
    x = tfm.embed_inputs(params, cfg, batch)
    k = cfg.shared_attn_every
    for g in range(_groups(cfg)):
        for lp in params["mamba_layers"][g * k:(g + 1) * k]:
            x, _ = _mamba_block(lp, x, cfg)
        x, _ = tfm.block_apply(params["shared"], x, cfg, 0)
    if last_only:
        x = x[:, -1:]
    return tfm.unembed(params, cfg, x)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cpu"):
    d_in, H, P, N = ssm.dims(cfg)
    G = _groups(cfg)
    conv_dim = d_in + 2 * N
    kv = (G, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1, conv_dim), dtype=L.CDTYPE,
                            device=device),
        "k": torch.zeros(kv, dtype=L.CDTYPE, device=device),
        "v": torch.zeros(kv, dtype=L.CDTYPE, device=device),
        "pos": 0,
    }


def decode_step(params, cfg: ModelConfig, cache, batch, *, last_only: bool = False):
    """As ``transformer.decode_step``: K/V written in place, the SSM and
    conv states returned as new tensors."""
    x = tfm.embed_inputs(params, cfg, batch)
    S = x.shape[1]
    pos = int(cache["pos"])
    k = cfg.shared_attn_every
    new_s, new_c = [], []
    for g in range(_groups(cfg)):
        for i in range(g * k, (g + 1) * k):
            x, (hs, hc) = _mamba_block(params["mamba_layers"][i], x, cfg,
                                       ssm_state=cache["ssm"][i], conv_state=cache["conv"][i])
            new_s.append(hs)
            new_c.append(hc)
        x, _ = tfm.block_apply(params["shared"], x, cfg, pos,
                               cache={"k": cache["k"][g], "v": cache["v"][g], "pos": pos})
    if last_only:
        x = x[:, -1:]
    new_cache = {**cache, "ssm": torch.stack(new_s), "conv": torch.stack(new_c), "pos": pos + S}
    return tfm.unembed(params, cfg, x), new_cache
