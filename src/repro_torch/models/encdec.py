"""Encoder-decoder backbone (seamless-m4t; port of ``repro.models.encdec``):
n_layers bidirectional encoder layers over frontend (audio) embeddings and
n_layers causal decoder layers with cross-attention.  The speech frontend
is the reference's stub: the caller supplies frame embeddings.  On the
card the encoder's self-attention and the cross-attention are K7 with
``causal=False``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "ln1": L.rmsnorm_init(d, gen.device),
        "attn": L.attention_init(gen, cfg),
        "ln_x": L.rmsnorm_init(d, gen.device),
        "xattn": L.attention_init(gen, cfg),
        "ln2": L.rmsnorm_init(d, gen.device),
        "ffn": L.mlp_init(gen, d, cfg.d_ff),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "embed": L.weight_init(gen, (cfg.padded_vocab, d), scale=0.02),
        "encoder": [tfm.block_init(gen, cfg) for _ in range(cfg.n_layers)],
        "decoder": [_dec_block_init(gen, cfg) for _ in range(cfg.n_layers)],
        "enc_norm": L.rmsnorm_init(d, gen.device),
        "final_norm": L.rmsnorm_init(d, gen.device),
        "lm_head": L.weight_init(gen, (d, cfg.padded_vocab)),
    }


def encode(params, cfg: ModelConfig, enc_embeddings, *, remat: bool = False):
    """enc_embeddings: (B, S_enc, D) from the frontend stub -> memory."""
    x = enc_embeddings.to(L.CDTYPE)
    for lp in params["encoder"]:
        a, _ = L.attention_apply(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg, 0,
                                 causal=False)
        x = x + a
        x = x + L.mlp_apply(lp["ffn"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(lp, cfg: ModelConfig, memory):
    B, S = memory.shape[:2]
    hk, dh = cfg.n_kv_heads, cfg.head_dim_
    k = (memory @ lp["xattn"]["wk"].to(L.CDTYPE)).reshape(B, S, hk, dh)
    v = (memory @ lp["xattn"]["wv"].to(L.CDTYPE)).reshape(B, S, hk, dh)
    return k, v


def _dec_block(lp, x, cfg, positions, memory=None, cross=None, cache=None):
    a, nc = L.attention_apply(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg, positions,
                              kv_cache=cache)
    x = x + a
    ck = cross if cross is not None else _cross_kv(lp, cfg, memory)
    xa, _ = L.attention_apply(lp["xattn"], L.rmsnorm(lp["ln_x"], x, cfg.norm_eps), cfg, positions,
                              cross_kv=ck)
    x = x + xa
    return x + L.mlp_apply(lp["ffn"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps)), nc


def forward(params, cfg: ModelConfig, batch, *, remat: bool = False, last_only: bool = False):
    """batch: {"enc_embeddings": (B,S_enc,D), "tokens": (B,S_dec)}."""
    memory = encode(params, cfg, batch["enc_embeddings"], remat=remat)
    x = params["embed"][batch["tokens"].long()].to(L.CDTYPE)
    for lp in params["decoder"]:
        x, _ = _dec_block(lp, x, cfg, 0, memory=memory)
    if last_only:
        x = x[:, -1:]
    return tfm.unembed(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, *, device="cpu"):
    hk, dh = cfg.n_kv_heads, cfg.head_dim_

    def zeros(T):
        return torch.zeros((cfg.n_layers, batch, T, hk, dh), dtype=L.CDTYPE, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len), "ck": zeros(enc_len), "cv": zeros(enc_len),
            "pos": 0}


def prefill_cross(params, cfg: ModelConfig, cache, memory):
    """Precompute per-layer cross-attention K/V from encoder memory."""
    ck, cv = zip(*(_cross_kv(lp, cfg, memory) for lp in params["decoder"]))
    return {**cache, "ck": torch.stack(ck), "cv": torch.stack(cv)}


def decode_step(params, cfg: ModelConfig, cache, batch, *, last_only: bool = False):
    """As ``transformer.decode_step``, over the cached cross K/V."""
    x = params["embed"][batch["tokens"].long()].to(L.CDTYPE)
    S = x.shape[1]
    pos = int(cache["pos"])
    for i, lp in enumerate(params["decoder"]):
        x, _ = _dec_block(lp, x, cfg, pos, cross=(cache["ck"][i], cache["cv"][i]),
                          cache={"k": cache["k"][i], "v": cache["v"][i], "pos": pos})
    if last_only:
        x = x[:, -1:]
    return tfm.unembed(params, cfg, x), {**cache, "pos": pos + S}
