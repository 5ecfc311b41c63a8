"""Decoder-only transformer family, dense path (port of
``repro.models.transformer`` where ``_moe_every == 0``): dense GQA models
(yi, deepseek, mistral-large), the M-RoPE backbone (qwen2-vl) and
local/global attention with softcaps (gemma2).

The reference stacks the layers and scans over them; here ``params["layers"]``
is a list of per-layer dicts and a Python loop walks it.  The KV cache
keeps the reference's stacked layout, (L, B, T, Hk, Dh), and is written in
place (``layers.attention_apply``).  MoE configurations are refused: their
layers are ROADMAP Queue 1's next slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def check_dense(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration with experts."""
    if cfg.n_experts or cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: the MoE layers (moe_init, moe_apply, the transformer's MoE branches) "
            "are not ported yet (ROADMAP Queue 1)")


def block_init(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "ln1": L.rmsnorm_init(d, gen.device),
        "attn": L.attention_init(gen, cfg),
        "ln2": L.rmsnorm_init(d, gen.device),
        "ffn": L.mlp_init(gen, d, cfg.d_ff),
    }


def block_apply(p, x, cfg: ModelConfig, positions, *, window=None, cache=None):
    a, new_cache = L.attention_apply(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, positions,
        layer_window=window, kv_cache=cache,
    )
    x = x + a
    h = L.mlp_apply(p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, new_cache


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def _windows(cfg: ModelConfig, n: int) -> list[int]:
    """Per-layer sliding-window sizes (0 = global attention)."""
    if cfg.sliding_window and cfg.local_global_alternate:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(n)]
    return [cfg.sliding_window] * n


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Seeded random weights on ``gen``'s device; the weights of
    ``layers.CAST_AT_USE`` in ``CDTYPE``, the rest in float32."""
    check_dense(cfg)
    d = cfg.d_model
    p = {
        "embed": L.weight_init(gen, (cfg.padded_vocab, d), scale=0.02),
        "layers": [block_init(gen, cfg) for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(d, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.weight_init(gen, (d, cfg.padded_vocab))
    return p


def embed_inputs(params, cfg: ModelConfig, batch):
    """tokens (B,S) -> embeddings; or pass-through precomputed frontend
    embeddings (vlm/audio stubs)."""
    if "embeddings" in batch:
        x = batch["embeddings"].to(L.CDTYPE)
    else:
        x = params["embed"][batch["tokens"].long()].to(L.CDTYPE)
    if cfg.attn_softcap:  # gemma2 scales embeddings, by sqrt(d) rounded to bf16
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=L.CDTYPE))
    return x


def unembed(params, cfg: ModelConfig, x):
    """Final norm and head -> float32 logits over the PADDED vocab (the
    reference keeps that width; decode paths slice to ``cfg.vocab``)."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(L.CDTYPE)).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(params, cfg: ModelConfig, batch, *, remat: bool = False,
            remat_group: int = 1, last_only: bool = False):
    """Prefill forward -> logits (B, S, V) over the padded vocab, or
    (B, 1, V) with ``last_only``.  ``remat`` and ``remat_group`` are the
    reference's training knobs, taken for its signature and unused until
    the training slice.  ``batch["positions"]``, where given, replaces
    arange(S); on the card that raises (``layers.attention_route``)."""
    check_dense(cfg)
    x = embed_inputs(params, cfg, batch)
    positions = batch.get("positions", 0)
    for lp, w in zip(params["layers"], _windows(cfg, cfg.n_layers)):
        x, _ = block_apply(lp, x, cfg, positions, window=w)
    if last_only:
        x = x[:, -1:]
    return unembed(params, cfg, x)


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cpu"):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=L.CDTYPE, device=device),
        "v": torch.zeros(shape, dtype=L.CDTYPE, device=device),
        "pos": 0,
    }


def decode_step(params, cfg: ModelConfig, cache, batch, *, last_only: bool = False):
    """One step of S tokens (S = 1 to decode, the prompt to prefill).
    batch: {"tokens": (B, S)} (or embeddings); cache as from init_cache,
    its K/V written in place.  Returns (logits (B, S, V), cache), or
    (B, 1, V) with ``last_only``, which unembeds the last position alone
    and gives it the same logits."""
    check_dense(cfg)
    x = embed_inputs(params, cfg, batch)
    S = x.shape[1]
    pos = int(cache["pos"])
    windows = _windows(cfg, cfg.n_layers)
    for i, (lp, w) in enumerate(zip(params["layers"], windows)):
        x, _ = block_apply(lp, x, cfg, pos, window=w,
                           cache={"k": cache["k"][i], "v": cache["v"][i], "pos": pos})
    if last_only:
        x = x[:, -1:]
    return unembed(params, cfg, x), {**cache, "pos": pos + S}
