"""Decoder-only transformer family (port of ``repro.models.transformer``):
dense GQA models (yi, deepseek, mistral-large), the M-RoPE backbone
(qwen2-vl), local/global attention with softcaps (gemma2), and the MoE
variants: dbrx (every layer MoE) and llama4-maverick (dense and MoE
layers interleaved, stacked as super-blocks of the two).

The reference stacks the layers and scans over them; here ``params["layers"]``
is a list of per-layer dicts (per super-block at ``_moe_every == 2``:
``{"dense": block with 2 d_ff, "moe": block}``) and a Python loop walks it.
The KV cache keeps the reference's stacked layout, (L, B, T, Hk, Dh), one
slot a layer (two a super-block), and is written in place
(``layers.attention_apply``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _moe_every(cfg: ModelConfig) -> int:
    """llama4-style interleaving: every k-th layer is MoE (k=2 for llama4);
    1 means every layer (dbrx); 0 means dense model."""
    if cfg.n_experts == 0:
        return 0
    return cfg.moe_every


def stack_depth(cfg: ModelConfig) -> int:
    """Entries of ``params["layers"]``: n_layers, or n_layers / 2
    super-blocks at ``_moe_every == 2``."""
    return cfg.n_layers // 2 if _moe_every(cfg) == 2 else cfg.n_layers


def block_init(gen: torch.Generator, cfg: ModelConfig, *, moe: bool = False,
               dense_ff: int | None = None):
    d = cfg.d_model
    return {
        "ln1": L.rmsnorm_init(d, gen.device),
        "attn": L.attention_init(gen, cfg),
        "ln2": L.rmsnorm_init(d, gen.device),
        "ffn": L.moe_init(gen, cfg) if moe else L.mlp_init(gen, d, dense_ff or cfg.d_ff),
    }


def block_apply(p, x, cfg: ModelConfig, positions, *, window=None, cache=None,
                moe: bool = False):
    a, new_cache = L.attention_apply(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, positions,
        layer_window=window, kv_cache=cache,
    )
    x = x + a
    h_in = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    h = L.moe_apply(p["ffn"], h_in, cfg) if moe else L.mlp_apply(p["ffn"], h_in)
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
    me = _moe_every(cfg)
    d = cfg.d_model
    embed = L.weight_init(gen, (cfg.padded_vocab, d), scale=0.02)
    if me == 2:
        layers = [{"dense": block_init(gen, cfg, dense_ff=2 * cfg.d_ff),
                   "moe": block_init(gen, cfg, moe=True)} for _ in range(stack_depth(cfg))]
    else:
        layers = [block_init(gen, cfg, moe=me == 1) for _ in range(cfg.n_layers)]
    p = {"embed": embed, "layers": layers, "final_norm": L.rmsnorm_init(d, gen.device)}
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
    x = embed_inputs(params, cfg, batch)
    positions = batch.get("positions", 0)
    me = _moe_every(cfg)
    for lp, w in zip(params["layers"], _windows(cfg, stack_depth(cfg))):
        if me == 2:
            x, _ = block_apply(lp["dense"], x, cfg, positions, window=w)
            x, _ = block_apply(lp["moe"], x, cfg, positions, window=w, moe=True)
        else:
            x, _ = block_apply(lp, x, cfg, positions, window=w, moe=me == 1)
    if last_only:
        x = x[:, -1:]
    return unembed(params, cfg, x)


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cpu"):
    """n_layers K/V slots (two a super-block at ``_moe_every == 2``)."""
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
    and gives it the same logits.  At ``_moe_every == 2`` super-block i
    writes cache slots 2i (its dense block) and 2i + 1 (its MoE block),
    the reference's (n_layers / 2, 2, ...) view of the cache."""
    x = embed_inputs(params, cfg, batch)
    S = x.shape[1]
    pos = int(cache["pos"])
    me = _moe_every(cfg)

    def slot(i):
        return {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}

    for i, (lp, w) in enumerate(zip(params["layers"], _windows(cfg, stack_depth(cfg)))):
        if me == 2:
            x, _ = block_apply(lp["dense"], x, cfg, pos, window=w, cache=slot(2 * i))
            x, _ = block_apply(lp["moe"], x, cfg, pos, window=w, cache=slot(2 * i + 1), moe=True)
        else:
            x, _ = block_apply(lp, x, cfg, pos, window=w, cache=slot(i), moe=me == 1)
    if last_only:
        x = x[:, -1:]
    return unembed(params, cfg, x), {**cache, "pos": pos + S}
