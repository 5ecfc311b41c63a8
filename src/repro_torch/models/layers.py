"""Shared neural layers of the LM stack (port of ``repro.models.layers``):
RMSNorm, RoPE / M-RoPE, GQA attention (sliding window, logit softcap, KV
cache), the SwiGLU MLP and the capacity-bounded, dropping MoE.

Parameters are plain dicts of tensors and the layer functions are pure,
except that a KV cache is written in place (:func:`attention_apply`).
Compute in bf16, normalisation and softmax statistics in f32.  The
reference keeps its weights in f32 and casts them to bf16 at each use;
here the weights of :data:`CAST_AT_USE` are stored in ``CDTYPE``
(:func:`weight_init`), which gives the same values in half the memory.
The other parameters (norm scales, conv and per-head vectors, the MoE
router) stay f32.

Positions are a (B, S) tensor, a (3, B, S) tensor for M-RoPE, as the
reference takes them, or an ``int`` p standing for ``p + arange(S)`` in
every row, which is what the models pass.

Attention has two implementations, and the device of the activations
picks one (:func:`attention_route`):

* CPU tensors run the reference's own arithmetic: the scores as a bf16
  einsum scaled in f32 by ``float(1 / sqrt(head_dim))``, the softcap, the
  causal and window mask with -1e30, and the softmax rounded to bf16
  before P @ V.  This is the plain version the parity tests hold against
  the JAX package.
* CUDA tensors launch K7 (:func:`repro_torch.kernels.attention.flash_attention`),
  once per call, with ``q_offset`` the positions' offset.  K7 keeps P in
  float32 and does not round it to bf16, so the card's activations differ
  from the CPU's by that rounding; ``tests/test_torch_models.py`` and
  ``chip_smoke.py`` (phase 12) state the bound.  There is no fallback:
  positions given as a tensor, or a head dim K7 is not built for, raise
  ``ValueError``.

The MoE layer (:func:`moe_apply`) has no kernel of its own, on the card
as in the reference: its routing, scatter, expert products and gather are
PyTorch ops, the products cuBLAS's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import attention as k7
from repro_torch.sharding import ctx

CDTYPE = torch.bfloat16
# weights every use casts to CDTYPE, stored in CDTYPE: that changes no value
CAST_AT_USE = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                         "w_down", "in_proj", "out_proj", "we_gate", "we_up", "we_down"})
MASKED = -1e30


def _cast(x):
    return x.to(CDTYPE)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: float | None = None) -> torch.Tensor:
    """Normal(0, scale^2) float32 weights on the generator's device;
    ``scale`` defaults to 1 / sqrt(fan_in)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return w * float(scale)


def weight_init(gen: torch.Generator, shape, scale: float | None = None) -> torch.Tensor:
    """:func:`dense_init` stored in ``CDTYPE``, for a weight of
    :data:`CAST_AT_USE`."""
    return dense_init(gen, shape, scale).to(CDTYPE)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------


def rmsnorm_init(d: int, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE / M-RoPE
# --------------------------------------------------------------------------


def position_tensor(positions, B: int, S: int, device) -> torch.Tensor:
    """``positions`` as a tensor: an int p becomes p + arange(S) in each of
    the B rows; a tensor is returned as it is."""
    if isinstance(positions, int):
        return (positions + torch.arange(S, dtype=torch.int32, device=device)).expand(B, S)
    return positions


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=64)
def _freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, copied there once: a
    copy from host memory at every call would stall the host behind the
    card twice a layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(x, positions, theta: float, sections: tuple[int, ...] = ()):
    """x: (B, S, H, Dh); positions: (B, S), (3, B, S) for M-RoPE, or an int
    offset.

    M-RoPE (qwen2-vl §3): the head_dim/2 frequency slots are split into
    ``sections`` (temporal / height / width), each rotated by its own
    position stream; with equal streams it is standard RoPE.
    """
    B, S, H, Dh = x.shape
    half = Dh // 2
    freqs = _freqs_on(Dh, float(theta), x.device)
    positions = position_tensor(positions, B, S, x.device)
    if sections:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} must sum to head_dim / 2 = {half}")
        if positions.dim() == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        parts, start = [], 0
        for si, sec in enumerate(sections):
            p = positions[si].float()
            parts.append(p[:, :, None] * freqs[None, None, start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)
    else:
        ang = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA; optional sliding window + softcap; prefill & decode)
# --------------------------------------------------------------------------


def attention_init(gen: torch.Generator, cfg: ModelConfig):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": weight_init(gen, (d, h * dh)),
        "wk": weight_init(gen, (d, hk * dh)),
        "wv": weight_init(gen, (d, hk * dh)),
        "wo": weight_init(gen, (h * dh, d)),
    }


def attention_route(device, head_dim: int, positions) -> str:
    """Which attention serves activations on ``device``: ``"plain"`` (the
    reference's arithmetic) on the CPU, ``"k7"`` on a CUDA device.  Raises
    ValueError where K7 cannot serve: positions given as a tensor (K7
    takes one offset, ``q_offset``) or a head dim it is not built for."""
    device = torch.device(device)
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"attention runs on the CPU or a CUDA device, not {device}")
    if head_dim not in k7.HEAD_DIMS:
        raise ValueError(f"K7 is not built for head dim {head_dim} (it takes {k7.HEAD_DIMS}; "
                         "kernels/attention.py HEAD_DIMS)")
    if not isinstance(positions, int):
        raise ValueError("K7 takes positions as one offset plus arange (q_offset); a caller's "
                         "own positions tensor cannot run on the card")
    return "k7"


def _softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


def _attn_scores(q, k, cfg: ModelConfig, q_pos, k_pos, window, causal: bool):
    """q: (B,Sq,Hk,G,Dh), k: (B,Sk,Hk,Dh) -> masked logits (B,Hk,G,Sq,Sk)."""
    scale = float(1.0 / np.sqrt(cfg.head_dim_))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    logits = _softcap(logits, cfg.attn_softcap)
    dq = q_pos[:, :, None]  # (B, Sq, 1)
    dk = k_pos[:, None, :]  # (B, 1, Sk)
    mask = torch.ones(dq.shape[:2] + dk.shape[-1:], dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (dk <= dq)
    if window is not None and window != 0:  # window == 0 means global
        mask = mask & (dk > dq - window)
    return torch.where(mask[:, None, None, :, :], logits, MASKED)


def _attend_plain(q, k, v, cfg: ModelConfig, positions, window, causal: bool):
    """The reference's attention (``repro/models/layers.py:180-187``):
    q (B, S, H, Dh), k/v (B, Sk, Hk, Dh) -> (B, S, H, Dh) in bf16."""
    B, S, h, dh = q.shape
    Sk, hk = k.shape[1], k.shape[2]
    q_pos = position_tensor(positions, B, S, q.device)
    if q_pos.dim() == 3:
        q_pos = q_pos[0]
    k_pos = torch.arange(Sk, dtype=torch.int32, device=q.device).expand(B, Sk)
    logits = _attn_scores(q.reshape(B, S, hk, h // hk, dh), k, cfg, q_pos, k_pos, window, causal)
    probs = torch.softmax(logits, dim=-1).to(CDTYPE)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(B, S, h, dh)


def _attend(q, k, v, cfg: ModelConfig, positions, window, causal: bool):
    """One attention of q over k/v: K7 on the card, the reference's
    arithmetic on the CPU (:func:`attention_route`)."""
    if attention_route(q.device, cfg.head_dim_, positions) == "k7":
        return k7.flash_attention(q, k, v, causal=causal, window=window or 0,
                                  softcap=cfg.attn_softcap, q_offset=positions)
    return _attend_plain(q, k, v, cfg, positions, window, causal)


def attention_apply(params, x, cfg: ModelConfig, positions, *, layer_window=None,
                    kv_cache: dict | None = None, cross_kv=None, causal: bool = True):
    """Returns (out, new_kv_cache).

    ``kv_cache`` is {"k", "v": (B, T, Hk, Dh), "pos": int, the entries
    filled}.  Its tensors are written in place at pos ... pos + S (a copy
    of a whole cache per layer and step would dominate decoding), and the
    new cache is a new dict over the same tensors with pos + S.  Entries
    past pos + S are masked by causality, as in the reference.
    ``layer_window`` is the sliding window (0 or None: global);
    ``cross_kv`` (k, v) makes this a cross-attention, never causal."""
    B, S, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    xc = _cast(x)
    q = (xc @ _cast(params["wq"])).reshape(B, S, h, dh)
    if cross_kv is None:
        k = (xc @ _cast(params["wk"])).reshape(B, S, hk, dh)
        v = (xc @ _cast(params["wv"])).reshape(B, S, hk, dh)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        k, v = cross_kv

    new_cache = None
    if kv_cache is not None and cross_kv is None:
        pos = int(kv_cache["pos"])
        ck, cv = kv_cache["k"], kv_cache["v"]
        if pos + S > ck.shape[1]:
            raise ValueError(f"KV cache of {ck.shape[1]} entries cannot take {S} more at {pos}")
        ck[:, pos:pos + S] = k
        cv[:, pos:pos + S] = v
        new_cache = {"k": ck, "v": cv, "pos": pos + S}
        k, v = ck, cv

    ctx = _attend(q, k, v, cfg, positions, layer_window, causal and cross_kv is None)
    return ctx.reshape(B, S, h * dh) @ _cast(params["wo"]), new_cache


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, f: int):
    return {
        "w_gate": weight_init(gen, (d, f)),
        "w_up": weight_init(gen, (d, f)),
        "w_down": weight_init(gen, (f, d)),
    }


def mlp_apply(params, x):
    xc = _cast(x)
    h = F.silu(xc @ _cast(params["w_gate"])) * (xc @ _cast(params["w_up"]))
    return h @ _cast(params["w_down"])


# --------------------------------------------------------------------------
# Dropping MoE (mesh-TF style dispatch/combine einsums; capacity-bounded)
# --------------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg: ModelConfig):
    """The router (float32, scale 0.02), the experts' SwiGLU weights (E, D, F)
    and (E, F, D) stored in ``CDTYPE``, and the shared expert where the
    configuration has one."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, e), scale=0.02),
        "we_gate": weight_init(gen, (e, d, f)),
        "we_up": weight_init(gen, (e, d, f)),
        "we_down": weight_init(gen, (e, f, d)),
    }
    if cfg.moe_shared_expert:
        p["shared"] = mlp_init(gen, d, f)
    return p


def moe_capacity(S: int, cfg: ModelConfig) -> int:
    """Slots of each expert in one batch row of S tokens:
    max(1, ceil(S K / E * capacity_factor)), in float64 as the reference."""
    return max(1, int(np.ceil(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def router_probs(x, router) -> torch.Tensor:
    """softmax(x @ router) in float32, (B, S, E).  The product runs in
    float64 and is rounded to float32: a float32 product on the card runs
    as TF32 wherever a caller has allowed that process-wide, and TF32
    would move the routing; float64 never does."""
    logits = (x.double() @ router.double()).float()
    return torch.softmax(logits, dim=-1)


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, descending,
    the lower index first among equal values, as ``jax.lax.top_k``
    (``torch.topk`` orders no ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(x, params, cfg: ModelConfig):
    """(slot, gates) of x (B, S, D): each token's K experts and their gates,
    renormalised in float32, then cast to ``CDTYPE``; slot (B, S*K) is the
    (expert, position) each assignment takes in flat (s, k) order, E*C (the
    sentinel) where its expert's C slots in the row are taken: dropped."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(S, cfg)
    gate_vals, gate_idx = top_k(router_probs(x, params["router"]), K)  # (B, S, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    flat_e = gate_idx.reshape(B, S * K)  # expert id per assignment, per row
    gates = gate_vals.reshape(B, S * K).to(CDTYPE)
    onehot = F.one_hot(flat_e, E)  # (B, SK, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    my_pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]  # (B, SK)
    keep = my_pos < C
    slot = torch.where(keep, flat_e * C + my_pos, E * C)  # sentinel slot drops
    return slot, gates


def moe_apply(params, x, cfg: ModelConfig):
    """x: (B, S, D).  Top-k routing, capacity-bounded with token dropping,
    dispatched per batch row: every row owns an (E, C) slot buffer (C =
    :func:`moe_capacity`) filled by a per-row scatter (``ctx.moe_scatter``),
    the expert SwiGLU as three einsums over all E experts' slots, and the
    per-row gather back (``ctx.moe_gather``) with the K gated outputs summed
    in float32 and rounded once, as the reference's bf16 sum does.  The
    shared expert, where the configuration has one, adds the dense MLP."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(S, cfg)
    slot, gates = moe_route(x, params, cfg)
    keep = slot < E * C
    tok = torch.arange(S * K, device=x.device) // K
    xk = _cast(x)[:, tok, :] * keep[..., None].to(CDTYPE)  # (B, SK, D)
    buf = ctx.moe_scatter(slot, xk, E * C + 1)  # (B, E*C+1, D)
    xe = ctx.constrain(buf[:, :E * C].reshape(B, E, C, D), "moe_tokens")
    w_gate = ctx.constrain(_cast(params["we_gate"]), "moe_w")
    w_up = ctx.constrain(_cast(params["we_up"]), "moe_w")
    w_down = ctx.constrain(_cast(params["we_down"]), "moe_w")
    h = F.silu(torch.einsum("becd,edf->becf", xe, w_gate))
    h = h * torch.einsum("becd,edf->becf", xe, w_up)
    eout = ctx.constrain(torch.einsum("becf,efd->becd", h, w_down), "moe_tokens")
    eout = torch.cat([eout.reshape(B, E * C, D), eout.new_zeros((B, 1, D))], dim=1)
    y = ctx.moe_gather(eout, slot) * gates[..., None]
    out = y.reshape(B, S, K, D).float().sum(dim=2).to(CDTYPE)
    if cfg.moe_shared_expert:
        out = out + mlp_apply(params["shared"], x)
    return out
