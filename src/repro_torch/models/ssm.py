"""Mamba2 SSD (state-space duality) block, port of ``repro.models.ssm``:
the chunked parallel form for prefill and the recurrent form for decode
(arXiv:2405.21060).  Plain PyTorch: the reference has no kernel here.

Layout (ngroups = 1):
  in_proj -> [z (d_in), xBC (d_in + 2*N), dt (H)]
  causal depthwise conv over xBC, SiLU
  SSD: X (B,S,H,P), B/C (B,S,N), dt (B,S,H), A (H,) < 0
  y = SSD(X, dt, A, B, C) + D * X ; out = out_proj(rmsnorm(y * silu(z)))

The inter-chunk state scan is a Python loop over the chunks.  Where
states are given and S > 1 (the engine's prefill into a cache), the
chunked form runs from the given state: the reference runs its recurrent
scan there, the same function by the SSD duality (a compiled loop in the
reference, S steps of small launches a layer in eager PyTorch; measured
46 s for zamba2-2.7b's prefill of 4 x 2019 tokens on an H100).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import CDTYPE, _cast, dense_init, rmsnorm, rmsnorm_init, weight_init


def dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    return d_in, H, cfg.ssm_headdim, cfg.ssm_state


def mamba2_init(gen: torch.Generator, cfg: ModelConfig):
    """in_proj and out_proj (``layers.CAST_AT_USE``) in ``CDTYPE``; conv_w
    and the per-head vectors stay float32, as they are used."""
    d_in, H, P, N = dims(cfg)
    conv_dim = d_in + 2 * N
    dev = gen.device
    return {
        "in_proj": weight_init(gen, (cfg.d_model, 2 * d_in + 2 * N + H)),
        "conv_w": dense_init(gen, (cfg.conv_kernel, conv_dim), scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),  # A = -exp(A_log) = -1
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_in, dev),
        "out_proj": weight_init(gen, (d_in, cfg.d_model)),
    }


def _split_proj(proj, cfg: ModelConfig):
    d_in, H, P, N = dims(cfg)
    z = proj[..., :d_in]
    xBC = proj[..., d_in:2 * d_in + 2 * N]
    dt = proj[..., 2 * d_in + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along S, in float32.  xBC: (B,S,Cd); w: (K,Cd)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for k in range(K):
        out = out + pad[:, k:k + S, :].float() * w[k][None, None, :]
    return out + b[None, None, :]


def _ssd_chunked(X, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD.  X: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N).
    Returns (Y: (B,S,H,P), h_final: (B,H,P,N))."""
    Bsz, S, H, P = X.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    Xc = X.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    dA = dtc * A[None, None, None, :]  # (B,nc,Q,H), negative
    cs = torch.cumsum(dA, dim=2)  # inclusive cumsum within chunk
    seg_end = cs[:, :, -1:, :]  # (B,nc,1,H)
    # intra-chunk: L[i,j] = exp(cs_i - cs_j) for i >= j
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,Q,Q,H)
    ii = torch.arange(Q, device=X.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    Lm = torch.where(causal, torch.exp(diff), 0.0)  # (B,nc,Q,Q,H)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,nc,Q,Q)
    M = scores[..., None] * Lm  # (B,nc,Q,Q,H)
    Y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", M, dtc, Xc)
    # chunk states: S_c = sum_j exp(seg_end - cs_j) * dt_j * B_j (x) X_j
    decay_state = torch.exp(seg_end - cs)  # (B,nc,Q,H)
    states = torch.einsum("bcqh,bcqh,bcqn,bcqhp->bchpn", decay_state, dtc, Bc, Xc)
    # inter-chunk scan: h_c = exp(sum dA_c) h_{c-1} + S_c
    seg_all = torch.exp(seg_end[:, :, 0, :])  # (B,nc,H)
    h = h0 if h0 is not None else torch.zeros((Bsz, H, P, N), dtype=X.dtype, device=X.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)  # the state BEFORE chunk c
        h = (h * seg_all[:, c, :, None, None] + states[:, c]).to(h.dtype)
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,nc,H,P,N)
    # inter-chunk contribution: y_i += C_i . (exp(cs_i) * h_prev)
    decay_in = torch.exp(cs)  # (B,nc,Q,H)
    Y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, h_prevs, decay_in)
    return (Y_intra + Y_inter).reshape(Bsz, S, H, P), h


def _ssd_recurrent_step(h, x, dt, A, Bv, Cv):
    """One decode step.  h: (B,H,P,N); x: (B,H,P); dt: (B,H); Bv/Cv: (B,N)."""
    dA = torch.exp(dt * A[None, :])  # (B,H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bv, x)
    h = h * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cv, h)
    return h, y


def mamba2_apply(params, x, cfg: ModelConfig, *, ssm_state=None, conv_state=None):
    """x: (B,S,D).  If states are given (decode), S is the new-token count
    and the updated states are returned (new tensors).

    Returns (out, (ssm_state, conv_state))."""
    Bsz, S, D = x.shape
    d_in, H, P, N = dims(cfg)
    proj = _cast(x) @ _cast(params["in_proj"])  # (B,S,2*d_in+2N+H)
    z, xBC, dt = _split_proj(proj, cfg)
    K = cfg.conv_kernel
    if conv_state is None:
        new_conv_state = xBC[:, -(K - 1):, :] if S >= K - 1 else F.pad(xBC, (0, 0, K - 1 - S, 0))
        conv = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    else:
        full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
        conv = _causal_conv(full, params["conv_w"], params["conv_b"])[:, K - 1:, :]
        new_conv_state = full[:, -(K - 1):, :]
    conv = F.silu(conv)
    Xf = conv[..., :d_in].float().reshape(Bsz, S, H, P)
    Bm = conv[..., d_in:d_in + N].float()
    Cm = conv[..., d_in + N:].float()
    dt = dt.float() + params["dt_bias"][None, None, :]
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype, device=dt.device))  # softplus
    A = -torch.exp(params["A_log"])  # (H,)

    if S > 1:
        Q = min(cfg.ssm_chunk, S)
        pad = (-S) % Q
        if pad:
            Xp = F.pad(Xf, (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            Bp = F.pad(Bm, (0, 0, 0, pad))
            Cp = F.pad(Cm, (0, 0, 0, pad))
        else:
            Xp, dtp, Bp, Cp = Xf, dt, Bm, Cm
        Y, h_final = _ssd_chunked(Xp, dtp, A, Bp, Cp, Q, h0=ssm_state)
        Y = Y[:, :S]
    else:
        h = (ssm_state if ssm_state is not None
             else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
        ys = []
        for s in range(S):  # S == 1: one decode step
            h, y = _ssd_recurrent_step(h, Xf[:, s], dt[:, s], A, Bm[:, s], Cm[:, s])
            ys.append(y)
        Y = torch.stack(ys, dim=1)
        h_final = h
    Y = Y + Xf * params["D"][None, None, :, None]
    Y = Y.reshape(Bsz, S, d_in).to(CDTYPE)
    gated = Y * F.silu(_cast(z))
    out = rmsnorm(params["norm"], gated, cfg.norm_eps) @ _cast(params["out_proj"])
    return out, (h_final, new_conv_state)
