"""Family dispatch (port of ``repro.models.model``): one API over the dense,
moe, ssm, hybrid and encdec families (dense and moe share the transformer).

    init_params(gen, cfg)                             -> params
    forward(params, cfg, batch, last_only=False)      -> logits (B, S, V)
    init_cache(cfg, batch, max_len, enc_len=0, device=) -> decode cache
    decode_step(params, cfg, cache, batch)            -> (logits, cache)

``gen`` is a ``torch.Generator``; the parameters are made on its device.
Params are nested dicts whose per-layer stacks are lists; caches keep the
reference's stacked layout and a Python int ``pos``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
TRANSFORMER = ("dense", "moe")  # the families of models.transformer


def _family(cfg: ModelConfig) -> str:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    return cfg.family


def check_device(cfg: ModelConfig, device) -> None:
    """Raise ValueError where ``cfg`` cannot run on ``device``: an unknown
    family, or, on the card, attention K7 cannot serve
    (``layers.attention_route``)."""
    if _family(cfg) != "ssm":
        L.attention_route(device, cfg.head_dim_, 0)


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()


# --------------------------------------------------------------------------
# pure-SSM (mamba2) decoder-only model
# --------------------------------------------------------------------------


def _ssm_init(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "embed": L.weight_init(gen, (cfg.padded_vocab, d), scale=0.02),
        "layers": [{"ln": L.rmsnorm_init(d, gen.device),
                    "mixer": ssm.mamba2_init(gen, cfg)}
                   for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(d, gen.device),
        "lm_head": L.weight_init(gen, (d, cfg.padded_vocab)),
    }


def _ssm_forward(params, cfg: ModelConfig, batch, *, last_only: bool = False):
    x = tfm.embed_inputs(params, cfg, batch)
    for lp in params["layers"]:
        h, _ = ssm.mamba2_apply(lp["mixer"], L.rmsnorm(lp["ln"], x, cfg.norm_eps), cfg)
        x = x + h
    if last_only:
        x = x[:, -1:]
    return tfm.unembed(params, cfg, x)


def _ssm_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cpu"):
    d_in, H, P, N = ssm.dims(cfg)
    conv_dim = d_in + 2 * N
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1, conv_dim), dtype=L.CDTYPE,
                            device=device),
        "pos": 0,
    }


def _ssm_decode(params, cfg: ModelConfig, cache, batch, *, last_only: bool = False):
    x = tfm.embed_inputs(params, cfg, batch)
    new_s, new_c = [], []
    for i, lp in enumerate(params["layers"]):
        h, (hs, hc) = ssm.mamba2_apply(
            lp["mixer"], L.rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
            ssm_state=cache["ssm"][i], conv_state=cache["conv"][i],
        )
        x = x + h
        new_s.append(hs)
        new_c.append(hc)
    new_cache = {"ssm": torch.stack(new_s), "conv": torch.stack(new_c),
                 "pos": int(cache["pos"]) + x.shape[1]}
    if last_only:
        x = x[:, -1:]
    return tfm.unembed(params, cfg, x), new_cache


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Seeded random weights on ``gen``'s device: those every use casts
    to ``CDTYPE`` (``layers.CAST_AT_USE``) stored in it, the rest float32."""
    family = _family(cfg)
    if family in TRANSFORMER:
        return tfm.init_params(gen, cfg)
    if family == "ssm":
        return _ssm_init(gen, cfg)
    if family == "hybrid":
        return hybrid.init_params(gen, cfg)
    return encdec.init_params(gen, cfg)


def forward(params, cfg: ModelConfig, batch, *, remat: bool = False,
            remat_group: int = 1, last_only: bool = False):
    """Logits (B, S, V) over the padded vocab.  ``remat`` and
    ``remat_group`` are training knobs, unused until the training slice."""
    family = _family(cfg)
    if family in TRANSFORMER:
        return tfm.forward(params, cfg, batch, remat=remat, remat_group=remat_group,
                           last_only=last_only)
    if family == "ssm":
        return _ssm_forward(params, cfg, batch, last_only=last_only)
    if family == "hybrid":
        return hybrid.forward(params, cfg, batch, remat=remat, last_only=last_only)
    return encdec.forward(params, cfg, batch, remat=remat, last_only=last_only)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0, *, device="cpu"):
    family = _family(cfg)
    if family in TRANSFORMER:
        return tfm.init_cache(cfg, batch, max_len, device=device)
    if family == "ssm":
        return _ssm_init_cache(cfg, batch, max_len, device=device)
    if family == "hybrid":
        return hybrid.init_cache(cfg, batch, max_len, device=device)
    return encdec.init_cache(cfg, batch, max_len, enc_len or max_len, device=device)


def decode_step(params, cfg: ModelConfig, cache, batch, *, last_only: bool = False):
    """One step over ``batch``'s S tokens -> (logits (B, S, vocab), cache),
    the logits sliced to the true vocab as the reference's decode emits
    them; ``last_only`` unembeds the last position alone (B, 1, vocab)."""
    family = _family(cfg)
    if family in TRANSFORMER:
        logits, cache = tfm.decode_step(params, cfg, cache, batch, last_only=last_only)
    elif family == "ssm":
        logits, cache = _ssm_decode(params, cfg, cache, batch, last_only=last_only)
    elif family == "hybrid":
        logits, cache = hybrid.decode_step(params, cfg, cache, batch, last_only=last_only)
    else:
        logits, cache = encdec.decode_step(params, cfg, cache, batch, last_only=last_only)
    return logits[..., :cfg.vocab], cache
