"""The port's LM models (``repro_torch.models``) on the CPU against the JAX
package's (``repro.models``), on the reduced configurations, with the
reference's parameters carried over by ``convert.params_from_reference``
and numpy-seeded inputs.

Tolerances, and why:

* Compute type float32 (``CDTYPE`` set to float32 in both packages for
  the test, the weights then stored in float32 too): ``F32_TOL``, 1e-4
  absolute and relative, on every single layer and on each family's
  whole model (forward over 20 tokens, past gemma2's reduced window of
  16, and decode_step with the cache it writes).  Both packages then do
  the same float32 arithmetic and differ only in summation order:
  measured up to 1.1e-5 on the layers, 9.2e-6 on the models' logits
  (|logits| up to 4.7) and 1.4e-5 on an SSM state of up to 30.  This is
  the check that the port computes the reference's function; its
  controls (the port's bf16 logits, and gemma2 with its window dropped)
  fall outside it.
* Compute type bf16, as shipped: the logits' max |difference| within
  ``BF16_MAX`` of the largest |logit| and their RMS within ``BF16_RMS`` of
  the logits' RMS.  The two frameworks round each bf16 product and sum at
  other places (a matmul's summation order alone flips one bf16 step,
  2^-8 relative, of some outputs, measured at the first projection), and
  a random-weight network carries those steps on through its layers:
  measured at most 3.9% of the largest value and 2.2% RMS (zamba2,
  whose shared block runs twice; 1.0-2.0% and 0.9-1.6% for the other
  families).  The reference's own decode-vs-prefill check is 2e-2
  absolute and relative within one framework.  This bound does not tell
  a wrong model from a right one; the float32 check does.
* The single layers in bf16: 2e-2 absolute and relative, the reference's
  own bound; one layer carries at most a step or two.
* The reference's runs are traced one after another and compiled in
  parallel threads at XLA's backend optimisation level 0, which takes
  about a third off their compile time; every bound here holds at the
  default level too.
* The port with its attention routed through K7's arithmetic
  (``flash_attention_ref``: P kept in float32, where the reference rounds
  it to bf16), what the card computes: ``K7_MAX`` / ``K7_RMS``, looser by
  that rounding.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JSS

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSS

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FAMILY_ARCHS = ["gemma2-2b", "yi-6b", "mamba2-130m", "zamba2-2.7b", "seamless-m4t-medium"]
F32_TOL = 1e-4
LAYER_TOL = 2e-2
BF16_MAX, BF16_RMS = 0.06, 0.04
K7_MAX, K7_RMS = 0.08, 0.05
XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _batch(cfg, B=2, S=20, seed=0):
    """(reference batch, port batch) of the same numpy-seeded values."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        arrays["enc_embeddings"] = rng.normal(size=(B, 12, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def _close_bf16(got, want, max_share: float, rms_share: float, what: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert err.max() <= max_share * np.abs(want).max(), (what, err.max(), np.abs(want).max())
    rms = np.sqrt((err ** 2).mean() / (want ** 2).mean())
    assert rms <= rms_share, (what, rms)


def _float32_compute(monkeypatch, packages=("jax", "torch")):
    """Set the compute type of ``packages`` to float32 (``monkeypatch``
    restores it)."""
    mods = {"jax": ((JL, jnp.float32), (JSS, jnp.float32)),
            "torch": ((TL, torch.float32), (TSS, torch.float32))}
    for package in packages:
        for mod, dt in mods[package]:
            monkeypatch.setattr(mod, "CDTYPE", dt)


def _random_cache(cfg, B: int, seed: int):
    """A decode cache of 16 entries filled to ``CACHE_POS`` with seeded
    values (K/V, SSM and conv states, cross K/V), as numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in TM.init_cache(cfg, B, 16, enc_len=12).items()
              if k != "pos"}
    return {k: (rng.normal(size=s) * (0.1 if k == "ssm" else 1.0)).astype(np.float32)
            for k, s in shapes.items()}


CACHE_POS = 5
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}

LAYER_CASES = {  # case -> (arch, stack, entry): layer 0 of the arch's reference params
    "window_softcap": ("gemma2-2b", "layers", "attn"),
    "cache": ("yi-6b", "layers", "attn"),
    "cross": ("seamless-m4t-medium", "decoder", "xattn"),
    "mamba2": ("mamba2-130m", "layers", "mixer"),
    "norm_rope_mlp": ("yi-6b", "layers", "ffn"),
}


def _layer_inputs(case: str) -> dict:
    """The numpy-seeded inputs of one layer case."""
    if case == "norm_rope_mlp":
        rng = np.random.default_rng(1)
        return {"x": rng.normal(size=(2, 6, 4, 32)).astype(np.float32),
                "scale": rng.normal(size=(32,)).astype(np.float32),
                "pos": rng.integers(0, 100, (3, 2, 6)).astype(np.int32),
                "h": rng.normal(size=(2, 6, 128)).astype(np.float32)}
    arch = LAYER_CASES[case][0]
    cfg = treg.get(arch).reduced()
    rng = np.random.default_rng(2)
    B, S = 2, (24 if case in ("window_softcap", "mamba2") else 3)
    out = {"x": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)}
    out["k"], out["v"] = (rng.normal(size=(B, 16 if case == "cache" else 10, cfg.n_kv_heads,
                                           cfg.head_dim_)).astype(np.float32) for _ in range(2))
    if case == "mamba2":
        states = _random_cache(cfg, B, 4)
        out["ssm_state"], out["conv_state"] = states["ssm"][0], states["conv"][0]
    return out


def _ropes(pos):
    """(M-RoPE sections, positions) of the rope cases: plain over one
    stream, M-RoPE over three distinct streams, M-RoPE over one."""
    return (((), pos[0]), ((4, 6, 6), pos), ((4, 6, 6), pos[1]))


def _reference_layer(case: str, jdt, p, a: dict, jcfg) -> list:
    """The reference's outputs of one layer case in compute type ``jdt``
    (traced inside :func:`_reference`'s jit)."""
    x = a["x"].astype(jdt)
    if case == "norm_rope_mlp":
        return [JL.rmsnorm({"scale": a["scale"]}, x), JL.mlp_apply(p, a["h"]),
                *(JL.apply_rope(x, pos, 1e4, sec) for sec, pos in _ropes(a["pos"]))]
    if case == "mamba2":
        y, states = JSS.mamba2_apply(p, x, jcfg)
        yd, dstates = JSS.mamba2_apply(p, x[:, :2], jcfg, ssm_state=a["ssm_state"],
                                       conv_state=a["conv_state"].astype(jdt))
        return [y, *states, yd, *dstates]
    B, S = x.shape[:2]
    kw, offset = {}, 0
    if case == "window_softcap":
        kw["layer_window"] = jcfg.sliding_window
    elif case == "cache":
        offset = CACHE_POS
        kw["kv_cache"] = {"k": a["k"].astype(jdt), "v": a["v"].astype(jdt),
                          "pos": jnp.asarray(offset, jnp.int32)}
    else:
        kw["cross_kv"] = (a["k"].astype(jdt), a["v"].astype(jdt))
    pos = jnp.broadcast_to(offset + jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    out, cache = JL.attention_apply(p, x, jcfg, pos, **kw)
    return [out] + ([cache["k"], cache["v"]] if case == "cache" else [])


def _lowered(arch: str):
    """The reference's side of one arch as ONE jitted call, lowered, and
    its arguments: its params from ``init_params``, and in bf16 and with
    float32 compute, the forward logits over the batch, one
    ``decode_step`` of 3 tokens into a seeded cache filled to CACHE_POS
    (logits and the new cache) and the outputs of the arch's
    ``LAYER_CASES``, which ride along to share its compile."""
    jcfg = jreg.get(arch).reduced()
    jb, _ = _batch(jcfg)
    cases = {c: _layer_inputs(c) for c, (a, _, _) in LAYER_CASES.items() if a == arch}

    def model_outputs(params, jdt, batch, cache):
        cache = {k: v.astype(jnp.float32 if k == "ssm" else jdt) for k, v in cache.items()}
        cache["pos"] = jnp.asarray(CACHE_POS, jnp.int32)
        logits, new_cache = JM.decode_step(params, jcfg, cache, {"tokens": batch["tokens"][:, :3]})
        return JM.forward(params, jcfg, batch), logits, new_cache

    def run(key, batch, cache, inputs):
        params = JM.init_params(key, jcfg)
        out = {}
        for name, (jdt, _) in DTYPES.items():
            with pytest.MonkeyPatch.context() as mp:
                if name == "f32":
                    _float32_compute(mp, ("jax",))
                layers = {c: _reference_layer(
                    c, jdt, jax.tree.map(lambda a: a[0], params[LAYER_CASES[c][1]][LAYER_CASES[c][2]]),
                    inputs[c], jcfg) for c in inputs}
                out[name] = (model_outputs(params, jdt, batch, cache), layers)
        return params, out

    args = (jax.random.PRNGKey(0), jb, _random_cache(jcfg, 2, 3), cases)
    return jax.jit(run).lower(*args), args


@functools.lru_cache(maxsize=None)
def _compiled() -> dict:
    """arch -> (compiled reference run, its arguments) for every arch of
    FAMILY_ARCHS: traced one after another, then compiled in parallel
    threads (XLA's compiles, most of this file's time, release the GIL)."""
    lowered = {arch: _lowered(arch) for arch in FAMILY_ARCHS}
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        jobs = {arch: pool.submit(low.compile, XLA_FAST_COMPILE)
                for arch, (low, _) in lowered.items()}
        return {arch: (job.result(), lowered[arch][1]) for arch, job in jobs.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(params, {"bf16" | "f32": (model outputs, {case: layer outputs})})
    of one arch's reference run (:func:`_lowered`), as numpy arrays."""
    run, args = _compiled()[arch]
    return jax.tree.map(np.asarray, run(*args))


def _port(arch: str, tcfg=None):
    """The port's side on the reference's params, in the compute type the
    test has set: forward logits, decode logits and new cache; ``tcfg``
    (default the arch's reduced config) is the configuration it runs."""
    tcfg = tcfg or treg.get(arch).reduced()
    tp = convert.params_from_reference(tcfg, _reference(arch)[0])
    _, tb = _batch(tcfg)
    cache = {k: torch.as_tensor(v).to(torch.float32 if k == "ssm" else TL.CDTYPE)
             for k, v in _random_cache(tcfg, 2, 3).items()}
    cache["pos"] = CACHE_POS
    logits, new_cache = TM.decode_step(tp, tcfg, cache, {"tokens": tb["tokens"][:, :3]})
    assert new_cache["pos"] == CACHE_POS + 3
    return TM.forward(tp, tcfg, tb), logits, new_cache


def _pairs(arch: str, want, got):
    """(what, reference, port) of the forward logits, the decode logits
    and each state the step wrote."""
    (jfwd, jlogits, jcache), (tfwd, tlogits, tcache) = want, got
    out = [(f"{arch} forward", jfwd, tfwd), (f"{arch} decode_step", jlogits, tlogits)]
    return out + [(f"{arch} cache {n}", jcache[n], tcache[n])
                  for n in ("k", "v", "ssm", "conv") if n in jcache]


def _compare(arch: str, max_share: float, rms_share: float, what: str):
    for name, want, got in _pairs(arch, _reference(arch)[1]["bf16"][0], _port(arch)):
        _close_bf16(got, want, max_share, rms_share, name + what)


def _layer_params(case: str):
    """The port's tensors of a case's layer, converted in the compute
    type the test has set."""
    arch, stack, sub = LAYER_CASES[case]
    cfg = treg.get(arch).reduced()
    return convert.params_from_reference(cfg, _reference(arch)[0])[stack][0][sub]


def _both_dtypes(monkeypatch, case: str, compute):
    """The port's ``compute(tdtype)`` against the reference's outputs of
    ``case``, in bf16 (within LAYER_TOL) and then with float32 compute in
    both packages (within F32_TOL)."""
    arch = LAYER_CASES[case][0]
    for name, (_, tdt) in DTYPES.items():
        tol = F32_TOL if name == "f32" else LAYER_TOL
        if name == "f32":
            _float32_compute(monkeypatch)
        want = _reference(arch)[1][name][1][case]
        got = compute(tdt)
        assert len(got) == len(want), case
        for w, g in zip(want, got):
            np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol, err_msg=f"{case} {tdt}")


def test_norm_rope_mlp_match_reference(monkeypatch):
    """rmsnorm, apply_rope (plain, and M-RoPE with three distinct position
    streams) and mlp_apply, in bf16 and float32; an int offset as
    positions equals the arange tensor it stands for."""
    a = _layer_inputs("norm_rope_mlp")

    def compute(tdt):
        tx = torch.as_tensor(a["x"]).to(tdt)
        return [TL.rmsnorm({"scale": torch.as_tensor(a["scale"])}, tx),
                TL.mlp_apply(_layer_params("norm_rope_mlp"), torch.as_tensor(a["h"])),
                *(TL.apply_rope(tx, p, 1e4, sec) for sec, p in _ropes(torch.as_tensor(a["pos"])))]

    _both_dtypes(monkeypatch, "norm_rope_mlp", compute)
    tx = torch.as_tensor(a["x"]).bfloat16()
    arange = torch.arange(5, 11, dtype=torch.int32).expand(2, 6)
    assert torch.equal(TL.apply_rope(tx, 5, 1e6, (4, 6, 6)), TL.apply_rope(tx, arange, 1e6, (4, 6, 6)))


@pytest.mark.parametrize("case", [c for c in LAYER_CASES if c != "norm_rope_mlp"])
def test_layer_matches_reference(case, monkeypatch):
    """One layer against the reference, in bf16 and float32:
    attention_apply as gemma2's windowed, softcapped prefill past its
    window (the port given an int offset, the reference its arange
    tensor); as yi-6b's decode of 3 tokens into a cache filled to 5 (the
    output and the cache written); as seamless's cross-attention over 10
    frames; and mamba2_apply's chunked prefill (24 tokens, chunks of 16,
    padded) and its recurrent decode of 2 tokens from seeded states."""
    cfg = treg.get(LAYER_CASES[case][0]).reduced()
    a = _layer_inputs(case)
    if case == "window_softcap":
        assert a["x"].shape[1] > cfg.sliding_window and cfg.attn_softcap

    def compute(tdt):
        tw = _layer_params(case)
        tx = torch.as_tensor(a["x"]).to(tdt)
        if case == "mamba2":
            ty, ts = TSS.mamba2_apply(tw, tx, cfg)
            td, tds = TSS.mamba2_apply(tw, tx[:, :2], cfg, ssm_state=torch.as_tensor(a["ssm_state"]),
                                       conv_state=torch.as_tensor(a["conv_state"]).to(tdt))
            return [ty, *ts, td, *tds]
        k, v = (torch.as_tensor(a[n]).to(tdt) for n in ("k", "v"))
        tkw, offset = {}, 0
        if case == "window_softcap":
            tkw["layer_window"] = cfg.sliding_window
        elif case == "cache":
            offset = CACHE_POS
            tkw["kv_cache"] = {"k": k, "v": v, "pos": offset}
        else:
            tkw["cross_kv"] = (k, v)
        tout, tcache = TL.attention_apply(tw, tx, cfg, offset, **tkw)
        if case != "cache":
            assert tcache is None
            return [tout]
        assert tcache["pos"] == offset + tx.shape[1]
        return [tout, tcache["k"], tcache["v"]]

    _both_dtypes(monkeypatch, case, compute)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_matches_reference(arch, monkeypatch):
    """forward and decode_step (3 tokens into a seeded cache filled to
    CACHE_POS, the cache it writes included) of one arch of each family:
    within the bf16 bound as shipped, then within F32_TOL with float32
    compute in both packages.  Controls that must fall outside F32_TOL of
    the reference's float32 logits: the port's bf16 ones (bf16 rounding
    is caught), and for gemma2 the port with its sliding window dropped
    (a wrong window layer is caught)."""
    _compare(arch, BF16_MAX, BF16_RMS, "")
    controls = [_np(_port(arch)[0])]
    _float32_compute(monkeypatch)
    want = _reference(arch)[1]["f32"][0]
    for name, w, g in _pairs(arch, want, _port(arch)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL, atol=F32_TOL, err_msg=name)
    cfg = treg.get(arch).reduced()
    if cfg.sliding_window:
        controls.append(_np(_port(arch, dataclasses.replace(cfg, sliding_window=0))[0]))
    for control in controls:
        assert not np.allclose(control, _np(want[0]), rtol=F32_TOL, atol=F32_TOL), arch


def test_decode_matches_prefill():
    """The port alone: greedy decode token by token equals the
    teacher-forced forward logits (the reference's
    ``tests/test_models.py:74`` check and tolerance), for every arch,
    seamless over its encoder's memory, the MoE archs at a capacity that
    drops nothing (capacity_factor = n_experts, as the reference's test:
    a dropping MoE's capacity competition is per call)."""
    for arch in sorted(treg.ARCHS):
        cfg = treg.get(arch).reduced()
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
        params = TM.init_params(torch.Generator().manual_seed(2), cfg)
        rng = np.random.default_rng(2)
        B, S = 2, 8
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))
        batch = {"tokens": tokens}
        cache = TM.init_cache(cfg, B, max_len=S)
        if cfg.family == "encdec":
            batch["enc_embeddings"] = torch.as_tensor(
                rng.normal(size=(B, 12, cfg.d_model)).astype(np.float32))
            cache = tencdec.prefill_cross(params, cfg, TM.init_cache(cfg, B, S, enc_len=12),
                                          tencdec.encode(params, cfg, batch["enc_embeddings"]))
        full = TM.forward(params, cfg, batch)[..., :cfg.vocab]
        outs = []
        for s in range(S):
            logits, cache = TM.decode_step(params, cfg, cache, {"tokens": tokens[:, s:s + 1]})
            outs.append(logits[:, 0])
        np.testing.assert_allclose(_np(torch.stack(outs, dim=1)), _np(full), rtol=2e-2,
                                   atol=2e-2, err_msg=arch)


def test_k7_arithmetic_model_matches_reference(monkeypatch):
    """The port's models with every attention routed through K7's entry
    point (on CPU tensors its plain version ``flash_attention_ref``, the
    arithmetic the card runs: P in float32) against the reference, within
    the looser K7_MAX / K7_RMS; the route is what the card takes."""
    routed = []

    def k7_route(device, head_dim, positions):
        routed.append(head_dim)
        return "k7"

    monkeypatch.setattr(TL, "attention_route", k7_route)
    for arch in ("gemma2-2b", "yi-6b", "zamba2-2.7b", "seamless-m4t-medium"):
        _compare(arch, K7_MAX, K7_RMS, " (K7 arithmetic)")
    assert routed
