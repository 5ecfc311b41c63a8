"""The port's flash attention (``repro_torch.kernels.attention``) on CPU
tensors, which run its plain version, held against the JAX package's
Pallas kernel in interpret mode on the same numpy-seeded inputs, over the
sweep of ``tests/test_kernels_attention.py`` plus the query that sees no
key at all.

Tolerances, per element, compared in float32:
* float32 I/O, 1e-5: both run the same float32 online softmax over the
  same key blocks; only the summation order inside the two matrix
  products differs (under 1e-6 at these sizes).
* bfloat16 I/O, 1e-5 plus one bf16 step of the reference's value: both
  round the float32 result to bfloat16 once, and a value near a rounding
  boundary can land one step apart; inputs are the same bf16 values on
  both sides.  Rounding the probabilities to bf16 before P @ V would
  exceed it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jattn

from repro_torch.kernels import attention as tattn

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F32_TOL = 1e-5


def _bf16_step(x):
    """The spacing of bfloat16 values at each |x|: 2^(e-8) for |x| in
    [2^(e-1), 2^e), 0 at 0."""
    mant, exp = np.frexp(x)
    return np.where(x == 0, 0.0, np.ldexp(1.0, exp - 8))


def _inputs(B, Sq, Skv, H, Hk, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, Sq, H, D), (B, Skv, Hk, D), (B, Skv, Hk, D))]


def _both(arrays, dtype, **kw):
    """(JAX interpret-mode output, port output), both as float32 numpy."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jattn.flash_attention(*(jnp.asarray(a, dtype=jdt) for a in arrays), **kw)
    got = tattn.flash_attention(*(torch.as_tensor(a).to(tdt) for a in arrays), **kw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    return np.asarray(want, dtype=np.float32), got.float().numpy()


# (id, (B, Sq, Skv, H, Hk, D), seed, dtype, keywords): the reference test's sweep
SWEEP = [
    ("mha", (1, 128, 128, 4, 4, 32), 0, "f32", dict(blk_q=64, blk_k=64)),
    ("gqa", (2, 256, 256, 4, 2, 32), 0, "f32", dict(blk_q=64, blk_k=64)),
    ("sq_lt_skv", (1, 128, 384, 8, 2, 64), 0, "f32", dict(blk_q=64, blk_k=64)),
    ("ragged", (1, 96, 160, 4, 4, 32), 0, "f32", dict(blk_q=64, blk_k=64)),
    ("non_causal", (1, 128, 128, 4, 4, 32), 1, "f32", dict(causal=False, blk_q=64, blk_k=64)),
    ("window", (1, 256, 256, 4, 4, 32), 2, "f32", dict(window=64, blk_q=64, blk_k=64)),
    ("softcap", (1, 128, 128, 4, 2, 32), 3, "f32", dict(softcap=50.0, blk_q=64, blk_k=64)),
    ("softcap_bends", (1, 128, 128, 4, 2, 32), 9, "f32", dict(softcap=1.0, blk_q=64, blk_k=64)),
    ("decode", (2, 1, 256, 4, 4, 32), 4, "f32", dict(q_offset=200, blk_q=64, blk_k=64)),
    ("blk32", (1, 256, 256, 2, 2, 32), 5, "f32", dict(blk_q=32, blk_k=32)),
    ("blk64", (1, 256, 256, 2, 2, 32), 5, "f32", dict(blk_q=64, blk_k=64)),
    ("blk128", (1, 256, 256, 2, 2, 32), 5, "f32", dict(blk_q=128, blk_k=128)),
    ("bf16", (1, 128, 128, 4, 4, 32), 6, "bf16", dict(blk_q=64, blk_k=64)),
    # head dim 80 (zamba2-2.7b), which K7 pads to 128 columns inside the kernel
    ("d80", (1, 128, 192, 4, 2, 80), 10, "f32", dict(window=64, softcap=30.0, blk_q=64,
                                                      blk_k=64)),
]


@pytest.mark.parametrize("shape,seed,dtype,kw", [c[1:] for c in SWEEP], ids=[c[0] for c in SWEEP])
def test_matches_reference_kernel(shape, seed, dtype, kw):
    want, got = _both(_inputs(*shape, seed), dtype, **kw)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        past = np.abs(got - want) > F32_TOL + _bf16_step(want)
        assert not past.any(), f"{past.sum()} elements more than one bf16 step apart"


@pytest.mark.parametrize("blk_k", [64, 128])
def test_query_that_sees_no_key(blk_k):
    """window=8 at q_offset=500 over 100 keys: every score is the sentinel,
    so both return sum(V[:Skv]) / Skv_padded, Skv_padded counting blk_k."""
    q, k, v = _inputs(1, 4, 100, 2, 1, 32, seed=7)
    want, got = _both((q, k, v), "f32", window=8, q_offset=500, blk_q=64, blk_k=blk_k)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    skv_padded = tattn.padded_keys(100, blk_k)
    mean = np.broadcast_to(v.sum(axis=1, keepdims=True) / skv_padded, got.shape)
    np.testing.assert_allclose(got, mean, rtol=F32_TOL, atol=F32_TOL)


def test_traffic_model_matches_reference():
    for args in ((2, 32768, 32768, 28, 4, 128), (1, 8192, 8192, 8, 4, 256), (16, 1, 8192, 8, 4, 256)):
        for kw in ({}, {"blk_q": 64, "itemsize": 4}):
            assert tattn.hbm_bytes_per_call(*args, **kw) == jattn.hbm_bytes_per_call(*args, **kw)


def test_entry_point_contract():
    """Output in q's dtype and layout; shapes the reference cannot take
    raise; blk_q changes nothing."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(1, 20, 30, 4, 2, 32, seed=8))
    out = tattn.flash_attention(q, k, v, blk_q=8)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert torch.equal(out, tattn.flash_attention(q, k, v, blk_q=128))
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k[:, :, :1].expand(1, 30, 3, 32), v[:, :, :1].expand(1, 30, 3, 32))
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k[..., :16], v[..., :16])
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v, blk_k=0)


# ---------------------------------------------------------------------------
# The numerics of K7's bf16 variants, emulated on the CPU on top of the
# plain version's block loop, and the wrapper's choice of variant.
# ---------------------------------------------------------------------------

def _emulate(q, k, v, *, causal=True, window=None, softcap=0.0, q_offset=0, blk_k=128,
             p_mode="split", ranges=None):
    """K7's bf16 arithmetic in float32 torch: scores from the bf16 q and k
    (exact products) with the scale applied to the float32 sum, then
    softcap and mask; P @ V from P as bf16 hi + lo ("split", the wgmma
    variant), from bf16(P) ("bf16", the control a bf16 tensor-core kernel
    would be) or from float32 P ("f32").  ``ranges`` cuts the keys into
    splits whose partial (m, l, acc) are combined as the decode variant
    does; a row that sees no key at all gets sum(V[:Skv]) / Skv_padded."""
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    skv_padded = tattn.padded_keys(Skv, blk_k)
    ranges = ranges or [(0, skv_padded)]
    q_pos = q_offset + torch.arange(Sq)[:, None]
    neg = tattn.NEG_INF
    out = torch.empty(q.shape, dtype=torch.float32)
    for hk in range(Hk):
        qh = q[:, :, hk * g:(hk + 1) * g].transpose(1, 2).float()  # (B, g, Sq, D), unscaled
        parts = []
        for lo_k, hi_k in ranges:
            m = torch.full((B, g, Sq), neg)
            l = torch.zeros((B, g, Sq))
            acc = torch.zeros((B, g, Sq, D))
            for j0 in range(lo_k, hi_k, blk_k):
                j1 = min(j0 + blk_k, hi_k)
                kb = torch.zeros((B, j1 - j0, D))
                vb = torch.zeros((B, j1 - j0, D))
                n = max(0, min(j1, Skv) - j0)
                kb[:, :n] = k[:, j0:j0 + n, hk].float()
                vb[:, :n] = v[:, j0:j0 + n, hk].float()
                s = (qh @ kb[:, None].transpose(-1, -2)) * (1.0 / np.sqrt(D))
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                k_pos = torch.arange(j0, j1)[None, :]
                mask = k_pos < Skv
                if causal:
                    mask = mask & (k_pos <= q_pos)
                if window:
                    mask = mask & (k_pos > q_pos - window)
                s = torch.where(mask, s, neg)
                m_new = torch.maximum(m, s.amax(dim=-1))
                # a row that has seen no key yet adds nothing
                p = torch.where(m_new[..., None] == neg, 0.0, torch.exp(s - m_new[..., None]))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                hi = p.bfloat16().float()
                if p_mode == "split":
                    pv = hi @ vb[:, None] + (p - hi).bfloat16().float() @ vb[:, None]
                else:
                    pv = (hi if p_mode == "bf16" else p) @ vb[:, None]
                acc = acc * alpha[..., None] + pv
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([p[0] for p in parts]).amax(dim=0)
        L = sum(l * torch.exp(m - M) for m, l, _ in parts)
        O = sum(acc * torch.exp(m - M)[..., None] for m, _, acc in parts)
        none = M == neg
        O = torch.where(none[..., None], v[:, :Skv, hk].float().sum(dim=1)[:, None, None], O)
        L = torch.where(none, float(skv_padded), L)
        o = O / torch.clamp_min(L, 1e-30)[..., None]
        out[:, :, hk * g:(hk + 1) * g] = o.transpose(1, 2)
    return out.to(q.dtype)


def _past_bf16_gate(got, want) -> int:
    """Elements of bf16 ``got`` more than 1e-5 plus one bf16 step of
    ``want`` from it: the gate K7 is held to on the card."""
    got, want = got.float().numpy(), want.float().numpy()
    return int((np.abs(got - want) > F32_TOL + _bf16_step(want)).sum())


def _bf16_inputs(B, Sq, Skv, H, Hk, D, seed):
    return [torch.as_tensor(a).bfloat16() for a in _inputs(B, Sq, Skv, H, Hk, D, seed)]


EMULATED = dict(shape=(1, 256, 256, 4, 2, 128), kw=dict(softcap=50.0))


def test_split_p_meets_the_gate_and_bf16_p_does_not():
    """The wgmma variant's numerics (bf16 products, scale after the sum,
    P as hi + lo) stay within the bf16 gate of the plain version; the
    same with P rounded to bf16 does not."""
    q, k, v = _bf16_inputs(*EMULATED["shape"], seed=11)
    want = tattn.flash_attention_ref(q, k, v, **EMULATED["kw"])
    assert _past_bf16_gate(_emulate(q, k, v, **EMULATED["kw"]), want) == 0
    assert _past_bf16_gate(_emulate(q, k, v, p_mode="bf16", **EMULATED["kw"]), want) > 0


@pytest.mark.parametrize("ranges,kw", [
    ([(0, 64), (64, 192), (192, 256)], dict(softcap=50.0)),
    # the middle split lies wholly before the window of every row
    ([(0, 64), (64, 128), (128, 256)], dict(window=40, q_offset=200, softcap=50.0)),
    ([(0, 128), (128, 256)], dict(causal=False, window=100)),
], ids=["three_splits", "empty_split", "two_splits_window"])
def test_split_kv_combine_meets_the_gate(ranges, kw):
    """The decode variant's combine of partial (m, l, acc) over key
    splits, a split that sees no key carrying (-1e30, 0, 0)."""
    q, k, v = _bf16_inputs(2, 3, 256, 8, 4, 128, seed=12)
    want = tattn.flash_attention_ref(q, k, v, **kw)
    got = _emulate(q, k, v, ranges=ranges, blk_k=64, **kw)
    assert _past_bf16_gate(got, want) == 0


@pytest.mark.parametrize("blk_k", [64, 128])
def test_split_kv_combine_when_no_split_sees_a_key(blk_k):
    """Every split sees no key: the combine gives the reference's
    sum(V[:Skv]) / Skv_padded, Skv_padded counting blk_k."""
    q, k, v = _bf16_inputs(1, 4, 100, 2, 1, 32, seed=7)
    kw = dict(window=8, q_offset=500, blk_k=blk_k)
    want = tattn.flash_attention_ref(q, k, v, **kw)
    got = _emulate(q, k, v, ranges=[(0, 64), (64, tattn.padded_keys(100, blk_k))], **kw)
    assert _past_bf16_gate(got, want) == 0


@pytest.mark.parametrize("dtype,D,Sq,group,want", [
    (torch.float32, 32, 1, 1, "simt"),
    (torch.float32, 256, 8192, 2, "simt"),
    (torch.bfloat16, 256, 1, 2, "decode"),    # gemma2-2b decode
    (torch.bfloat16, 128, 1, 8, "decode"),    # yi-6b decode: 8 rows
    (torch.bfloat16, 32, 4, 2, "decode"),
    (torch.bfloat16, 128, 2, 8, "wgmma"),     # 16 rows: past the decode bound
    (torch.bfloat16, 64, 9, 1, "wgmma"),
    (torch.bfloat16, 256, 8192, 2, "wgmma"),  # gemma2-2b prefill
    (torch.bfloat16, 128, 4096, 8, "wgmma"),  # yi-6b prefill
    (torch.bfloat16, 80, 4096, 1, "wgmma"),   # zamba2-2.7b prefill
    (torch.bfloat16, 80, 1, 1, "decode"),     # zamba2-2.7b decode
    (torch.float32, 80, 100, 2, "simt"),
])
def test_variant_choice(dtype, D, Sq, group, want):
    assert tattn.attention_variant(dtype, D, Sq, group) == want


def test_variant_choice_rejects_what_no_variant_takes():
    with pytest.raises(ValueError):
        tattn.attention_variant(torch.float16, 64, 128, 1)
    with pytest.raises(ValueError):
        tattn.attention_variant(torch.bfloat16, 48, 128, 1)


@pytest.mark.parametrize("B,Hk,Skv", [(16, 4, 8192), (2, 4, 1000), (1, 1, 100), (1, 8, 32768)])
def test_decode_splits_cover_the_keys(B, Hk, Skv):
    n_split, per = tattn.decode_splits(B, Hk, Skv, n_sm=132)
    tiles = -(-Skv // tattn.DECODE_KEYS)
    assert (n_split - 1) * per < tiles <= n_split * per
    assert per >= min(8, tiles)
    if tiles >= 8 * 264 // (B * Hk):
        assert B * Hk * n_split >= 2 * 132  # two waves of the SMs
