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
