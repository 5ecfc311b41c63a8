"""The PyTorch port's BFV layer, its host bigint reference, HE gradient
aggregation and the front-door functions ``execute`` / ``plan_from_params``,
held against the JAX reference package.

Parity is exact: the reference's samples (drawn as ``repro.core.bfv`` draws
them) go through the port's ``_keygen_with`` / ``_encrypt_with``, and every
residue, decrypted integer and noise budget must be equal.  The port's own
``torch.Generator`` sampling is checked by decrypt round trips and the
noise budget.  Reference: ``backend="jnp"``; port: ``device="cpu"``
(backend ``torch``), n = 64, t = 3, v = 30, pt_mod = 2^16."""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
from repro.core import bfv as jbfv
from repro.core import bfv_ref as jbfv_ref
from repro.core import params as jparams
from repro.train import aggregation as jagg

import repro_torch
from repro_torch.core import bfv as tbfv
from repro_torch.core import bfv_ref as tbfv_ref
from repro_torch.core import params as tparams
from repro_torch.core import polymul as tpm
from repro_torch.examples import encrypted_inference
from repro_torch.kernels import ntt as tkern
from repro_torch.train import aggregation as tagg

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N, T, V, PT = 64, 3, 30, 1 << 16
BATCHES = [(), (4,)]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _eq(port: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return port.dtype == torch.int64 and np.array_equal(port.cpu().numpy(), ref)


def _ref_keygen_samples(key, ctx):
    """(s, a, e) as ``repro.core.bfv.keygen`` draws them from ``key``."""
    k_s, k_a, k_e = jax.random.split(key, 3)
    n = ctx.params.n
    return (jbfv._ternary(k_s, (n,)), jbfv._uniform_res(k_a, ctx, (n,)),
            jbfv._noise(k_e, (n,), ctx.noise_bound))


def _ref_encrypt_samples(key, shape, ctx):
    """(u, e1, e2) as ``repro.core.bfv.encrypt`` draws them from ``key``."""
    k_u, k_e1, k_e2 = jax.random.split(key, 3)
    return (jbfv._ternary(k_u, shape), jbfv._noise(k_e1, shape, ctx.noise_bound),
            jbfv._noise(k_e2, shape, ctx.noise_bound))


@pytest.fixture(scope="module", autouse=True)
def _jit_reference_products():
    """The reference's BFV layer calls ``repro.api.negacyclic_mul`` eagerly,
    about 0.5 s a call on the CPU; the same function under ``jax.jit``
    gives the same integers in milliseconds (as tests/test_torch_polymul.py
    runs it).  Restored after this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(repro.api, "negacyclic_mul", jax.jit(repro.api.negacyclic_mul))
        yield


@pytest.fixture(scope="module")
def ctxs():
    return (jbfv.make_context(n=N, t=T, v=V, pt_mod=PT),
            tbfv.make_context(n=N, t=T, v=V, pt_mod=PT, device="cpu"))


@pytest.fixture(scope="module")
def keypairs(ctxs):
    jctx, tctx = ctxs
    key = jax.random.PRNGKey(0)
    s, a, e = _ref_keygen_samples(key, jctx)
    return jbfv.keygen(key, jctx), tbfv._keygen_with(_t(s), _t(a), _t(e), tctx)


@pytest.fixture(scope="module")
def ciphertexts(ctxs, keypairs):
    """Per batch shape: (messages, reference ciphertexts, port ciphertexts),
    three of each, the port's from the reference's samples."""
    jctx, tctx = ctxs
    jkp, tkp = keypairs
    rng = np.random.default_rng(7)
    out = {}
    for batch in BATCHES:
        ms, jcts, tcts = [], [], []
        for i in range(3):
            m = rng.integers(0, PT, size=batch + (N,), dtype=np.int64)
            key = jax.random.PRNGKey(100 + 10 * len(batch) + i)
            u, e1, e2 = _ref_encrypt_samples(key, batch + (N,), jctx)
            ms.append(m)
            jcts.append(jbfv.encrypt(key, jnp.asarray(m), jkp, jctx))
            tcts.append(tbfv._encrypt_with(m, _t(u), _t(e1), _t(e2), tkp, tctx))
        out[batch] = (ms, jcts, tcts)
    return out


def _schoolbook_mod_pt(m: np.ndarray, w: np.ndarray, pt: int) -> np.ndarray:
    rows = m.reshape(-1, m.shape[-1])
    wl = [int(x) % pt for x in w]
    return np.array([tpm.schoolbook_negacyclic(r.tolist(), wl, pt) for r in rows],
                    dtype=np.int64).reshape(m.shape)


# --------------------------------------------------------------------------
# parity with the reference on the reference's samples
# --------------------------------------------------------------------------


def test_keygen_matches_reference(ctxs, keypairs):
    jctx, tctx = ctxs
    jkp, tkp = keypairs
    assert _eq(tkp.sk, jkp.sk) and _eq(tkp.pk, jkp.pk)
    assert tuple(tkp.pk.shape) == (2, T, N)
    assert _eq(tctx.delta_res, jctx.delta_res)
    assert tctx.plan.config.backend == "torch"


@pytest.mark.parametrize("batch", BATCHES)
def test_encrypt_matches_reference(ciphertexts, batch):
    _, jcts, tcts = ciphertexts[batch]
    for jct, tct in zip(jcts, tcts):
        assert tct.batch_shape == batch
        assert _eq(tct.c, jct.c)


@pytest.mark.parametrize("batch", BATCHES)
def test_homomorphic_ops_match_reference(ctxs, keypairs, ciphertexts, batch):
    jctx, tctx = ctxs
    jkp, tkp = keypairs
    ms, jcts, tcts = ciphertexts[batch]
    w = np.random.default_rng(11).integers(-4, 5, size=(N,), dtype=np.int64)
    pairs = {
        "add": (jbfv.add(jcts[0], jcts[1], jctx), tbfv.add(tcts[0], tcts[1], tctx)),
        "add_many": (jbfv.add_many(jcts, jctx), tbfv.add_many(tcts, tctx)),
        "mul_plain": (jbfv.mul_plain(jcts[0], jnp.asarray(w), jctx),
                      tbfv.mul_plain(tcts[0], w, tctx)),
    }
    for name, (jct, tct) in pairs.items():
        assert _eq(tct.c, jct.c), name
        dec = tbfv.decrypt(tct, tkp, tctx)
        assert dec.dtype == np.int64 and dec.shape == batch + (N,)
        assert np.array_equal(dec, jbfv.decrypt(jct, jkp, jctx)), name
    want_sum = sum(ms) % PT
    assert np.array_equal(tbfv.decrypt(pairs["add_many"][1], tkp, tctx), want_sum)
    fresh = tbfv.noise_budget_bits(tcts[0], tkp, tctx, ms[0])
    assert fresh == jbfv.noise_budget_bits(jcts[0], jkp, jctx, ms[0])
    m2 = _schoolbook_mod_pt(ms[0], w, PT)
    after = tbfv.noise_budget_bits(pairs["mul_plain"][1], tkp, tctx, m2)
    assert after == jbfv.noise_budget_bits(pairs["mul_plain"][0], jkp, jctx, m2)


# --------------------------------------------------------------------------
# the port's own sampling
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def own_keys(ctxs):
    return tbfv.keygen(torch.Generator().manual_seed(3), ctxs[1])


def test_own_sampling_round_trips_and_adds(ctxs, own_keys):
    tctx = ctxs[1]
    gen = torch.Generator().manual_seed(4)
    rng = np.random.default_rng(5)
    a = rng.integers(0, PT // 4, size=(2, N), dtype=np.int64)
    b = rng.integers(0, PT // 4, size=(2, N), dtype=np.int64)
    ca = tbfv.encrypt(gen, a, own_keys, tctx)
    cb = tbfv.encrypt(gen, b, own_keys, tctx)
    assert not torch.equal(ca.c, cb.c)
    assert np.array_equal(tbfv.decrypt(ca, own_keys, tctx), a)
    assert np.array_equal(tbfv.decrypt(tbfv.add(ca, cb, tctx), own_keys, tctx), (a + b) % PT)
    # the same seed draws the same ciphertext
    again = tbfv.encrypt(torch.Generator().manual_seed(4), a, own_keys, tctx)
    assert torch.equal(again.c, ca.c)


def test_own_sampling_mul_plain_and_noise_budget(ctxs, own_keys):
    tctx = ctxs[1]
    rng = np.random.default_rng(6)
    m = rng.integers(0, 64, size=(N,), dtype=np.int64)
    w = rng.integers(-4, 5, size=(N,), dtype=np.int64)
    ct = tbfv.encrypt(torch.Generator().manual_seed(8), m, own_keys, tctx)
    prod = tbfv.mul_plain(ct, w, tctx)
    m2 = _schoolbook_mod_pt(m, w, PT)
    assert np.array_equal(tbfv.decrypt(prod, own_keys, tctx), m2)
    fresh = tbfv.noise_budget_bits(ct, own_keys, tctx, m)
    after = tbfv.noise_budget_bits(prod, own_keys, tctx, m2)
    assert fresh > 20 and 0 < after < fresh
    with pytest.raises(ValueError):
        tbfv.noise_budget_bits(ct, own_keys, tctx, m[:-1])


def test_samples_follow_the_reference_distributions(ctxs):
    tctx = ctxs[1]
    gen = torch.Generator().manual_seed(9)
    tern = tbfv._ternary(gen, (4096,), tctx)
    noise = tbfv._noise(gen, (4096,), tctx)
    uni = tbfv._uniform_res(gen, (4096,), tctx)
    assert set(tern.unique().tolist()) == {-1, 0, 1}
    assert noise.abs().max() <= tctx.noise_bound and noise.min() < 0 < noise.max()
    assert uni.shape == (T, 4096)
    for c, q in enumerate(tctx.params.qs):
        assert 0 <= uni[c].min() and uni[c].max() < int(q)
        assert uni[c].max() > int(q) // 2


def test_context_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        tbfv.make_context(n=N, t=T, v=V)
    assert err.value.knob == "device"
    with pytest.raises(repro_torch.UnservableConfigError):
        tagg.HeAggregator(n=N, t=T, v=V)
    assert tbfv.make_context(n=N, t=T, v=V, device="cpu").plan.device.type == "cpu"


# --------------------------------------------------------------------------
# the host bigint reference
# --------------------------------------------------------------------------


def _ref_run(mod, seed: int):
    """make_ref_context, keygen, encrypt, ct x ct with relinearization and
    decrypt of one package from random.Random(seed)."""
    ctx = mod.make_ref_context(n=32, t=3, v=30, pt_mod=257)
    rng = random.Random(seed)
    keys = mod.keygen(rng, ctx)
    a = [rng.randrange(16) for _ in range(ctx.n)]
    b = [rng.randrange(16) for _ in range(ctx.n)]
    ca = mod.encrypt(rng, a, keys, ctx)
    cb = mod.encrypt(rng, b, keys, ctx)
    prod = mod.mul(ca, cb, keys, ctx)
    return ctx.q, keys.s, keys.pk, keys.evk, ca, cb, prod, mod.decrypt(prod, keys, ctx), a, b


def test_bfv_ref_matches_reference():
    port, ref = _ref_run(tbfv_ref, 21), _ref_run(jbfv_ref, 21)
    assert port[:8] == ref[:8]
    a, b = port[8:]
    assert port[7] == tpm.schoolbook_negacyclic(a, b, 257)


def test_bfv_ref_depth_two():
    rctx = tbfv_ref.make_ref_context(n=32, t=3, v=30, pt_mod=257)
    rkeys = tbfv_ref.keygen(random.Random(0), rctx)
    rng = random.Random(3)
    a, b, c = ([rng.randrange(4) for _ in range(rctx.n)] for _ in range(3))
    ca, cb, cc = (tbfv_ref.encrypt(rng, x, rkeys, rctx) for x in (a, b, c))
    prod = tbfv_ref.mul(tbfv_ref.mul(ca, cb, rkeys, rctx), cc, rkeys, rctx)
    want = tpm.schoolbook_negacyclic(tpm.schoolbook_negacyclic(a, b, 257), c, 257)
    assert tbfv_ref.decrypt(prod, rkeys, rctx) == want
    assert tbfv_ref.decrypt(tbfv_ref.add(ca, cb, rctx), rkeys, rctx) == [
        (x + y) % 257 for x, y in zip(a, b)]


# --------------------------------------------------------------------------
# HE gradient aggregation
# --------------------------------------------------------------------------


def test_aggregator_steps_match_reference(ctxs, keypairs):
    jagg_ = jagg.HeAggregator(n=N, t=T, v=V, pt_mod=PT, frac_bits=4)
    tagg_ = tagg.HeAggregator(n=N, t=T, v=V, pt_mod=PT, frac_bits=4, device="cpu")
    rng = np.random.default_rng(12)
    flat = (rng.normal(size=200) * 300).astype(np.float32)  # some past the clip at pt / 4
    flat[:4] = [0.5 / 16, 1.5 / 16, -2.5 / 16, 1e9]  # ties round to even; one clipped
    jq = jagg_._quantize(flat)
    tq = tagg_._quantize(torch.as_tensor(flat))
    assert _eq(tq, jq) and int(np.abs(jq).max()) == PT // 4
    assert _eq(tagg_._pack(tq), jagg_._pack(jq))
    jkp, tkp = keypairs
    key = jax.random.PRNGKey(13)
    jct = jagg_.encrypt_grads(key, flat, jkp)
    u, e1, e2 = _ref_encrypt_samples(key, (4, N), jagg_.ctx)
    tct = tbfv._encrypt_with(tagg_._pack(tq), _t(u), _t(e1), _t(e2), tkp, tagg_.ctx)
    assert _eq(tct.c, jct.c)
    got = tagg_.decrypt_mean(tct, tkp, 3, 200)
    want = jagg_.decrypt_mean(jct, jkp, 3, 200)
    assert got.dtype == np.float64 and np.array_equal(got, want)


def test_leaf_order_matches_jax_tree():
    rng = np.random.default_rng(14)
    arrays = {k: rng.normal(size=(i + 1,)).astype(np.float32)
              for i, k in enumerate(["z", "a", "m"])}
    nested = {"w": arrays, "b": [arrays["a"], (arrays["m"], arrays["z"])]}
    for tree in (arrays, nested):
        jleaves = jax.tree.leaves(jax.tree.map(jnp.asarray, tree))
        tree_t = jax.tree.map(torch.as_tensor, tree)
        tleaves = tagg.tree_leaves(tree_t)
        assert [x.numpy().tolist() for x in tleaves] == [np.asarray(x).tolist() for x in jleaves]
        back = tagg.tree_unflatten(tree_t, tleaves)
        assert list(back) == list(tree_t)  # insertion order kept
        assert all(a is b for a, b in zip(tagg.tree_leaves(back), tleaves))


def test_he_aggregation_matches_plain_mean():
    agg = tagg.HeAggregator(n=256, t=3, v=30, pt_mod=1 << 24, frac_bits=10, device="cpu")
    keys = agg.keygen(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    workers = [
        {"w": torch.as_tensor(rng.normal(size=(20,)).astype(np.float32) * 0.1),
         "b": torch.as_tensor(rng.normal(size=(5,)).astype(np.float32) * 0.1)}
        for _ in range(3)
    ]
    got = tagg.he_aggregate_gradients(agg, workers, torch.Generator().manual_seed(2), keys)
    assert list(got) == ["w", "b"]
    for name in ("w", "b"):
        want = sum(w[name] for w in workers) / 3
        assert got[name].dtype == torch.float32 and got[name].shape == want.shape
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=2e-3)


def test_encrypted_inference_example_on_the_cpu(capsys):
    assert encrypted_inference.main(["--device", "cpu"]) == 0
    assert "[ok] encrypted == plaintext predictions on all 20 samples (torch on cpu)" in (
        capsys.readouterr().out)


# --------------------------------------------------------------------------
# execute and plan_from_params
# --------------------------------------------------------------------------


def test_execute_matches_polymul_and_reference():
    pl = repro_torch.plan(N, T, V, device="cpu")
    jpl = repro.plan(n=N, t=T, v=V)
    rng = np.random.default_rng(15)
    S = pl.config.seg_count
    za = rng.integers(0, 1 << V, size=(3, N, S), dtype=np.int64)
    zb = rng.integers(0, 1 << V, size=(3, N, S), dtype=np.int64)
    got = repro_torch.execute(pl, torch.as_tensor(za), torch.as_tensor(zb), donate=True)
    assert torch.equal(got, repro_torch.polymul(pl, torch.as_tensor(za), torch.as_tensor(zb)))
    assert _eq(got, repro.execute(jpl, jnp.asarray(za), jnp.asarray(zb)))
    cuda = repro_torch.plan_from_params(tparams.make_params(N, T, V, device="cpu"),
                                        backend="cuda")
    assert torch.equal(repro_torch.execute(cuda, torch.as_tensor(za), torch.as_tensor(zb)), got)


def test_plan_from_params_matches_plan_and_reference():
    params = tparams.make_params(N, T, V, device="cpu")
    assert params.backend == "auto"
    pl = repro_torch.plan_from_params(params)
    jpl = repro.api.plan_from_params(jparams.make_params(N, T, V))
    key = lambda c: (c.n, c.t, c.v, c.seg_count, c.w, c.L)
    assert key(pl.config) == key(jpl.config)
    assert pl.config == repro_torch.plan(N, T, V, device="cpu").config
    assert pl.params is params
    fused = params.with_backend("cuda_fused")
    assert repro_torch.plan_from_params(fused).config.backend == "cuda_fused"
    assert repro_torch.plan_from_params(fused, backend="torch").config.backend == "torch"


def test_plan_from_params_refuses_what_plan_refuses():
    with pytest.raises(repro_torch.UnknownKnobError) as err:
        tparams.make_params(N, T, V, device="cpu").with_backend("bogus")
    assert err.value.knob == "backend"
    # use_sau=False (the generic decompose) serves, as in plan()
    generic = repro_torch.plan_from_params(tparams.make_params(N, T, V, device="cpu"),
                                           use_sau=False)
    assert generic.config.use_sau is False
    with pytest.raises(repro_torch.UnknownKnobError) as err:
        repro_torch.plan_from_params(tparams.make_params(N, T, V, device="cpu"), use_sau="no")
    assert err.value.knob == "use_sau"
    # the shared admission: the e2e kernels' reach (K2-fs past one CTA, at
    # any t whose decompose and compose CTAs fit: t = 49 too) and the
    # kernels' decompose constants
    big = tparams.make_params(1 << 15, 1, 30, device="cpu")
    assert repro_torch.plan_from_params(big, backend="cuda_fused_e2e").config.schedule.multi_block
    big49 = tparams.make_params(1 << 15, 49, 30, device="cpu")
    assert repro_torch.plan_from_params(big49,
                                        backend="cuda_fused_e2e").config.schedule.multi_block
    assert repro_torch.plan_from_params(big, backend="cuda").config.backend == "cuda"
    assert repro_torch.plan_from_params(big, backend="cuda_fused").config.schedule.multi_block
    # no in-kernel decompose constants at v = 31 past t = 6 at n = 32768
    wide = tparams.make_params(1 << 15, 8, 31, device="cpu")
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan_from_params(wide, backend="cuda")
    assert err.value.knob == "t"
    assert repro_torch.plan_from_params(wide).config.backend == "torch"
    assert tkern.cascade_smem_bytes(1 << 15) > tkern.MAX_SMEM_BYTES
