"""The port's distributed four-step NTT (``repro_torch.core.dntt``) and
its collectives held against the JAX reference: the tables and the three
transforms at (n, n1) = (64, 8) and (256, 16) against
``repro.core.dntt``, the same transforms column-sharded over a gloo mesh
of world size 1 with their all-to-all and all-gather counts,
``quantize_int8`` on the reference's own draws, ``compressed_psum`` at
world size 1; one spawned world of 4 gloo ranks: ``polymul_sharded`` and
``negacyclic_mul_sharded`` on the reference's ``host_mesh_4`` layout
(data=2, model=2), the four-step product over model=2 and model=4, and
``compressed_psum`` over a 4-rank pod axis; and at the int64 width on
the world of one, the sharded products and the engine's mesh mode
against the reference's unsharded ``repro.polymul`` and
``repro.negacyclic_mul`` (the same reference outputs as the 4 ranks').
Inputs are made from a seed with numpy; the tolerance is exact equality,
and rtol 1e-6 for the float result of ``compressed_psum``."""
import multiprocessing as mp
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import dntt as rdntt
from repro.train import aggregation as ragg

import repro_torch
from repro_torch.core import dntt
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding import ctx
from repro_torch.train import aggregation as tagg

from _torch_dist import check_world_of_one, run_rank, seeded_inputs
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

Q = 998244353
SPLITS = [(64, 8), (256, 16)]
INT64 = (64, 6, 30)


@pytest.fixture(scope="module")
def mesh():
    """A gloo (data=1, model=1) mesh of world size 1 for this module, its
    process group destroyed when the module ends."""
    m = mesh_mod.make_local_mesh(device="cpu")
    try:
        yield m
    finally:
        m.close()


@pytest.fixture(scope="module")
def int64_ref():
    """A getter of the port's int64 plan, seeded inputs, and the reference's
    unsharded polymul and negacyclic_mul of them, computed at its first
    call (the 4-rank test calls it while its ranks start).  The
    reference's fused cascade is bit-exact with its jnp datapath by its
    own contract."""
    got = []

    def get():
        if not got:
            pl = repro_torch.plan(*INT64, device="cpu")
            ins = seeded_inputs(pl, seed=44)
            jpl = repro.plan(*INT64, backend="pallas_fused")
            za, zb, ra, rb = (jnp.asarray(x) for x in ins)
            got.append((pl, ins, np.asarray(repro.polymul(jpl, za, zb)),
                        np.asarray(repro.negacyclic_mul(jpl, ra, rb))))
        return got[0]

    return get


def _poly(seed, n, rows=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, Q, size=(rows, n), dtype=np.int64) for _ in range(2))


@pytest.mark.parametrize("n,n1", SPLITS)
def test_fourstep_matches_reference(n, n1):
    """make_fourstep_tables (built with numpy) equals the reference's
    tables field for field, and fourstep_ntt, fourstep_intt and
    negacyclic_mul_fourstep equal the reference's outputs exactly."""
    rt, tt = rdntt.make_fourstep_tables(Q, n, n1), dntt.make_fourstep_tables(Q, n, n1)
    for f in ("psi_w", "psi_iw", "tw", "itw"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(rt, f), err_msg=f)
    for f in ("st1", "ist1", "st2", "ist2"):
        assert len(getattr(tt, f)) == len(getattr(rt, f))
        for got, want in zip(getattr(tt, f), getattr(rt, f)):
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tt.n2, tt.half) == (rt.n2, rt.half)
    a, b = _poly(n, n)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    # the reference under jit: one compile each, where its eager ops compile one by one
    np.testing.assert_array_equal(dntt.fourstep_ntt(ta, tt).numpy(), np.asarray(
        jax.jit(lambda x: rdntt.fourstep_ntt(x, rt))(ja)))
    np.testing.assert_array_equal(dntt.fourstep_intt(ta, tt).numpy(), np.asarray(
        jax.jit(lambda x: rdntt.fourstep_intt(x, rt))(ja)))
    np.testing.assert_array_equal(dntt.negacyclic_mul_fourstep(ta, tb, tt).numpy(), np.asarray(
        jax.jit(lambda x, y: rdntt.negacyclic_mul_fourstep(x, y, rt))(ja, jb)))


def test_sharded_fourstep_and_psum_on_world_of_one(mesh):
    """Column-sharded over model=1 the transforms equal the unsharded ones;
    one transform issues exactly one all-to-all (and its entry point one
    all-gather), the product three all-to-alls and one all-gather; and
    compressed_psum over a one-rank pod axis is the dequantized value."""
    n, n1 = SPLITS[1]
    tt = dntt.make_fourstep_tables(Q, n, n1)
    a, b = (torch.as_tensor(x) for x in _poly(5, n))
    cons = dntt.make_shard_constrain(mesh)
    for fn, args, calls in ((dntt.fourstep_ntt, (a,), {"all_to_all": 1, "all_gather": 1}),
                            (dntt.fourstep_intt, (a,), {"all_to_all": 1, "all_gather": 1}),
                            (dntt.negacyclic_mul_fourstep, (a, b),
                             {"all_to_all": 3, "all_gather": 1})):
        with ctx.count_collectives() as coll:
            got = fn(*args, tt, cons)
        assert coll.calls == calls, fn.__name__
        assert torch.equal(got, fn(*args, tt)), fn.__name__
    with mesh_mod.make_mesh((1,), ("pod",), device="cpu") as pod:
        g = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(1))}
        draws = [torch.rand(4, 3, generator=torch.Generator().manual_seed(2))]
        got = tagg.compressed_psum_draws(g, draws, pod)
        q, s = tagg.quantize_int8_draws(g["w"], draws[0])
        assert torch.equal(got["w"], q.to(torch.float32) * s)
        assert tagg.compressed_psum(g, torch.Generator().manual_seed(3), pod)["w"].shape == (4, 3)


def test_quantize_int8_on_reference_draws():
    """quantize_int8 on the reference's own jax.random.uniform draws equals
    its values and scale exactly; dequantize_int8 equals its product; the
    Generator form draws in [0, 1) and is unbiased within its scale."""
    rng = np.random.default_rng(3)
    for shape in ((257,), (16, 33)):
        x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
        key = jax.random.PRNGKey(int(np.prod(shape)))
        qr, sr = jax.jit(ragg.quantize_int8)(jnp.asarray(x), key)
        draws = np.array(jax.jit(jax.random.uniform, static_argnums=1)(key, x.shape))
        qt, st = tagg.quantize_int8_draws(torch.as_tensor(x), torch.as_tensor(draws))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
        assert qt.dtype == torch.int8 and float(st) == float(sr)
        np.testing.assert_array_equal(tagg.dequantize_int8(qt, st).numpy(),
                                      np.asarray(ragg.dequantize_int8(qr, sr)))
    q, s = tagg.quantize_int8(torch.as_tensor(x), torch.Generator().manual_seed(0))
    assert (tagg.dequantize_int8(q, s) - torch.as_tensor(x)).abs().max() <= s


def _psum_formula(grads, draws, leaf, i):
    """The reference's compressed_psum on these draws, in numpy float32."""
    qsum, ssum = np.zeros(grads[0][leaf].shape, np.int32), np.float32(0)
    for g, d in zip(grads, draws):
        xf = g[leaf]
        scale = np.float32(max(np.abs(xf).max(), np.float32(1e-12)) / np.float32(127.0))
        y = xf / scale
        lo = np.floor(y)
        qsum += np.clip(lo + (d[i] < y - lo).astype(np.float32), -127, 127).astype(np.int32)
        ssum += scale
    k = np.float32(len(grads))
    return qsum.astype(np.float32) * (ssum / k) / k


def test_four_gloo_ranks_match_reference(int64_ref, tmp_path):
    """Four spawned gloo ranks: polymul_sharded and negacyclic_mul_sharded
    on (data=2, model=2), t = 6, 4 rows; negacyclic_mul_fourstep over
    model=2 and model=4 and fourstep_ntt over model=4; compressed_psum
    over a 4-rank pod axis.  Every rank's result equals the reference's
    unsharded output (computed here from the same seeded inputs), and
    compressed_psum numpy's evaluation of the reference's formula on the
    same draws to rtol 1e-6.  A rank that stalls fails the test at 120 s
    (its processes killed)."""
    za, zb, ra, rb = seeded_inputs(repro_torch.plan(*INT64, device="cpu"), seed=44)
    dn, dn1 = SPLITS[1]
    a, b = _poly(45, dn, rows=2)
    rng = np.random.default_rng(46)
    grads = [{"w": rng.standard_normal((8, 5)).astype(np.float32) * (r + 1),
              "b": rng.standard_normal(7).astype(np.float32)} for r in range(4)]
    draws = [[rng.random(g[k].shape, dtype=np.float32) for k in ("b", "w")] for g in grads]
    inputs = {"plan": INT64, "za": za, "zb": zb, "ra": ra, "rb": rb, "dntt": (Q, dn, dn1),
              "a": a, "b": b, "grads": grads, "draws": draws}
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=run_rank, args=(r, 4, str(tmp_path), inputs))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        # the reference's outputs while the ranks run
        _, _, want_poly, want_nega = int64_ref()
        rt = rdntt.make_fourstep_tables(Q, dn, dn1)
        mul = np.asarray(jax.jit(lambda x, y: rdntt.negacyclic_mul_fourstep(x, y, rt))(
            jnp.asarray(a), jnp.asarray(b)))
        want = {
            "polymul": want_poly, "negacyclic": want_nega,
            "fourstep_m2": mul, "fourstep_m4": mul,
            "fourstep_ntt_m4": np.asarray(jax.jit(lambda x: rdntt.fourstep_ntt(x, rt))(
                jnp.asarray(a))),
        }
        psum = {leaf: _psum_formula(grads, draws, leaf, i) for i, leaf in enumerate(("b", "w"))}
        deadline = time.monotonic() + 120.0
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.0))
        stalled = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    assert not stalled, f"ranks {stalled} stalled past 120 s"
    assert [p.exitcode for p in procs] == [0] * 4
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"rank {r} {k}")
        for leaf, w in psum.items():
            np.testing.assert_allclose(got["psum_" + leaf], w, rtol=1e-6, err_msg=f"rank {r}")


def test_int64_sharded_products_and_engine_on_world_of_one(mesh, int64_ref):
    """At the int64 width on the (1, 1) gloo mesh, polymul_sharded and
    negacyclic_mul_sharded equal the reference's unsharded products
    exactly, and PolymulEngine(mesh=) serves each request equal to its
    polymul (the wide width: tests/test_torch_sharding.py)."""
    check_world_of_one(mesh, *int64_ref())
