"""The PyTorch port's host constants and plain lane arithmetic, held bit
for bit against the JAX reference package: prime sets, NTT/Shoup tables,
RNS plans and their decompose circuits, the constant import path
(``repro_torch.convert``), the modmath lane ops in all three reduction
regimes, the bigint limb ops, the host oracles, and the import purity of
the port (no JAX, no ``repro``)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bigint as jbigint
from repro.core import modmath as jmod
from repro.core import ntt as jntt
from repro.core import params as jparams
from repro.core import polymul as jpm
from repro.kernels.crt import plan_dec_arrays

from repro_torch import convert
from repro_torch.core import bigint as tbigint
from repro_torch.core import modmath as tmod
from repro_torch.core import ntt as tntt
from repro_torch.core import params as tparams
from repro_torch.core import polymul as tpm
from repro_torch.core import rns as trns
from repro_torch.kernels import ntt as tkern

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]

# (n, t, v): the paper's point and its test presets, plus the v = 29
# (lazy window 4) and v = 31 (generic %) regimes
TABLE_PRESETS = [
    (64, 3, 30), (256, 6, 30), (4096, 6, 30), (4096, 3, 30), (64, 3, 29), (64, 3, 31),
]

_CT_FIELDS = ("qs", "fwd", "inv", "half", "mul_eps", "fwd_shoup", "inv_shoup")
_RNS_FIELDS = ("qs", "beta_pows", "block_consts", "qi_tilde", "qi_star_limbs", "q_limbs")


def _same(x, y):
    if x is None or y is None:
        return x is None and y is None
    x, y = np.asarray(x), np.asarray(y)
    return x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)


def export_reference(jp) -> dict:
    """A reference params object's constants as the numpy dict
    ``repro_torch.convert.tables_from_reference`` takes."""
    ct, rp = jp.tables, jp.plan
    arrays = {name: getattr(ct, name) for name in _CT_FIELDS}
    arrays.update(plan_dec_arrays(rp))
    for name in ("qi_tilde", "qi_star_limbs", "q_limbs"):
        arrays[name] = getattr(rp, name)
    return {k: None if v is None else np.asarray(v) for k, v in arrays.items()}


def assert_tables_equal(tt, jt):
    for name in _CT_FIELDS:
        assert _same(getattr(tt, name), getattr(jt, name)), name
    assert tt.mul_shifts == jt.mul_shifts
    assert (tt.lazy_window, tt.shoup_beta) == (jt.lazy_window, jt.shoup_beta)
    for name in _CT_FIELDS:
        host, dev = getattr(tt, name), getattr(tt, name + "_d")
        assert (host is None) == (dev is None), name
        if host is not None:
            assert dev.dtype == torch.int64 and np.array_equal(dev.cpu().numpy(), host), name


def assert_plans_equal(tp, jp):
    for name in ("n", "v", "t", "q", "seg_count", "t_prime", "w", "L", "beta_terms"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in _RNS_FIELDS:
        assert _same(getattr(tp, name), getattr(jp, name)), name
    assert (tp.dec is None) == (jp.dec is None)
    if jp.dec is not None:
        for tc, jc in zip(tp.dec, jp.dec, strict=True):
            assert dataclass_tuple(tc) == dataclass_tuple(jc)
        tdec, jdec = trns.dec_arrays(tp), plan_dec_arrays(jp)
        assert tdec.keys() == jdec.keys()
        for k in jdec:
            assert _same(tdec[k], jdec[k]), k
            assert np.array_equal(tp.dec_d[k].cpu().numpy(), jdec[k]), k


def dataclass_tuple(c):
    return (c.qi, tuple(map(tuple, c.beta_terms)), tuple(c.block_consts),
            tuple(c.sau_barrett), tuple(c.acc_barrett))


# --------------------------------------------------------------------------
# tables, plans, primes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,t,v", TABLE_PRESETS)
def test_tables_and_plan_match_reference(n, t, v):
    jp = jparams.make_params(n=n, t=t, v=v)
    tp = tparams.make_params(n=n, t=t, v=v, device="cpu")
    assert tuple(s.q for s in tp.primes) == tuple(s.q for s in jp.primes)
    assert tuple(s.beta_terms for s in tp.primes) == tuple(s.beta_terms for s in jp.primes)
    assert_tables_equal(tp.tables, jp.tables)
    assert_plans_equal(tp.plan, jp.plan)


@pytest.mark.parametrize("n,t,v", TABLE_PRESETS)
def test_convert_round_trips_reference_constants(n, t, v):
    """Constants exported from the reference build the port's tables, and
    they equal the port's own host-built ones."""
    jp = jparams.make_params(n=n, t=t, v=v)
    tables, plan = convert.tables_from_reference(export_reference(jp))
    own = tparams.make_params(n=n, t=t, v=v, device="cpu")
    assert_tables_equal(tables, jp.tables)
    assert_tables_equal(own.tables, jp.tables)
    assert_plans_equal(plan, jp.plan)
    assert_plans_equal(own.plan, jp.plan)


@pytest.mark.parametrize("v", [29, 30, 31])
def test_converted_constants_drive_the_plain_multiplier(v):
    """The same multiply through imported and through own constants."""
    n, t = 64, 3
    jp = jparams.make_params(n=n, t=t, v=v)
    tables, plan = convert.tables_from_reference(export_reference(jp))
    own = tparams.make_params(n=n, t=t, v=v, device="cpu")
    rng = np.random.default_rng(v)
    za = torch.as_tensor(rng.integers(0, 1 << v, size=(2, n, plan.seg_count)))
    zb = torch.as_tensor(rng.integers(0, 1 << v, size=(2, n, plan.seg_count)))
    got = tkern.fused_e2e_polymul_ref(za, zb, tables, plan)
    assert torch.equal(got, tkern.fused_e2e_polymul_ref(za, zb, own.tables, own.plan))


def test_tables_upload_to_the_requested_device():
    tp = tparams.make_params(n=64, t=3, v=30, device="cpu")
    assert tp.device == torch.device("cpu")
    assert tp.tables.fwd_d.device == torch.device("cpu")
    assert tparams.make_params(n=64, t=3, v=30, device="cpu") is tp  # cached


# --------------------------------------------------------------------------
# modmath lanes, all three reduction regimes
# --------------------------------------------------------------------------


def _lanes(rng, hi, size=4096):
    return rng.integers(0, hi, size=size, dtype=np.int64)


def _eq(t_out, j_out):
    return np.array_equal(t_out.numpy(), np.asarray(j_out))


@pytest.mark.parametrize("v", [29, 30, 31])
def test_modmath_lanes_match_reference(v):
    jp = jparams.make_params(n=64, t=3, v=v)
    q = int(jp.qs[0])
    rng = np.random.default_rng(100 + v)
    x, y, w = _lanes(rng, q), _lanes(rng, q), _lanes(rng, q)
    T = torch.as_tensor
    half = (q + 1) // 2
    assert _eq(tmod.add_mod(T(x), T(y), q), jmod.add_mod(jnp.asarray(x), jnp.asarray(y), q))
    assert _eq(tmod.sub_mod(T(x), T(y), q), jmod.sub_mod(jnp.asarray(x), jnp.asarray(y), q))
    assert _eq(tmod.div2_mod(T(x), half), jmod.div2_mod(jnp.asarray(x), half))
    assert _eq(tmod.cond_sub(T(x), q // 2), jmod.cond_sub(jnp.asarray(x), q // 2))
    # generic % and, where the envelope allows, Barrett products
    assert _eq(tmod.mul_mod(T(x), T(y), q), jmod.mul_mod(jnp.asarray(x), jnp.asarray(y), q))
    eps, shifts = tmod.mul_barrett_constants(jp.qs)
    jeps, jshifts = jmod.mul_barrett_constants(jp.qs)
    assert _same(eps, jeps) and shifts == jshifts
    assert tmod.channel_mul_constants(jp.qs) == jmod.channel_mul_constants(jp.qs)
    assert tmod.lazy_params(jp.qs) == jmod.lazy_params(jp.qs)
    if eps is None:
        assert v == 31 and tmod.lazy_params(jp.qs) == (None, None)
        return
    e0 = int(eps[0])
    got = tmod.mul_mod(T(x), T(y), q, e0, shifts)
    assert _eq(got, jmod.mul_mod(jnp.asarray(x), jnp.asarray(y), q, e0, shifts))
    assert _eq(got, tmod.mul_mod(T(x), T(y), q))
    # Barrett of a wide word
    c = v + 24
    be = tmod.barrett_constants(q, c, v)
    assert be == jmod.barrett_constants(q, c, v)
    wide = _lanes(rng, 1 << c)
    assert _eq(tmod.barrett_reduce(T(wide), q, *be), jmod.barrett_reduce(jnp.asarray(wide), q, *be))
    # Harvey lazy butterflies in the configuration's window
    window, beta = tmod.lazy_params(jp.qs)
    assert window == (4 if v == 29 else 2)
    tmod.validate_lazy_envelope(q, window, beta)
    ws = tmod.shoup_constants(w, q, beta)
    assert _same(ws, jmod.shoup_constants(w, q, beta))
    u, vv = _lanes(rng, window * q), _lanes(rng, window * q)
    J = jnp.asarray
    assert _eq(tmod.shoup_mul(T(vv), T(w), T(ws), q, beta),
               jmod.shoup_mul(J(vv), J(w), J(ws), q, beta))
    for tf, jf in ((tmod.lazy_ct_butterfly, jmod.lazy_ct_butterfly),):
        for a_, b_ in zip(tf(T(u), T(vv), T(w), T(ws), q, beta=beta, window=window),
                          jf(J(u), J(vv), J(w), J(ws), q, beta=beta, window=window)):
            assert _eq(a_, b_)
    for a_, b_ in zip(
        tmod.lazy_gs_butterfly(T(u), T(vv), T(w), T(ws), q, half, beta=beta, window=window),
        jmod.lazy_gs_butterfly(J(u), J(vv), J(w), J(ws), q, half, beta=beta, window=window),
    ):
        assert _eq(a_, b_)
    assert _eq(tmod.canonicalize(T(u), q, window), jmod.canonicalize(J(u), q, window))


def test_lazy_envelope_rejects_overflow():
    q = (1 << 30) - 35
    with pytest.raises(ValueError):
        tmod.validate_lazy_envelope(q, 3, 32)
    with pytest.raises(ValueError):
        tmod.validate_lazy_envelope(q, 4, 31)  # 4q > 2^31
    with pytest.raises(ValueError):
        tmod.validate_lazy_envelope(q, 4, 33)  # v*w' > 2^63
    with pytest.raises(ValueError):
        tmod.barrett_constants(q, 2 * 30 + 5, 30)


# --------------------------------------------------------------------------
# NTT reference transforms, bigint limbs, host oracles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,t,v", [(64, 3, 30), (64, 3, 29), (64, 3, 31)])
def test_channel_transforms_match_reference(n, t, v):
    jp = jparams.make_params(n=n, t=t, v=v)
    tp = tparams.make_params(n=n, t=t, v=v, device="cpu")
    rng = np.random.default_rng(n + v)
    a = rng.integers(0, 1 << 31, size=(t, 2, n)) % jp.qs[:, None, None]
    fa = tntt.ntt_channels(torch.as_tensor(a), tp.tables)
    fwd = jax.jit(lambda x: jntt.ntt_channels(x, jp.tables, "radix2"))
    inv = jax.jit(lambda x: jntt.intt_channels(x, jp.tables, "radix2"))
    assert _eq(fa, fwd(jnp.asarray(a)))
    back = tntt.intt_channels(fa, tp.tables)
    assert _eq(back, inv(jnp.asarray(fa.numpy())))
    assert np.array_equal(back.numpy(), a)


def test_single_modulus_transforms_invert():
    tb = tntt.make_tables(int(tparams.make_params(64, 3, 30).qs[0]), 64)
    a = torch.as_tensor(np.random.default_rng(0).integers(0, tb.q, size=(3, 64)))
    fwd, inv = torch.as_tensor(tb.fwd), torch.as_tensor(tb.inv)
    f = tntt.ntt_raw(a, fwd, tb.q, tb.mul_eps, tb.mul_shifts)
    assert torch.equal(tntt.intt_raw(f, inv, tb.q, tb.half, tb.mul_eps, tb.mul_shifts), a)
    assert _same(tntt.bit_reverse_indices(64), jntt.bit_reverse_indices(64))


def test_bigint_limb_ops_match_reference():
    rng = np.random.default_rng(7)
    xs = [int(x) << 40 | int(y) for x, y in zip(rng.integers(0, 1 << 40, 16),
                                                  rng.integers(0, 1 << 40, 16))]
    limbs = tbigint.ints_to_limbs(xs, 28, 4)
    assert _same(limbs, jbigint.ints_to_limbs(xs, 28, 4))
    assert tbigint.limbs_to_ints(limbs, 28) == xs
    raw = rng.integers(0, 1 << 60, size=(16, 5))
    assert _eq(tbigint.carry_normalize(torch.as_tensor(raw), 28),
               jbigint.carry_normalize(jnp.asarray(raw), 28))
    a = tbigint.ints_to_limbs(xs, 28, 4)
    m = np.broadcast_to(tbigint.int_to_limbs(1 << 70, 28, 4), a.shape).copy()
    T, J = torch.as_tensor, jnp.asarray
    assert _eq(tbigint.compare_ge(T(a), T(m)), jbigint.compare_ge(J(a), J(m)))
    assert _eq(tbigint.cond_sub(T(a), T(m), 28), jbigint.cond_sub(J(a), J(m), 28))
    assert _eq(tbigint.mod_by_subtraction(T(a), T(m), 28, 3),
               jbigint.mod_by_subtraction(J(a), J(m), 28, 3))


def test_host_oracles_match_reference():
    p = tparams.make_params(64, 3, 30)
    q = int(p.qs[0])
    rng = np.random.default_rng(3)
    a = [int(x) for x in rng.integers(0, q, 64)]
    b = [int(x) for x in rng.integers(0, q, 64)]
    ref = jpm.schoolbook_negacyclic(a, b, q)
    assert tpm.schoolbook_negacyclic(a, b, q) == ref
    assert tpm.ntt_negacyclic_host(a, b, q) == ref
    big = [int(x) for x in rng.integers(0, 1 << 62, 64)]
    assert tpm.oracle_multiply(big, a, p) == jpm.oracle_multiply(
        big, a, jparams.make_params(64, 3, 30)
    )
    segs = tpm.ints_to_segments(big, p.plan)
    assert _same(segs, jpm.ints_to_segments(big, jparams.make_params(64, 3, 30).plan))
    assert tbigint.limbs_to_ints(segs, p.v) == big
    limbs = tbigint.ints_to_limbs(big, p.plan.w, p.plan.L)
    assert tpm.limbs_out_to_ints(limbs, p.plan) == big


# --------------------------------------------------------------------------
# import purity
# --------------------------------------------------------------------------

_PURITY_PROBE = """
import importlib, importlib.util, pkgutil, sys
import repro_torch

names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_reference():
    """Importing the port and every submodule, and loading chip_smoke.py
    without running it, leaves jax and repro out of sys.modules."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PURITY_PROBE.format(smoke=str(ROOT / "chip_smoke.py"))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 12
    assert bad == "[]"
