"""The PyTorch port's wide (31 < v <= 46) and oracle (v > 46) widths held
bit for bit against the JAX reference: the digit-split arithmetic of
``repro_torch.core.wide`` on seeded and adversarial values, every entry
point of a ``plan(32, 4, 45)`` wide plan and the host oracle of a
``plan(32, 2, 50)`` plan, the plan-time refusals with the reference's
knobs, and the wide constants carried across by ``convert.py``.  Inputs
are made from a seed with numpy and fed to both packages; the tolerance
is exact int64 equality.  n = 32: the reference's own n = 64 wide tests
are marked slow."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import wide as rwide

import repro_torch
from repro_torch import convert
from repro_torch.core import polymul as tpm
from repro_torch.core import primes as tprimes
from repro_torch.core import wide as twide

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N, T, V = 32, 4, 45
ORACLE = (32, 2, 50)
ROWS = 2
PRIMES = tprimes.default_prime_set(N, T, V)


@pytest.mark.parametrize("i", range(len(PRIMES)))
def test_wide_mul_mod_and_reduce_mod_match_reference(i):
    """mul_mod and reduce_mod of one of plan(32, 4, 45)'s primes on
    seeded values and the corners 0, 1, q - 1, 2^v - 1: port == reference
    == Python ints."""
    spec = twide.from_special(PRIMES[i])
    rspec = rwide.WideSpec(q=spec.q, v=spec.v, beta=spec.beta)
    q, v = spec.q, spec.v
    rng = np.random.default_rng(100 + i)
    corners = np.array([0, 1, q - 1, (1 << v) - 1], dtype=np.int64)
    a = np.concatenate([rng.integers(0, q, 252, dtype=np.int64), corners])
    b = np.concatenate([rng.integers(0, q, 252, dtype=np.int64), corners[::-1]])
    a2 = np.concatenate([a, np.repeat(corners, 4)])
    b2 = np.concatenate([b, np.tile(corners, 4)])
    got = twide.mul_mod(torch.from_numpy(a2), torch.from_numpy(b2), spec).numpy()
    want = np.asarray(rwide.mul_mod(jnp.asarray(a2), jnp.asarray(b2), rspec))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [(int(x) * int(y)) % q for x, y in zip(a2, b2)]
    # reduce_mod on x < 2^62: products of the corners' digits and raw words
    x = np.concatenate([rng.integers(0, 1 << 62, 256, dtype=np.int64), corners,
                        np.array([(1 << 62) - 1], dtype=np.int64)])
    got = twide.reduce_mod(torch.from_numpy(x), spec).numpy()
    np.testing.assert_array_equal(got, np.asarray(rwide.reduce_mod(jnp.asarray(x), rspec)))
    assert got.tolist() == [int(y) % q for y in x]


@pytest.fixture(scope="module")
def wide_pair():
    tpl = repro_torch.plan(N, T, V, device="cpu")
    rpl = repro.plan(n=N, t=T, v=V)
    rng = np.random.default_rng(45)
    S = tpl.config.seg_count
    za = rng.integers(0, 1 << V, size=(ROWS, N, S), dtype=np.int64)
    zb = rng.integers(0, 1 << V, size=(ROWS, N, S), dtype=np.int64)
    qs = np.asarray(tpl.params.qs, dtype=np.int64)[:, None, None]
    ra = rng.integers(0, 1 << 62, size=(T, ROWS, N), dtype=np.int64) % qs
    rb = rng.integers(0, 1 << 62, size=(T, ROWS, N), dtype=np.int64) % qs
    return tpl, rpl, za, zb, ra, rb


def test_wide_entry_points_match_reference(wide_pair):
    """polymul, ntt, intt, negacyclic_mul, decompose and compose of
    plan(32, 4, 45) at batch 2, port (CPU tensors) == reference (jnp);
    polymul_ints == the schoolbook (q - 1 in a corner)."""
    tpl, rpl, za, zb, ra, rb = wide_pair
    cfg = tpl.config
    assert (cfg.width, cfg.backend, cfg.schedule.kind) == ("wide", "torch", "radix2")
    assert (cfg.seg_count, cfg.w, cfg.L) == (rpl.config.seg_count, rpl.config.w, rpl.config.L)
    assert tpl.q == rpl.q
    T_ = torch.from_numpy

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    same(repro_torch.polymul(tpl, T_(za), T_(zb)), repro.polymul(rpl, za, zb))
    same(repro_torch.ntt(tpl, T_(ra)), repro.ntt(rpl, ra))
    same(repro_torch.intt(tpl, T_(ra)), repro.intt(rpl, ra))
    same(repro_torch.negacyclic_mul(tpl, T_(ra), T_(rb)), repro.negacyclic_mul(rpl, ra, rb))
    same(repro_torch.decompose(tpl, T_(za)), repro.decompose(rpl, za))
    same(repro_torch.compose(tpl, T_(ra)), repro.compose(rpl, ra))
    a = [(y << 150) % tpl.q for y in range(1, 2 * N, 2)]
    a[0] = tpl.q - 1
    assert repro_torch.polymul_ints(tpl, a, a[::-1]) == \
        tpm.schoolbook_negacyclic(a, a[::-1], tpl.q)


def test_wide_constants_from_convert_equal_reference(wide_pair):
    """convert.py takes the reference's wide leaves (pl.consts as numpy):
    each equals the port's own, and a plan on them multiplies bit for bit
    as the reference does."""
    tpl, rpl, za, zb, _, _ = wide_pair
    exported = {k: np.asarray(x) for k, x in rpl.consts.items()}
    assert set(exported) == set(convert.WIDE_KEYS) == set(tpl.consts)
    consts = convert.tables_from_reference(exported)
    for k in convert.WIDE_KEYS:
        np.testing.assert_array_equal(consts[k].numpy(), tpl.consts[k].numpy(), err_msg=k)
    on_ref = repro_torch.Plan(config=tpl.config, params=tpl.params, consts=consts)
    got = repro_torch.polymul(on_ref, torch.from_numpy(za), torch.from_numpy(zb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(repro.polymul(rpl, za, zb)))
    bad = dict(exported, wide_q_limbs=exported["wide_q_limbs"] + 1)
    with pytest.raises(ValueError):
        convert.tables_from_reference(bad)


def test_oracle_polymul_ints_matches_reference_and_schoolbook():
    """plan(32, 2, 50): the host oracle through polymul_ints and polymul,
    against the reference and the O(n^2) schoolbook."""
    n, t, v = ORACLE
    tpl = repro_torch.plan(n, t, v, device="cpu")
    rpl = repro.plan(n=n, t=t, v=v)
    assert (tpl.config.width, tpl.config.backend) == ("oracle", repro_torch.ORACLE_BACKEND)
    rng = np.random.default_rng(50)
    a = [int(x) % tpl.q for x in rng.integers(0, 1 << 62, n)]
    b = [(int(x) << 40) % tpl.q for x in rng.integers(0, 1 << 62, n)]
    a[0], b[-1] = tpl.q - 1, tpl.q - 1
    want = tpm.schoolbook_negacyclic(a, b, tpl.q)
    assert repro_torch.polymul_ints(tpl, a, b) == want == repro.polymul_ints(rpl, a, b)
    S = tpl.config.seg_count
    za = rng.integers(0, 1 << v, size=(ROWS, n, S), dtype=np.int64)
    zb = rng.integers(0, 1 << v, size=(ROWS, n, S), dtype=np.int64)
    got = repro_torch.execute(tpl, torch.from_numpy(za), torch.from_numpy(zb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(repro.polymul(rpl, za, zb)))


def test_oracle_stage_entry_points_match_reference():
    """The oracle width's host decompose and compose against the
    reference; its device transforms are refused as the reference refuses
    them."""
    n, t, v = ORACLE
    tpl = repro_torch.plan(n, t, v, device="cpu")
    rpl = repro.plan(n=n, t=t, v=v)
    rng = np.random.default_rng(51)
    z = rng.integers(0, 1 << v, size=(3, tpl.config.seg_count), dtype=np.int64)
    np.testing.assert_array_equal(repro_torch.decompose(tpl, torch.from_numpy(z)).numpy(),
                                  np.asarray(repro.decompose(rpl, z)))
    r = rng.integers(0, 1 << 62, size=(t, 3), dtype=np.int64) % \
        np.asarray(tpl.params.qs, dtype=np.int64)[:, None]
    np.testing.assert_array_equal(repro_torch.compose(tpl, torch.from_numpy(r)).numpy(),
                                  np.asarray(repro.compose(rpl, r)))
    a = torch.zeros((t, 1, n), dtype=torch.int64)
    for fn in (repro_torch.ntt, repro_torch.intt):
        with pytest.raises(ValueError, match="oracle width"):
            fn(tpl, a)
    with pytest.raises(ValueError, match="oracle width"):
        repro_torch.negacyclic_mul(tpl, a, a)


def test_width_refusals_carry_reference_knobs():
    """Each refusal keeps the reference's class and knob: a kernel backend,
    a four-step schedule or a tiling on the wide width, a device backend
    on the oracle width, and the wide CRT envelope."""
    cases = [
        (dict(n=N, t=T, v=V, backend="cuda_fused"), dict(n=N, t=T, v=V, backend="pallas_fused"),
         "backend"),
        (dict(n=N, t=T, v=V, schedule="four_step"), dict(n=N, t=T, v=V, schedule="four_step"),
         "schedule"),
        (dict(n=N, t=T, v=V, tiling=((4, 8),)), dict(n=N, t=T, v=V, tiling=((4, 8),)), "tiling"),
        (dict(n=N, t=2, v=50, backend="torch"), dict(n=N, t=2, v=50, backend="jnp"), "backend"),
        (dict(n=N, t=40, v=46), dict(n=N, t=40, v=46), "t"),
    ]
    for port_kw, ref_kw, knob in cases:
        with pytest.raises(repro_torch.UnservableConfigError) as got:
            repro_torch.plan(**port_kw, device="cpu")
        with pytest.raises(repro.UnservableConfigError) as want:
            repro.plan(**ref_kw)
        assert got.value.knob == want.value.knob == knob, (port_kw, got.value)
    for v in (32, 45, 46, 47, 60):  # no width in (31, 60] is refused for its own sake
        assert repro_torch.width_for(v) == repro.api.width_for(v)
    assert repro_torch.plan(8, 1, 60, device="cpu").config.width == "oracle"
    with pytest.raises(repro_torch.UnknownKnobError):
        repro_torch.plan(N, T, 61, device="cpu")


def test_width_field_leaves_the_int64_width_unchanged():
    """PlanConfig.width is "int64" at v <= 31 with every other field as
    before; the widths are distinct bucket keys; a wide plan built from
    its params (plan_from_params) is the same config."""
    pl = repro_torch.plan(64, 3, 30, device="cpu")
    assert repro_torch.WIDTHS == repro.WIDTHS
    assert pl.config.width == "int64" and pl.consts == {}
    assert pl.config == repro_torch.plan(64, 3, 30, device="cpu").config
    wide = repro_torch.plan(N, T, V, device="cpu")
    assert repro_torch.plan_from_params(wide.params).config == wide.config
    keys = {repro_torch.plan_key(p) for p in (pl, wide, repro_torch.plan(*ORACLE, device="cpu"))}
    assert len(keys) == 3
