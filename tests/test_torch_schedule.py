"""The port's NTT schedule layer held against the JAX reference, exact:
the four-step split, chain, row-table gather and lane strides
(``repro_torch.core.ntt``), ``ScheduleSpec`` / ``parse_schedule`` /
``concrete_spec`` and the paper's FPGA cycle model
(``repro_torch.core.schedule``), the four-step tables and their Shoup
companions, ``ntt_raw_hier`` / ``intt_raw_hier`` and ``*_channels`` with
``schedule=`` at depths 1, 2 and 3, ``plan(schedule=, tiling=)`` with its
refusals, ``plan_key``, and ``polymul`` / ``negacyclic_mul`` on the CPU
under ``schedule="four_step:h"``.  The reference runs under ``jax.jit``
(eager, its four-step transforms take seconds a call at n >= 8192).

    python -m pytest -q tests/test_torch_schedule.py
"""
import functools

import numpy as np
import pytest
import torch

import jax

import repro
from repro.core import ntt as jntt
from repro.core import params as jparams
from repro.core import primes as jprimes
from repro.core import schedule as jsched
from repro.errors import PlanError as JPlanError
from repro.errors import UnknownKnobError as JUnknownKnobError

import repro_torch
from repro_torch import convert
from repro_torch.core import bigint as tbigint
from repro_torch.core import modmath as tmod
from repro_torch.core import ntt as tntt
from repro_torch.core import params as tparams
from repro_torch.core import schedule as tsched
from repro_torch.kernels import ntt as tkern
from repro_torch.kernels import ops as tops

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

NS = [1 << k for k in range(2, 17)]  # n = 4 ... 65536
SEED = 19


def _residues(qs, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 62, size=(len(qs),) + shape, dtype=np.int64) % np.asarray(
        qs, dtype=np.int64).reshape((-1,) + (1,) * len(shape))


# --------------------------------------------------------------------------
# the four-step layer of core/ntt.py
# --------------------------------------------------------------------------


def test_split_chain_row_indices_and_lane_strides_match_reference():
    for n in NS:
        assert tntt.four_step_split(n) == jntt.four_step_split(n)
        chain = tntt.four_step_chain(n)
        assert chain == jntt.four_step_chain(n)
        for c, r in chain:
            assert np.array_equal(tntt.four_step_row_indices(c, r), jntt.four_step_row_indices(c, r))
        for sched in ("radix2", "four_step", tsched.concrete_spec(n, "four_step")):
            assert tntt.stage_lane_strides(n, sched) == jntt.stage_lane_strides(
                n, getattr(sched, "kind", sched))
    assert (tntt.MAX_FS_COL, tntt.SUB_ROW_FACTOR) == (jntt.MAX_FS_COL, jntt.SUB_ROW_FACTOR)
    for bad in (2, 6, 100):
        with pytest.raises(ValueError):
            tntt.four_step_split(bad)
        with pytest.raises(ValueError):
            jntt.four_step_split(bad)
    with pytest.raises(ValueError):
        tntt.stage_lane_strides(64, "bogus")


@pytest.mark.parametrize("v", (29, 30, 31))
@pytest.mark.parametrize("n", (256, 8192, 65536))
def test_four_step_tables_match_reference(n, v):
    qs = [s.q for s in jprimes.default_prime_set(n, 2, v)]
    jt, tt = jntt.make_channel_tables(qs, n), tntt.make_channel_tables(qs, n)
    for name in ("fs_row_fwd", "fs_row_inv", "fs_row_fwd_shoup", "fs_row_inv_shoup"):
        want, got = getattr(jt, name), getattr(tt, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert got.dtype == np.int64 and np.array_equal(got, want), name
            assert np.array_equal(getattr(tt, name + "_d").numpy(), want), name
    for name in ("fs_sub_fwd", "fs_sub_inv", "fs_sub_fwd_shoup", "fs_sub_inv_shoup"):
        want, got = getattr(jt, name), getattr(tt, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert len(got) == len(want) == len(tt.fs_chain) - 1, name
            for g, w, d in zip(got, want, getattr(tt, name + "_d")):
                assert np.array_equal(g, w) and np.array_equal(d.numpy(), w), name
    assert (tt.fs_split, tt.fs_chain) == (jt.fs_split, jt.fs_chain)


# depth 1 (n = 256), 2 (n = 8192) and 3 (n = 65536, one row, t = 2), each
# with Barrett products (v = 30) and the generic % (v = 31); the lazy
# v = 29 tables at depth 2
DEPTHS = [(256, 3, 2, 1, 30), (256, 3, 2, 1, 31), (8192, 2, 2, 2, 29), (8192, 2, 2, 2, 30),
          (8192, 2, 2, 2, 31), (65536, 2, 1, 3, 30), (65536, 2, 1, 3, 31)]


@pytest.mark.parametrize("n,t,rows,depth,v", DEPTHS)
def test_hier_transforms_match_reference_at_each_depth(n, t, rows, depth, v):
    qs = [s.q for s in jprimes.default_prime_set(n, t, v)]
    jt, tt = jntt.make_channel_tables(qs, n), tntt.make_channel_tables(qs, n)
    assert len(tt.fs_chain) == depth
    a = _residues(qs, (rows, n), SEED + n + v)
    b = _residues(qs, (rows, n), SEED + n + v + 1)
    A, B = torch.as_tensor(a), torch.as_tensor(b)
    spec = tsched.concrete_spec(n, "four_step")
    jspec = jsched.concrete_spec(n, "four_step")
    # the single-modulus transforms of channel 0 with the full row chain
    # (depth 3 runs them through the channel transforms below)
    q = int(qs[0])
    eps = None if tt.mul_eps is None else int(tt.mul_eps[0])
    half = int(tt.half[0])
    rows_f = (tt.fs_row_fwd[0],) + tuple(s[0] for s in tt.fs_sub_fwd)
    rows_i = (tt.fs_row_inv[0],) + tuple(s[0] for s in tt.fs_sub_inv)
    if depth < 3:
        T = lambda xs: tuple(torch.as_tensor(x) for x in xs)
        jf = jax.jit(functools.partial(jntt.ntt_raw_hier, shifts=tt.mul_shifts))
        ji = jax.jit(functools.partial(jntt.intt_raw_hier, shifts=tt.mul_shifts))
        got = tntt.ntt_raw_hier(A[0], torch.as_tensor(tt.fwd[0]), T(rows_f), q, eps,
                                tt.mul_shifts)
        assert np.array_equal(got.numpy(), np.asarray(jf(a[0], jt.fwd[0], rows_f, q, eps)))
        got = tntt.intt_raw_hier(A[0], torch.as_tensor(tt.inv[0]), T(rows_i), q, half, eps,
                                 tt.mul_shifts)
        assert np.array_equal(got.numpy(), np.asarray(ji(a[0], jt.inv[0], rows_i, q, half, eps)))
    # the channel transforms under the spec, equal to radix-2 too, and the
    # cascade at depth 3 (depth 2's runs in test_four_step_h_datapaths_...)
    for tfn, jfn in ((tntt.ntt_channels, jntt.ntt_channels),
                     (tntt.intt_channels, jntt.intt_channels)):
        got = tfn(A, tt, spec)
        assert np.array_equal(got.numpy(), np.asarray(jax.jit(lambda x: jfn(x, jt, jspec))(a)))
        assert torch.equal(got, tfn(A, tt))
    if depth == 3:
        got = tntt.negacyclic_mul_channels(A, B, tt, spec)
        want = jax.jit(lambda x, y: jntt.negacyclic_mul_channels(x, y, jt, jspec))(a, b)
        assert np.array_equal(got.numpy(), np.asarray(want))
    if depth == 1:  # the historical depth-1 entry points (reference under jax.jit)
        got = tntt.ntt_raw_four_step(A[0], torch.as_tensor(tt.fwd[0]), torch.as_tensor(rows_f[0]),
                                     q, eps, tt.mul_shifts)
        jf = jax.jit(functools.partial(jntt.ntt_raw_four_step, shifts=tt.mul_shifts))
        want = jf(a[0], jt.fwd[0], rows_f[0], q, eps)
        assert np.array_equal(got.numpy(), np.asarray(want))
        got = tntt.intt_raw_four_step(A[0], torch.as_tensor(tt.inv[0]),
                                      torch.as_tensor(rows_i[0]), q, half, eps, tt.mul_shifts)
        ji = jax.jit(functools.partial(jntt.intt_raw_four_step, shifts=tt.mul_shifts))
        want = ji(a[0], jt.inv[0], rows_i[0], q, half, eps)
        assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# core/schedule.py: specs and the FPGA cycle model
# --------------------------------------------------------------------------


def _spec_key(s):
    return (s.kind, s.splits, s.depth, s.canonical, str(s))


def test_specs_match_reference_for_every_string_and_n():
    assert tsched.SCHEDULE_STRINGS == jsched.SCHEDULE_STRINGS
    for n in NS:
        for string in tsched.SCHEDULE_STRINGS:
            try:
                want = _spec_key(jsched.concrete_spec(n, string))
            except JPlanError as err:
                with pytest.raises(repro_torch.PlanError) as got:
                    tsched.concrete_spec(n, string)
                assert type(got.value).__name__ == type(err).__name__
                assert (got.value.knob, got.value.value, got.value.alternatives) == (
                    err.knob, err.value, err.alternatives)
                continue
            spec = tsched.concrete_spec(n, string)
            assert _spec_key(spec) == want
            assert tsched.concrete_spec(n, spec) is spec
            assert _spec_key(tsched.concrete_spec(n, spec.canonical)) == want
        for string in tsched.SCHEDULE_STRINGS:
            assert tsched.parse_schedule(string) == jsched.parse_schedule(string)
    for bad in ("bogus", "radix2:h", 7, None):
        with pytest.raises(repro_torch.UnknownKnobError) as got:
            tsched.parse_schedule(bad)
        with pytest.raises(JUnknownKnobError) as want:
            jsched.parse_schedule(bad)
        assert (got.value.knob, got.value.alternatives) == (want.value.knob,
                                                            want.value.alternatives)
    for kind, splits, rb, S, L, lazy in (("radix2", (), 4, 6, 7, True),
                                         ("four_step", ((32, 128),), 2, 6, 7, False),
                                         ("four_step", ((512, 128), (64, 8), (8, 8)), 1, 6, 7, True)):
        assert tsched.tile_bytes_model(kind, 4096, splits, rb, S, L, lazy) == \
            jsched.tile_bytes_model(kind, 4096, splits, rb, S, L, lazy)


def test_cycle_model_matches_reference():
    for n in (8, 16, 64, 256, 1024):
        assert tsched.bpp_cycles(n) == jsched.bpp_cycles(n)
        for pipe, shuffle in ((0, False), (7, True)):
            assert tsched.latency_cycles(n, pipe, shuffle) == jsched.latency_cycles(n, pipe, shuffle)
            assert tsched.total_cycles(n, 5, pipe, shuffle) == jsched.total_cycles(n, 5, pipe,
                                                                                   shuffle)
        for s in range(n.bit_length() - 1):
            assert np.array_equal(tsched.ntt_folding_order(n, s), jsched.ntt_folding_order(n, s))
            assert np.array_equal(tsched.intt_folding_order(n, s), jsched.intt_folding_order(n, s))
        for brv in (True, False):
            got, want = tsched.simulate_cascade(n, brv), jsched.simulate_cascade(n, brv)
            assert (got.n, got.max_buffer_pairs, got.added_latency) == (
                want.n, want.max_buffer_pairs, want.added_latency)
        # the paper's claim: no buffer with the bit-reversed folding set, n/4 without
        assert tsched.simulate_cascade(n).max_buffer_pairs == 0


# --------------------------------------------------------------------------
# plan(schedule=, tiling=), plan_key, and the datapaths under a schedule
# --------------------------------------------------------------------------

REFUSALS = [
    (dict(n=4096, schedule="bogus"), "UnknownKnobError", "schedule"),
    (dict(n=4096, schedule="four_step:h"), "UnservableConfigError", "schedule"),
    (dict(n=8192, tiling=((64, 128),)), "UnservableConfigError", "tiling"),
    (dict(n=8192, schedule="radix2", tiling=((64, 128), (8, 8))), "UnservableConfigError", "tiling"),
]


@pytest.mark.parametrize("kw,error,knob", REFUSALS)
def test_plan_refuses_as_the_reference_does(kw, error, knob):
    with pytest.raises(JPlanError) as want:
        repro.plan(t=3, v=30, **kw)
    with pytest.raises(repro_torch.PlanError) as got:
        repro_torch.plan(t=3, v=30, device="cpu", **kw)
    assert type(want.value).__name__ == type(got.value).__name__ == error
    assert got.value.knob == want.value.knob == knob


def test_plan_resolves_schedule_and_tiling_into_plan_key():
    for n, string, tiling in ((64, "auto", None), (4096, "auto", ((32, 128),)),
                              (8192, "four_step:h", ((64, 128), (8, 8))), (8192, "radix2", ())):
        want = repro.plan(n, 3, 30, schedule=string, tiling=tiling).config.schedule
        for backend in ("torch", "cuda", "cuda_fused"):
            pl = repro_torch.plan(n, 3, 30, schedule=string, tiling=tiling, backend=backend,
                                  device="cpu")
            assert _spec_key(pl.config.schedule) == _spec_key(want)
            assert repro_torch.plan_key(pl).schedule == pl.config.schedule
    radix = repro_torch.plan(8192, 3, 30, schedule="radix2", device="cpu")
    hier = repro_torch.plan(8192, 3, 30, schedule="four_step:h", device="cpu")
    assert repro_torch.plan_key(radix) != repro_torch.plan_key(hier)
    assert hier.config == repro_torch.plan(8192, 3, 30, schedule="four_step", device="cpu").config
    # an integer tiling is the reference's TPU row-block request, not ported
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(8192, 3, 30, tiling=4, device="cpu")
    assert err.value.knob == "tiling"
    # plan_from_params honours params.schedule
    params = tparams.make_params(8192, 3, 30, device="cpu").with_schedule("radix2")
    assert repro_torch.plan_from_params(params).config.schedule.kind == "radix2"
    with pytest.raises(repro_torch.UnknownKnobError):
        params.with_schedule("bogus")


def test_plan_records_the_cards_accounting():
    """The spec records the kernel of each backend's main path: one-block
    K3/K4, K1 and K2 while a CTA holds the polynomial, multi-block past it,
    up to n = 65536; n = 131072 is refused (knob n), an explicit e2e
    backend past K2-fs's reach (t = 49, seven slots of two tiles a CTA)
    too (knob t), and auto takes cuda_fused past t = 8 beyond K2."""
    for n, t, backend, multi in ((32768, 2, "cuda", False), (65536, 2, "cuda", True),
                                 (16384, 2, "cuda_fused", False), (32768, 2, "cuda_fused", True),
                                 (65536, 2, "cuda_fused", True), (16384, 6, "cuda_fused_e2e", False),
                                 (32768, 2, "cuda_fused_e2e", True)):
        spec = repro_torch.plan(n, t, 30, backend=backend, device="cpu").config.schedule
        assert spec.multi_block == multi and spec.smem_budget == tkern.MAX_SMEM_BYTES
        assert 0 < spec.smem_bytes <= spec.smem_budget
        assert spec.card_split == (tkern.fs_split(n) if multi else ())
    assert tkern.fs_split(65536) == (256, 256) and tkern.fs_split(32768) == (128, 256)
    for n, t, backend, knob in ((131072, 6, "cuda", "n"), (131072, 6, "cuda_fused", "n"),
                                (131072, 6, "cuda_fused_e2e", "n"), (32768, 49, "cuda_fused_e2e", "t")):
        with pytest.raises(repro_torch.UnservableConfigError) as err:
            repro_torch.plan(n, t, 30, backend=backend, device="cpu")
        assert err.value.knob == knob
    # auto on a card: the e2e kernels where they hold (n, t), the fused cascade past them
    assert tops.resolve_backend("auto", torch.device("cuda"), 65536, 6, 30) == "cuda_fused_e2e"
    assert tops.resolve_backend("auto", torch.device("cuda"), 32768, 6, 30) == "cuda_fused_e2e"
    assert tops.resolve_backend("auto", torch.device("cuda"), 32768, 9, 30) == "cuda_fused"
    assert tops.resolve_backend("auto", torch.device("cuda"), 16384, 6, 30) == "cuda_fused_e2e"
    assert tops.resolve_backend("auto", torch.device("cpu"), 65536, 6, 30) == "torch"
    assert repro_torch.plan(131072, 1, 30, backend="torch", device="cpu").config.n == 131072


def test_e2e_backend_serves_past_one_cta():
    """auto on a card resolves to cuda_fused_e2e at n = 32768 and 65536
    for every t <= 8 (K2-fs, the multi-block e2e kernel) and to cuda_fused
    at t = 9, as before K2-fs served t > 8; an explicit cuda_fused_e2e plan
    there records the multi-block kernel with the card's split and K2-fs's
    shared memory at the plan's S and L, also at t = 9 and 15 (two
    channels on some CTAs of a cluster of 8), and is refused at t = 49
    (knob t), where seven slots of two tiles exceed a CTA."""
    cuda = torch.device("cuda")
    for n, split in ((32768, (128, 256)), (65536, (256, 256))):
        for t in range(1, 9):
            assert tops.resolve_backend("auto", cuda, n, t, 30) == "cuda_fused_e2e"
            assert tkern.e2e_fs_fits(n, t, t, t + 1) and not tkern.e2e_fits(n, t, t, t + 1)
        assert tops.resolve_backend("auto", cuda, n, 9, 30) == "cuda_fused"
        for t in (1, 6, 8, 9, 15):
            pl = repro_torch.plan(n, t, 30, backend="cuda_fused_e2e", device="cpu")
            spec = pl.config.schedule
            assert pl.config.backend == "cuda_fused_e2e" and spec.multi_block
            assert spec.card_split == split == tkern.fs_split(n)
            assert spec.smem_bytes == tkern.e2e_fs_smem_bytes(
                n, t, pl.config.seg_count, pl.config.L) <= spec.smem_budget
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(32768, 49, 30, backend="cuda_fused_e2e", device="cpu")
    assert (err.value.knob, err.value.value) == ("t", 49)
    assert "backend='cuda_fused'" in err.value.alternatives
    assert tkern.e2e_fs_fits(65536, 48, 48, 52) and not tkern.e2e_fs_fits(65536, 49, 49, 53)
    assert not tkern.e2e_fs_fits(8, 3, 3, 4)


def test_four_step_h_datapaths_match_reference_jnp():
    """polymul and negacyclic_mul at n = 8192 under four_step:h on the CPU
    (torch, and the kernel backends' plain versions) equal repro's jnp."""
    n, t, v = 8192, 3, 30
    jpl = repro.plan(n, t, v, backend="jnp", schedule="four_step:h")
    assert jpl.config.schedule.depth == 2
    rng = np.random.default_rng(SEED)
    S = jpl.config.seg_count
    za = rng.integers(0, 1 << v, size=(2, n, S), dtype=np.int64)
    zb = rng.integers(0, 1 << v, size=(2, n, S), dtype=np.int64)
    za[..., -1] = zb[..., -1] = 0
    want = np.asarray(jax.jit(repro.polymul)(jpl, za, zb))
    ra = _residues(jpl.params.qs, (2, n), SEED + 1)
    rb = _residues(jpl.params.qs, (2, n), SEED + 2)
    want_r = np.asarray(jax.jit(repro.negacyclic_mul)(jpl, ra, rb))
    for backend in ("torch", "cuda", "cuda_fused"):
        pl = repro_torch.plan(n, t, v, backend=backend, schedule="four_step:h", device="cpu")
        got = repro_torch.polymul(pl, torch.as_tensor(za), torch.as_tensor(zb))
        assert np.array_equal(got.numpy(), want), backend
        got = repro_torch.negacyclic_mul(pl, torch.as_tensor(ra), torch.as_tensor(rb))
        assert np.array_equal(got.numpy(), want_r), backend


def test_convert_carries_the_four_step_tables():
    n = 8192
    jp = jparams.make_params(n, 3, 30)
    ct = jp.tables
    arrays = {name: getattr(ct, name) for name in (
        "qs", "fwd", "inv", "half", "mul_eps", "fwd_shoup", "inv_shoup", "fs_row_fwd",
        "fs_row_inv", "fs_row_fwd_shoup", "fs_row_inv_shoup", "fs_sub_fwd", "fs_sub_inv",
        "fs_sub_fwd_shoup", "fs_sub_inv_shoup")}
    from repro.kernels.crt import plan_dec_arrays

    arrays.update(plan_dec_arrays(jp.plan))
    for name in ("qi_tilde", "qi_star_limbs", "q_limbs"):
        arrays[name] = getattr(jp.plan, name)
    tables, _ = convert.tables_from_reference(arrays)
    own = tparams.make_params(n, 3, 30).tables
    for name in ("fs_row_fwd", "fs_row_inv", "fs_row_fwd_shoup", "fs_row_inv_shoup"):
        assert np.array_equal(getattr(tables, name), getattr(own, name)), name
    for name in ("fs_sub_fwd", "fs_sub_inv", "fs_sub_fwd_shoup", "fs_sub_inv_shoup"):
        got, want = getattr(tables, name), getattr(own, name)
        assert len(got) == len(want) == 1 and all(np.array_equal(g, w) for g, w in zip(got, want))
    # without the four-step keys the same tables are gathered from fwd / inv
    bare = {k: x for k, x in arrays.items() if not k.startswith("fs_")}
    gathered, _ = convert.tables_from_reference(bare)
    assert np.array_equal(gathered.fs_row_inv_shoup, own.fs_row_inv_shoup)


# --------------------------------------------------------------------------
# the 32-bit SAU Barrett window of n >= 32768 at t = 6
# --------------------------------------------------------------------------


def test_wide_sau_window_decomposes_exactly():
    """At n = 32768, t = 6, v = 30 the default primes' SAU words need a
    32-bit Barrett window, past the reference's 31 (its decompose circuits
    are None there); the port's are exact: compose(decompose(z)) == z on
    every backend's plain path, and barrett_reduce equals Python ints."""
    n, t, v = 32768, 6, 30
    assert jparams.make_params(n, t, v).plan.dec is None
    pl = repro_torch.plan(n, t, v, backend="cuda", device="cpu")
    assert max(c.sau_barrett[2] for c in pl.params.plan.dec) == 32
    rng = np.random.default_rng(SEED)
    q = pl.q
    ints = [0, q - 1] + [int.from_bytes(rng.bytes(24), "little") % q for _ in range(62)]
    z = torch.as_tensor(tbigint.ints_to_limbs(ints, v, pl.config.seg_count))
    for backend in ("torch", "cuda"):
        bpl = repro_torch.plan(n, t, v, backend=backend, device="cpu")
        res = repro_torch.decompose(bpl, z)
        assert [[int(x) for x in row] for row in res.tolist()] == [
            [x % int(qi) for x in ints] for qi in pl.params.qs]
        assert repro_torch.from_limbs(bpl, repro_torch.compose(bpl, res)) == ints
    qi = int(pl.params.qs[0])
    eps, s1, s2 = tmod.barrett_constants(qi, 61, 30)
    x = rng.integers(0, 1 << 61, size=4096, dtype=np.int64)
    x[:2] = (1 << 61) - 1, 0
    got = tmod.barrett_reduce(torch.as_tensor(x), qi, eps, s1, s2)
    assert got.tolist() == [int(xi) % qi for xi in x]
