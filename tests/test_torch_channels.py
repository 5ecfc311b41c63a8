"""The port's kernel backends over the reference's whole channel range:
``cuda``, ``cuda_fused`` and ``cuda_fused_e2e`` past 16 segments, 16
limbs and 15 channels (their plain versions, on the CPU) against the
reference and a Python-int schoolbook, admission against the
reference's Pallas backends, the auto rule, and ``plan()``'s
``row_blk``, ``channel_grid``, ``use_sau`` and ``tuning`` keywords.
Every comparison is exact int64 equality.  The file keeps fewer tests
than the reference's tests/test_sharding.py (13), so a test run that
hands files out by test count starts that one first.

At these t the reference's Pallas decompose and compose take 4-34 s a
call in interpret mode and its whole polymul 12-78 s (jitted or not),
so the multiplier is held against the Python-int schoolbook product
(which the reference's ``pallas`` polymul equals), the residue-domain
product against the reference's Pallas cascade in interpret mode, the
decompose against the reference's SAU decompose and the compose against
the exact CRT of the residues.

    python -m pytest -q tests/test_torch_channels.py
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro
import repro.tune
from repro.core import rns as jrns

import repro_torch
import repro_torch.tune
from repro_torch import api as tapi
from repro_torch.core import bigint as tbigint
from repro_torch.core import polymul as tpm
from repro_torch.core.params import make_params
from repro_torch.kernels import ntt as tkern
from repro_torch.kernels import ops as tops

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N, V = 64, 30
# past 16 segments or limbs: (S, L) = (15, 17), (16, 18), (20, 22), (30, 33)
WIDE_T = (15, 16, 20, 30)
KERNEL_BACKENDS = ("cuda", "cuda_fused", "cuda_fused_e2e")


def _operands(t: int, seed: int):
    """Two rows of segments (2, N, S): a seeded row of coefficients below
    q, and the corner whose every coefficient is q - 1; with the rows'
    integers."""
    params = make_params(N, t, V, device="cpu")
    q, S = params.q, params.plan.seg_count
    rng = np.random.default_rng(seed)
    a = [[int.from_bytes(rng.bytes(S * 4), "little") % q for _ in range(N)], [q - 1] * N]
    b = [[int.from_bytes(rng.bytes(S * 4), "little") % q for _ in range(N)], [q - 1] * N]
    za = np.stack([tbigint.ints_to_limbs(x, V, S) for x in a])
    zb = np.stack([tbigint.ints_to_limbs(x, V, S) for x in b])
    return params, za, zb, a, b


_negacyclic_jit = jax.jit(repro.negacyclic_mul)  # a Plan is a pytree argument


@pytest.fixture(scope="module")
def reference():
    """Per t: the operands and their schoolbook products, seeded canonical
    residues with the reference's Pallas cascade of them (interpret mode,
    about a second a call), and the reference's SAU decompose of the
    operands."""
    out = {}
    for t in WIDE_T:
        params, za, zb, a, b = _operands(t, seed=t)
        qs = params.qs[:, None, None]
        rng = np.random.default_rng(100 + t)
        ra = rng.integers(0, 1 << 62, size=(t, 2, N), dtype=np.int64) % qs
        rb = rng.integers(0, 1 << 62, size=(t, 2, N), dtype=np.int64) % qs
        ra[:, 1] = rb[:, 1] = qs[:, 0] - 1
        jpl = repro.plan(N, t, V, backend="pallas")
        out[t] = dict(
            za=za, zb=zb, ra=ra, rb=rb,
            prod=[tpm.schoolbook_negacyclic(x, y, params.q) for x, y in zip(a, b)],
            neg=np.asarray(_negacyclic_jit(jpl, ra, rb)),
            dec=np.asarray(jrns.decompose_sau(za, jpl.params.plan)),
        )
    return out


@pytest.mark.parametrize("t", WIDE_T)
def test_kernel_backends_past_16_channels_match_reference(reference, t):
    """Explicit cuda, cuda_fused and cuda_fused_e2e plans at (64, t, 30)
    on the CPU (the kernels' plain versions): polymul equals the
    Python-int schoolbook on a seeded row and on the q - 1 corner, where
    one int64 limb sum of the old kernels' 15 channels no longer held;
    negacyclic_mul equals the reference's Pallas cascade, decompose the
    reference's SAU decompose, and compose the exact CRT of q - 1
    residues and seeded ones."""
    rec = reference[t]
    T = torch.as_tensor
    for backend in KERNEL_BACKENDS:
        pl = repro_torch.plan(N, t, V, backend=backend, device="cpu")
        assert pl.config.backend == backend and (pl.config.seg_count > 14 or pl.config.L > 16)
        got = repro_torch.polymul(pl, T(rec["za"]), T(rec["zb"]))
        assert [repro_torch.from_limbs(pl, row) for row in got] == rec["prod"], backend
        assert np.array_equal(repro_torch.negacyclic_mul(pl, T(rec["ra"]), T(rec["rb"])).numpy(),
                              rec["neg"])
        assert np.array_equal(repro_torch.decompose(pl, T(rec["za"])).numpy(), rec["dec"])
        limbs = repro_torch.compose(pl, T(rec["ra"]))
        qs = [int(q) for q in pl.params.qs]
        for i in range(2):
            crt = sum(int(r) * pow(pl.q // q, -1, q) % q * (pl.q // q)
                      for r, q in zip(rec["ra"][:, i, 0], qs)) % pl.q
            assert repro_torch.from_limbs(pl, limbs[i, :1]) == [crt]


@pytest.mark.parametrize("n", (64, 4096))
def test_port_admits_every_t_the_reference_pallas_backends_admit(n):
    """Plan building only, t = 1 ... 40 at v = 30: wherever the reference
    builds a ``pallas`` plan the port builds ``cuda``, ``cuda_fused`` and
    ``cuda_fused_e2e`` plans on the same params (the three Pallas backends
    share their admission at the int64 width; checked at t = 1, 20, 40),
    each recording the kernel that serves it within one CTA's shared
    memory."""
    for t in range(1, 41):
        try:
            repro.plan(n, t, V, backend="pallas")
        except repro.PlanError:
            continue
        if t in (1, 20, 40):
            for jb in ("pallas_fused", "pallas_fused_e2e"):
                repro.plan(n, t, V, backend=jb)
        params = make_params(n, t, V, device="cpu")
        for backend in KERNEL_BACKENDS:
            spec = repro_torch.plan_from_params(params, backend=backend).config.schedule
            assert 0 < spec.smem_bytes <= spec.smem_budget, (n, t, backend)


def test_wide_points_build_multi_block_e2e_plans():
    """The slice's chip points on the CPU: W1 = (32768, 15, 30) and
    W2 = (16384, 30, 30) build K2-fs plans on cuda_fused_e2e (past K2's two
    and four channels a CTA), and beside them cuda_fused and cuda; auto on
    a card takes cuda_fused at W1 and cuda_fused_e2e at W2, as the walls
    decided (PERF.md §5)."""
    cuda = torch.device("cuda")
    for n, t, slots in ((32768, 15, 2), (16384, 30, 4)):
        params = make_params(n, t, V, device="cpu")
        S, L = params.plan.seg_count, params.plan.L
        assert tkern.e2e_cluster(t) == (8, slots)
        assert tkern.e2e_fs_fits(n, t, S, L) and not tkern.e2e_fits(n, t, S, L)
        pl = repro_torch.plan_from_params(params, backend="cuda_fused_e2e")
        assert pl.config.schedule.multi_block
        assert pl.config.schedule.smem_bytes == tkern.e2e_fs_smem_bytes(n, t, S, L)
        for backend in ("cuda", "cuda_fused"):
            assert repro_torch.plan_from_params(params, backend=backend).config.backend == backend
        want = "cuda_fused_e2e" if n == 16384 else "cuda_fused"
        assert tops.resolve_backend("auto", cuda, n, t, V) == want


# auto's reach at v = 30 on a card: cuda_fused_e2e at t <= this (14 up to
# n = 8192), cuda_fused past it.  That is where K2 served auto with S and L
# <= 16 before the e2e kernels took more (t = 15 has L = 17 there); past
# one CTA (n >= 32768) auto takes cuda_fused at every t, since the walls
# showed K2-fs on K1-fs's cluster slower there (at t = 6 and 15).
AUTO_E2E_T = {16384: 8, 32768: 0, 65536: 0}
# and K2-fs where K2 does not hold the plan (n >= 8192 at these t), from
# t = 29: chip_smoke's [auto] walls showed it faster there
AUTO_E2E_FS_T = 29


def test_auto_resolves_as_before():
    cuda = torch.device("cuda")
    for log_n in range(2, 17):
        n = 1 << log_n
        edge = AUTO_E2E_T.get(n, 14)
        for t in (1, 8, 9, 14, 15, 28, 29, 30, 31):
            k2fs = t >= AUTO_E2E_FS_T and n >= 8192  # past K2 (K2 holds t <= 31 below 8192)
            want = "cuda_fused_e2e" if t <= edge or k2fs else "cuda_fused"
            assert tops.resolve_backend("auto", cuda, n, t, V) == want, (n, t)
    assert tops.auto_backend(4096, 14, 16, 16) == "cuda_fused_e2e"
    for n, t, S, L in ((4096, 14, 14, 17), (4096, 14, 17, 16), (16384, 9, 9, 10),
                       (32768, 15, 15, 16), (65536, 6, 6, 7), (16384, 28, 28, 30),
                       (65536, 28, 28, 30)):
        assert tops.auto_backend(n, t, S, L) == "cuda_fused", (n, t, S, L)
        assert tkern.e2e_serves(n, t, S, L)
    for n, t, S, L in ((16384, 29, 29, 31), (16384, 30, 30, 32), (65536, 29, 29, 31)):
        assert tops.auto_backend(n, t, S, L) == "cuda_fused_e2e", (n, t, S, L)


def test_auto_steps_back_where_the_card_holds_no_e2e_cluster(monkeypatch):
    """Where the card cannot hold one e2e cluster at once, an explicit
    cuda_fused_e2e plan is refused at plan time (knob t, naming the
    backends that serve) and auto takes cuda_fused."""
    params = make_params(4096, 6, V, device="cpu")
    cuda = torch.device("cuda")
    admit = lambda backend, **kw: tapi._admit(backend, 4096, 6, V, cuda, params=params, **kw)
    monkeypatch.setattr(tkern, "e2e_clusters_resident", lambda tables, plan: 1)
    assert admit("cuda_fused_e2e", auto=True)[0] == "cuda_fused_e2e"
    monkeypatch.setattr(tkern, "e2e_clusters_resident", lambda tables, plan: 0)
    assert admit("cuda_fused_e2e", auto=True)[0] == "cuda_fused"
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        admit("cuda_fused_e2e")
    assert err.value.knob == "t"
    assert err.value.alternatives == ("backend='cuda'", "backend='cuda_fused'", "backend='torch'")


def test_e2e_refusal_names_the_backends_that_serve(monkeypatch):
    """Past K2's reach (n = 4096, t = 49: seven slots a CTA) cuda_fused_e2e
    runs K2-fs, whose CTAs' shared memory does not grow with t past the
    channels' tables; where the card holds none of its clusters it is
    refused at plan time, knob t, naming cuda, cuda_fused and torch, which
    serve it."""
    params = make_params(4096, 49, V, device="cpu")
    pl = repro_torch.plan_from_params(params, backend="cuda_fused_e2e")
    assert pl.config.schedule.multi_block
    monkeypatch.setattr(tkern, "e2e_clusters_resident", lambda tables, plan: 0)
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        tapi._admit("cuda_fused_e2e", 4096, 49, V, torch.device("cuda"), params=params)
    assert err.value.knob == "t" and err.value.value == 49
    assert err.value.alternatives == ("backend='cuda'", "backend='cuda_fused'", "backend='torch'")
    for backend in ("cuda", "cuda_fused"):
        assert repro_torch.plan_from_params(params, backend=backend).config.backend == backend


def test_plan_takes_the_references_four_keywords():
    """row_blk, channel_grid, use_sau and tuning: the reference's invalid
    values raise UnknownKnobError with the reference's knob, valid ones the
    card has no use for UnservableConfigError with their own knob; None /
    True channel grids, tuning='off' and 'auto' and both use_sau serve, and
    a missing table path raises TuningTableError, as in the reference."""
    plan = lambda **kw: repro_torch.plan(N, 3, V, device="cpu", **kw)
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        plan(row_blk=8)
    assert (err.value.knob, err.value.value) == ("row_blk", 8)
    for bad, knob in ((dict(row_blk=0), "row_blk"), (dict(channel_grid="yes"), "channel_grid"),
                      (dict(tuning=3), "tuning")):
        with pytest.raises(repro_torch.UnknownKnobError) as err:
            plan(**bad)
        assert err.value.knob == knob
        with pytest.raises(repro.UnknownKnobError) as jerr:
            repro.plan(N, 3, V, **bad)
        assert jerr.value.knob == knob
    with pytest.raises(repro_torch.UnknownKnobError) as err:
        plan(use_sau="no")
    assert err.value.knob == "use_sau"
    for kw, knob in ((dict(channel_grid=True), "channel_grid"),
                     (dict(channel_grid=True, backend="cuda_fused"), "channel_grid"),
                     (dict(channel_grid=False, backend="cuda_fused_e2e"), "channel_grid")):
        with pytest.raises(repro_torch.UnservableConfigError) as err:
            plan(**kw)
        assert err.value.knob == knob, kw
    with pytest.raises(repro.UnservableConfigError) as jerr:
        repro.plan(N, 3, V, channel_grid=True, backend="pallas_fused")
    assert jerr.value.knob == "channel_grid"
    # tuning serves as in the reference: "auto" reads the port's committed
    # table (degrading to the defaults), a missing path raises
    assert plan(tuning="auto").config.n == repro.plan(N, 3, V, tuning="auto").config.n
    with pytest.raises(repro_torch.tune.TuningTableError):
        plan(tuning="table.json")
    with pytest.raises(repro.tune.TuningTableError):
        repro.plan(N, 3, V, tuning="table.json")
    base = plan().config
    for kw in (dict(tuning="off"), dict(tuning=None), dict(channel_grid=None), dict(use_sau=True)):
        assert plan(**kw).config == base, kw
    e2e = plan(backend="cuda_fused_e2e").config
    assert plan(channel_grid=True, backend="cuda_fused_e2e").config == e2e
    assert plan(use_sau=False).config == dataclasses.replace(base, use_sau=False)


def test_generic_decompose_matches_reference():
    """use_sau=False runs the generic decompose on backend torch, as the
    reference's jnp does, and the kernel backends ignore it, as the
    reference's Pallas backends do: decompose and polymul equal
    ``repro`` with use_sau=False on jnp, bit for bit, through plan() and
    plan_from_params()."""
    t = 6
    params, za, zb, _, _ = _operands(t, seed=61)
    jpl = repro.plan(N, t, V, backend="jnp", use_sau=False)
    want = np.asarray(jax.jit(repro.polymul)(jpl, za, zb))
    want_r = np.asarray(jax.jit(repro.decompose)(jpl, za))
    plans = [p for backend in ("torch", "cuda", "cuda_fused_e2e") for p in (
        repro_torch.plan(N, t, V, backend=backend, use_sau=False, device="cpu"),
        repro_torch.plan_from_params(params, backend=backend, use_sau=False))]
    for pl in plans:
        assert pl.config.use_sau is False
        assert np.array_equal(repro_torch.polymul(pl, torch.as_tensor(za),
                                                  torch.as_tensor(zb)).numpy(), want)
        assert np.array_equal(repro_torch.decompose(pl, torch.as_tensor(za)).numpy(), want_r)
