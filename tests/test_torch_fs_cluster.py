"""The port's multi-block cascade as one cluster launch (K1-fs,
``csrc/fused_polymul_fs.cu``; ``csrc/parentt.cuh`` cluster_cascade) and
the multi-block e2e multiplier as three streaming launches (K2-fs,
``csrc/fused_e2e_polymul_fs.cu``), emulated on the CPU in the 32-bit
arithmetic of ``tests/test_torch_kernel_arith.py`` and held bit for bit
against their plain versions and the JAX reference.

The kernels run only on the card (``tests/test_torch_cuda.py``).  Here:
the two DSMEM transposes of the cluster as index maps (each moves every
element exactly once), the cluster's geometry and K2-fs's shared-memory
model, the cascade phase by phase at both cluster sizes, K2-fs's three
launches one at a time, and the rule ``backend="auto"`` follows past one
CTA.

    python -m pytest -q tests/test_torch_fs_cluster.py
"""
import jax
import numpy as np
import pytest
import torch

import repro
from repro_torch.core import bigint as tbigint
from repro_torch.core.params import make_params
from repro_torch.kernels import crt as tcrt
from repro_torch.kernels import ntt as tkern
from repro_torch.kernels import ops as tops

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_kernel_arith import (
    _segments,
    compose_quotient_emulated,
    decompose_emulated,
    fs_emulated,
    passes_emulated,
)

SEED = 22
T = torch.as_tensor


def cluster_maps(n: int, cluster: int):
    """The cluster cascade's index maps at n for ``cluster`` CTAs (E = n / C
    elements an operand a CTA, Cc = n2 / C columns a column block):
    ``colmap[k, v]``, the element x of CTA k's column-block word v
    (ColMap); ``to_rows[k, v]``, where the last column pass stores it
    (owner CTA, word of its row block: PeerRows); ``to_cols[k, i]``, where
    the last inverse row pass stores element x = k E + i of CTA k's row
    block (owner CTA, word of its column block: PeerCols)."""
    n1, n2 = tkern.fs_split(n)
    E, cc = n // cluster, n2 // cluster
    v = np.arange(E)
    ks = np.arange(cluster)[:, None]
    colmap = (v // cc) * n2 + ks * cc + v % cc
    to_rows = np.stack([colmap // E, colmap % E], axis=-1)
    x = ks * E + v
    col = x % n2
    to_cols = np.stack([col // cc, (x // n2) * cc + col % cc], axis=-1)
    return colmap, to_rows, to_cols


def cluster_sizes(n: int) -> tuple[int, ...]:
    """The cluster sizes the cascade may launch with at n: min(8, n1), and
    16 where n1 holds it."""
    n1 = tkern.fs_split(n)[0]
    return (min(8, n1),) + ((16,) if n1 >= 16 else ())


def test_cluster_transposes_move_every_element_once():
    """At n = 16 ... 65536 and each cluster size: the first transpose
    (PeerRows) and the second (PeerCols) are bijections onto the peers'
    buffers, each CTA sends E / C words to every peer in runs of Cc
    contiguous words of one row, and the second undoes the first (it lands
    element x where ColMap reads it)."""
    for log_n in range(4, 17):
        n = 1 << log_n
        n1, n2 = tkern.fs_split(n)
        for cluster in cluster_sizes(n):
            E, cc = n // cluster, n2 // cluster
            colmap, to_rows, to_cols = cluster_maps(n, cluster)
            assert np.array_equal(np.sort(colmap.ravel()), np.arange(n))
            for dest in (to_rows, to_cols):
                flat = dest[..., 0] * E + dest[..., 1]
                assert np.array_equal(np.sort(flat.ravel()), np.arange(n))  # each word once
                for k in range(cluster):  # E / C words from each CTA to each peer
                    assert np.array_equal(np.bincount(dest[k, :, 0], minlength=cluster),
                                          np.full(cluster, E // cluster))
            # a row block holds whole rows; the words a CTA sends one peer
            # come in runs of Cc contiguous words
            assert E % n2 == 0
            runs = to_rows[..., 1].reshape(cluster, -1, cc)
            assert (np.diff(runs, axis=-1) == 1).all()
            assert (to_rows[..., 0].reshape(cluster, -1, cc) == to_rows[:, ::cc, None, 0]).all()
            # the second transpose sends element x back to the word ColMap reads it from
            back = colmap[to_cols[..., 0], to_cols[..., 1]]
            assert np.array_equal(back, np.arange(cluster)[:, None] * E + np.arange(E))


def test_cluster_geometry_and_e2e_admission():
    """The cluster's size, threads and shared memory (three padded buffers
    of n / C words) as the kernels derive them, and K2-fs's shared-memory
    model: a decompose CTA of two TR-coefficient tiles beside the circuits
    (TR x G threads: dec_groups), the cascade's CTA (K1's where it holds a
    pair, else the cluster's), K6's compose CTA; none but the tables grows
    with t, so K2-fs serves wherever K5 and K6 do at n >= 16."""
    assert [tkern.fs_cluster(1 << k) for k in range(2, 17)] == [
        2, 2, 4, 4, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 16]
    for n, smem, threads in ((32768, 52224, 256), (65536, 52224, 256), (16384, 26112, 128)):
        assert tkern.cascade_fs_smem_bytes(n) == smem
        assert tkern.cascade_fs_threads(n) == threads
    assert tkern.cascade_fs_smem_bytes(65536, 8) == 104448
    assert [tkern.dec_groups(t) for t in (1, 3, 6, 8, 15, 30, 48, 169)] == [
        1, 1, 2, 3, 5, 8, 8, 8]
    for n, t in ((16, 3), (4096, 6), (32768, 6), (65536, 6), (32768, 15), (16384, 30),
                 (4096, 49), (4096, 169)):
        cfg = make_params(n, t, 30).plan
        S, L = cfg.seg_count, cfg.L
        (dec, cascade, compose), tr, rows = tkern.e2e_fs_geom(n, t, S, L)
        groups = tkern.dec_groups(t)
        assert 1 <= tr <= tkern.E2E_FS_DEC_THREADS // groups
        assert dec == tcrt.decompose_table_bytes(t) + 2 * tr * S * 8 <= tcrt.MAX_SMEM_BYTES
        assert cascade == (tkern.cascade_smem_bytes(n) if tkern.cascade_fits(n)
                           else tkern.cascade_fs_smem_bytes(n))
        assert (compose, rows) == (tcrt.compose_smem_bytes(t, L), tcrt.compose_rows(t, L))
        assert tkern.e2e_fs_fits(n, t, S, L) == (tcrt.decompose_fits(t, S)
                                                 and tcrt.compose_fits(t, L))
    assert not tkern.e2e_fs_fits(8, 3, 3, 4)


# the cascade at the small n of the correctness edges (clusters of 4 and
# 8) and past one CTA (n = 32768 and 65536) at both cluster sizes, in the
# three regimes
CASCADE_POINTS = [(16, 29), (1024, 30), (32768, 31), (65536, 30)]


@pytest.mark.parametrize("n,v", CASCADE_POINTS)
def test_cluster_cascade_matches_plain_versions(n, v):
    """K1-fs phase by phase (its column blocks, the first transpose, the
    row blocks around the product, the second transpose, the inverse column
    blocks; 32-bit lazy words between the phases) at each cluster size
    equals fused_polymul_fs_ref and the radix-2 plain version, with 0 and
    q - 1 among the inputs; at n = 1024 also the reference's
    negacyclic_mul on jnp."""
    p = make_params(n, 2, v)
    rng = np.random.default_rng(SEED + n + v)
    qs = p.qs[:, None, None]
    a = rng.integers(0, 1 << 62, size=(2, 1, n), dtype=np.int64) % qs
    b = rng.integers(0, 1 << 62, size=(2, 1, n), dtype=np.int64) % qs
    a[:, 0, :2] = qs[:, 0] - 1
    b[:, 0, -2:] = 0
    want = tkern.fused_polymul_fs_ref(T(a), T(b), p.tables).numpy()
    assert np.array_equal(want, tkern.fused_polymul_ref(T(a), T(b), p.tables).numpy())
    for cluster in cluster_sizes(n):
        assert np.array_equal(fs_emulated(a, b, p.tables, "cascade", cluster=cluster), want)
    if n == 1024:
        jpl = repro.plan(n, 2, v, backend="jnp")
        assert np.array_equal(np.asarray(jax.jit(repro.negacyclic_mul)(jpl, a, b)), want)


# K2-fs past one CTA (its cascade a cluster), at t = 3 where the
# reference's SAU window holds n = 32768 (in two regimes) and at the
# paper's t = 6 at n = 65536 (the reference refuses it there)
E2E_POINTS = [(32768, 3, 29), (32768, 3, 30), (65536, 6, 30)]


@pytest.mark.parametrize("n,t,v", E2E_POINTS)
def test_e2e_launches_match_plain_versions_and_reference(n, t, v):
    """K2-fs's three launches one at a time, each emulated and equal to its
    plain counterpart on the same inputs (e2e_fs_decompose_ref: 32-bit
    canonical residues; e2e_fs_cascade_ref: y = p q~ mod q, the cascade at
    both cluster sizes; e2e_fs_compose_ref: the limbs), and end to end
    equal to fused_e2e_polymul_fs_ref and, at t = 3, the reference's
    polymul on jnp; the launches' plain counterparts chained equal the
    wrapper on CPU tensors."""
    p = make_params(n, t, v)
    plan = p.plan
    rng = np.random.default_rng(SEED + n + t + v)
    za, zb = _segments(plan, (1, n), rng), _segments(plan, (1, n), rng)
    za[0, 0] = zb[0, 1] = 0
    za[0, 2] = zb[0, 2] = tbigint.ints_to_limbs([plan.q - 1], v, plan.seg_count)[0]
    ra, rb = tkern.e2e_fs_decompose_ref(T(za), T(zb), plan)
    assert ra.dtype == torch.int32
    narrow = tcrt.narrow_moduli(plan)
    for z, r in ((za, ra), (zb, rb)):
        got = decompose_emulated(z.reshape(-1, plan.seg_count), plan, narrow)
        assert np.array_equal(got.reshape(t, 1, n), r.numpy())
    y = tkern.e2e_fs_cascade_ref(ra, rb, p.tables, plan)
    for cluster in cluster_sizes(n):
        got = fs_emulated(ra.numpy(), rb.numpy(), p.tables, "cascade", e2e=plan, cluster=cluster)
        assert np.array_equal(got, y.numpy())
    limbs = tkern.e2e_fs_compose_ref(y, plan)
    assert np.array_equal(compose_quotient_emulated(y.reshape(t, -1).numpy(), plan),
                          limbs.reshape(n, plan.L).numpy())
    want = tkern.fused_e2e_polymul_fs_ref(T(za), T(zb), p.tables, plan)
    assert torch.equal(limbs, want)
    assert np.array_equal(fs_emulated(None, None, p.tables, "e2e", (za, zb, plan)), want.numpy())
    chained = tkern.e2e_fs_compose_cuda(tkern.e2e_fs_cascade_cuda(
        *tkern.e2e_fs_decompose_cuda(T(za), T(zb), p.tables, plan), p.tables, plan), plan)
    assert torch.equal(chained, tkern.fused_e2e_polymul_fs_cuda(T(za), T(zb), p.tables, plan))
    if t == 3:
        ref = np.asarray(repro.execute(repro.plan(n, t, v, backend="jnp"), za, zb))
        assert np.array_equal(want.numpy(), ref)


def test_e2e_launches_at_one_cta_pair_match_k2():
    """Where one CTA holds a channel's pair (n = 256, 4096), K2-fs's cascade
    launch is K1's register passes with the y store: emulated, it equals
    e2e_fs_cascade_ref, and K2-fs's limbs equal K2's plain version."""
    for n, t, v in ((256, 6, 29), (4096, 6, 31)):
        p = make_params(n, t, v)
        rng = np.random.default_rng(SEED + n)
        za, zb = _segments(p.plan, (1, n), rng), _segments(p.plan, (1, n), rng)
        ra, rb = tkern.e2e_fs_decompose_ref(T(za), T(zb), p.plan)
        y = tkern.e2e_fs_cascade_ref(ra, rb, p.tables, p.plan)
        got = passes_emulated(ra.numpy().astype(np.int64), rb.numpy().astype(np.int64), p.tables,
                              "e2e", p.plan.qi_tilde)
        assert np.array_equal(got, y.numpy())
        assert torch.equal(tkern.fused_e2e_polymul_fs_ref(T(za), T(zb), p.tables, p.plan),
                           tkern.fused_e2e_polymul_ref(T(za), T(zb), p.tables, p.plan))


def test_auto_past_one_cta_follows_the_measured_walls():
    """backend="auto" on a card at the points whose polymul walls decided it
    (v = 30; chip_smoke's FS_MAIN, WIDE_POINTS and AUTO_EDGES):
    cuda_fused where K2-fs's wall was the longer, at W1 = (32768, 15),
    (16384, 9) and (8192, 25), or where the t = 6 walls spread across
    equal (65536, 6), (32768, 6), or where the two runs disagreed below
    t = 29 (16384, 16); cuda_fused_e2e (one K2-fs call) from t = 29, where
    it was the shorter: W2 = (16384, 30) and every point up to the largest
    t at each n, on K1's one-CTA body and on K1-fs's cluster alike."""
    cuda = torch.device("cuda")
    fused = [(65536, 6), (32768, 6), (32768, 15), (16384, 9), (16384, 16), (8192, 25)]
    e2e = [(16384, 30), (16384, 29), (16384, 48), (16384, 110), (8192, 30), (8192, 139),
           (4096, 49), (4096, 169), (2048, 109), (2048, 208), (32768, 30), (32768, 85),
           (65536, 30), (65536, 63)]
    for points, backend in ((fused, "cuda_fused"), (e2e, "cuda_fused_e2e")):
        for n, t in points:
            assert tops.resolve_backend("auto", cuda, n, t, 30) == backend, (n, t)
