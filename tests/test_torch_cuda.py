"""The PyTorch port's CUDA kernels on the card, against their plain
PyTorch versions (exact int64 equality for K1-K6, a stated float
tolerance for the attention kernel K7) and the host bigint oracle.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips on a machine without a CUDA device.  This file imports neither JAX
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import bfv, bigint, polymul as host
from repro_torch.core.params import make_params
from repro_torch.kernels import attention, crt
from repro_torch.kernels import ntt as kern

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]

# the three reduction regimes at n = 64, the paper's t = 6, and the
# paper's point at a small batch
PRESETS = [(64, 3, 29, 3), (64, 3, 30, 3), (64, 3, 31, 3), (256, 6, 30, 5), (4096, 6, 30, 2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(pl, rows, seed, device):
    cfg = pl.config
    rng = np.random.default_rng(seed)
    shape = (rows, cfg.n, cfg.seg_count)
    za = torch.as_tensor(rng.integers(0, 1 << cfg.v, size=shape), device=device)
    zb = torch.as_tensor(rng.integers(0, 1 << cfg.v, size=shape), device=device)
    qs = pl.params.qs[:, None, None]
    size = (cfg.t, rows, cfg.n)
    ra = torch.as_tensor(rng.integers(0, 1 << 62, size=size) % qs, device=device)
    rb = torch.as_tensor(rng.integers(0, 1 << 62, size=size) % qs, device=device)
    return za, zb, ra, rb


@pytest.mark.parametrize("n,t,v,rows", PRESETS)
def test_kernels_match_plain_versions(cuda_device, n, t, v, rows):
    pl = repro_torch.plan(n, t, v, device=cuda_device)
    p = pl.params
    za, zb, ra, rb = _inputs(pl, rows, seed=n + v, device=cuda_device)
    k1 = kern.fused_polymul_cuda(ra, rb, p.tables)
    torch.cuda.synchronize()
    assert torch.equal(k1, kern.fused_polymul_ref(ra, rb, p.tables))
    k2 = kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan)
    torch.cuda.synchronize()
    assert torch.equal(k2, kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan))


@pytest.mark.parametrize("n,t,v,rows", PRESETS)
def test_stage_kernels_match_plain_versions(cuda_device, n, t, v, rows):
    pl = repro_torch.plan(n, t, v, device=cuda_device)
    p = pl.params
    za, _, ra, _ = _inputs(pl, rows, seed=n + v + 1, device=cuda_device)
    z2 = za.reshape(-1, pl.config.seg_count)
    r2 = ra.reshape(t, -1)
    for got, want in (
        (kern.ntt_channels_cuda(ra, p.tables), kern.ntt_channels_ref(ra, p.tables)),
        (kern.intt_channels_cuda(ra, p.tables), kern.intt_channels_ref(ra, p.tables)),
        (crt.decompose_cuda(z2, p.plan), crt.decompose_ref(z2, p.plan)),
        (crt.compose_cuda(r2, p.plan), crt.compose_ref(r2, p.plan)),
    ):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


STAGE_WRAPPERS = (kern.fused_polymul_cuda, kern.fused_e2e_polymul_cuda, kern.ntt_channels_cuda,
                  kern.intt_channels_cuda, crt.decompose_cuda, crt.compose_cuda)


@pytest.mark.parametrize("backend,want", [
    # K1, K2, K3, K4, K5, K6 launches of one polymul call
    ("cuda", (0, 0, 2, 1, 2, 1)),
    ("cuda_fused", (1, 0, 0, 0, 2, 1)),
])
def test_staged_paths_launch_their_kernels(cuda_device, backend, want):
    pl = repro_torch.plan(256, 6, 30, backend=backend)
    za, zb, _, _ = _inputs(pl, 3, seed=2, device=pl.device)
    for w in STAGE_WRAPPERS:
        w.launches = 0
    out = repro_torch.polymul(pl, za, zb)
    torch.cuda.synchronize()
    assert tuple(w.launches for w in STAGE_WRAPPERS) == want
    e2e = repro_torch.polymul(repro_torch.plan(256, 6, 30), za, zb)
    assert torch.equal(out, e2e)


def test_main_path_launches_the_kernels(cuda_device):
    pl = repro_torch.plan(256, 6, 30)
    assert pl.config.backend == "cuda_fused_e2e" and pl.device.type == "cuda"
    za, zb, ra, rb = _inputs(pl, 3, seed=1, device=pl.device)
    kern.fused_polymul_cuda.launches = kern.fused_e2e_polymul_cuda.launches = 0
    out = repro_torch.polymul(pl, za, zb)
    prod = repro_torch.negacyclic_mul(pl, ra, rb)
    torch.cuda.synchronize()
    assert (kern.fused_polymul_cuda.launches, kern.fused_e2e_polymul_cuda.launches) == (1, 1)
    for r in range(3):
        a = bigint.limbs_to_ints(za[r].cpu().numpy(), pl.v)
        b = bigint.limbs_to_ints(zb[r].cpu().numpy(), pl.v)
        assert repro_torch.from_limbs(pl, out[r]) == host.oracle_multiply(a, b, pl.params)
    for c in range(pl.t):
        q = int(pl.params.qs[c])
        want = host.schoolbook_negacyclic(ra[c, 0].tolist(), rb[c, 0].tolist(), q)
        assert prod[c, 0].tolist() == want


# the largest (n, t) plan() serves on K2 in each regime (lazy W=4 at v=29,
# lazy W=2 at v=30, strict at v=31), with one channel a CTA (n = 16384,
# t = 8) and three (n = 8192, t = 24: up to 200 KB of shared memory a CTA,
# one CTA an SM, clusters of 8 SMs); at v = 31 the in-kernel decompose
# constants stop at t = 13 for n = 8192
E2E_CORNERS = [(16384, 8, 29), (16384, 8, 30), (16384, 8, 31),
               (8192, 24, 29), (8192, 24, 30), (8192, 13, 31)]
# K2-fs's (n, t, v) past one CTA at t <= 8 that plan() refuses on every
# kernel backend: at v = 31 the in-kernel decompose constants stop at t = 6
# for n = 32768 and t = 3 for 65536 (knob t)
E2E_FS_REFUSED = {(32768, 8, 31), (65536, 6, 31), (65536, 8, 31)}


@pytest.mark.parametrize("n,t,v", [(n, t, v) for n, t, v, _ in PRESETS]
                         + [(8192, 6, 30), (16384, 3, 30)] + E2E_CORNERS)
def test_e2e_and_decompose_kernels_at_one_and_odd_rows(cuda_device, n, t, v):
    """K2 at one row and at an odd row count, as clusters of min(t, 8)
    CTAs of which the card holds at least one; K5 at one coefficient, at
    odd counts and across tiles."""
    pl = repro_torch.plan(n, t, v, backend="cuda_fused_e2e", device=cuda_device)
    p = pl.params
    assert kern.e2e_max_active_clusters(p.tables, p.plan) >= 1
    za, zb, _, _ = _inputs(pl, 7, seed=n + t + v + 7, device=cuda_device)
    for rows in (1, 7):
        got = kern.fused_e2e_polymul_cuda(za[:rows], zb[:rows], p.tables, p.plan)
        torch.cuda.synchronize()
        assert kern.fused_e2e_polymul_cuda.cluster == min(t, 8)
        assert torch.equal(got, kern.fused_e2e_polymul_ref(za[:rows], zb[:rows], p.tables, p.plan))
    z2 = za.reshape(-1, pl.config.seg_count)
    for m in (1, 255, 257, z2.shape[0] - 1):
        got = crt.decompose_cuda(z2[:m], p.plan)
        torch.cuda.synchronize()
        assert torch.equal(got, crt.decompose_ref(z2[:m], p.plan))


def test_e2e_corners_are_the_edge_of_admission():
    """Runs without a card: each corner is admitted on K2 (one block a
    channel's slots), and one step past it in t is K2-fs's (the multi-block
    kernel takes what K2's CTA cannot) or, where the decompose constants
    stop, refused (knob t); one step past it in n is K2-fs's too, or
    refused for the same constants; K2-fs's own edge is t = 48 (six slots
    of two 4096-element tiles), t = 49 refused (knob t) naming the
    backends that serve; n = 131072 is refused (knob n)."""
    for n, t, v in E2E_CORNERS:
        pl = repro_torch.plan(n, t, v, backend="cuda_fused_e2e", device="cpu")
        assert not pl.config.schedule.multi_block
        for nn, tt in ((n, t + 1), (2 * n, t)):
            if make_params(nn, tt, v, device="cpu").plan.dec is None:
                with pytest.raises(repro_torch.UnservableConfigError) as err:
                    repro_torch.plan(nn, tt, v, backend="cuda_fused_e2e", device="cpu")
                assert err.value.knob == "t"
            else:
                pl = repro_torch.plan(nn, tt, v, backend="cuda_fused_e2e", device="cpu")
                assert pl.config.schedule.multi_block
    pl = repro_torch.plan(8192, 48, 30, backend="cuda_fused_e2e", device="cpu")
    assert pl.config.schedule.multi_block
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(8192, 49, 30, backend="cuda_fused_e2e", device="cpu")
    assert err.value.knob == "t" and "backend='cuda_fused'" in err.value.alternatives
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(131072, 8, 30, backend="cuda_fused_e2e", device="cpu")
    assert err.value.knob == "n"


@pytest.mark.parametrize("n,t,v", [(64, 3, 30), (256, 6, 30), (4096, 6, 30), (64, 9, 30)])
def test_polymul_is_one_cluster_launch(cuda_device, n, t, v):
    """An auto polymul is one K2 launch, a cluster of min(t, 8) CTAs a row
    (two channels on some CTAs at t = 9), equal to the host oracle."""
    pl = repro_torch.plan(n, t, v)
    za, zb, _, _ = _inputs(pl, 3, seed=n + t, device=pl.device)
    for w in STAGE_WRAPPERS:
        w.launches = 0
    kern.fused_e2e_polymul_cuda.cluster = 0
    out = repro_torch.polymul(pl, za, zb)
    torch.cuda.synchronize()
    assert tuple(w.launches for w in STAGE_WRAPPERS) == (0, 1, 0, 0, 0, 0)
    assert kern.fused_e2e_polymul_cuda.cluster == min(t, 8)
    a = bigint.limbs_to_ints(za[2].cpu().numpy(), pl.v)
    b = bigint.limbs_to_ints(zb[2].cpu().numpy(), pl.v)
    assert repro_torch.from_limbs(pl, out[2]) == host.oracle_multiply(a, b, pl.params)


def test_e2e_admits_n8192_and_every_plan_admitted_before():
    """Runs without a card: plan() serves n = 8192 at t = 6 on the e2e
    backend, and every (n, t) the one-block-per-row kernel fitted (8tn
    bytes, and 8n for the cascade) still fits one CTA."""
    pl = repro_torch.plan(n=8192, t=6, v=30, backend="cuda_fused_e2e", device="cpu")
    assert pl.config.backend == "cuda_fused_e2e"
    for log_n in range(2, 16):
        n = 1 << log_n
        for t in range(1, 17):
            before = max(8 * n, 8 * t * n) <= kern.MAX_SMEM_BYTES
            now = kern.e2e_fits(n, t, 16, 16)  # at most 16 segments and limbs then
            assert now or not before, (n, t)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# K1, K3 and K4 at the edges of their register passes, as chip_smoke.py's
# phase 3 checks them (its PASS_POINTS: kernel -> (backend, n values)):
# (kernel, backend, n)
SMOKE_PASS_POINTS = _chip_smoke().PASS_POINTS
PASS_POINTS = [(name, backend, n) for name, (backend, ns) in SMOKE_PASS_POINTS.items()
               for n in ns]


@pytest.mark.parametrize("v", (29, 30, 31))
@pytest.mark.parametrize("kernel,backend,n", PASS_POINTS)
def test_register_pass_kernels_match_plain_versions(cuda_device, kernel, backend, n, v):
    """K1, K3 and K4 equal their plain versions bit for bit in every
    regime at the edges of their passes, at an odd row count, and an SM
    holds at least one of their CTAs."""
    pl = repro_torch.plan(n, 3, v, backend=backend, device=cuda_device)
    tables = pl.params.tables
    _, _, ra, rb = _inputs(pl, 3, seed=n + v + 3, device=cuda_device)
    if kernel == "fused_polymul":
        want = kern.fused_polymul_ref(ra, rb, tables)
        got = kern.fused_polymul_cuda(ra, rb, tables)
        assert kern.cascade_blocks_per_sm(tables) >= 1
    elif kernel == "ntt_channels":
        want = kern.ntt_channels_ref(ra, tables)
        got = kern.ntt_channels_cuda(ra, tables)
        assert kern.ntt_blocks_per_sm(tables) >= 1
    else:
        want = kern.intt_channels_ref(ra, tables)
        got = kern.intt_channels_cuda(ra, tables)
        assert kern.intt_blocks_per_sm(tables) >= 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# K6 at one chunk of 16 limbs in each regime (t = 15, 14, 14 at v = 29,
# 30, 31), at 17 limbs (a second chunk of one), 32 (two chunks, three
# groups of channels) and 45, beside the regime presets
COMPOSE_CORNERS = [(64, 15, 29), (64, 14, 30), (64, 14, 31), (64, 15, 30), (64, 29, 30),
                   (64, 40, 31)]


@pytest.mark.parametrize("n,t,v", [(n, t, v) for n, t, v, _ in PRESETS] + COMPOSE_CORNERS)
def test_compose_kernel_at_odd_rows_and_the_limb_corners(cuda_device, n, t, v):
    """K6 equals its plain version at one row, at 255 and 257 (a partial
    last tile), with r = 0 and r = q - 1 in every channel, in one chunk of
    limbs and past it."""
    pl = repro_torch.plan(n, t, v, backend="cuda", device=cuda_device)
    _, _, ra, _ = _inputs(pl, 5, seed=n + t + v + 5, device=cuda_device)
    r2 = ra.reshape(t, -1)[:, :257].contiguous()
    r2[:, 0] = 0
    r2[:, 1] = pl.params.plan.qs_d - 1
    for rows in (1, 255, 257):
        got = crt.compose_cuda(r2[:, :rows].contiguous(), pl.params.plan)
        torch.cuda.synchronize()
        assert torch.equal(got, crt.compose_ref(r2[:, :rows], pl.params.plan))


# K5, K6, K2 and K2-fs past 16 segments, limbs and channels: chip_smoke.py's
# CHANNEL_EDGES (t = 9, 15, 16, 20, 30 at n = 64 and 4096, and at 4096 the
# largest t of K2/K2-fs, 48, and of K5/K6, 169) and the largest t plan()
# admits at n = 64, 484 (the special primes the search finds there; every
# kernel backend serves it), one row: (n, t, rows)
CHANNEL_EDGE_POINTS = _chip_smoke().CHANNEL_EDGES + [(64, 484, 1)]


@pytest.mark.parametrize("n,t,rows", CHANNEL_EDGE_POINTS)
def test_channel_edge_kernels_match_plain_versions(cuda_device, n, t, rows):
    """K5 and K6 on every point, K2 and K2-fs where plan() serves
    cuda_fused_e2e, bit for bit against their plain versions (and K2-fs
    against K2), with a zero and a q - 1 operand coefficient and residues
    0 and q - 1; the card holds at least one cluster.  At (64, 484) the
    plain versions take minutes."""
    pl = repro_torch.plan(n, t, 30, backend="cuda", device=cuda_device)
    p, cfg = pl.params, pl.config
    za, zb, ra, _ = _inputs(pl, rows, seed=n + t + 11, device=cuda_device)
    za[..., -1] = zb[..., -1] = 0  # below q
    za[0, 0] = zb[0, 1] = 0
    za[-1, -1] = zb[-1, -1] = repro_torch.to_segments(pl, [pl.q - 1])[0]
    z2 = za.reshape(-1, cfg.seg_count)
    r2 = ra.reshape(t, -1).contiguous()
    r2[:, 0] = 0
    r2[:, 1] = p.plan.qs_d - 1
    assert torch.equal(crt.decompose_cuda(z2, p.plan), crt.decompose_ref(z2, p.plan))
    assert torch.equal(crt.compose_cuda(r2, p.plan), crt.compose_ref(r2, p.plan))
    S, L = cfg.seg_count, cfg.L
    if kern.e2e_fits(n, t, S, L):
        k2 = kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan)
        assert torch.equal(k2, kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan))
        assert kern.e2e_max_active_clusters(p.tables, p.plan) >= 1
    if kern.e2e_fs_fits(n, t, S, L):
        fs = kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan)
        assert kern.fused_e2e_polymul_fs_cuda.cluster == min(t, 8)
        if kern.e2e_fits(n, t, S, L):
            assert torch.equal(fs, k2)
        else:
            assert torch.equal(fs, kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan))
        assert min(kern.e2e_fs_max_active_clusters(p.tables, p.plan)) >= 1
    serves = kern.e2e_fits(n, t, S, L) or kern.e2e_fs_fits(n, t, S, L)
    assert serves == (t <= 48 or n == 64)


def test_pass_kernel_admission_edges_did_not_move():
    """Runs without a card: with K1's and K3's padded shared layout
    (stage_smem_bytes, cascade_smem_bytes) the one-block kernels serve
    backend="cuda_fused" up to n = 16384 and backend="cuda" up to
    n = 32768, and the multi-block kernels twice those (plan() records
    which, and admits up to n = 65536); the largest n chip_smoke.py
    checks K1 and K3 at is that edge."""
    for backend, edge in (("cuda_fused", 16384), ("cuda", 32768)):
        for t in (1, 3):
            pl = repro_torch.plan(edge, t, 30, backend=backend, device="cpu")
            assert pl.config.backend == backend and not pl.config.schedule.multi_block
            pl = repro_torch.plan(2 * edge, t, 30, backend=backend, device="cpu")
            assert pl.config.schedule.multi_block
            with pytest.raises(repro_torch.UnservableConfigError) as err:
                repro_torch.plan(131072, t, 30, backend=backend, device="cpu")
            assert err.value.knob == "n"
    assert kern.cascade_smem_bytes(16384) <= kern.MAX_SMEM_BYTES < kern.cascade_smem_bytes(32768)
    assert kern.stage_smem_bytes(32768) <= kern.MAX_SMEM_BYTES < kern.stage_smem_bytes(65536)
    assert {backend: max(ns) for backend, ns in SMOKE_PASS_POINTS.values()} == {
        "cuda_fused": 16384, "cuda": 32768}


# K1-fs, K3-fs and K4-fs, the multi-block kernels, at chip_smoke.py's
# FS_POINTS (n = 16 ... 65536), where n <= 16384 (K1) or 32768 (K3, K4) is
# served by the one-block kernels too
SMOKE_FS_POINTS = _chip_smoke().FS_POINTS


@pytest.mark.parametrize("v", (29, 30, 31))
@pytest.mark.parametrize("n", SMOKE_FS_POINTS)
def test_multi_block_kernels_match_plain_versions(cuda_device, n, v):
    """K1-fs, K3-fs and K4-fs equal their plain versions (the four-step
    plain PyTorch) bit for bit in every regime at an odd row count, equal
    K1, K3 and K4 where those serve n too, and an SM holds at least one
    CTA of each of their launches."""
    pl = repro_torch.plan(n, 3, v, backend="cuda", device=cuda_device)
    tables = pl.params.tables
    _, _, ra, rb = _inputs(pl, 3, seed=n + v + 11, device=cuda_device)
    ra[:, 0, :2] = pl.params.plan.qs_d[:, None] - 1
    for cuda, ref, one_block, fits, operands, blocks in (
        (kern.fused_polymul_fs_cuda, kern.fused_polymul_fs_ref, kern.fused_polymul_cuda,
         kern.cascade_fits, (ra, rb), kern.cascade_fs_blocks_per_sm),
        (kern.ntt_channels_fs_cuda, kern.ntt_channels_fs_ref, kern.ntt_channels_cuda,
         kern.stage_fits, (ra,), kern.ntt_fs_blocks_per_sm),
        (kern.intt_channels_fs_cuda, kern.intt_channels_fs_ref, kern.intt_channels_cuda,
         kern.stage_fits, (ra,), kern.intt_fs_blocks_per_sm),
    ):
        got = cuda(*operands, tables)
        torch.cuda.synchronize()
        assert torch.equal(got, ref(*operands, tables))
        if fits(n):
            assert torch.equal(got, one_block(*operands, tables))
        assert min(blocks(tables)) >= 1


def test_multi_block_admission_edges():
    """Runs without a card: plan() admits n = 65536 at t = 6 on cuda,
    cuda_fused and cuda_fused_e2e (multi-block kernels: K2-fs on the
    last) and refuses 131072 there (knob n); an explicit cuda_fused_e2e
    above n = 16384 is K2-fs's at t = 9 and refused at t = 49 (knob t),
    past its six slots a CTA; the launch geometry of the multi-block
    kernels at 32768 and 65536 comes from their own helpers."""
    for backend in ("cuda", "cuda_fused", "cuda_fused_e2e"):
        pl = repro_torch.plan(65536, 6, 30, backend=backend, device="cpu")
        assert pl.config.schedule.multi_block and pl.config.schedule.card_split == (256, 256)
        with pytest.raises(repro_torch.UnservableConfigError) as err:
            repro_torch.plan(131072, 6, 30, backend=backend, device="cpu")
        assert err.value.knob == "n"
    for n in (32768, 65536):
        pl = repro_torch.plan(n, 6, 30, backend="cuda_fused_e2e", device="cpu")
        assert pl.config.schedule.card_split == kern.fs_split(n)
        for t in (1, 6, 14):
            assert kern.fs_blocks(t, 16, n) * kern.fs_tile(n) == t * 16 * n
        assert kern.fs_threads(n) == 256
        assert max(kern.ntt_fs_smem_bytes(n), kern.intt_fs_smem_bytes(n),
                   kern.cascade_fs_smem_bytes(n),
                   kern.e2e_fs_smem_bytes(n, 48, 48, 52)) <= kern.MAX_SMEM_BYTES
        assert not kern.e2e_fs_fits(n, 49, 49, 53)
    pl = repro_torch.plan(32768, 9, 30, backend="cuda_fused_e2e", device="cpu")
    assert pl.config.schedule.multi_block
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(32768, 49, 30, backend="cuda_fused_e2e", device="cpu")
    assert err.value.knob == "t"


def test_front_door_past_one_cta(cuda_device):
    """plan(65536, 6, 30) under auto is cuda_fused_e2e on K2-fs (its
    negacyclic_mul on K1-fs); polymul, negacyclic_mul, ntt and intt on it
    and on backends cuda_fused and cuda equal a backend="torch" plan on the
    card, and a polymul row the host oracle."""
    n = 65536
    auto = repro_torch.plan(n, 6, 30)
    assert auto.config.backend == "cuda_fused_e2e" and auto.config.schedule.multi_block
    plain = repro_torch.plan(n, 6, 30, backend="torch", device=auto.device)
    za, zb, ra, rb = _inputs(auto, 2, seed=7, device=auto.device)
    za[..., -1] = zb[..., -1] = 0  # below q
    for pl, want in ((auto, (1, 1)), (repro_torch.plan(n, 6, 30, backend="cuda_fused"), (2, 0)),
                     (repro_torch.plan(n, 6, 30, backend="cuda"), (0, 0))):
        kern.fused_polymul_fs_cuda.launches = kern.fused_e2e_polymul_fs_cuda.launches = 0
        out = repro_torch.polymul(pl, za, zb)
        assert torch.equal(out, repro_torch.polymul(plain, za, zb))
        assert torch.equal(repro_torch.negacyclic_mul(pl, ra, rb),
                           repro_torch.negacyclic_mul(plain, ra, rb))
        assert torch.equal(repro_torch.ntt(pl, ra), repro_torch.ntt(plain, ra))
        assert torch.equal(repro_torch.intt(pl, ra), repro_torch.intt(plain, ra))
        assert (kern.fused_polymul_fs_cuda.launches,
                kern.fused_e2e_polymul_fs_cuda.launches) == want
    a = bigint.limbs_to_ints(za[1].cpu().numpy(), auto.v)
    b = bigint.limbs_to_ints(zb[1].cpu().numpy(), auto.v)
    assert repro_torch.from_limbs(auto, out[1]) == host.oracle_multiply(a, b, auto.params)


# K2-fs at chip_smoke.py's FS_POINTS, with clusters of 3, 6 and 8 CTAs
@pytest.mark.parametrize("t", (3, 6, 8))
@pytest.mark.parametrize("n", SMOKE_FS_POINTS)
def test_multi_block_e2e_kernel_matches_plain_version_and_k2(cuda_device, n, t):
    """K2-fs equals its plain version (K2's over the four-step cascade)
    bit for bit at an odd row count in each regime, equals K2 where K2
    also serves n, runs clusters of min(t, 8) CTAs, and the card holds at
    least one cluster of each of its cluster launches."""
    for v in (29, 30, 31):
        if (n, t, v) in E2E_FS_REFUSED:
            with pytest.raises(repro_torch.UnservableConfigError):
                repro_torch.plan(n, t, v, backend="cuda_fused_e2e", device=cuda_device)
            continue
        pl = repro_torch.plan(n, t, v, backend="cuda_fused_e2e", device=cuda_device)
        p = pl.params
        za, zb, _, _ = _inputs(pl, 3, seed=n + t + v + 13, device=cuda_device)
        za[..., -1] = zb[..., -1] = 0  # below q
        got = kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan)
        torch.cuda.synchronize()
        assert kern.fused_e2e_polymul_fs_cuda.cluster == min(t, 8)
        assert torch.equal(got, kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan))
        if kern.e2e_fits(n, t, pl.config.seg_count, pl.config.L):
            assert torch.equal(got, kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan))
        assert min(kern.e2e_fs_max_active_clusters(p.tables, p.plan)) >= 1


def test_auto_polymul_past_one_cta_launches_only_k2fs(cuda_device):
    """An auto polymul at (65536, 6, 30) is one K2-fs call (its three
    launches) and nothing else, equal to a backend="torch" plan on the
    card and to the host oracle on a row."""
    pl = repro_torch.plan(65536, 6, 30)
    za, zb, _, _ = _inputs(pl, 2, seed=17, device=pl.device)
    za[..., -1] = zb[..., -1] = 0  # below q
    wrappers = STAGE_WRAPPERS + (kern.fused_polymul_fs_cuda, kern.ntt_channels_fs_cuda,
                                 kern.intt_channels_fs_cuda, kern.fused_e2e_polymul_fs_cuda)
    for w in wrappers:
        w.launches = 0
    out = repro_torch.polymul(pl, za, zb)
    torch.cuda.synchronize()
    assert tuple(w.launches for w in wrappers) == (0,) * (len(wrappers) - 1) + (1,)
    plain = repro_torch.plan(65536, 6, 30, backend="torch", device=pl.device)
    assert torch.equal(out, repro_torch.polymul(plain, za, zb))
    a = bigint.limbs_to_ints(za[0].cpu().numpy(), pl.v)
    b = bigint.limbs_to_ints(zb[0].cpu().numpy(), pl.v)
    assert repro_torch.from_limbs(pl, out[0]) == host.oracle_multiply(a, b, pl.params)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    p = repro_torch.plan(64, 3, 30, device=cuda_device).params
    a = torch.zeros((3, 2, 64), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        kern.fused_polymul_cuda(a.to(torch.int32), a.to(torch.int32), p.tables)
    strided = torch.zeros((3, 64, 2), dtype=torch.int64, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        kern.fused_polymul_cuda(strided, strided, p.tables)
    with pytest.raises(ValueError):
        kern.fused_polymul_cuda(a, a.cpu(), p.tables)
    empty = kern.fused_polymul_cuda(a[:, :0], a[:, :0], p.tables)
    assert empty.shape == (3, 0, 64)
    with pytest.raises(ValueError):
        kern.ntt_channels_cuda(a.to(torch.int32), p.tables)


# K7 against its plain version: (B, Sq, Skv, H, Hk, D), dtype, keywords.
# Every element within ATTN_ATOL in float32 (summation order only), plus
# one bf16 step of the plain output for bfloat16 I/O (both round a
# float32 result once, so a value near a rounding boundary may land one
# step apart).  softcap=1.0 bends every score, not only the largest.
ATTN_CASES = [
    ((1, 96, 160, 4, 4, 32), torch.float32, dict(blk_k=64)),
    ((2, 256, 256, 4, 2, 64), torch.float32, dict(window=64, softcap=50.0)),
    ((1, 128, 128, 4, 4, 32), torch.float32, dict(causal=False)),
    ((2, 1, 256, 4, 4, 128), torch.float32, dict(q_offset=200)),
    ((1, 128, 200, 4, 2, 64), torch.float32, dict(softcap=1.0, q_offset=72)),
    ((1, 4, 100, 2, 1, 32), torch.float32, dict(window=8, q_offset=500, blk_k=64)),
    ((1, 4, 100, 2, 1, 32), torch.float32, dict(window=8, q_offset=500, blk_k=128)),
    ((1, 70, 130, 2, 1, 256), torch.float32, dict(causal=False, window=40, q_offset=20)),
    ((1, 1024, 1024, 8, 4, 256), torch.bfloat16, dict(window=512, softcap=50.0)),
    ((1, 512, 512, 32, 4, 128), torch.bfloat16, {}),
]
ATTN_ATOL = 1e-5


def _past_attention_tolerance(got, want) -> int:
    """How many elements of ``got`` lie past ATTN_ATOL (plus one bf16 step
    of ``want`` for bfloat16) from ``want``, compared in float32."""
    err = (got.float() - want.float()).abs()
    allowed = ATTN_ATOL
    if got.dtype == torch.bfloat16:
        mant, exp = torch.frexp(want.float())
        allowed = allowed + torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(mant), exp - 8))
    return int((err > allowed).sum())


def _attention_inputs(shape, dtype, seed, device):
    B, Sq, Skv, H, Hk, D = shape
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=size).astype(np.float32)).to(device, dtype)
            for size in ((B, Sq, H, D), (B, Skv, Hk, D), (B, Skv, Hk, D))]


@pytest.mark.parametrize("shape,dtype,kw", ATTN_CASES)
def test_attention_kernel_matches_plain_version(cuda_device, monkeypatch, shape, dtype, kw):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _attention_inputs(shape, dtype, seed=sum(shape), device=cuda_device)
    got = attention.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _past_attention_tolerance(got, want) == 0


def test_attention_entry_point_launches_k7_once(cuda_device):
    q, k, v = _attention_inputs((1, 200, 300, 8, 4, 64), torch.bfloat16, seed=3,
                                device=cuda_device)
    for w in (*STAGE_WRAPPERS, attention.flash_attention_cuda):
        w.launches = 0
    out = attention.flash_attention(q, k, v, window=100)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == 1
    assert all(w.launches == 0 for w in STAGE_WRAPPERS)
    pl = repro_torch.plan(256, 6, 30)
    za, zb, _, _ = _inputs(pl, 2, seed=3, device=pl.device)
    repro_torch.polymul(pl, za, zb)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == 1
    want = attention.flash_attention_ref(q, k, v, window=100)
    assert _past_attention_tolerance(out, want) == 0


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _attention_inputs((1, 4, 6, 2, 1, 32), torch.float32, seed=4, device=cuda_device)
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(q.to(torch.float64), k.double(), v.double())
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(q[..., :16].contiguous(), k[..., :16].contiguous(),
                                       v[..., :16].contiguous())
    shifted = torch.zeros(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(shifted, k, v)
    empty = attention.flash_attention_cuda(q[:, :0], k, v)
    assert empty.shape == (1, 0, 2, 32)


# K7's variants at bf16 (attention_variant picks them by shape), each
# case asserting which one ran: (B, Sq, Skv, H, Hk, D), keywords, variant.
ATTN_VARIANT_CASES = [
    ((1, 128, 128, 4, 4, 32), dict(blk_k=64), "wgmma"),
    ((1, 90, 190, 4, 1, 64), dict(q_offset=7), "wgmma"),
    ((1, 256, 256, 8, 4, 128), dict(softcap=1.0), "wgmma"),
    ((1, 200, 300, 8, 4, 256), dict(window=100, softcap=50.0), "wgmma"),
    ((1, 130, 200, 2, 2, 128), dict(causal=False), "wgmma"),
    # decode: B = 16, one query, GQA; 1000 keys, which no split divides
    ((16, 1, 8192, 8, 4, 256), dict(q_offset=8191, softcap=50.0), "decode"),
    ((16, 1, 1000, 8, 4, 128), dict(q_offset=999), "decode"),
    # a window that leaves the early splits without a visible key
    ((4, 1, 3000, 8, 2, 64), dict(q_offset=2999, window=700), "decode"),
    ((2, 2, 517, 16, 4, 32), dict(q_offset=515, softcap=50.0), "decode"),
    # the query that sees no key at all, in bf16, in both bf16 variants
    ((1, 4, 100, 2, 1, 32), dict(window=8, q_offset=500, blk_k=64), "decode"),
    ((1, 70, 130, 2, 1, 64), dict(window=8, q_offset=500), "wgmma"),
]


@pytest.mark.parametrize("shape,kw,variant", ATTN_VARIANT_CASES)
def test_attention_variants_match_plain_version(cuda_device, monkeypatch, shape, kw, variant):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _attention_inputs(shape, torch.bfloat16, seed=sum(shape), device=cuda_device)
    before = dict(attention.flash_attention_cuda.variants)
    got = attention.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in attention.flash_attention_cuda.variants.items()}
    assert ran == {n: int(n == variant) for n in attention.VARIANTS}
    want = attention.flash_attention_ref(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    assert _past_attention_tolerance(got, want) == 0
    if variant == "decode":  # the combine leaves its counters at zero for the next call
        again = attention.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(again, got)


# --------------------------------------------------------------------------
# the BFV layer and the front door on the card
# --------------------------------------------------------------------------


def test_execute_launches_k2_once(cuda_device):
    pl = repro_torch.plan(4096, 6, 30)
    za, zb, _, _ = _inputs(pl, 4, seed=18, device=pl.device)
    for w in STAGE_WRAPPERS:
        w.launches = 0
    out = repro_torch.execute(pl, za, zb, donate=True)
    torch.cuda.synchronize()
    assert tuple(w.launches for w in STAGE_WRAPPERS) == (0, 1, 0, 0, 0, 0)
    assert torch.equal(out, repro_torch.polymul(pl, za, zb))
    assert repro_torch.plan_from_params(make_params(4096, 6, 30, device="cuda")).config == pl.config


def _bfv_run(ctx, seed: int, counts: dict):
    """keygen, three encrypts of a (3, n) batch, add_many, mul_plain and
    decrypt from one generator seed: every ciphertext and decrypt, with
    each call's (K1, K6) launches recorded in ``counts``."""
    gen = torch.Generator(device=ctx.plan.device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n = ctx.params.n
    ms = [rng.integers(0, ctx.pt_mod, size=(3, n), dtype=np.int64) for _ in range(3)]
    w = rng.integers(-8, 9, size=(n,), dtype=np.int64)

    def counted(name, fn):
        kern.fused_polymul_cuda.launches = crt.compose_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[name] = (kern.fused_polymul_cuda.launches, crt.compose_cuda.launches)
        return out

    kp = counted("keygen", lambda: bfv.keygen(gen, ctx))
    cts = [counted("encrypt", lambda: bfv.encrypt(gen, m, kp, ctx)) for m in ms]
    total = counted("add_many", lambda: bfv.add_many(cts, ctx))
    prod = counted("mul_plain", lambda: bfv.mul_plain(total, w, ctx))
    decs = [counted("decrypt", lambda: bfv.decrypt(ct, kp, ctx)) for ct in cts + [total, prod]]
    return ms, w, [kp.sk, kp.pk] + [ct.c for ct in cts + [total, prod]], decs


@pytest.mark.parametrize("n,t", [(256, 6), (4096, 6)])
def test_bfv_on_the_kernels_matches_the_plain_backend(cuda_device, n, t):
    """BFV on the auto plan (every product on K1, every compose on K6)
    equals BFV on a backend="torch" plan on the card from the same seed:
    every residue and every decrypt; the decrypts are right."""
    counts, plain_counts = {}, {}
    auto = bfv.make_context(n=n, t=t, v=30, pt_mod=1 << 24)
    plain = bfv.make_context(n=n, t=t, v=30, pt_mod=1 << 24, backend="torch")
    assert auto.plan.config.backend == "cuda_fused_e2e" and auto.plan.device.type == "cuda"
    ms, w, tensors, decs = _bfv_run(auto, 5, counts)
    _, _, plain_tensors, plain_decs = _bfv_run(plain, 5, plain_counts)
    assert counts == {"keygen": (1, 0), "encrypt": (2, 0), "add_many": (0, 0),
                      "mul_plain": (2, 0), "decrypt": (1, 1)}
    assert set(plain_counts.values()) == {(0, 0)}
    for got, want in zip(tensors, plain_tensors):
        assert torch.equal(got, want)
    for got, want in zip(decs, plain_decs):
        assert np.array_equal(got, want)
    pt = auto.pt_mod
    total = sum(ms) % pt
    for got, want in zip(decs, ms + [total]):
        assert np.array_equal(got, want)
    assert np.array_equal(decs[-1], _negacyclic_mod(total, w, pt))
    if n <= 256:
        want = host.schoolbook_negacyclic(total[0].tolist(), [int(x) % pt for x in w], pt)
        assert decs[-1][0].tolist() == want


def _negacyclic_mod(m: np.ndarray, w: np.ndarray, pt: int) -> np.ndarray:
    """Rows of m times w mod (x^n + 1, pt) by exact int64 convolution
    (|m| < 2^24, |w| <= 8: every sum stays below 2^40)."""
    n = m.shape[-1]
    out = []
    for row in m.reshape(-1, n):
        c = np.convolve(row, w)
        p = c[:n].copy()
        p[:n - 1] -= c[n:]
        out.append(p % pt)
    return np.stack(out).reshape(m.shape)
