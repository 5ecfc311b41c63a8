"""The PyTorch port's CUDA kernels on the card, against their plain
PyTorch versions (exact int64 equality) and the host bigint oracle.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips on a machine without a CUDA device.  This file imports neither JAX
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import bigint, polymul as host
from repro_torch.kernels import crt
from repro_torch.kernels import ntt as kern

pytestmark = pytest.mark.cuda

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
