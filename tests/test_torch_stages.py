"""The PyTorch port's staged datapath and stage entry points held bit for
bit against the JAX reference: ``repro_torch.ntt``, ``intt``,
``decompose``, ``compose``, ``negacyclic_mul`` and ``polymul`` on every
port backend (``cuda`` is the counterpart of the reference's per-stage
``pallas`` backend), and the plain versions of the four stage kernels
called directly.

References: the JAX package's ``backend="pallas"`` outputs (its stage
kernels in interpret mode) at n=64, t=3 in all three reduction regimes
(v = 29, 30, 31), and its ``jnp`` outputs at n=256, t=6, v=30.  Inputs
are seeded numpy with a leading batch of (2, 3): six rows, not a power
of two.  Residue inputs are canonical, the domain the kernels take.  The
tolerance is exact equality: outputs are canonical integers."""
import jax
import numpy as np
import pytest
import torch

import repro

import repro_torch
from repro_torch.core import bigint as tbigint
from repro_torch.kernels import crt as tcrt
from repro_torch.kernels import ntt as tkern

# (n, t, v, reference backend)
PRESETS = [(64, 3, 29, "pallas"), (64, 3, 30, "pallas"), (64, 3, 31, "pallas"),
           (256, 6, 30, "jnp")]
LEAD = (2, 3)
STAGES = ("ntt", "intt", "decompose", "compose", "negacyclic_mul", "polymul")

# a Plan is a pytree argument: each jitted stage compiles once per config
_REF_STAGES = {
    "ntt": jax.jit(repro.ntt),
    "intt": jax.jit(repro.intt),
    "decompose": jax.jit(repro.decompose),
    "compose": jax.jit(repro.compose),
    "negacyclic_mul": jax.jit(repro.negacyclic_mul),
    "polymul": repro.execute,  # already jitted
}


def _inputs(n, t, v, seed):
    """Seeded segments (*LEAD, n, S) x 2 and canonical residues (t, *LEAD, n) x 2."""
    pl = repro_torch.plan(n, t, v, device="cpu")
    rng = np.random.default_rng(seed)
    S = pl.config.seg_count
    za = rng.integers(0, 1 << v, size=LEAD + (n, S), dtype=np.int64)
    zb = rng.integers(0, 1 << v, size=LEAD + (n, S), dtype=np.int64)
    qs = pl.params.qs.reshape((t,) + (1,) * (len(LEAD) + 1))
    ra = rng.integers(0, 1 << 62, size=(t,) + LEAD + (n,), dtype=np.int64) % qs
    rb = rng.integers(0, 1 << 62, size=(t,) + LEAD + (n,), dtype=np.int64) % qs
    return {"za": za, "zb": zb, "ra": ra, "rb": rb}


# the inputs each stage takes
ARGS = {
    "ntt": ("ra",), "intt": ("ra",), "decompose": ("za",), "compose": ("ra",),
    "negacyclic_mul": ("ra", "rb"), "polymul": ("za", "zb"),
}


@pytest.fixture(scope="module")
def reference():
    """Inputs and the reference output of every stage per preset, built once."""
    out = {}
    for n, t, v, backend in PRESETS:
        x = _inputs(n, t, v, seed=n * 1000 + v)
        pl = repro.plan(n, t, v, backend=backend)
        x["ref"] = {
            stage: np.asarray(fn(pl, *(x[k] for k in ARGS[stage])))
            for stage, fn in _REF_STAGES.items()
        }
        out[(n, t, v)] = x
    return out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("backend", repro_torch.BACKENDS)
@pytest.mark.parametrize("n,t,v,ref_backend", PRESETS)
def test_entry_points_match_reference(reference, n, t, v, ref_backend, backend, stage):
    x = reference[(n, t, v)]
    pl = repro_torch.plan(n, t, v, backend=backend, device="cpu")
    fn = getattr(repro_torch, stage)
    got = fn(pl, *(torch.as_tensor(x[k]) for k in ARGS[stage]))
    want = x["ref"][stage]
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want), (ref_backend, stage)


@pytest.mark.parametrize("n,t,v,ref_backend", PRESETS)
def test_stage_plain_versions_match_reference(reference, n, t, v, ref_backend):
    """The four stage kernels' plain versions, called directly on the
    kernels' flat layouts."""
    x = reference[(n, t, v)]
    p = repro_torch.plan(n, t, v, device="cpu").params
    S, L = p.plan.seg_count, p.plan.L
    ra = torch.as_tensor(x["ra"]).reshape(t, -1, n)
    za = torch.as_tensor(x["za"]).reshape(-1, S)
    ref = x["ref"]
    assert np.array_equal(tkern.ntt_channels_ref(ra, p.tables).numpy(),
                          ref["ntt"].reshape(t, -1, n))
    assert np.array_equal(tkern.intt_channels_ref(ra, p.tables).numpy(),
                          ref["intt"].reshape(t, -1, n))
    assert np.array_equal(tcrt.decompose_ref(za, p.plan).numpy(),
                          ref["decompose"].reshape(t, -1))
    assert np.array_equal(tcrt.compose_ref(ra.reshape(t, -1), p.plan).numpy(),
                          ref["compose"].reshape(-1, L))


@pytest.mark.parametrize("backend", repro_torch.BACKENDS)
def test_stages_round_trip(backend):
    """intt(ntt(r)) == r, and compose(decompose(z)) gives back z's integers
    for coefficients below q."""
    n, t, v = 64, 3, 30
    pl = repro_torch.plan(n, t, v, backend=backend, device="cpu")
    rng = np.random.default_rng(11)
    qs = pl.params.qs[:, None, None]
    r = torch.as_tensor(rng.integers(0, 1 << 62, size=(t, 5, n), dtype=np.int64) % qs)
    assert torch.equal(repro_torch.intt(pl, repro_torch.ntt(pl, r)), r)
    ints = [int.from_bytes(rng.bytes(24), "little") % pl.q for _ in range(5 * n)]
    z = torch.as_tensor(tbigint.ints_to_limbs(ints, v, pl.config.seg_count)).reshape(5, n, -1)
    res = repro_torch.decompose(pl, z)
    assert tuple(res.shape) == (t, 5, n)
    assert repro_torch.from_limbs(pl, repro_torch.compose(pl, res)) == ints


def test_plan_resolves_the_cuda_backend():
    pl = repro_torch.plan(64, 3, 30, backend="cuda", device="cpu")
    cfg = repro_torch.plan_key(pl)
    assert (cfg.backend, cfg.device, cfg.seg_count, cfg.L) == ("cuda", "cpu", 3, 4)
    assert "cuda" in repro_torch.BACKENDS
    assert {"ntt", "intt", "decompose", "compose"} <= set(repro_torch.__all__)
    # n = 65536 runs on the multi-block K3-fs and K4-fs; past it the kernel
    # backends refuse
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(131072, 2, 30, backend="cuda", device="cpu")
    assert err.value.knob == "n"


def test_stage_shape_contracts_raise():
    pl = repro_torch.plan(64, 3, 30, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.ntt(pl, torch.zeros((2, 4, 64), dtype=torch.int64))
    with pytest.raises(ValueError):
        repro_torch.intt(pl, torch.zeros((3, 4, 32), dtype=torch.int64))
    with pytest.raises(ValueError):
        repro_torch.decompose(pl, torch.zeros((4, 64, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        repro_torch.compose(pl, torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(TypeError):
        repro_torch.ntt(object(), torch.zeros((3, 4, 64), dtype=torch.int64))
