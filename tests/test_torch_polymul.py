"""The PyTorch port's multiplier held bit for bit against the JAX
reference: the plain versions of the fused cascade kernel (through
``repro_torch.negacyclic_mul``) and of the fused e2e kernel (through
``repro_torch.polymul``), on every port backend, against the reference's
``jnp`` datapath and its Pallas kernels in interpret mode, and against the
port's own host bigint oracle; plus the plan-time error paths and the
no-fallback contract of the kernel wrappers.  The tolerance is exact
equality: outputs are canonical integers."""
import jax
import numpy as np
import pytest
import torch

import repro

import repro_torch
from repro_torch.core import bigint as tbigint
from repro_torch.core import polymul as tpm
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import crt as tcrt
from repro_torch.kernels import ntt as tkern

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# (n, t, v): the three reduction regimes at n = 64 and the paper's t = 6
PRESETS = [(64, 3, 29), (64, 3, 30), (64, 3, 31), (256, 6, 30),
           # outside the regime presets: t = 4 strict, t = 9 (two channels on
           # some K2 CTAs), and a narrow v
           (64, 4, 31), (32, 9, 30), (64, 3, 20)]
SMALL = [p for p in PRESETS if p[0] == 64]
ROWS = 3  # not a power of two
PORT_BACKENDS = ("torch", "cuda", "cuda_fused", "cuda_fused_e2e")


def _inputs(n, t, v, seed):
    """Seeded segments (ROWS, n, S) and canonical residues (t, ROWS, n)."""
    pl = repro_torch.plan(n, t, v, device="cpu")
    rng = np.random.default_rng(seed)
    S = pl.config.seg_count
    za = rng.integers(0, 1 << v, size=(ROWS, n, S), dtype=np.int64)
    zb = rng.integers(0, 1 << v, size=(ROWS, n, S), dtype=np.int64)
    qs = pl.params.qs[:, None, None]
    ra = rng.integers(0, 1 << 62, size=(t, ROWS, n), dtype=np.int64) % qs
    rb = rng.integers(0, 1 << 62, size=(t, ROWS, n), dtype=np.int64) % qs
    return za, zb, ra, rb


_negacyclic_jit = jax.jit(repro.negacyclic_mul)  # a Plan is a pytree argument


@pytest.fixture(scope="module")
def reference():
    """Inputs and the reference outputs per preset, built once:
    ``polymul`` under jnp (and pallas_fused_e2e in interpret mode at
    n = 64), ``negacyclic_mul`` under jnp (and pallas_fused)."""
    out = {}
    for n, t, v in PRESETS:
        za, zb, ra, rb = _inputs(n, t, v, seed=n * 100 + v)
        rec = {"za": za, "zb": zb, "ra": ra, "rb": rb, "polymul": {}, "negacyclic": {}}
        kernels = n == 64
        for be in ("jnp", "pallas_fused_e2e") if kernels else ("jnp",):
            # the jitted executor compiles once instead of op by op
            rec["polymul"][be] = np.asarray(repro.execute(repro.plan(n, t, v, backend=be), za, zb))
        for be in ("jnp", "pallas_fused") if kernels else ("jnp",):
            pl = repro.plan(n, t, v, backend=be)
            rec["negacyclic"][be] = np.asarray(_negacyclic_jit(pl, ra, rb))
        out[(n, t, v)] = rec
    return out


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("n,t,v", PRESETS)
def test_polymul_matches_reference(reference, n, t, v, backend):
    rec = reference[(n, t, v)]
    pl = repro_torch.plan(n, t, v, backend=backend, device="cpu")
    got = repro_torch.polymul(pl, torch.as_tensor(rec["za"]), torch.as_tensor(rec["zb"]))
    assert got.dtype == torch.int64 and tuple(got.shape) == (ROWS, n, pl.config.L)
    for be, ref in rec["polymul"].items():
        assert np.array_equal(got.numpy(), ref), be


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("n,t,v", PRESETS)
def test_negacyclic_mul_matches_reference(reference, n, t, v, backend):
    rec = reference[(n, t, v)]
    pl = repro_torch.plan(n, t, v, backend=backend, device="cpu")
    got = repro_torch.negacyclic_mul(pl, torch.as_tensor(rec["ra"]), torch.as_tensor(rec["rb"]))
    for be, ref in rec["negacyclic"].items():
        assert np.array_equal(got.numpy(), ref), be


@pytest.mark.parametrize("n,t,v", PRESETS)
def test_kernel_plain_versions_match_reference(reference, n, t, v):
    """The wrappers' plain versions, called directly."""
    rec = reference[(n, t, v)]
    p = repro_torch.plan(n, t, v, device="cpu").params
    T = torch.as_tensor
    k1 = tkern.fused_polymul_ref(T(rec["ra"]), T(rec["rb"]), p.tables)
    assert np.array_equal(k1.numpy(), rec["negacyclic"]["jnp"])
    k2 = tkern.fused_e2e_polymul_ref(T(rec["za"]), T(rec["zb"]), p.tables, p.plan)
    assert np.array_equal(k2.numpy(), rec["polymul"]["jnp"])


@pytest.mark.parametrize("n,t,v", SMALL + [(256, 6, 30)])
def test_polymul_matches_host_oracle(reference, n, t, v):
    rec = reference[(n, t, v)]
    pl = repro_torch.plan(n, t, v, backend="cuda_fused_e2e", device="cpu")
    got = repro_torch.polymul(pl, torch.as_tensor(rec["za"]), torch.as_tensor(rec["zb"]))
    for r in range(ROWS):
        a = tbigint.limbs_to_ints(rec["za"][r], v)
        b = tbigint.limbs_to_ints(rec["zb"][r], v)
        assert repro_torch.from_limbs(pl, got[r]) == tpm.oracle_multiply(a, b, pl.params)


def test_e2e_backend_past_one_cta_matches_reference_jnp():
    """A cuda_fused_e2e plan at the smallest multi-block point, n = 32768
    (t = 3, v = 30: the reference's SAU window holds its words there, not
    at t = 6), runs K2-fs's plain version; one row equals repro.polymul on
    jnp bit for bit."""
    n, t, v = 32768, 3, 30
    pl = repro_torch.plan(n, t, v, backend="cuda_fused_e2e", device="cpu")
    assert pl.config.schedule.multi_block
    rng = np.random.default_rng(n + v)
    S = pl.config.seg_count
    top = pl.q >> (v * (S - 1))  # keeps the values below q
    za, zb = (np.concatenate([rng.integers(0, 1 << v, size=(1, n, S - 1), dtype=np.int64),
                              rng.integers(0, top, size=(1, n, 1), dtype=np.int64)], axis=-1)
              for _ in range(2))
    want = np.asarray(repro.execute(repro.plan(n, t, v, backend="jnp"), za, zb))
    got = repro_torch.polymul(pl, torch.as_tensor(za), torch.as_tensor(zb))
    assert np.array_equal(got.numpy(), want)


def test_polymul_batch_shapes_and_ints():
    """Leading batch dims fold and unfold; the int convenience path."""
    pl = repro_torch.plan(64, 3, 30, device="cpu")
    rng = np.random.default_rng(5)
    za = torch.as_tensor(rng.integers(0, 1 << 30, size=(5, 1, 64, pl.config.seg_count)))
    zb = torch.as_tensor(rng.integers(0, 1 << 30, size=(5, 1, 64, pl.config.seg_count)))
    got = repro_torch.polymul(pl, za, zb)
    assert tuple(got.shape) == (5, 1, 64, pl.config.L)
    flat = repro_torch.polymul(pl, za.reshape(5, 64, -1), zb.reshape(5, 64, -1))
    assert torch.equal(got.reshape(flat.shape), flat)
    a = [int(x) for x in rng.integers(0, pl.q >> 64, 64)]
    b = [int(x) for x in rng.integers(0, 1 << 62, 64)]
    assert repro_torch.polymul_ints(pl, a, b) == tpm.schoolbook_negacyclic(a, b, pl.q)


def test_plan_config_resolution():
    pl = repro_torch.plan(64, 3, 30, device="cpu")
    cfg = repro_torch.plan_key(pl)
    assert cfg.backend == "torch" and cfg.device == "cpu"
    assert (cfg.seg_count, cfg.w, cfg.L) == (3, 28, 4)
    assert repro_torch.plan(64, 3, 30, device="cpu").config == cfg
    assert repro_torch.plan(64, 3, 30, device="cpu", backend="cuda_fused").config != cfg
    assert repro_torch.BACKENDS == ("torch", "cuda", "cuda_fused", "cuda_fused_e2e")


# --------------------------------------------------------------------------
# error paths
# --------------------------------------------------------------------------


def test_plan_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(64, 3, 30)
    assert err.value.knob == "device"
    with pytest.raises(repro_torch.UnservableConfigError):
        repro_torch.plan(64, 3, 30, device="cuda")


def test_plan_rejects_unservable_and_unknown_knobs():
    # the wide width (v = 45) has one datapath, plain PyTorch: a kernel
    # backend is refused there, as the reference refuses Pallas (knob backend)
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(64, 4, 45, backend="cuda_fused", device="cpu")
    assert err.value.knob == "backend"
    # past one CTA (n = 32768 needs over 272 KiB of shared memory for K2)
    # the e2e backend runs K2-fs, whose CTAs' shared memory does not grow
    # with t past the channels' tables; at v = 31 the in-kernel decompose
    # constants stop at t = 6 for n = 32768 (knob t)
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(1 << 15, 8, 31, backend="cuda_fused_e2e", device="cpu")
    assert err.value.knob == "t"
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(1 << 17, 6, 30, backend="cuda_fused_e2e", device="cpu")
    assert err.value.knob == "n"
    # the multi-block kernels serve n up to 65536 on the other kernel backends
    with pytest.raises(repro_torch.UnservableConfigError) as err:
        repro_torch.plan(1 << 17, 1, 30, backend="cuda_fused", device="cpu")
    assert err.value.knob == "n"
    with pytest.raises(repro_torch.UnknownKnobError):
        repro_torch.plan(64, 3, 30, backend="pallas", device="cpu")
    with pytest.raises(repro_torch.UnknownKnobError):
        repro_torch.plan(100, 3, 30, device="cpu")
    assert issubclass(repro_torch.UnservableConfigError, ValueError)


def test_shape_contracts_raise():
    pl = repro_torch.plan(64, 3, 30, device="cpu")
    z = torch.zeros((2, 64, 3), dtype=torch.int64)
    with pytest.raises(ValueError):
        repro_torch.polymul(pl, z, z[..., :2])
    with pytest.raises(ValueError):
        repro_torch.polymul(pl, z, z[:1])
    r = torch.zeros((3, 2, 64), dtype=torch.int64)
    with pytest.raises(ValueError):
        repro_torch.negacyclic_mul(pl, r, r[:2])
    with pytest.raises(TypeError):
        repro_torch.polymul(object(), z, z)


class _FakeCudaTensor:
    """Stands in for a CUDA tensor on a machine without one: only the
    attributes the wrappers read before they load the kernel."""

    def __init__(self, x):
        self._x = x
        self.device = torch.device("cuda", 0)
        self.dtype = x.dtype
        self.shape = x.shape

    def dim(self):
        return self._x.dim()

    def is_contiguous(self):
        return True


# wrapper -> (module, plain version, operand shapes at n = 64, t = 3, v = 30;
# attention: q, k, v at B = 1, Sq = 4, Skv = 6, H = 2, Hk = 1, D = 32)
WRAPPERS = {
    "fused_polymul_cuda": (tkern, "fused_polymul_ref", [(3, 2, 64), (3, 2, 64)]),
    "fused_e2e_polymul_cuda": (tkern, "fused_e2e_polymul_ref", [(2, 64, 3), (2, 64, 3)]),
    "fused_e2e_polymul_fs_cuda": (tkern, "fused_e2e_polymul_fs_ref", [(2, 64, 3), (2, 64, 3)]),
    "ntt_channels_cuda": (tkern, "ntt_channels_ref", [(3, 2, 64)]),
    "intt_channels_cuda": (tkern, "intt_channels_ref", [(3, 2, 64)]),
    "decompose_cuda": (tcrt, "decompose_ref", [(2, 3)]),
    "compose_cuda": (tcrt, "compose_ref", [(3, 2)]),
    "flash_attention_cuda": (tattn, "flash_attention_ref", [(1, 4, 2, 32), (1, 6, 1, 32),
                                                            (1, 6, 1, 32)]),
}
OPERAND_DTYPE = {"flash_attention_cuda": torch.bfloat16}  # the others take int64
SOURCE = {"flash_attention_cuda": "attention"}  # the others: the wrapper's name less _cuda


def _operands(name, make):
    return [make(shape, dtype=OPERAND_DTYPE.get(name, torch.int64))
            for shape in WRAPPERS[name][2]]


def _launch_counts():
    return {name: getattr(mod, name).launches for name, (mod, _, _) in WRAPPERS.items()}


def _call_wrapper(name, operands, p):
    mod = WRAPPERS[name][0]
    extra = {
        "fused_polymul_cuda": (p.tables,), "ntt_channels_cuda": (p.tables,),
        "intt_channels_cuda": (p.tables,), "fused_e2e_polymul_cuda": (p.tables, p.plan),
        "fused_e2e_polymul_fs_cuda": (p.tables, p.plan),
        "decompose_cuda": (p.plan,), "compose_cuda": (p.plan,), "flash_attention_cuda": (),
    }[name]
    return getattr(mod, name)(*operands, *extra)


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_cuda_tensors_never_reach_the_plain_version(monkeypatch, kernel):
    """On a CUDA tensor a wrapper loads and launches its kernel or raises;
    the loader's error propagates, and the plain version is never run."""

    class LoaderCalled(RuntimeError):
        pass

    def loader(*args, **kwargs):
        raise LoaderCalled(args[0])

    def plain(*args, **kwargs):
        raise AssertionError("plain version reached for a CUDA tensor")

    monkeypatch.setattr(_build, "load", loader)
    for mod, ref, _ in WRAPPERS.values():
        monkeypatch.setattr(mod, ref, plain)
    p = repro_torch.plan(64, 3, 30, device="cpu").params
    before = _launch_counts()
    operands = [_FakeCudaTensor(x) for x in _operands(kernel, torch.zeros)]
    with pytest.raises(LoaderCalled, match=SOURCE.get(kernel, kernel.removesuffix("_cuda"))):
        _call_wrapper(kernel, operands, p)
    assert _launch_counts() == before


def test_cpu_calls_do_not_count_as_launches():
    before = _launch_counts()
    z = torch.zeros((1, 64, 3), dtype=torch.int64)
    r = torch.zeros((3, 1, 64), dtype=torch.int64)
    for backend in PORT_BACKENDS[1:]:
        p = repro_torch.plan(64, 3, 30, backend=backend, device="cpu")
        repro_torch.polymul(p, z, z)
        repro_torch.negacyclic_mul(p, r, r)
        repro_torch.compose(p, repro_torch.decompose(p, z))
        repro_torch.intt(p, repro_torch.ntt(p, r))
    tattn.flash_attention(*_operands("flash_attention_cuda", torch.ones))
    for name in WRAPPERS:
        _call_wrapper(name, _operands(name, torch.zeros), p.params)
    assert _launch_counts() == before
