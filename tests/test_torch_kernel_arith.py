"""The arithmetic and schedule of the port's CUDA kernels K1 (the fused
cascade, ``csrc/fused_polymul.cu``), K2 (the fused e2e multiplier,
``csrc/fused_e2e_polymul.cu``), K3 (the forward NTT,
``csrc/ntt_channels.cu``), K4 (the inverse NTT, ``csrc/intt_channels.cu``),
K5 (decompose, ``csrc/decompose.cu``) and K6 (compose,
``csrc/compose.cu``), emulated on the CPU and held against the port's
int64 lane ops (``repro_torch.core.modmath``), the JAX package's
(``repro.core.modmath``) and the plain versions.

The kernels run only on the card (``tests/test_torch_cuda.py``).  Here
numpy uint64 lanes masked to 32 bits repeat, operation for operation,
what ``csrc/parentt.cuh`` computes: the 32-bit butterflies (``__umulhi``
Shoup quotient at v = 30, one 32x32->64 product at v <= 29, block-Barrett
products at v = 31 with the constant K1, K3 and K4 derive from q and K2
takes from the plan), the 32-bit Barrett of the residue products, the
SAU Barrett and the block-product Barrett of the decompose and of K6's
y = r q~, the Eq-10 tail from a double quotient that K2 and K6 run, and
the register passes that K1-K4 run over their padded shared-memory
layout.  The cluster's ownership of channels and coefficients is checked
on the host helpers the wrapper launches with.

    python -m pytest -q tests/test_torch_kernel_arith.py
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import modmath as jmod
from repro_torch.core import bigint as tbigint
from repro_torch.core import modmath as tmod
from repro_torch.core.ntt import four_step_row_indices as tntt_row_indices
from repro_torch.core import primes as tprimes
from repro_torch.core import rns as trns
from repro_torch.core.params import make_params
from repro_torch.kernels import crt as tcrt
from repro_torch.kernels import ntt as tkern

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

M32 = np.uint64(0xFFFFFFFF)
LAZY, REM = tkern.MODE_LAZY, tkern.MODE_REM
SEED = 15


def U(x):
    return np.asarray(x, dtype=np.uint64)


def sh(k):
    return np.uint64(k)


class Regime:
    """A table set's reduction constants as uint64 lanes shaped (t, 1, 1)."""

    def __init__(self, tables):
        self.mode, self.window, self.beta, self.s1, self.s2 = tkern.reduction_mode(tables)
        col = lambda a: U(a).reshape(-1, 1, 1)
        self.q = col(tables.qs)
        self.half = col(tables.half)
        self.eps = col(tables.mul_eps if tables.mul_eps is not None else tables.qs)
        # strict v = 31 products: the block Barrett (m, s1) that K1, K3 and K4
        # derive in channel_reduce (K2 takes the same m from RnsPlan.dec_d)
        self.block_m = None
        if self.mode == REM:
            consts = [kernel_block_barrett(int(q)) for q in tables.qs]
            self.block_m = (col([m for m, _ in consts]), consts[0][1])
            assert all(s1 == consts[0][1] for _, s1 in consts)


def kernel_block_barrett(q: int) -> tuple[int, int]:
    """(m, s1) as csrc/parentt.cuh ``channel_reduce`` derives them from q
    under kRem: b = 32 - clz(q), m = floor(2^(b+31) / q), s1 = b - 1."""
    clz = 32 - int(q).bit_length()  # __clz of the 32-bit word q
    b = 32 - clz
    return (1 << (b + 31)) // int(q), b - 1


# --------------------------------------------------------------------------
# the device functions of csrc/parentt.cuh on uint64 lanes, 32-bit wrapping
# --------------------------------------------------------------------------


def cond_sub(x, m):
    return np.where(x >= m, x - m, x)


def mul_mod(x, y, r):
    p = x * y
    if r.mode == REM:
        return block_barrett(p, r.q, *r.block_m)
    qhat = ((((p >> sh(r.s1)) & M32) * (r.eps & M32)) >> sh(r.s2)) & M32
    rem = (p - qhat * r.q) & M32
    for _ in range(3):
        rem = cond_sub(rem, r.q)
    return rem


def shoup_mul(v, w, ws, r):
    qhat = (v * ws) >> sh(32) if r.window == 2 else ((v * ws) >> sh(r.beta)) & M32
    return (v * w - qhat * r.q) & M32


def div2(x, r):
    return ((x >> sh(1)) + (x & sh(1)) * r.half) & M32


def ct(u, v, w, ws, r):
    if r.mode == LAZY:
        t = shoup_mul(v, w, ws, r)
        q2 = 2 * r.q
        if r.window == 4:
            uu = cond_sub(u, q2)
            return (uu + t) & M32, (uu - t + q2) & M32
        return cond_sub((u + t) & M32, q2), cond_sub((u - t + q2) & M32, q2)
    p = mul_mod(v, w, r)
    return cond_sub((u + p) & M32, r.q), np.where(u >= p, u - p, (u - p + r.q) & M32)


def gs(u, v, w, ws, r):
    if r.mode == LAZY:
        wq = (r.window * r.q) & M32
        s = cond_sub((u + v) & M32, wq)
        d = shoup_mul(cond_sub((u - v + wq) & M32, wq), w, ws, r)
        return div2(s, r), div2(d, r)
    s = cond_sub((u + v) & M32, r.q)
    d = mul_mod(np.where(u >= v, u - v, (u - v + r.q) & M32), w, r)
    return div2(s, r), div2(d, r)


def canonicalize(x, r):
    if r.mode != LAZY:
        return x
    if r.window == 4:
        x = cond_sub(x, 2 * r.q)
    return cond_sub(x, r.q)


# --------------------------------------------------------------------------
# 32-bit butterflies and products against the int64 lane ops
# --------------------------------------------------------------------------

BUTTERFLY_PRESETS = [(n, v) for n in (64, 256, 4096) for v in (29, 30, 31)]


def _lane_pairs(r, n, rng, domain):
    """(u, v) lanes (t, n, 6): the edges 0 and domain - 1 in all four
    pairings, then seeded random values below ``domain`` (t, 1, 1)."""
    t = r.q.shape[0]
    top = domain - 1
    zero = np.zeros((t, n, 1), dtype=np.uint64)
    hi = np.broadcast_to(top, (t, n, 1))
    rand = lambda: U(rng.integers(0, 1 << 62, size=(t, n, 2), dtype=np.int64)) % domain
    u = np.concatenate([zero, hi, zero, hi, rand()], axis=-1)
    v = np.concatenate([zero, zero, hi, hi, rand()], axis=-1)
    return u, v


def _torch(x):
    return torch.as_tensor(np.asarray(x, dtype=np.int64))


def _jax(x):
    return jnp.asarray(np.asarray(x, dtype=np.int64))


def _int64(x):
    return np.asarray(x, dtype=np.int64)


@pytest.mark.parametrize("n,v", BUTTERFLY_PRESETS)
def test_butterflies_32bit_match_int64_lane_ops(n, v):
    """Every twiddle of the n-point tables at v = 29 (W = 4), 30 (W = 2)
    and 31 (strict, block-Barrett products), each with the edge values 0
    and W q - 1 (q - 1 strict) and seeded random values: the kernels'
    32-bit CT and GS butterflies equal the port's and the JAX package's
    int64 ones."""
    tables = make_params(n, 3, v).tables
    r = Regime(tables)
    rng = np.random.default_rng(SEED + n + v)
    domain = r.q * (r.window if r.mode == LAZY else 1)
    u, x = _lane_pairs(r, n, rng, domain)
    q64 = _int64(r.q)
    for tab, tab_sh, kernel_fly in (
        (tables.fwd, tables.fwd_shoup, ct),
        (tables.inv, tables.inv_shoup, gs),
    ):
        w = U(tab)[:, :, None]
        ws = U(tab_sh)[:, :, None] if tab_sh is not None else np.zeros_like(w)
        got = [_int64(y) for y in kernel_fly(u, x, w, ws, r)]
        if r.mode == LAZY:
            if kernel_fly is ct:
                tw = tmod.lazy_ct_butterfly(_torch(u), _torch(x), _torch(w), _torch(ws),
                                            _torch(q64), beta=r.beta, window=r.window)
                jw = jmod.lazy_ct_butterfly(_jax(u), _jax(x), _jax(w), _jax(ws), _jax(q64),
                                            beta=r.beta, window=r.window)
            else:
                tw = tmod.lazy_gs_butterfly(_torch(u), _torch(x), _torch(w), _torch(ws),
                                            _torch(q64), _torch(_int64(r.half)),
                                            beta=r.beta, window=r.window)
                jw = jmod.lazy_gs_butterfly(_jax(u), _jax(x), _jax(w), _jax(ws), _jax(q64),
                                            _jax(_int64(r.half)), beta=r.beta, window=r.window)
        else:
            tw = _strict_fly(tmod, _torch, kernel_fly is ct, u, x, w, q64, r, tables)
            jw = _strict_fly(jmod, _jax, kernel_fly is ct, u, x, w, q64, r, tables)
        for g, a, b in zip(got, tw, jw):
            assert np.array_equal(g, a.numpy())
            assert np.array_equal(g, np.asarray(b))


def _strict_fly(mod, arr, forward, u, x, w, q64, r, tables):
    """The strict butterflies of kernels/ntt.py ``_butterflies`` on one
    package's lane ops."""
    eps = None if tables.mul_eps is None else arr(_int64(r.eps))
    q, u, x, w = arr(q64), arr(u), arr(x), arr(w)
    if forward:
        p = mod.mul_mod(x, w, q, eps, tables.mul_shifts)
        return mod.add_mod(u, p, q), mod.sub_mod(u, p, q)
    half = arr(_int64(r.half))
    s = mod.add_mod(u, x, q)
    d = mod.mul_mod(mod.sub_mod(u, x, q), w, q, eps, tables.mul_shifts)
    return mod.div2_mod(s, half), mod.div2_mod(d, half)


@pytest.mark.parametrize("v", (29, 30, 31))
def test_products_and_canonicalize_32bit_match_int64_lane_ops(v):
    """The residue products (the pointwise product and y = p q~) on
    canonical values, (q - 1)^2 included, and the lazy exit canonicalize
    on [0, W q), as the kernels compute them in 32 bits."""
    tables = make_params(256, 3, v).tables
    r = Regime(tables)
    rng = np.random.default_rng(SEED + v)
    x, y = _lane_pairs(r, 256, rng, r.q)
    got = _int64(mul_mod(x, y, r))
    eps = None if tables.mul_eps is None else _int64(r.eps)
    want_t = tmod.mul_mod(_torch(x), _torch(y), _torch(_int64(r.q)),
                          None if eps is None else _torch(eps), tables.mul_shifts)
    want_j = jmod.mul_mod(_jax(x), _jax(y), _jax(_int64(r.q)),
                          None if eps is None else _jax(eps), tables.mul_shifts)
    assert np.array_equal(got, want_t.numpy())
    assert np.array_equal(got, np.asarray(want_j))
    assert np.array_equal(got, _int64((x * y) % r.q))
    if r.mode == LAZY:
        z, _ = _lane_pairs(r, 256, rng, r.window * r.q)
        got = _int64(canonicalize(z, r))
        assert np.array_equal(got, tmod.canonicalize(_torch(z), _torch(_int64(r.q)),
                                                     r.window).numpy())
        assert np.array_equal(got, np.asarray(jmod.canonicalize(_jax(z), _jax(_int64(r.q)),
                                                                r.window)))


# --------------------------------------------------------------------------
# the decompose reductions
# --------------------------------------------------------------------------

DEC_PRESETS = [(64, 3, 29), (64, 3, 30), (64, 3, 31), (256, 6, 30), (4096, 6, 30)]


def _remainder(x, qhat, q, narrow, subs):
    """x - qhat q and ``subs`` conditional subtractions, in 32-bit words
    when ``narrow`` (wrapping mod 2^32), else in 64-bit words."""
    r = ((x & M32) - ((qhat * q) & M32)) & M32 if narrow else x - qhat * q
    for _ in range(subs):
        r = cond_sub(r, q)
    return r


def block_barrett(x, q, m, s1, narrow=False):
    """parentt.cuh ``block_barrett`` on uint64 lanes."""
    qhat = (((x >> sh(s1)) & M32) * (m & M32)) >> sh(32)
    return _remainder(x, qhat, q, narrow, 2)


def sau_barrett(x, q, eps, s1, s2, narrow=False):
    """parentt.cuh ``sau_barrett`` on non-negative int64 lanes."""
    qhat = ((((U(x) >> sh(s1)) & M32) * U(eps & 0xFFFFFFFF)) >> sh(s2)) & M32
    return _remainder(U(x), qhat, U(q), narrow, 3).astype(np.int64)


def _narrow_modes(q):
    """The remainder widths a kernel may use for q: 32-bit below 2^30."""
    return (False, True) if int(q).bit_length() <= 30 else (False,)


@pytest.mark.parametrize("n,t,v", DEC_PRESETS)
def test_block_barrett_equals_remainder(n, t, v):
    """The block-product Barrett that replaces the 64-bit % of K5's block
    products and of K1-K4's strict residue products is x mod q on (q - 1)^2, on every block constant times seeded residues,
    on seeded values below 2^(2b) and at 2^(2b) - 1, for every channel."""
    plan = make_params(n, t, v).plan
    block_m = plan.dec_d["block_m"].numpy()
    rng = np.random.default_rng(SEED + n + t + v)
    for c, ch in enumerate(plan.dec):
        q, s1 = ch.qi, ch.acc_barrett[1]
        m = int(block_m[c])
        assert m == trns.block_barrett_constant(q, s1) and m < 1 << 32
        b = q.bit_length()
        blk = rng.integers(0, q, size=64, dtype=np.int64)
        xs = [(q - 1) ** 2, 0, q, q * q - 1 if q * q - 1 < 1 << (2 * b) else 0, (1 << (2 * b)) - 1]
        xs += [int(k) * int(bc) for bc in ch.block_consts for k in blk]
        xs += [int(x) for x in rng.integers(0, 1 << (2 * b), size=256, dtype=np.uint64)]
        x = U(xs)
        for narrow in _narrow_modes(q):
            assert np.array_equal(block_barrett(x, U(q), U(m), s1, narrow), x % U(q))


@pytest.mark.parametrize("n,t,v", DEC_PRESETS)
def test_sau_barrett_32bit_quotient_matches_int64(n, t, v):
    """The SAU words' Barrett with its quotient from one 32x32->64 product
    equals the int64 ``barrett_reduce`` of both packages on seeded words
    below 2^c and at 2^c - 1 (the window the constants are made for)."""
    plan = make_params(n, t, v).plan
    rng = np.random.default_rng(SEED + 2 * n + t + v)
    for ch in plan.dec:
        q = ch.qi
        for eps, s1, s2 in (ch.sau_barrett, ch.acc_barrett):
            c = s1 + s2
            x = np.concatenate([rng.integers(0, 1 << c, size=512, dtype=np.int64),
                                np.array([0, q, (1 << c) - 1], dtype=np.int64)])
            want = tmod.barrett_reduce(torch.as_tensor(x), q, eps, s1, s2).numpy()
            assert np.array_equal(want, np.asarray(jmod.barrett_reduce(jnp.asarray(x), q, eps,
                                                                       s1, s2)))
            for narrow in _narrow_modes(q):
                assert np.array_equal(sau_barrett(x, q, eps, s1, s2, narrow), want)


def decompose_emulated(z: np.ndarray, plan, narrow: bool) -> np.ndarray:
    """parentt.cuh ``decompose`` for every channel on (N, S) int64
    segments: the SAU network as one product by beta (mod 2^64), the
    Barretts with 32-bit quotients, remainders 32-bit when ``narrow``, and
    the Alg-2 blocks by Horner from the most significant one down, acc =
    block_barrett(acc * [beta^t']_q) + blk with one conditional
    subtraction, canonical after every block."""
    a = {k: x.numpy() for k, x in plan.dec_d.items()}
    S, tp = plan.seg_count, plan.t_prime
    s1 = plan.dec[0].acc_barrett[1]
    outs = []
    for c in range(plan.t):
        q = plan.dec[c].qi
        eps, s2 = int(a["sau_eps"][c]), int(a["sau_s2"][c])
        assert int(a["beta"][c]) == sum(s << e for e, s in plan.dec[c].beta_terms) - 1
        horner = int(a["horner"][c])
        assert horner == (pow(1 << plan.v, tp, q) if plan.n_blocks > 1 else 0)
        m = U(int(a["block_m"][c]))

        def sau(x):
            return (U(x) * U(int(a["beta"][c]))).astype(np.int64)

        acc = np.zeros(z.shape[0], dtype=np.int64)
        for rho in range(plan.n_blocks - 1, -1, -1):
            base = rho * tp
            blk = z[:, base].copy()
            if tp > 1 and base + 1 < S:
                blk = blk + sau(z[:, base + 1])
            for k in range(2, tp):
                if base + k >= S:
                    break
                x = sau_barrett(sau(z[:, base + k]), q, eps, s1, s2, narrow)
                for _ in range(k - 1):
                    x = sau_barrett(sau(x), q, eps, s1, s2, narrow)
                blk = blk + x
            blk = sau_barrett(blk, q, eps, s1, s2, narrow)
            assert (blk < q).all()
            if rho < plan.n_blocks - 1:
                step = block_barrett(U(acc) * U(horner), U(q), m, s1, narrow).astype(np.int64)
                blk = blk + step
                blk = np.where(blk >= q, blk - q, blk)
            acc = blk
        outs.append(acc)
    return np.stack(outs)


def _segments(plan, shape, rng):
    z = rng.integers(0, 1 << plan.v, size=shape + (plan.seg_count,), dtype=np.int64)
    z[..., -1] = rng.integers(0, plan.q >> (plan.v * (plan.seg_count - 1)), size=shape)
    return z


# past six Alg-2 blocks (the most the kernels' circuit table held): 10, 14
# and, past the accumulator Barrett's old window of 16, 20 and 34 blocks
DEC_WIDE = [(64, 30, 30), (64, 40, 31), (64, 60, 30), (64, 100, 29)]


@pytest.mark.parametrize("n,t,v", DEC_PRESETS + DEC_WIDE)
def test_decompose_emulation_matches_plain_version(n, t, v):
    """K5's per-coefficient arithmetic (and K2's first step) on seeded
    segments, the all-zero and the all-ones segment, equals decompose_ref,
    and both equal the residues of the segments' integers, also past six
    Alg-2 blocks (Horner in the kernels, the widened accumulator window in
    the plain version)."""
    plan = make_params(n, t, v).plan
    rng = np.random.default_rng(SEED + 3 * n + v)
    z = _segments(plan, (64 if t > 16 else 200,), rng)
    z[0] = 0
    z[1, :-1] = (1 << v) - 1
    want = tcrt.decompose_ref(torch.as_tensor(z), plan).numpy()
    for narrow in (False, True) if tcrt.narrow_moduli(plan) else (False,):
        assert np.array_equal(decompose_emulated(z, plan, narrow), want)
    values = tbigint.limbs_to_ints(z, v)
    assert want.T.tolist() == [[x % int(q) for q in plan.qs] for x in values]


# --------------------------------------------------------------------------
# K2: the cluster layout and the register passes of the cascade
# --------------------------------------------------------------------------


@pytest.mark.parametrize("t", (3, 4, 6, 9, 15, 30, 48))
def test_cluster_covers_every_coefficient_and_channel_once(t):
    cluster, slots = tkern.e2e_cluster(t)
    assert cluster == min(t, 8) and slots == -(-t // cluster)
    owned = [list(tkern.e2e_channels(t, cluster, r)) for r in range(cluster)]
    assert sorted(c for cs in owned for c in cs) == list(range(t))
    assert all(1 <= len(cs) <= slots for cs in owned)
    for log_n in range(6, 14):
        n = 1 << log_n
        slices = [tkern.e2e_slice(n, cluster, r) for r in range(cluster)]
        assert [j for s in slices for j in s] == list(range(n))
        assert max(len(s) for s in slices) - min(len(s) for s in slices) <= 1


def pad(i):
    return i + (i >> 4)


def passes_emulated(a, b, tables, kernel, tilde=None):
    """The register passes of csrc/parentt.cuh for every channel and row at
    once, as ``kernel`` runs them on (t, rows, n) canonical residues:
    "e2e" (K2 ``channel_cascade``: y = p q~ mod q), "cascade" (K1: the
    product, canonical), "forward" (K3: the forward passes of ``a``
    alone, canonical spectra) or "inverse" (K4: the inverse passes of
    ``a`` alone from s0 = 0, the first from device memory, the last
    canonical to device memory), in groups of G stages a thread over the
    padded shared layout.  Each pass checks that its pass_threads(n)
    threads hold every element once, that the passes that write device
    memory, and all but K4's first that read it, do so coalesced, and that
    K4's first pass reads 2^G contiguous words a thread."""
    r = Regime(tables)
    t, rows, n = a.shape
    log_n = n.bit_length() - 1
    threads, K = tkern.pass_threads(n), tkern.pass_group(n)
    passes = -(-log_n // K)
    g0 = log_n - K * (passes - 1)
    assert 1 <= K <= 3 and passes >= 2 and 1 <= g0 <= K
    ps = tkern.padded_words(n)
    A = np.zeros((t, rows, ps), dtype=np.uint64)
    B = np.zeros_like(A)
    A[..., pad(np.arange(n))] = U(a)
    if b is not None:
        B[..., pad(np.arange(n))] = U(b)
    fwd, inv = U(tables.fwd), U(tables.inv)
    fsh = U(tables.fwd_shoup) if tables.fwd_shoup is not None else np.zeros_like(fwd)
    ish = U(tables.inv_shoup) if tables.inv_shoup is not None else np.zeros_like(inv)
    tw = lambda tab, idx: np.take_along_axis(tab, idx[None, :].repeat(t, 0), 1)[:, None, :]

    def ct_group(xs, G, hi, s0):
        for j in range(G):
            half = 1 << (G - 1 - j)
            for blk in range(1 << j):
                idx = (1 << (s0 + j)) + (hi << j) + blk
                w, ws = tw(fwd, idx), tw(fsh, idx)
                for k in range(half):
                    m = blk * 2 * half + k
                    for x in xs:
                        x[m], x[m + half] = ct(x[m], x[m + half], w, ws, r)

    def gs_group(x, G, hi, s0):
        for j in range(G):
            half = 1 << j
            for blk in range(1 << (G - 1 - j)):
                idx = (1 << (log_n - 1 - s0 - j)) + (hi << (G - 1 - j)) + blk
                w, ws = tw(inv, idx), tw(ish, idx)
                for k in range(half):
                    m = blk * 2 * half + k
                    x[m], x[m + half] = gs(x[m], x[m + half], w, ws, r)

    def elements(G, log_st):
        """(hi, unpadded element indices per m) of groups p = 0 .. n/2^G - 1,
        which the kernel's loop hands out as p = tid, tid + threads, ..."""
        p = np.arange(n >> G)
        assert len(p) >= threads  # every thread has a group in every pass
        hi = p >> log_st
        base = (hi << (log_st + G)) + (p & ((1 << log_st) - 1))
        idx = [base + (m << log_st) for m in range(1 << G)]
        assert np.array_equal(np.sort(np.concatenate(idx)), np.arange(n))
        return hi, idx

    def load(polys, idx):
        return [[P[..., pad(i)] for i in idx] for P in polys]

    def store(polys, idx, values):
        for P, xs in zip(polys, values):
            for i, x in zip(idx, xs):
                P[..., pad(i)] = x

    def coalesced(idx, stride):  # thread p's m-th element is p + m * stride
        p = np.arange(n // len(idx))
        assert all(np.array_equal(i, p + m * stride) for m, i in enumerate(idx))

    if kernel == "inverse":
        s0 = 0
        for q in range(passes):
            G = K if q + 1 < passes else g0
            hi, idx = elements(G, s0)
            if q == 0:  # DevicePolys: thread p reads words p 2^G .. p 2^G + 2^G - 1
                assert all(np.array_equal(i, (np.arange(n >> G) << G) + m)
                           for m, i in enumerate(idx))
            (x,) = load((A,), idx)
            gs_group(x, G, hi, s0)
            if q + 1 == passes:  # DeviceOut: stored canonical to device memory
                coalesced(idx, 1 << s0)
                x = [canonicalize(v, r) for v in x]
            store((A,), idx, [x])
            s0 += G
        return _int64(A[..., pad(np.arange(n))])
    polys = (A,) if kernel == "forward" else (A, B)
    s0 = 0
    forward = passes if kernel == "forward" else passes - 1
    for q in range(forward):
        G = g0 if q == 0 else K
        hi, idx = elements(G, log_n - s0 - G)
        if q == 0:
            coalesced(idx, 1 << (log_n - G))  # DevicePolys: read from device memory
        if kernel == "forward" and q == forward - 1:
            assert all(np.array_equal(i, (np.arange(n >> G) << G) + m) for m, i in enumerate(idx))
        xs = load(polys, idx)
        ct_group(xs, G, hi, s0)
        store(polys, idx, xs)
        s0 += G
    if kernel == "forward":
        return _int64(canonicalize(A[..., pad(np.arange(n))], r))
    hi, idx = elements(K, 0)  # middle pass
    (x, y) = load(polys, idx)
    ct_group((x, y), K, hi, log_n - K)
    x = [mul_mod(canonicalize(x[m], r), canonicalize(y[m], r), r) for m in range(1 << K)]
    gs_group(x, K, hi, 0)
    store((A,), idx, [x])
    s0 = K
    for q in range(passes - 2, -1, -1):  # inverse passes
        G = g0 if q == 0 else K
        hi, idx = elements(G, s0)
        (x,) = load((A,), idx)
        gs_group(x, G, hi, s0)
        if q == 0:
            coalesced(idx, 1 << s0)
            if kernel == "e2e":
                x = [mul_mod(canonicalize(v, r), U(tilde).reshape(-1, 1, 1), r) for v in x]
            else:  # DeviceOut: stored canonical to device memory
                x = [canonicalize(v, r) for v in x]
        store((A,), idx, [x])
        s0 += G
    return _int64(A[..., pad(np.arange(n))])


CASCADE_PRESETS = [(64, 3, 29), (64, 3, 30), (64, 3, 31), (256, 6, 30), (4096, 6, 30),
                   (8192, 6, 30), (16384, 3, 30)]


@pytest.mark.parametrize("n,t,v", CASCADE_PRESETS)
def test_e2e_register_passes_match_plain_cascade(n, t, v):
    """K2's pass schedule (groups of G <= 3 stages per trip through its
    padded shared memory, the last forward and first inverse pass fused
    around the pointwise product, y = p q~ in the last pass) equals the
    plain cascade followed by the q~ product, in every regime."""
    p = make_params(n, t, v)
    rows = 1 if n >= 4096 else 2
    rng = np.random.default_rng(SEED + n + t + v)
    qs = p.qs[:, None, None]
    a = rng.integers(0, 1 << 62, size=(t, rows, n), dtype=np.int64) % qs
    b = rng.integers(0, 1 << 62, size=(t, rows, n), dtype=np.int64) % qs
    got = passes_emulated(a, b, p.tables, "e2e", p.plan.qi_tilde)
    prod = tkern.fused_polymul_ref(torch.as_tensor(a), torch.as_tensor(b), p.tables)
    q, _, eps = tkern.channel_scalars(p.tables, 3)
    want = tmod.mul_mod(prod, p.plan.qi_tilde_d.view(t, 1, 1), q, eps, p.tables.mul_shifts)
    assert np.array_equal(got, want.numpy())


# K1 and K3 at the presets above and where G and g0 are smallest
# (n = 4: one stage a pass, two threads; n = 8: three passes of one stage)
PASS_PRESETS = CASCADE_PRESETS + [(n, 3, v) for n in (4, 8) for v in (29, 30, 31)]


@pytest.mark.parametrize("n,t,v", PASS_PRESETS)
def test_cascade_and_forward_register_passes_match_plain_versions(n, t, v):
    """K1's schedule (the first forward pass from device memory, the
    middle pass, the last inverse pass canonical to device memory) equals
    fused_polymul_ref, and K3's (forward passes of one operand, the last
    over contiguous elements, canonical out) equals ntt_channels_ref, in
    the regime of each preset, at the kernels' thread counts."""
    p = make_params(n, t, v)
    rows = 1 if n >= 4096 else 2
    rng = np.random.default_rng(SEED + 11 * n + t + v)
    qs = p.qs[:, None, None]
    a = rng.integers(0, 1 << 62, size=(t, rows, n), dtype=np.int64) % qs
    b = rng.integers(0, 1 << 62, size=(t, rows, n), dtype=np.int64) % qs
    a[:, 0, :2] = qs[:, 0] - 1  # the largest canonical residue
    T = torch.as_tensor
    assert np.array_equal(passes_emulated(a, b, p.tables, "cascade"),
                          tkern.fused_polymul_ref(T(a), T(b), p.tables).numpy())
    assert np.array_equal(passes_emulated(a, None, p.tables, "forward"),
                          tkern.ntt_channels_ref(T(a), p.tables).numpy())


@pytest.mark.parametrize("n,t,v", PASS_PRESETS)
def test_inverse_register_passes_match_plain_version(n, t, v):
    """K4's schedule (inverse passes of K stages from s0 = 0, the first
    read from device memory, the last of g0 stages canonical to device
    memory, coalesced) equals intt_channels_ref on canonical bit-reversed spectra with 0 and
    q - 1 among them, in the regime of each preset, at the kernel's
    thread count."""
    p = make_params(n, t, v)
    rows = 1 if n >= 4096 else 2
    rng = np.random.default_rng(SEED + 13 * n + t + v)
    qs = p.qs[:, None, None]
    a = rng.integers(0, 1 << 62, size=(t, rows, n), dtype=np.int64) % qs
    a[:, 0, :2] = qs[:, 0] - 1
    a[:, -1, -2:] = 0
    assert np.array_equal(passes_emulated(a, None, p.tables, "inverse"),
                          tkern.intt_channels_ref(torch.as_tensor(a), p.tables).numpy())


# --------------------------------------------------------------------------
# the multi-block kernels K1-fs, K3-fs, K4-fs (csrc/*_fs.cu, parentt.cuh
# "Multi-block transforms")
# --------------------------------------------------------------------------


def fs_geometry(n, cluster=None):
    """(log n1, log n2, E, log C, blocks a polynomial, K) as the kernels
    derive them (parentt.cuh fs_stream_geom, and cluster_cascade with a cluster of
    ``cluster`` CTAs, E = n / cluster), checked against the host helpers:
    a column CTA takes n1 rows x E / n1 = 2^(log C) adjacent columns, a row
    CTA (or the same CTA of the cluster, in the row phase) E / n2 whole
    rows."""
    L = n.bit_length() - 1
    log_n2 = (L + 1) // 2
    log_n1 = L - log_n2
    assert tkern.fs_split(n) == (1 << log_n1, 1 << log_n2)
    if cluster is None:  # K3-fs, K4-fs: 4096-element tiles
        log_e = min(L, 12)
        assert tkern.fs_tile(n) == 1 << log_e
        # the stream's consumers; a pass's groups spread over them, whatever n
        assert tkern.fs_threads(n) == tkern.FS_STREAM_THREADS >= tkern.pass_threads(1 << log_e)
    else:  # the cluster cascade (K1-fs, K2-fs past one CTA): n / C elements a CTA
        assert cluster & (cluster - 1) == 0 and 2 <= cluster <= 1 << log_n1
        log_e = L - (cluster.bit_length() - 1)
        assert tkern.cascade_fs_threads(n, cluster) == tkern.pass_threads(1 << log_e)
        assert tkern.cascade_fs_smem_bytes(n, cluster) == 3 * tkern.padded_words(1 << log_e) * 4
    E = 1 << log_e
    return log_n1, log_n2, E, log_e - log_n1, n // E, tkern.pass_group(E)


def fs_passes(begin, end, K, inverse):
    """(s0, G) of each pass of forward_stages / inverse_stages: passes of K
    stages after a first of g0 (forward) or before a last of g0 (inverse)."""
    passes = -(-(end - begin) // K)
    g0 = end - begin - K * (passes - 1)
    out, s0 = [], begin
    for q in range(passes):
        G = (K if q + 1 < passes else g0) if inverse else (g0 if q == 0 else K)
        out.append((s0, G))
        s0 += G
    assert s0 == end
    return out


def fs_emulated(a, b, tables, kernel, e2e=None, cluster=None):
    """K3-fs ("forward"), K4-fs ("inverse") or K1-fs ("cascade") on (t,
    rows, n) canonical residues, as the kernels run them: the column CTAs'
    virtual length-E polynomials (v = r C + cc, gathered through the
    kernels' ColMap), the row CTAs' spans of E / n2 whole rows, passes of
    G stages (at most 3; K3-fs's tiles 4) over their groups p0 .. p1 - 1
    with the kernels' twiddle indices, and 32-bit values below W q (q when
    strict) between the column and the row stages.  Every pass's groups of
    a CTA's span hold each of its elements once.  K3-fs and K4-fs run
    4096-element tiles, the values in a scratch tensor between a
    polynomial's column and row tiles (the order of the tiles of different
    polynomials, tests/test_torch_fs_stream.py, changes none); K1-fs
    is one cluster of ``cluster`` CTAs a (channel, row) (default
    fs_cluster(n)), E = n / C elements of each operand a CTA: its column
    blocks are the virtual polynomials, its row blocks the spans, and the
    two DSMEM transposes between them are the moves from one to the other
    (tests/test_torch_fs_cluster.py checks their index maps).

    K2-fs ("e2e", ``e2e`` = (za, zb, plan), segments (rows, n, S)): its
    three launches, the decompose of both operands (parentt.cuh
    ``decompose`` per coefficient and channel) to 32-bit words, the
    cascade with y = canonical(p) q~ mod q stored (K1's register passes
    where one CTA holds a pair, else K1-fs's cluster), and the quotient
    compose on the y words.  Returns (rows, n, L) limbs."""
    r = Regime(tables)
    if kernel == "e2e":
        za, zb, plan = e2e
        t, (rows, n) = tables.t, za.shape[:2]
        narrow = tcrt.narrow_moduli(plan)
        ra, rb = (decompose_emulated(z.reshape(-1, plan.seg_count), plan, narrow)
                  .reshape(t, rows, n) for z in (za, zb))
        assert (ra < U(plan.qs).reshape(-1, 1, 1)).all()  # canonical 32-bit words
        if tkern.cascade_fits(n):
            y = passes_emulated(ra, rb, tables, "e2e", plan.qi_tilde)
        else:
            y = fs_emulated(ra, rb, tables, "cascade", cluster=cluster, e2e=plan)
        return compose_quotient_emulated(y.reshape(t, -1), plan).reshape(rows, n, plan.L)
    t, rows, n = a.shape
    cascade = kernel == "cascade"
    if cascade:
        cluster = cluster or tkern.fs_cluster(n)
    L = n.bit_length() - 1
    log_n1, log_n2, E, log_c, tiles, K = fs_geometry(n, cluster if cascade else None)
    if not cascade:  # the tile streams' passes: K3-fs four stages, K4-fs three
        K = tkern.FS_STREAM_GROUP["ntt_channels_fs" if kernel == "forward" else "intt_channels_fs"]
    log_e = E.bit_length() - 1
    # ColMap: column block blk's virtual element v -> x = r n2 + c0 + cc
    v = np.arange(E)
    colmap = (((v >> log_c) << log_n2)[None, :] + (np.arange(tiles) << log_c)[:, None]
              + (v & ((1 << log_c) - 1)))
    assert np.array_equal(np.sort(colmap.ravel()), np.arange(n))
    assert E % (1 << log_n2) == 0  # a row CTA's span holds whole rows
    fwd, inv = U(tables.fwd), U(tables.inv)
    fsh = U(tables.fwd_shoup) if tables.fwd_shoup is not None else np.zeros_like(fwd)
    ish = U(tables.inv_shoup) if tables.inv_shoup is not None else np.zeros_like(inv)
    tw = lambda tab, idx: tab[:, idx][:, None, :]
    bound = r.window * r.q if r.mode == LAZY else r.q

    def groups(N, G, log_st, span):
        """(hi, element indices per m) of every group, the CTAs' spans of
        ``span`` elements taken together (p0 = x0 >> G, p1 = (x0 + span) >> G)."""
        p = np.arange(N >> G)
        hi = p >> log_st
        base = (hi << (log_st + G)) + (p & ((1 << log_st) - 1))
        idx = [base + (m << log_st) for m in range(1 << G)]
        assert all(np.array_equal(i // span, p // (span >> G)) for i in idx)
        assert np.array_equal(np.sort(np.concatenate(idx)), np.arange(N))
        return hi, idx

    def forward(X, begin, end, log_n, span):  # X: (t, R, N) uint64, in place
        for s0, G in fs_passes(begin, end, K, inverse=False):
            hi, idx = groups(X.shape[-1], G, log_n - s0 - G, span)
            xs = [X[..., i] for i in idx]
            for j in range(G):
                half = 1 << (G - 1 - j)
                for blk in range(1 << j):
                    ti = (1 << (s0 + j)) + (hi << j) + blk
                    for k in range(half):
                        m = blk * 2 * half + k
                        xs[m], xs[m + half] = ct(xs[m], xs[m + half], tw(fwd, ti), tw(fsh, ti), r)
            for i, x in zip(idx, xs):
                X[..., i] = x

    def inverse(X, begin, end, log_n, span):
        for s0, G in fs_passes(begin, end, K, inverse=True):
            hi, idx = groups(X.shape[-1], G, s0, span)
            xs = [X[..., i] for i in idx]
            for j in range(G):
                half = 1 << j
                for blk in range(1 << (G - 1 - j)):
                    ti = (1 << (log_n - 1 - s0 - j)) + (hi << (G - 1 - j)) + blk
                    for k in range(half):
                        m = blk * 2 * half + k
                        xs[m], xs[m + half] = gs(xs[m], xs[m + half], tw(inv, ti), tw(ish, ti), r)
            for i, x in zip(idx, xs):
                X[..., i] = x

    def middle(A, B, G, span):  # middle_span: last G forward, product, first G inverse
        p = np.arange(n >> G)
        assert np.array_equal((p << G) // span, p // (span >> G))
        x = [A[..., (p << G) + m] for m in range(1 << G)]
        y = [B[..., (p << G) + m] for m in range(1 << G)]
        for j in range(G):
            half = 1 << (G - 1 - j)
            for blk in range(1 << j):
                ti = (1 << (L - G + j)) + (p << j) + blk
                for k in range(half):
                    m = blk * 2 * half + k
                    for z in (x, y):
                        z[m], z[m + half] = ct(z[m], z[m + half], tw(fwd, ti), tw(fsh, ti), r)
        x = [mul_mod(canonicalize(x[m], r), canonicalize(y[m], r), r) for m in range(1 << G)]
        for j in range(G):
            half = 1 << j
            for blk in range(1 << (G - 1 - j)):
                ti = (1 << (L - 1 - j)) + (p << (G - 1 - j)) + blk
                for k in range(half):
                    m = blk * 2 * half + k
                    x[m], x[m + half] = gs(x[m], x[m + half], tw(inv, ti), tw(ish, ti), r)
        for m in range(1 << G):
            A[..., (p << G) + m] = x[m]

    def tiles_of(X):  # the column blocks' virtual polynomials, (t, rows * tiles, E)
        return X[..., colmap].reshape(t, rows * tiles, E)

    def untile(V):
        X = np.zeros((t, rows, n), dtype=np.uint64)
        X[..., colmap] = V.reshape(t, rows, tiles, E)
        return X

    def lazy(X):  # 32-bit words under the lazy window between the phases
        assert (X < bound).all() and (X <= M32).all()
        return X

    A = U(a).copy()
    if kernel == "inverse":
        inverse(A, 0, log_n2, L, E)  # rows
        V = tiles_of(lazy(A))
        inverse(V, log_c, log_e, log_e, E)  # columns, virtual stages log C ..
        return _int64(canonicalize(untile(V), r))
    polys = [A] if kernel == "forward" else [A, U(b).copy()]
    for i, P in enumerate(polys):  # forward columns, virtual stages 0 .. log n1 - 1
        V = tiles_of(P)
        forward(V, 0, log_n1, log_e, E)
        polys[i] = lazy(untile(V))  # K1-fs: the first transpose
    A = polys[0]
    if kernel == "forward":
        forward(A, log_n1, L, L, E)  # rows
        return _int64(canonicalize(A, r))
    B = polys[1]
    if log_n2 <= K:  # one row pass around the product
        middle(A, B, log_n2, E)
    else:
        forward(A, log_n1, L - K, L, E)
        forward(B, log_n1, L - K, L, E)
        middle(A, B, K, E)
        inverse(A, K, log_n2, L, E)
    V = tiles_of(lazy(A))  # the second transpose
    inverse(V, log_c, log_e, log_e, E)
    if e2e is not None:  # K2-fs's cascade: y = canonical(p) q~ mod q
        return _int64(untile(mul_mod(canonicalize(V, r), U(e2e.qi_tilde).reshape(-1, 1, 1), r)))
    return _int64(canonicalize(untile(V), r))


# the points chip_smoke.py holds the multi-block kernels at (FS_POINTS),
# and n = 4 and 8, where a launch is one pass and the row cascade one
# middle pass
FS_PRESETS = [(n, v) for n in (4, 8, 16, 256, 1024, 4096) for v in (29, 30, 31)] + [
    (16384, 30), (32768, 29), (65536, 30), (65536, 31)]


@pytest.mark.parametrize("n,v", FS_PRESETS)
def test_multi_block_passes_match_plain_versions(n, v):
    """K3-fs and K4-fs launch by launch, and K1-fs's cluster phase by phase,
    pass by pass with 32-bit values between the column and the row stages,
    equal their plain versions (the four-step plain PyTorch) and the
    radix-2 ones, in the regime of each point, with 0 and q - 1 among the
    inputs."""
    p = make_params(n, 2, v)
    rows = 1 if n >= 16384 else 2
    rng = np.random.default_rng(SEED + 17 * n + v)
    qs = p.qs[:, None, None]
    a = rng.integers(0, 1 << 62, size=(2, rows, n), dtype=np.int64) % qs
    b = rng.integers(0, 1 << 62, size=(2, rows, n), dtype=np.int64) % qs
    a[:, 0, :2] = qs[:, 0] - 1
    b[:, -1, -2:] = 0
    T = torch.as_tensor
    fwd = fs_emulated(a, None, p.tables, "forward")
    assert np.array_equal(fwd, tkern.ntt_channels_fs_ref(T(a), p.tables).numpy())
    assert np.array_equal(fwd, tkern.ntt_channels_ref(T(a), p.tables).numpy())
    back = fs_emulated(a, None, p.tables, "inverse")
    assert np.array_equal(back, tkern.intt_channels_fs_ref(T(a), p.tables).numpy())
    assert np.array_equal(back, tkern.intt_channels_ref(T(a), p.tables).numpy())
    prod = fs_emulated(a, b, p.tables, "cascade")
    assert np.array_equal(prod, tkern.fused_polymul_fs_ref(T(a), T(b), p.tables).numpy())
    assert np.array_equal(prod, tkern.fused_polymul_ref(T(a), T(b), p.tables).numpy())


def test_multi_block_row_twiddles_are_the_reference_row_tables():
    """The row CTAs read fwd[2^s + (x >> (L - s))] at row stage k = s - log
    n1 of element x = j n2 + c: the reference's twist-merged row table
    ``four_step_row_indices(n1, n2)`` at (2^k + (c >> (log n2 - k)), j),
    ((n1 + j) << k) + low, for the split the kernels choose at every n
    from 1024 to 65536."""
    for n in (1 << k for k in range(10, 17)):
        n1, n2 = tkern.fs_split(n)
        assert n1 * n2 == n and n1 <= n2 <= 2 * n1
        L, log_n1, log_n2 = n.bit_length() - 1, n1.bit_length() - 1, n2.bit_length() - 1
        idx = tntt_row_indices(n1, n2)
        j, c = np.divmod(np.arange(n), n2)
        for k in range(log_n2):
            s = log_n1 + k
            kernel = (1 << s) + (np.arange(n) >> (L - s))
            assert np.array_equal(kernel, idx[(1 << k) + (c >> (log_n2 - k)), j])
        assert tkern.fs_blocks(6, 16, n) * tkern.fs_tile(n) == 6 * 16 * n


# K2-fs where K1's one-CTA body runs its cascade (n = 16, 256, 1024; the
# cluster's, past one CTA, is in tests/test_torch_fs_cluster.py) at t = 3
# and 6 (one and two channel groups a decompose CTA) in the three
# regimes; and past t = 8: t = 9, 15, 30 (three, five and eight groups;
# L = 10, 16/17, 33/32)
E2E_FS_PRESETS = [(n, t, v) for n in (16, 256, 1024) for t in (3, 6) for v in (29, 30, 31)] + [
    (16, 9, 30), (256, 15, 29), (1024, 15, 31), (256, 30, 30)]


@pytest.mark.parametrize("n,t,v", E2E_FS_PRESETS)
def test_multi_block_e2e_matches_plain_versions(n, t, v):
    """K2-fs launch by launch (the decompose of both operands to 32-bit
    words, the cascade storing y = p q~, the quotient compose on the y
    words) equals its plain version and K2's, with the zero coefficient and
    q - 1 among the inputs."""
    p = make_params(n, t, v)
    rng = np.random.default_rng(SEED + 11 * n + t + v)
    za, zb = _segments(p.plan, (2, n), rng), _segments(p.plan, (2, n), rng)
    za[0, 0] = zb[0, 1] = 0
    za[1, 0] = zb[1, 0] = tbigint.ints_to_limbs([p.plan.q - 1], v, p.plan.seg_count)[0]
    got = fs_emulated(None, None, p.tables, "e2e", (za, zb, p.plan))
    T = torch.as_tensor
    assert np.array_equal(got, tkern.fused_e2e_polymul_fs_ref(T(za), T(zb), p.tables,
                                                               p.plan).numpy())
    assert np.array_equal(got, tkern.fused_e2e_polymul_ref(T(za), T(zb), p.tables,
                                                            p.plan).numpy())


def test_kernel_block_barrett_constant_for_every_31_bit_special_prime():
    """channel_reduce's m = floor(2^(b+31) / q) for every 31-bit special
    prime the search of core/primes.py can give (n = 4 admits the most;
    a larger n keeps a subset), equals block_barrett_constant, lies below
    2^32, and reduces the largest product (q - 1)^2 and seeded products
    of residues exactly."""
    qs = set()
    for mu, pot in ((2 * 31 + 15, 4), (2 * 31 + 15, 5), (2 * 31 + 30, 5)):
        qs |= {sp.q for sp in tprimes.find_special_primes(v=31, n=4, mu=mu, pot=pot)}
    assert len(qs) > 1000
    rng = np.random.default_rng(SEED)
    for q in sorted(qs):
        m, s1 = kernel_block_barrett(q)
        assert (m, s1) == (trns.block_barrett_constant(q, s1), 30) and m < 1 << 32
        x = U([(q - 1) ** 2] + [int(v) for v in rng.integers(0, q, size=8, dtype=np.int64) ** 2])
        assert np.array_equal(block_barrett(x, U(q), U(m), s1), x % U(q))


@pytest.mark.parametrize("n,t,v", [(64, 3, 29), (64, 3, 30), (64, 3, 31), (256, 6, 30)])
def test_e2e_emulation_matches_plain_version(n, t, v):
    """K2 end to end as emulated (decompose per coefficient, the register
    passes, the quotient-estimate Eq-10 tail) equals fused_e2e_polymul_ref."""
    p = make_params(n, t, v)
    rng = np.random.default_rng(SEED + 5 * n + v)
    za, zb = _segments(p.plan, (2, n), rng), _segments(p.plan, (2, n), rng)
    narrow = p.tables.lazy is not None  # K2 keeps 32-bit remainders in its lazy regimes
    ra = decompose_emulated(za.reshape(-1, p.plan.seg_count), p.plan, narrow).reshape(t, 2, n)
    rb = decompose_emulated(zb.reshape(-1, p.plan.seg_count), p.plan, narrow).reshape(t, 2, n)
    y = passes_emulated(ra, rb, p.tables, "e2e", p.plan.qi_tilde)
    limbs = compose_quotient_emulated(y.reshape(t, -1), p.plan)
    got = torch.as_tensor(limbs.reshape(2, n, p.plan.L))
    want = tkern.fused_e2e_polymul_ref(torch.as_tensor(za), torch.as_tensor(zb), p.tables, p.plan)
    assert torch.equal(got, want)


def quotient_estimate(y: np.ndarray, plan) -> np.ndarray:
    """sum_c y_c / q_c as K2 and K6 accumulate it: channel by channel, one
    double fma(y_c, 1 / q_c, sum) each, rounded once (exact rational
    arithmetic, then one rounding to double)."""
    inv = [Fraction(1.0 / float(q)) for q in plan.qs]
    out = np.empty(y.shape[1])
    for i in range(y.shape[1]):
        acc = 0.0
        for c in range(plan.t):
            acc = float(Fraction(float(y[c, i])) * inv[c] + Fraction(acc))
        out[i] = acc
    return out


SUM_CHANNELS = 15  # parentt.cuh kSumChannels


def limb_sums_emulated(y: np.ndarray, star: np.ndarray, l0: int, maxl: int, w: int):
    """parentt.cuh ``crt_limb_sums`` on (t, N) y and (t, L) limbs: the sums
    of limbs l0 .. l0 + maxl - 1 as int64 lanes, every 15 channels
    carry-normalised (limbs below the top one masked, the top one keeping
    the rest), checked below 2^63 after every product (beside a float64
    copy that does not wrap).  Returns (acc (N, maxl), the carries pushed
    out of the chunk)."""
    t, N = y.shape
    L = star.shape[1]
    mask = (1 << w) - 1
    acc = np.zeros((N, maxl), dtype=np.int64)
    shadow = np.zeros((N, maxl))
    spill = np.zeros(N, dtype=np.int64)
    width = min(maxl, L - l0)
    for c0 in range(0, t, SUM_CHANNELS):
        for c in range(c0, min(t, c0 + SUM_CHANNELS)):
            prod = y[c][:, None].astype(np.int64) * star[c, l0:l0 + width][None, :]
            acc[:, :width] += prod
            shadow[:, :width] += prod.astype(np.float64)
            assert shadow.max() < 2.0 ** 63 * (1 - 2.0 ** -20)
        if c0 + SUM_CHANNELS < t:
            carry = np.zeros(N, dtype=np.int64)
            for l in range(width):
                if l0 + l < L - 1:
                    s = acc[:, l] + carry
                    acc[:, l], carry = s & mask, s >> w
                else:
                    acc[:, l] += carry
                    carry = np.zeros(N, dtype=np.int64)
            spill += carry
            shadow = acc.astype(np.float64)
    return acc, spill


def compose_quotient_emulated(y: np.ndarray, plan, shift: int = 0) -> np.ndarray:
    """parentt.cuh ``crt_compose`` on (t, N) canonical y: the limb sums in
    chunks of MAXL = 8 (L <= 8) or 16 limbs, the quotient floor(sum y_c /
    q_c) in double (moved by ``shift``, to drive both corrections) from the
    first chunk's channel pass, each chunk's ripple that subtracts k q with
    the carries passed to the next, and one conditional addition or
    subtraction of q (``correct_limbs``)."""
    L, w = plan.L, plan.w
    mask = (1 << w) - 1
    maxl = 8 if L <= 8 else 16
    star = np.asarray(plan.qi_star_limbs, dtype=np.int64)
    ql = np.asarray(plan.q_limbs, dtype=np.int64)
    k = quotient_estimate(y, plan).astype(np.int64) + shift
    limb = np.zeros((y.shape[1], L), dtype=np.int64)
    carry = np.zeros(y.shape[1], dtype=np.int64)
    for l0 in range(0, L, maxl):
        acc, spill = limb_sums_emulated(y, star, l0, maxl, w)
        acc[:, 0] += carry
        carry = np.zeros_like(carry)
        for l in range(min(maxl, L - l0)):
            s = acc[:, l] + carry - k * ql[l0 + l]
            limb[:, l0 + l] = s & mask
            carry = s >> w
        carry = carry + spill
    assert np.isin(carry, (-1, 0)).all()
    low = carry < 0
    c_add = np.zeros_like(carry)
    added = limb.copy()
    for l in range(L):
        d = added[:, l] + ql[l] + c_add
        c_add = d >> w
        added[:, l] = d & mask
    top = np.full(y.shape[1], L - 1)  # the highest limb that differs from q's decides
    for l in range(L - 1, 0, -1):
        top = np.where((top == l) & (limb[:, l] == ql[l]), l - 1, top)
    ge = limb[np.arange(y.shape[1]), top] >= ql[top]
    borrow = np.zeros_like(carry)
    subbed = limb.copy()
    for l in range(L):
        d = subbed[:, l] - ql[l] - borrow
        borrow = (d < 0).astype(np.int64)
        subbed[:, l] = np.where(d < 0, d + (1 << w), d)
    return np.where(low[:, None], added, np.where(ge[:, None], subbed, limb))


@pytest.mark.parametrize("t,L", [(15, 17), (16, 17), (31, 32), (40, 44), (100, 107)])
def test_chunked_limb_sums_are_exact_on_worst_case_words(t, L):
    """crt_limb_sums with every y = 2^31 - 1 and every q^ limb 2^28 - 1 (the
    largest words v = 31 can give) but the top two (a q^ = q / q_c leaves
    the sum below t q, which L limbs hold), and on seeded words, in chunks of 8 and
    16 limbs: no sum reaches 2^63 (checked after every product), and the
    chunks' limbs and carried-out normalisations add up to the exact
    sum_c y_c q^_c, which one int64 sum of t >= 17 such products passes."""
    w = 28
    rng = np.random.default_rng(SEED + t + L)
    y = np.full((t, 3), (1 << 31) - 1, dtype=np.int64)
    y[:, 1] = rng.integers(0, 1 << 31, size=t)
    y[:, 2] = 0
    star = np.full((t, L), (1 << w) - 1, dtype=np.int64)
    star[t // 2:] = rng.integers(0, 1 << w, size=(t - t // 2, L))
    star[:, L - 2:] = 0  # q^_c < q / 2^31: the sum stays below t q < 2^(wL), as a plan's
    stars = [sum(int(x) << (w * l) for l, x in enumerate(row)) for row in star]
    exact = [sum(int(y[c, i]) * stars[c] for c in range(t)) for i in range(3)]
    assert (t * ((1 << 31) - 1) * ((1 << w) - 1) >= 1 << 63) == (t >= 17)
    for maxl in (8, 16):
        got = [0, 0, 0]
        for l0 in range(0, L, maxl):
            acc, spill = limb_sums_emulated(y, star, l0, maxl, w)
            for i in range(3):
                got[i] += sum(int(acc[i, l]) << (w * (l0 + l)) for l in range(maxl))
                got[i] += int(spill[i]) << (w * (l0 + maxl))
        assert got == exact


# the edges of the limb chunks: L = 16 (one chunk of 16 limbs at t = 15,
# 14, 14 for v = 29, 30, 31), 17 and 18 (a second chunk of one or two
# limbs, t = 15 and 16, the first t that normalises between channel
# groups), 32 and 34 (two chunks, t = 29 and 31: three groups of
# channels), and 44 and 45 (t = 40)
COMPOSE_CORNERS = [(64, 15, 29), (64, 14, 30), (64, 14, 31), (64, 15, 30), (64, 16, 31),
                   (64, 29, 30), (64, 31, 30), (64, 40, 30), (64, 40, 31)]


@pytest.mark.parametrize("n,t,v", DEC_PRESETS + COMPOSE_CORNERS)
def test_compose_quotient_tail_matches_plain_tail(n, t, v):
    """K2's and K6's compose tail (chunked limb sums, quotient estimate,
    one correction) equals the plain Eq-10 tail and the exact value mod q
    on seeded residues, on all-zero and all q - 1 ones, and with the
    estimate moved one down or up, past 16 limbs and 15 channels; the
    estimate is within t (t + 1) 2^-53 of the exact sum_c y_c / q_c."""
    plan = make_params(n, t, v).plan
    rng = np.random.default_rng(SEED + 7 * n + v)
    qs = np.asarray(plan.qs, dtype=np.int64)[:, None]
    y = rng.integers(0, 1 << 62, size=(t, 128 if t > 16 else 512), dtype=np.int64) % qs
    y[:, 0] = 0
    y[:, 1] = qs[:, 0] - 1
    acc = trns.limb_sums(torch.as_tensor(y), torch.as_tensor(plan.qi_star_limbs)[:, None, :],
                         plan.w)
    want = tcrt.compose_finalize(acc, plan.q_limbs, w=plan.w, t=t).numpy()
    for shift in (-1, 0, 1):
        assert np.array_equal(compose_quotient_emulated(y, plan, shift), want), shift
    value = [sum(int(y[c, i]) * (plan.q // int(plan.qs[c])) for c in range(t))
             for i in range(4)]
    assert tbigint.limbs_to_ints(want[:4], plan.w) == [x % plan.q for x in value]
    est = quotient_estimate(y[:, :4], plan)
    for i in range(4):
        err = abs(Fraction(est[i]) - sum(Fraction(int(y[c, i]), int(plan.qs[c]))
                                         for c in range(t)))
        assert err <= Fraction(t * (t + 1), 1 << 53)


def compose_emulated(r: np.ndarray, plan, narrow: bool) -> np.ndarray:
    """K6 on (t, N) canonical residues: y_c = r_c q~_c as one 32x32->64
    product reduced by the block Barrett with the plan's m (remainders
    32-bit when ``narrow``), then the quotient tail."""
    m = plan.dec_d["block_m"].numpy()
    s1 = plan.dec[0].acc_barrett[1]
    assert all(ch.acc_barrett[1] == s1 == int(ch.qi).bit_length() - 1 for ch in plan.dec)
    y = np.stack([
        block_barrett(U(r[c]) * U(int(plan.qi_tilde[c])), U(int(plan.qs[c])), U(int(m[c])), s1,
                      narrow)
        for c in range(plan.t)
    ]).astype(np.int64)
    return compose_quotient_emulated(y, plan)


@pytest.mark.parametrize("n,t,v", DEC_PRESETS + COMPOSE_CORNERS)
def test_compose_emulation_matches_plain_version(n, t, v):
    """K6 as emulated equals compose_ref on seeded canonical residues, on
    r = 0 and r = q - 1 in every channel, and on the residues of the
    integers 1, q - 1 and q - 2 (whose value / q lies next to an integer),
    in every remainder width; the double quotient is within one of
    floor(value / q) on all of them, up to the largest t the kernel holds."""
    plan = make_params(n, t, v).plan
    rng = np.random.default_rng(SEED + 17 * n + t + v)
    qs = np.asarray(plan.qs, dtype=np.int64)[:, None]
    r = rng.integers(0, 1 << 62, size=(t, 256), dtype=np.int64) % qs
    r[:, 0] = 0
    r[:, 1] = qs[:, 0] - 1
    for i, x in enumerate((1, plan.q - 1, plan.q - 2)):
        r[:, 2 + i] = [x % int(q) for q in plan.qs]
    want = tcrt.compose_ref(torch.as_tensor(r), plan).numpy()
    for narrow in (False, True) if tcrt.narrow_moduli(plan) else (False,):
        assert np.array_equal(compose_emulated(r, plan, narrow), want), narrow
    y = (r * np.asarray(plan.qi_tilde, dtype=np.int64)[:, None]) % qs
    value = [sum(int(y[c, i]) * (plan.q // int(plan.qs[c])) for c in range(t))
             for i in range(r.shape[1])]
    exact = np.array([x // plan.q for x in value])
    assert np.abs(np.floor(quotient_estimate(y, plan)) - exact).max() <= 1
