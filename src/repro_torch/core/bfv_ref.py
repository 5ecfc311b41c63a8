"""Host-side (Python bigint) BFV reference, including ct x ct multiplication
with relinearization (PyTorch port of ``repro.core.bfv_ref``): the piece
the device layer :mod:`repro_torch.core.bfv` delegates (the BFV scaling
step needs exact rational rounding; the paper likewise cites the HPS RNS
variant [33] rather than re-deriving it).

Pure Python over ``random.Random``; its parameters come from
:func:`repro_torch.core.params.make_params` on the CPU.  O(n^2) schoolbook
products: keep n small.
"""
from __future__ import annotations

import dataclasses
import random

from repro_torch.core import polymul as pm
from repro_torch.core.params import ParenttParams, make_params


@dataclasses.dataclass
class RefContext:
    params: ParenttParams
    pt_mod: int
    noise_bound: int = 4
    decomp_bits: int = 30  # relinearization base T = 2^decomp_bits

    @property
    def q(self):
        return self.params.q

    @property
    def n(self):
        return self.params.n

    @property
    def delta(self):
        return self.q // self.pt_mod


def make_ref_context(n: int = 32, t: int = 3, v: int = 30, pt_mod: int = 257):
    return RefContext(params=make_params(n=n, t=t, v=v, device="cpu"), pt_mod=pt_mod)


# polynomial helpers (coefficient lists, mod q)


def _padd(a, b, q):
    return [(x + y) % q for x, y in zip(a, b)]


def _pneg(a, q):
    return [(-x) % q for x in a]


def _pmul(a, b, q):
    return pm.schoolbook_negacyclic(a, b, q)


def _centered(a, q):
    return [x - q if x > q // 2 else x for x in a]


def _negacyclic_int(a, b):
    """Exact integer negacyclic product (no modulus)."""
    n = len(a)
    p = [0] * n
    for i in range(n):
        if not a[i]:
            continue
        for j in range(n):
            k = i + j
            if k >= n:
                p[k - n] -= a[i] * b[j]
            else:
                p[k] += a[i] * b[j]
    return p


def _small(rng, n, bound):
    return [rng.randint(-bound, bound) for _ in range(n)]


def _ternary(rng, n):
    return [rng.randint(-1, 1) for _ in range(n)]


@dataclasses.dataclass
class RefKeys:
    s: list[int]
    pk: tuple[list[int], list[int]]
    evk: list[tuple[list[int], list[int]]]  # relinearization key, base-T


def keygen(rng: random.Random, ctx: RefContext) -> RefKeys:
    q, n = ctx.q, ctx.n
    s = _ternary(rng, n)
    s_q = [x % q for x in s]
    a = [rng.randrange(q) for _ in range(n)]
    e = [x % q for x in _small(rng, n, ctx.noise_bound)]
    pk0 = _pneg(_padd(_pmul(a, s_q, q), e, q), q)
    # evk_j = (-(a_j s + e_j) + T^j s^2, a_j)
    s2 = _pmul(s_q, s_q, q)
    evk = []
    T = 1 << ctx.decomp_bits
    levels = -(-q.bit_length() // ctx.decomp_bits)
    for j in range(levels):
        aj = [rng.randrange(q) for _ in range(n)]
        ej = [x % q for x in _small(rng, n, ctx.noise_bound)]
        b = _pneg(_padd(_pmul(aj, s_q, q), ej, q), q)
        b = _padd(b, [(pow(T, j, q) * x) % q for x in s2], q)
        evk.append((b, aj))
    return RefKeys(s=s_q, pk=(pk0, a), evk=evk)


def encrypt(rng: random.Random, m: list[int], keys: RefKeys, ctx: RefContext):
    q, n = ctx.q, ctx.n
    u = [x % q for x in _ternary(rng, n)]
    e1 = [x % q for x in _small(rng, n, ctx.noise_bound)]
    e2 = [x % q for x in _small(rng, n, ctx.noise_bound)]
    dm = [(ctx.delta * (x % ctx.pt_mod)) % q for x in m]
    c0 = _padd(_padd(_pmul(keys.pk[0], u, q), e1, q), dm, q)
    c1 = _padd(_pmul(keys.pk[1], u, q), e2, q)
    return (c0, c1)


def decrypt(ct, keys: RefKeys, ctx: RefContext) -> list[int]:
    q = ctx.q
    phase = _padd(ct[0], _pmul(ct[1], keys.s, q), q)
    return [((ctx.pt_mod * x + q // 2) // q) % ctx.pt_mod for x in phase]


def add(a, b, ctx: RefContext):
    return (_padd(a[0], b[0], ctx.q), _padd(a[1], b[1], ctx.q))


def mul_plain(ct, w: list[int], ctx: RefContext):
    wq = [x % ctx.q for x in w]
    return (_pmul(ct[0], wq, ctx.q), _pmul(ct[1], wq, ctx.q))


def mul(ct_a, ct_b, keys: RefKeys, ctx: RefContext):
    """ct x ct with BFV scaling (exact bigint rounding) + relinearization."""
    q, pt = ctx.q, ctx.pt_mod
    a0, a1 = (_centered(c, q) for c in ct_a)
    b0, b1 = (_centered(c, q) for c in ct_b)

    def scale(poly_int):
        return [(((pt * x) + (q // 2) * (1 if x >= 0 else -1)) // q) % q for x in poly_int]

    e0 = scale(_negacyclic_int(a0, b0))
    e1 = scale(
        [x + y for x, y in zip(_negacyclic_int(a0, b1), _negacyclic_int(a1, b0))]
    )
    e2 = scale(_negacyclic_int(a1, b1))
    # relinearize e2 via base-T digits
    T = 1 << ctx.decomp_bits
    c0, c1 = e0, e1
    rem = list(e2)
    for j, (b, aj) in enumerate(keys.evk):
        digit = [x % T for x in rem]
        rem = [x // T for x in rem]
        c0 = _padd(c0, _pmul(digit, b, q), q)
        c1 = _padd(c1, _pmul(digit, aj, q), q)
    return (c0, c1)
