"""Ground-truth host oracles for the multiplier (PyTorch port of
``repro.core.polymul``; pure Python bigints, no device code).

* ``schoolbook_negacyclic`` — O(n^2) negacyclic product.
* ``ntt_negacyclic_host``   — O(n log n) negacyclic product via a twisted
  cyclic host NTT (any channel prime with 2n | q-1).
* ``oracle_multiply``       — the RNS+NTT pipeline in Python bigints.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core import bigint, primes as primes_mod, rns as rns_mod
from repro_torch.core.params import ParenttParams


def schoolbook_negacyclic(a: list[int], b: list[int], q: int) -> list[int]:
    """p = a*b mod (x^n + 1, q), Python bigints."""
    n = len(a)
    p = [0] * n
    for i in range(n):
        ai = a[i] % q
        if not ai:
            continue
        for j in range(n):
            k = i + j
            if k >= n:
                p[k - n] = (p[k - n] - ai * b[j]) % q
            else:
                p[k] = (p[k] + ai * b[j]) % q
    return p


def _host_fft(v: list[int], q: int, root: int) -> list[int]:
    """In-place iterative Cooley-Tukey NTT over Python ints; ``root`` is a
    primitive len(v)-th root of unity mod q."""
    n = len(v)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            v[i], v[j] = v[j], v[i]
    length = 2
    while length <= n:
        wlen = pow(root, n // length, q)
        half = length >> 1
        for start in range(0, n, length):
            wcur = 1
            for k in range(start, start + half):
                u = v[k]
                t = v[k + half] * wcur % q
                v[k] = (u + t) % q
                v[k + half] = (u - t) % q
                wcur = wcur * wlen % q
        length <<= 1
    return v


@functools.lru_cache(maxsize=None)
def _host_twist(q: int, n: int) -> tuple[tuple[int, ...], tuple[int, ...], int]:
    """(psi^i, psi^-i, n^-1) mod q for the negacyclic twist, cached."""
    psi = primes_mod.root_of_unity(q, 2 * n)
    psi_inv = pow(psi, q - 2, q)
    tw, itw = [1] * n, [1] * n
    for i in range(1, n):
        tw[i] = tw[i - 1] * psi % q
        itw[i] = itw[i - 1] * psi_inv % q
    return tuple(tw), tuple(itw), pow(n, q - 2, q)


def ntt_negacyclic_host(a: list[int], b: list[int], q: int) -> list[int]:
    """p = a*b mod (x^n + 1, q) via the twisted cyclic NTT, O(n log n)."""
    tw, itw, n_inv = _host_twist(q, len(a))
    w = tw[1] * tw[1] % q  # psi^2: primitive n-th root
    w_inv = itw[1] * itw[1] % q
    fa = _host_fft([x % q * t % q for x, t in zip(a, tw)], q, w)
    fb = _host_fft([x % q * t % q for x, t in zip(b, tw)], q, w)
    fp = _host_fft([x * y % q for x, y in zip(fa, fb)], q, w_inv)
    return [x * n_inv % q * t % q for x, t in zip(fp, itw)]


# Below this transform length oracle_multiply keeps the schoolbook path,
# a reference with no shared structure with any NTT.
_FAST_ORACLE_MIN_N = 512


def oracle_multiply(a: list[int], b: list[int], params: ParenttParams) -> list[int]:
    """RNS+NTT pipeline in Python bigints (reference for any v)."""
    plan = params.plan
    out = [0] * params.n
    for i in range(params.t):
        qi = int(plan.qs[i])
        ai = [x % qi for x in a]
        bi = [x % qi for x in b]
        if params.n >= _FAST_ORACLE_MIN_N:
            pi = ntt_negacyclic_host(ai, bi, qi)
        else:
            pi = schoolbook_negacyclic(ai, bi, qi)
        star = plan.q // qi
        tilde = int(plan.qi_tilde[i])
        for j in range(params.n):
            out[j] = (out[j] + ((pi[j] * tilde) % qi) * star) % plan.q
    return out


def ints_to_segments(xs: list[int], plan: rns_mod.RnsPlan) -> np.ndarray:
    return bigint.ints_to_limbs(xs, plan.v, plan.seg_count)


def limbs_out_to_ints(limbs, plan: rns_mod.RnsPlan) -> list[int]:
    return bigint.limbs_to_ints(limbs, plan.w)
