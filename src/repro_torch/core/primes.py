"""Special NTT-compatible, CRT-friendly prime search (paper §IV-B, Eq 3/6).

Each RNS modulus has the Solinas-like form

    q_i = 2^v - beta_i,   beta_i = 2^{v1} ± 2^{v2} ± ... ± 2^{v_nq} - 1

(so q_i itself has ``n_q + 2`` signed power-of-two (PoT) terms), subject to

  (C1)  q_i prime,
  (C2)  2n | (q_i - 1)              (NTT-compatible),
  (C3)  ceil((mu - 1) / n_beta) > v1 > v2 > ...   (Eq 6, CRT-friendly:
        bounds the shift-add-unit (SAU) intermediate word-length so that a
        single Barrett unit with input word-length ``mu`` suffices),

where ``n_beta = t - 1`` (Approach 1) or ``t' - 1`` (Approach 2, Alg 2
factorization t = d * t').  The paper's contribution 2 *expands* the
feasible set by allowing mu in {2v+15, 2v+30} instead of the classic 2v
(Table III).  The search is exhaustive and runs offline in Python bigints
(prime selection is a compile-time activity on every platform, FPGA or
TPU alike).

This module is host-side only (no JAX).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import random
from typing import Iterator

# --------------------------------------------------------------------------
# Primality (deterministic Miller-Rabin for < 3.3e24, covers all our vt-bit
# candidates individually; the composed modulus q is composite by design).
# --------------------------------------------------------------------------

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)


def is_prime(x: int) -> bool:
    if x < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41):
        if x % p == 0:
            return x == p
    d, s = x - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _MR_BASES:
        w = pow(a, d, x)
        if w in (1, x - 1):
            continue
        for _ in range(s - 1):
            w = (w * w) % x
            if w == x - 1:
                break
        else:
            return False
    return True


def _pollard_rho(x: int) -> int:
    if x % 2 == 0:
        return 2
    rng = random.Random(0xC0FFEE ^ x)
    while True:
        c = rng.randrange(1, x)
        f = lambda y: (y * y + c) % x
        a = b = rng.randrange(2, x)
        d = 1
        while d == 1:
            a = f(a)
            b = f(f(b))
            d = math.gcd(abs(a - b), x)
        if d != x:
            return d


def factorize(x: int) -> dict[int, int]:
    """Full factorization (trial division + Pollard rho)."""
    out: dict[int, int] = {}
    for p in (2, 3, 5, 7, 11, 13):
        while x % p == 0:
            out[p] = out.get(p, 0) + 1
            x //= p
    stack = [x] if x > 1 else []
    while stack:
        y = stack.pop()
        if y == 1:
            continue
        if is_prime(y):
            out[y] = out.get(y, 0) + 1
            continue
        d = _pollard_rho(y)
        stack += [d, y // d]
    return out


def primitive_root(q: int, factors: dict[int, int] | None = None) -> int:
    """Smallest generator of Z_q^* (q prime)."""
    fac = factors or factorize(q - 1)
    for g in itertools.count(2):
        if all(pow(g, (q - 1) // p, q) != 1 for p in fac):
            return g
    raise RuntimeError("unreachable")


def root_of_unity(q: int, order: int) -> int:
    """A primitive ``order``-th root of unity mod prime q (order | q-1)."""
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide {q}-1")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    # primitivity check: w^(order/p) != 1 for prime p | order (order = 2^k here)
    assert pow(w, order, q) == 1
    for p in factorize(order):
        assert pow(w, order // p, q) != 1
    return w


# --------------------------------------------------------------------------
# Special prime search (Eq 3 + Eq 6)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecialPrime:
    """q = 2^v - beta, beta = sum(sign * 2^exp for exp, sign in beta_terms) - 1.

    ``beta_terms`` excludes the trailing ``-1``; exps strictly decreasing.
    """

    q: int
    v: int
    beta_terms: tuple[tuple[int, int], ...]  # ((exp, sign), ...), sign in {+1,-1}

    @property
    def beta(self) -> int:
        return sum(s * (1 << e) for e, s in self.beta_terms) - 1

    @property
    def pot_terms(self) -> int:
        """Number of signed power-of-two terms in q itself (paper's '# PoT')."""
        return len(self.beta_terms) + 2

    def __post_init__(self):
        assert self.q == (1 << self.v) - self.beta


def _beta_candidates(
    v: int, n_pot_inner: int, v1_bound: int, min_exp: int
) -> Iterator[tuple[tuple[int, int], ...]]:
    """Yield beta term tuples: exps from [min_exp, v1_bound), leading sign +."""
    exps_range = range(min_exp, v1_bound)
    for exps in itertools.combinations(exps_range, n_pot_inner):
        exps = tuple(sorted(exps, reverse=True))
        for signs in itertools.product((1, -1), repeat=n_pot_inner - 1):
            yield tuple(
                (e, 1 if k == 0 else signs[k - 1]) for k, e in enumerate(exps)
            )


def find_special_primes(
    *,
    v: int,
    n: int,
    mu: int,
    pot: int,
    n_beta: int = 2,
    constraint: str = "wordlen",
    limit: int | None = None,
) -> list[SpecialPrime]:
    """Exhaustive search per paper §IV-B.

    Args:
      v: word-length of each q_i.
      n: polynomial degree (power of two); requires 2n | q_i - 1.
      mu: Barrett input word-length (paper uses 2v+15 or 2v+30).
      pot: number of signed PoT terms in q_i (4 or 5 in Table III).
      n_beta: SAU chain depth bound.  The paper's Table III numbers are
        reproduced exactly with n_beta = 2 (the Alg-2 factorized datapath,
        t' = 3) for BOTH the v=45 and v=30 rows.
      constraint: 'wordlen' applies the paper's own §IV-C word-length
        derivation, mu >= v + n_beta*(v1+1) + 1  <=>  v1 <= (mu-v-1)/n_beta - 1.
        This reproduces all eight Table III counts exactly
        (12/33/126/480 for v=45; 8/26/23/169 for v=30).  'eq6' applies the
        constraint as *printed* in Eq 6 (v1 < ceil((mu-1)/n_beta)), which is
        inconsistent with Table III — kept for the erratum benchmark.
      limit: optionally stop after this many primes.
    """
    n_inner = pot - 2  # beta has (pot - 2) PoT terms plus the trailing -1
    if n_inner < 1:
        raise ValueError("need pot >= 3")
    if constraint == "wordlen":
        v1_bound = (mu - v - 1) // n_beta  # exclusive: v1 <= bound - 1
    elif constraint == "eq6":
        v1_bound = -(-(mu - 1) // n_beta)  # ceil((mu-1)/n_beta); v1 < bound
    else:
        raise ValueError(constraint)
    v1_bound = min(v1_bound, v)  # beta must stay below 2^v
    two_n = 2 * n
    # NTT compatibility: q-1 = 2^v - beta - ... ; q ≡ 1 (mod 2n) forces the
    # low log2(2n) bits of beta to equal those of 2^v, i.e. beta ≡ 0 mod 2n
    # given v > log2(2n).  beta = 2^{v1} ± ... - 1 is odd - 1 + ...: we just
    # filter on the congruence directly (cheap) rather than pre-pruning.
    out: list[SpecialPrime] = []
    seen: set[int] = set()
    for terms in _beta_candidates(v, n_inner, v1_bound, min_exp=1):
        beta = sum(s * (1 << e) for e, s in terms) - 1
        if beta <= 0:
            continue
        q = (1 << v) - beta
        if q in seen:
            continue
        if q.bit_length() != v:
            continue
        if (q - 1) % two_n != 0:
            continue
        if not is_prime(q):
            continue
        seen.add(q)
        out.append(SpecialPrime(q=q, v=v, beta_terms=terms))
        if limit and len(out) >= limit:
            break
    out.sort(key=lambda s: s.q)
    return out


@functools.lru_cache(maxsize=None)
def default_prime_set(n: int, t: int, v: int) -> tuple[SpecialPrime, ...]:
    """The prime sets used throughout the framework.

    Matches the paper's hardware configs: (t=4, v=45) and (t=6, v=30) with
    mu = 2v + 15 and 4 PoT terms, SAU depth n_beta = 2 (Alg 2, t' = 3) —
    the setting that reproduces Table III exactly.
    """
    mu = 2 * v + 15
    primes = find_special_primes(v=v, n=n, mu=mu, pot=4, n_beta=2)
    if len(primes) < t:
        primes = find_special_primes(v=v, n=n, mu=mu, pot=5, n_beta=2)
    if len(primes) < t:
        primes = find_special_primes(v=v, n=n, mu=2 * v + 30, pot=5, n_beta=2)
    if len(primes) < t:
        raise RuntimeError(
            f"search found only {len(primes)} special primes for n={n} v={v}"
        )
    return tuple(primes[:t])
