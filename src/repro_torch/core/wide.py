"""Wide-modulus (31 < v <= 46) modular arithmetic on int64 tensors
(PyTorch port of ``repro.core.wide``): the paper's t=4 / v=45
configuration.

A 45-bit x 45-bit product needs 90 bits and there is no int128 tensor.
The special-prime form q = 2^v - beta makes the fold cheap: products
are built from 23-bit digit partials (all below 2^63) and the bits at
and above v are folded with 2^v = beta (mod q) a bounded number of
times, so the arithmetic stays inside one 64-bit integer unit.

Every function is elementwise and broadcasts; it runs on int64 tensors
of any device (the wide width's one datapath is this plain PyTorch, on
the card as on the CPU; the reference's is pure jnp, with no Pallas
kernel behind it).  The operands stay non-negative and below 2^63, so
``>>``, ``&`` and ``%`` give the same bits on every device.  A
:class:`WideSpec` carries one prime's constants as Python ints.

The ``*_channels`` functions are the array-in/array-out blocks the wide
width of :mod:`repro_torch.api` runs; the leading axis is the RNS
channel, and the per-channel twiddle tables and RNS constants arrive as
stacked tensors on the plan's device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bigint

D = 23  # digit width
M = (1 << D) - 1

# Post-processing limb width: y (46 bits) x limb (14 bits) x t (4) stays
# inside int64.  The api repacks pairs of these limbs into the standard
# base-2^28 output limbs, so every width shares one output contract.
POST_W = 14


@dataclasses.dataclass(frozen=True)
class WideSpec:
    q: int
    v: int
    beta: int  # q = 2^v - beta, 0 < beta < 2^30, low Hamming weight

    def __post_init__(self):
        assert self.q == (1 << self.v) - self.beta
        assert 32 <= self.v <= 46, self.v
        # fold-safety: the terms of mul_mod stay below 2^62 (see there)
        assert self.beta < 1 << 30, hex(self.beta)


def from_special(prime) -> WideSpec:
    """Build from :class:`repro_torch.core.primes.SpecialPrime`."""
    return WideSpec(q=prime.q, v=prime.v, beta=prime.beta)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Assert-free :class:`WideSpec` twin whose ``q`` and ``beta`` may be
    0-d tensors (a channel's constants read off stacked tensors; they were
    checked on the host specs at plan time).  ``v`` stays a Python int:
    it sets shift amounts."""

    q: object
    v: int
    beta: object


def add_mod(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    d_ = a - b
    return torch.where(d_ < 0, d_ + q, d_)


def div2_mod(x, q):
    return (x >> 1) + (x & 1) * ((q + 1) // 2)


def _fold_v(x, spec: WideSpec):
    """x < 2^62 -> a value congruent mod q below 2^(v+1) or so, by two
    folds at 2^v."""
    v, beta = spec.v, spec.beta
    mask = (1 << v) - 1
    x = (x & mask) + (x >> v) * beta  # x >> v < 2^17, * beta < 2^47: below 2^48
    x = (x & mask) + (x >> v) * beta  # second pass: below 2^v + 2^32
    return x


def reduce_mod(x, spec: WideSpec):
    """x < 2^62 -> x mod q (canonical)."""
    x = _fold_v(x, spec)
    x = torch.where(x >= spec.q, x - spec.q, x)
    x = torch.where(x >= spec.q, x - spec.q, x)
    return x


def mul_mod(a, b, spec: WideSpec):
    """(a * b) mod q for a, b < q < 2^46, int64-safe throughout.

    The bounds (the reference's derivation): the partials p00 < 2^46,
    p01 < 2^47, p11 < 2^46; hi46 = (p01 >> 23) + p11 is the value of
    x >> 46, below 2^47, and lo46 = p00 + (p01 & M) << 23 below 2^47.  For
    v <= 46, 2^46 = 2^(46-v) 2^v = g (mod q) with g = 2^(46-v) beta, so
    x = lo46 + g h0 + ((g h1 & M) << 23) + g (g h1 >> 23) (mod q) with
    h0 = hi46 & M < 2^23 and h1 = hi46 >> 23 < 2^24: g h0 < 2^54,
    g h1 < 2^55, and the last term below 2^62 for beta < 2^30 (asserted on
    the spec).  The sum stays below 2^63, which is all :func:`_fold_v`
    needs.
    """
    a0, a1 = a & M, a >> D
    b0, b1 = b & M, b >> D
    p00 = a0 * b0
    p01 = a0 * b1 + a1 * b0
    p11 = a1 * b1
    lo46 = p00 + ((p01 & M) << D)  # bits [0, 47)
    hi46 = (p01 >> D) + p11  # value of x >> 46
    g = (1 << (46 - spec.v)) * spec.beta  # 2^46 = g (mod q)
    h0, h1 = hi46 & M, hi46 >> D
    t1 = g * h0  # < 2^54
    z = g * h1  # < 2^55
    acc = lo46 + t1 + ((z & M) << D) + g * (z >> D)
    return reduce_mod(acc, spec)


# --------------------------------------------------------------------------
# NTT over a wide modulus (the flow graphs of core/ntt.py, radix-2)
# --------------------------------------------------------------------------


def ntt_raw(a, fwd, spec: WideSpec):
    """Forward negative-wrapped NTT on the last axis: natural order in,
    bit-reversed out (``fwd[i] = psi^brv(i)``)."""
    n = a.shape[-1]
    lead = tuple(a.shape[:-1])
    q = spec.q
    m, t = 1, n
    while m < n:
        t //= 2
        w = fwd[m:2 * m]
        x = a.reshape(lead + (m, 2, t))
        u = x[..., 0, :]
        vv = mul_mod(x[..., 1, :], w[:, None], spec)
        a = torch.stack([add_mod(u, vv, q), sub_mod(u, vv, q)], dim=-2)
        a = a.reshape(lead + (n,))
        m *= 2
    return a


def intt_raw(a, inv, spec: WideSpec):
    """Inverse of :func:`ntt_raw` with the halving in every stage (n^-1
    folded in): bit-reversed in, natural order out."""
    n = a.shape[-1]
    lead = tuple(a.shape[:-1])
    q = spec.q
    h, t = n // 2, 1
    while h >= 1:
        w = inv[h:2 * h]
        x = a.reshape(lead + (h, 2, t))
        u, vv = x[..., 0, :], x[..., 1, :]
        s = add_mod(u, vv, q)
        d_ = mul_mod(sub_mod(u, vv, q), w[:, None], spec)
        a = torch.stack([div2_mod(s, q), div2_mod(d_, q)], dim=-2)
        a = a.reshape(lead + (n,))
        h //= 2
        t *= 2
    return a


def negacyclic_mul(a, b, fwd, inv, spec: WideSpec):
    fa = ntt_raw(a, fwd, spec)
    fb = ntt_raw(b, fwd, spec)
    return intt_raw(mul_mod(fa, fb, spec), inv, spec)


# --------------------------------------------------------------------------
# multi-channel blocks (the wide width of repro_torch.api); leading axis =
# RNS channel
# --------------------------------------------------------------------------


def decompose_channels(z, specs, beta_pows):
    """z: (..., S) base-2^v segments -> residues (t, ...): per channel i,
    sum_k z_k [B^k]_{q_i} with the digit-split product; ``beta_pows`` is
    the (t, S) tensor of B^k mod q_i."""
    outs = []
    for i, spec in enumerate(specs):
        acc = z[..., 0].to(torch.int64)
        for k in range(1, z.shape[-1]):
            acc = add_mod(acc, mul_mod(z[..., k].to(torch.int64), beta_pows[i, k], spec), spec.q)
        outs.append(acc)
    return torch.stack(outs)


def ntt_channels(a, fwd, specs):
    """a: (t, ..., n) -> the forward wide NTT per channel; fwd: (t, n)."""
    return torch.stack([ntt_raw(a[i], fwd[i], spec) for i, spec in enumerate(specs)])


def intt_channels(a, inv, specs):
    """a: (t, ..., n) bit-reversed spectra -> natural order; inv: (t, n)."""
    return torch.stack([intt_raw(a[i], inv[i], spec) for i, spec in enumerate(specs)])


def negacyclic_mul_channels(a, b, fwd, inv, specs):
    """(t, ..., n) x (t, ..., n) -> per-channel negacyclic products."""
    return torch.stack([
        negacyclic_mul(a[i], b[i], fwd[i], inv[i], spec) for i, spec in enumerate(specs)
    ])


def compose_channels(residues, specs, qi_tilde, qi_star_limbs, q_limbs):
    """Inverse CRT (Eq 10) in POST_W-bit limbs: residues (t, ...) ->
    (..., L14) base-2^POST_W limbs of p mod q (canonical).

    ``qi_star_limbs``: (t, L14) limbs of q / q_i; ``q_limbs``: (L14,).
    Each product y (< 2^46) x limb (< 2^14) is below 2^60, and the t-sum
    below 2^62 (the plan refuses t and v past t 2^(v+14) <= 2^63)."""
    t = len(specs)
    W, L = POST_W, qi_star_limbs.shape[-1]
    y = torch.stack([mul_mod(residues[i], qi_tilde[i], spec) for i, spec in enumerate(specs)])
    star_b = qi_star_limbs.reshape((t,) + (1,) * (y.dim() - 1) + (L,))
    acc = bigint.carry_normalize((y[..., None] * star_b).sum(dim=0), W)
    q_b = q_limbs.reshape((1,) * (acc.dim() - 1) + (L,))
    return bigint.mod_by_subtraction(acc, q_b.expand(acc.shape), W, t - 1)


def repack_limbs(limbs, w_in: int, w_out: int):
    """Exact repack of canonical base-2^w_in limbs into base-2^w_out
    (w_out a multiple of w_in), zero-padding the tail group.  Since
    ceil(ceil(B / w_in) / k) == ceil(B / (k w_in)), the wide width's
    POST_W = 14 limbs repack at w_out = 28 into exactly the plan's L."""
    if w_out % w_in:
        raise ValueError(f"w_out={w_out} must be a multiple of w_in={w_in}")
    k = w_out // w_in
    L = limbs.shape[-1]
    pad = (-L) % k
    if pad:
        limbs = torch.cat([limbs, limbs.new_zeros(tuple(limbs.shape[:-1]) + (pad,))], dim=-1)
    grouped = limbs.reshape(tuple(limbs.shape[:-1]) + (-1, k))
    shifts = torch.tensor([1 << (w_in * j) for j in range(k)], dtype=limbs.dtype,
                          device=limbs.device)
    return (grouped * shifts).sum(dim=-1)
