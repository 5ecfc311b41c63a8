"""Modular lane arithmetic on int64 tensors (PyTorch port of
``repro.core.modmath``), plus the numpy functions that build its
constants.

The plain-PyTorch datapaths (:mod:`repro_torch.core.ntt`,
:mod:`repro_torch.core.rns`, the plain versions in
:mod:`repro_torch.kernels`) all reduce through these helpers, and the CUDA
device functions in ``csrc/parentt.cuh`` repeat the same arithmetic
line by line, so a kernel and its plain version compute the same int64
values.

Three reduction regimes, chosen per configuration from the moduli width
b = bit_length(q):

* b <= 29: Harvey lazy butterflies, window W = 4, Shoup shift beta = b + 2;
* b == 30: lazy, W = 2, beta = 32 (the paper's v = 30 point);
* b == 31: no lazy or Barrett constants; the butterfly multiply reduces
  with a generic ``%``.

Every value a lazy butterfly stores stays below W*q < 2^31, every product
below 2^63 (``validate_lazy_envelope``).  ``%`` on int64 tensors is
``torch.remainder``; all operands reaching it here are non-negative, so
it agrees with C's ``%`` on the card.  ``>>`` on int64 tensors is the
arithmetic shift, as in the reference.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

# python ints or int64 tensors, broadcastable against each other
Lanes = Any

# --------------------------------------------------------------------------
# add / sub / halve
# --------------------------------------------------------------------------


def add_mod(x: Lanes, y: Lanes, q: Lanes) -> Lanes:
    """(x + y) mod q for x, y in [0, q)."""
    s = x + y
    return torch.where(s >= q, s - q, s)


def sub_mod(x: Lanes, y: Lanes, q: Lanes) -> Lanes:
    """(x - y) mod q for x, y in [0, q)."""
    d = x - y
    return torch.where(d < 0, d + q, d)


def div2_mod(x: Lanes, q_half: Lanes) -> Lanes:
    """x * 2^{-1} mod q via paper Eq 24: (x >> 1) + (x & 1) * (q+1)/2."""
    return (x >> 1) + (x & 1) * q_half


# --------------------------------------------------------------------------
# Barrett reduction
# --------------------------------------------------------------------------


def barrett_constants(q: int, c: int, v: int) -> tuple[int, int, int]:
    """Constants for reducing x < 2^c mod q (q of v bits):
    q_hat = ((x >> (v-1)) * eps) >> (c - v + 1), eps = floor(2^c / q).
    Both factors of the quotient lie below 2^(c - v + 1), the window,
    which may reach 32 bits: the reference stops at 31 (a 63-bit
    product), where the default primes of n >= 32768 at t = 6 put the
    SAU words of the decompose out of reach; :func:`barrett_reduce` forms
    the wider product exactly, and the kernels form it as one unsigned
    32x32->64 product."""
    if c - v + 1 > 32:
        raise ValueError(f"Barrett window c={c} too wide for v={v} (q={q})")
    eps = (1 << c) // q
    return eps, v - 1, c - v + 1


def barrett_reduce(x: Lanes, q: Lanes, eps: Lanes, s1: int, s2: int) -> Lanes:
    """x mod q for x < 2^c (see barrett_constants).  A 32-bit window's
    quotient product (up to 2^64) is taken with eps split in 16-bit
    halves, floor((a e_hi 2^16 + a e_lo) / 2^s2) =
    floor((a e_hi + floor(a e_lo / 2^16)) / 2^(s2 - 16)), exact in int64."""
    a = x >> s1
    if 2 * s2 > 63:
        qhat = (a * (eps >> 16) + ((a * (eps & 0xFFFF)) >> 16)) >> (s2 - 16)
    else:
        qhat = (a * eps) >> s2
    r = x - qhat * q
    for _ in range(3):
        r = torch.where(r >= q, r - q, r)
    return r


def mul_barrett_constants(
    qs: Lanes,
) -> tuple[np.ndarray, tuple[int, int]] | tuple[None, None]:
    """Per-channel Barrett ``eps`` for residue products plus the shared
    shift pair, or ``(None, None)`` outside the 63-bit-safe envelope
    (mixed widths, or q >= 2^31)."""
    qs = np.atleast_1d(np.asarray(qs, dtype=np.int64))
    widths = {int(q).bit_length() for q in qs}
    if len(widths) != 1:
        return None, None
    b = widths.pop()
    c = 2 * b
    if 2 * (c - b + 1) > 63:
        return None, None
    eps = np.array([(1 << c) // int(q) for q in qs], dtype=np.int64)
    return eps, (b - 1, b + 1)


def channel_mul_constants(
    qs: Lanes,
) -> tuple[tuple[tuple[int, int, int | None], ...], tuple[int, int] | None]:
    """Per-channel ``(qi, half, eps)`` python-int triples plus the shared
    shift pair (``eps`` None outside the Barrett envelope)."""
    eps, shifts = mul_barrett_constants(qs)
    qs = np.atleast_1d(np.asarray(qs, dtype=np.int64))
    triples = tuple(
        (int(q), (int(q) + 1) // 2, None if eps is None else int(eps[i]))
        for i, q in enumerate(qs)
    )
    return triples, shifts


def mul_mod(
    x: Lanes, y: Lanes, q: Lanes, eps: Lanes = None, shifts: tuple[int, int] | None = None
) -> Lanes:
    """(x * y) mod q for x, y in [0, q): Barrett with ``eps``/``shifts``,
    else the generic ``%`` (the v = 31 regime)."""
    p = x * y
    if eps is None or shifts is None:
        return p % q
    s1, s2 = shifts
    return barrett_reduce(p, q, eps, s1, s2)


# --------------------------------------------------------------------------
# Harvey lazy reduction (Shoup multiplication, deferred canonicalize)
# --------------------------------------------------------------------------


def lazy_params(qs: Lanes) -> tuple[int, int] | tuple[None, None]:
    """(window, beta) for the lazy butterflies, or (None, None) outside the
    63-bit-safe envelope (mixed widths or q >= 2^31)."""
    qs = np.atleast_1d(np.asarray(qs, dtype=np.int64))
    widths = {int(q).bit_length() for q in qs}
    if len(widths) != 1:
        return None, None
    b = widths.pop()
    if b <= 29:
        return 4, b + 2
    if b == 30:
        return 2, 32
    return None, None


def validate_lazy_envelope(q: int, window: int, beta: int) -> None:
    """Every butterfly value stays < window*q <= 2^beta and the Shoup
    product v*w' fits 63 bits."""
    if window not in (2, 4):
        raise ValueError(f"lazy window must be 2 or 4, got {window}")
    b = int(q).bit_length()
    if window * q > 1 << beta:
        raise ValueError(
            f"lazy window overflows the Shoup operand range: "
            f"window*q = {window * q} > 2^{beta}"
        )
    if b + (window.bit_length() - 1) + beta > 63:
        raise ValueError(
            f"Shoup product v*w' exceeds 63 bits: b={b}, window={window}, "
            f"beta={beta}"
        )


def shoup_constants(table: Lanes, q: int, beta: int) -> np.ndarray:
    """w' = floor(w * 2^beta / q) per twiddle (host bigints, any shape)."""
    tab = np.asarray(table, dtype=np.int64)
    flat = [((int(w) << beta) // int(q)) for w in tab.reshape(-1)]
    return np.array(flat, dtype=np.int64).reshape(tab.shape)


def cond_sub(x: Lanes, m: Lanes) -> Lanes:
    """x - m if x >= m else x: one conditional (window) subtraction."""
    return torch.where(x >= m, x - m, x)


def shoup_mul(v: Lanes, w: Lanes, w_shoup: Lanes, q: Lanes, beta: int) -> Lanes:
    """v * w mod q up to one extra q: output in [0, 2q)."""
    return v * w - ((v * w_shoup) >> beta) * q


def lazy_ct_butterfly(
    u: Lanes, v: Lanes, w: Lanes, w_shoup: Lanes, q: Lanes, *, beta: int, window: int
) -> tuple[Lanes, Lanes]:
    """DIT/CT butterfly keeping both outputs in [0, window*q)."""
    t = shoup_mul(v, w, w_shoup, q, beta)  # [0, 2q)
    if window == 4:
        u = cond_sub(u, 2 * q)  # [0, 2q)
        return u + t, u - t + 2 * q  # both [0, 4q)
    x = cond_sub(u + t, 2 * q)
    y = cond_sub(u - t + 2 * q, 2 * q)
    return x, y


def lazy_gs_butterfly(
    u: Lanes, v: Lanes, w: Lanes, w_shoup: Lanes, q: Lanes, half: Lanes, *, beta: int, window: int
) -> tuple[Lanes, Lanes]:
    """Mirror-order GS butterfly with the Eq-24 halving folded in; values
    stay in [0, window*q)."""
    wq = window * q
    s = cond_sub(u + v, wq)
    d = cond_sub(u - v + wq, wq)
    d = shoup_mul(d, w, w_shoup, q, beta)  # [0, 2q)
    return div2_mod(s, half), div2_mod(d, half)


def canonicalize(x: Lanes, q: Lanes, window: int) -> Lanes:
    """[0, window*q) -> [0, q): the single exit reduce of a lazy transform."""
    if window == 4:
        x = cond_sub(x, 2 * q)
    return cond_sub(x, q)
