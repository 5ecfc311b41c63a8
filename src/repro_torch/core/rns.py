"""RNS/CRT pre- and post-processing (PyTorch port of ``repro.core.rns``).

Pre-processing (Alg 1 / Alg 2): coefficients arrive as base-B segments
(B = 2^v) and each residue is ``sum_k z_k * (B^k mod q_i) mod q_i``.
``decompose_sau`` is the paper's shift-add-unit network with Alg-2 blocks
of t' = 3 segments, SAU depth capped at 1 with a Barrett between SAU
applications (int64 safety, with Barrett windows up to 32 bits:
:func:`repro_torch.core.modmath.barrett_reduce`).  The reference's generic ``decompose``
(its ``use_sau=False`` path) is not ported.

Post-processing (Eq 10): ``p = sum_i [p_i * q~_i]_{q_i} * q^_i mod q``
with q^_i as base-2^w limbs; the sum is < t*q and is finished with t-1
conditional big-integer subtractions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bigint
from repro_torch.core.modmath import barrett_constants, barrett_reduce


@dataclasses.dataclass(frozen=True)
class ChannelDecompose:
    """Static pre-processing constants for ONE RNS channel (one of the
    paper's specialized SAU circuits)."""

    qi: int
    beta_terms: tuple[tuple[int, int], ...]  # signed-PoT terms of beta_i
    block_consts: tuple[int, ...]  # [beta_i^{t'*rho}]_{q_i} per Alg-2 block
    sau_barrett: tuple[int, int, int]  # (eps, s1, s2) for SAU/block words
    acc_barrett: tuple[int, int, int]  # (eps, s1, s2) for the accumulator


@dataclasses.dataclass(frozen=True, eq=False)
class RnsPlan:
    """All host-precomputed constants for one (n, v, t) RNS configuration,
    with their int64 device copies (``<field>_d``) uploaded once."""

    n: int
    v: int
    t: int
    q: int  # composed modulus, prod(qs)
    qs: np.ndarray  # (t,)
    beta_terms: tuple[tuple[tuple[int, int], ...], ...]
    seg_count: int  # S: base-2^v segments of an input coefficient
    beta_pows: np.ndarray  # (t, S): B^k mod q_i
    t_prime: int  # Alg 2 block width
    block_consts: np.ndarray  # (t, n_blocks)
    w: int  # post-processing limb width
    L: int  # post-processing limb count
    qi_tilde: np.ndarray  # (t,): (q/q_i)^-1 mod q_i
    qi_star_limbs: np.ndarray  # (t, L): q/q_i in base 2^w
    q_limbs: np.ndarray  # (L,)
    # per-channel in-kernel decompose constants (their device arrays
    # ``dec_d``: dec_arrays plus what the CUDA kernels take besides, the
    # block-product Barrett constants ``block_m`` and the SAU multipliers
    # ``beta``); None when the int64
    # kernels cannot serve the config (v > 31, or an SAU word outside the
    # 32-bit Barrett window v1 + 4 <= 32, make_dec)
    dec: tuple[ChannelDecompose, ...] | None = None
    device: torch.device = torch.device("cpu")

    @property
    def n_blocks(self) -> int:
        return -(-self.seg_count // self.t_prime)

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))
        for name in ("qs", "qi_tilde", "qi_star_limbs", "q_limbs"):
            dev = torch.as_tensor(getattr(self, name), device=self.device)
            object.__setattr__(self, name + "_d", dev)
        dec_d = None
        if self.dec is not None:
            arrays = dec_arrays(self)
            arrays["block_m"] = np.array(
                [block_barrett_constant(c.qi, c.acc_barrett[1]) for c in self.dec], dtype=np.int64
            )
            arrays["beta"] = np.array(
                [sum(s << e for e, s in c.beta_terms) - 1 for c in self.dec], dtype=np.int64
            )
            dec_d = {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}
        object.__setattr__(self, "dec_d", dec_d)


def block_barrett_constant(q: int, s1: int) -> int:
    """m = floor(2^(s1+32) / q) of the decompose kernels' block-product
    reduction, for q of s1 + 1 bits (s1 <= 30): with x' = x >> s1 and
    qhat = (x' * m) >> 32, x - qhat*q lies in [0, 3q) for every x < 2^(2 s1 + 2),
    so two conditional subtractions give x mod q (csrc/parentt.cuh
    ``block_barrett``).  Both x' and m are below 2^32, so the kernel's quotient
    is one ``__umulhi``."""
    if int(q).bit_length() != s1 + 1 or s1 > 30:
        raise ValueError(f"block Barrett needs q of s1 + 1 <= 31 bits, got q={q}, s1={s1}")
    return (1 << (s1 + 32)) // int(q)


def dec_arrays(plan: RnsPlan) -> dict[str, np.ndarray]:
    """Stacked (t, ...) int64 views of ``plan.dec``, one row per channel,
    SAU terms zero-padded to the widest channel (a zero sign contributes
    nothing to the shift/add network): the layout of the reference's
    ``plan_dec_arrays``."""
    if plan.dec is None:
        raise ValueError(f"plan (v={plan.v}) has no in-kernel decompose constants")
    dec = plan.dec
    t_max = max(len(c.beta_terms) for c in dec)
    beta_e = np.zeros((plan.t, t_max), dtype=np.int64)
    beta_s = np.zeros((plan.t, t_max), dtype=np.int64)
    for i, c in enumerate(dec):
        for j, (e, s) in enumerate(c.beta_terms):
            beta_e[i, j] = e
            beta_s[i, j] = s
    return {
        "sau_eps": np.array([c.sau_barrett[0] for c in dec], dtype=np.int64),
        "sau_s2": np.array([c.sau_barrett[2] for c in dec], dtype=np.int64),
        "acc_eps": np.array([c.acc_barrett[0] for c in dec], dtype=np.int64),
        "beta_e": beta_e,
        "beta_s": beta_s,
        "block_consts": np.array([c.block_consts for c in dec], dtype=np.int64),
    }


def make_dec(qs, v: int, beta_terms, block_consts) -> tuple[ChannelDecompose, ...] | None:
    """Per-channel decompose circuits, or None outside the int64 kernels'
    envelope (v > 31, or a SAU Barrett window v1 + 4 above 32 bits for
    some channel; the reference stops at 31 bits, 2*(v1 + 4) <= 63, and
    so refuses the default primes of n >= 32768 at t = 6, whose v1 is 28)."""
    if v > 31 or not all(terms[0][0] + 4 <= 32 for terms in beta_terms):
        return None
    return tuple(
        ChannelDecompose(
            qi=int(qi),
            beta_terms=tuple(tuple(term) for term in terms),
            block_consts=tuple(int(c) for c in block_consts[i]),
            # SAU output + block-sum headroom: c = v + v1 + 3 bits
            sau_barrett=barrett_constants(int(qi), v + terms[0][0] + 3, v),
            # accumulator of <= n_blocks reduced terms: < 2^{v+3}
            acc_barrett=barrett_constants(int(qi), v + 3, v),
        )
        for i, (qi, terms) in enumerate(zip(qs, beta_terms))
    )


def make_plan(qs, n: int, v: int, beta_terms, t_prime: int = 3, device="cpu") -> RnsPlan:
    t = len(qs)
    q = 1
    for qi in qs:
        q *= int(qi)
    seg_count = -(-q.bit_length() // v)
    beta_pows = np.array(
        [[pow(1 << v, k, int(qi)) for k in range(seg_count)] for qi in qs],
        dtype=np.int64,
    )
    n_blocks = -(-seg_count // t_prime)
    block_consts = np.array(
        [[pow(1 << v, t_prime * r, int(qi)) for r in range(n_blocks)] for qi in qs],
        dtype=np.int64,
    )
    w = 28
    L = -(-(q.bit_length() + t.bit_length()) // w)  # final accumulator < t * q
    qi_star = [q // int(qi) for qi in qs]
    qi_tilde = np.array(
        [pow(s % int(qi), int(qi) - 2, int(qi)) for s, qi in zip(qi_star, qs)],
        dtype=np.int64,
    )
    return RnsPlan(
        n=n,
        v=v,
        t=t,
        q=q,
        qs=np.array(qs, dtype=np.int64),
        beta_terms=tuple(tuple(tuple(term) for term in terms) for terms in beta_terms),
        seg_count=seg_count,
        beta_pows=beta_pows,
        t_prime=t_prime,
        block_consts=block_consts,
        w=w,
        L=L,
        qi_tilde=qi_tilde,
        qi_star_limbs=bigint.ints_to_limbs(qi_star, w, L),
        q_limbs=bigint.int_to_limbs(q, w, L),
        dec=make_dec(qs, v, beta_terms, block_consts),
        device=device,
    )


# --------------------------------------------------------------------------
# pre-processing
# --------------------------------------------------------------------------


def _sau_mul_beta(z: torch.Tensor, terms) -> torch.Tensor:
    """z * beta via shifts/adds; beta = sum(sign * 2^e) - 1 (Eq 5)."""
    acc = -z
    for e, s in terms:
        acc = acc + s * (z << e)
    return acc


def decompose_sau(z: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Alg 2 with SAUs: per channel i and block rho of t' segments,
        block = z0 + SAU(z1) + SAU(Barrett(SAU(z2)))
        acc  += Barrett(block) * [beta_i^{t' rho}]_{q_i} mod q_i
    and a final Barrett of the accumulator."""
    S, tp = plan.seg_count, plan.t_prime
    n_blocks = -(-S // tp)
    pad = n_blocks * tp - S
    if pad:
        z = torch.cat([z, z.new_zeros(z.shape[:-1] + (pad,))], dim=-1)
    outs = []
    for i in range(plan.t):
        qi = int(plan.qs[i])
        terms = plan.beta_terms[i]
        v1 = terms[0][0]
        eps, s1, s2 = barrett_constants(qi, plan.v + v1 + 3, plan.v)
        epsa, sa1, sa2 = barrett_constants(qi, plan.v + 3, plan.v)
        acc = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for rho in range(n_blocks):
            blk = z[..., rho * tp]
            if tp > 1:
                blk = blk + _sau_mul_beta(z[..., rho * tp + 1], terms)
            for k in range(2, tp):
                x = _sau_mul_beta(z[..., rho * tp + k], terms)
                x = barrett_reduce(x, qi, eps, s1, s2)
                for _ in range(k - 1):
                    x = _sau_mul_beta(x, terms)
                    x = barrett_reduce(x, qi, eps, s1, s2)
                blk = blk + x
            blk = barrett_reduce(blk, qi, eps, s1, s2)
            if rho == 0:
                acc = acc + blk
            else:
                acc = acc + (blk * int(plan.block_consts[i, rho])) % qi
        outs.append(barrett_reduce(acc, qi, epsa, sa1, sa2))
    return torch.stack(outs, dim=0)


# --------------------------------------------------------------------------
# post-processing
# --------------------------------------------------------------------------


def compose(residues: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Inverse CRT per Eq 10: residues (t, ...) -> base-2^w limbs (..., L)."""
    shape = (plan.t,) + (1,) * (residues.dim() - 1)
    qs = plan.qs_d.view(shape)
    y = (residues * plan.qi_tilde_d.view(shape)) % qs  # (t, ...)
    star = plan.qi_star_limbs_d.view(shape + (plan.L,))
    acc = (y[..., None] * star).sum(dim=0)  # (..., L), < t * 2^59
    acc = bigint.carry_normalize(acc, plan.w)
    q_b = plan.q_limbs_d.expand(acc.shape)
    return bigint.mod_by_subtraction(acc, q_b, plan.w, plan.t - 1)
