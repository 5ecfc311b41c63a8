"""Plain-PyTorch RNS stages of the fused end-to-end multiplier (port of
the in-kernel stages of ``repro.kernels.crt``).

:func:`decompose_stage` is one channel's Alg-2 SAU circuit and
:func:`compose_finalize` the Eq-10 tail (carry ripple, then t-1
conditional big-integer subtractions of q).  They are the building blocks
of ``kernels.ntt.fused_e2e_polymul_ref``, the plain version of the CUDA
e2e kernel, whose device functions ``decompose`` and ``compose_finalize``
in ``csrc/parentt.cuh`` repeat this arithmetic.  The standalone
decompose/compose kernels of the reference are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath
from repro_torch.core.rns import ChannelDecompose


def decompose_stage(z: torch.Tensor, ch: ChannelDecompose, *, seg_count: int,
                    t_prime: int) -> torch.Tensor:
    """z: (..., S) base-2^v segments -> residues (...) mod ``ch.qi``, with
    the channel's SAU shift/add network and Barrett constants from ``ch``."""
    qi = ch.qi
    eps, s1, s2 = ch.sau_barrett
    epsa, sa1, sa2 = ch.acc_barrett
    n_blocks = -(-seg_count // t_prime)

    def sau(x):
        acc = -x
        for e, s in ch.beta_terms:
            acc = acc + s * (x << e)
        return acc

    def red(x):
        return modmath.barrett_reduce(x, qi, eps, s1, s2)

    acc = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    for rho in range(n_blocks):
        blk = z[..., rho * t_prime]
        if t_prime > 1 and rho * t_prime + 1 < seg_count:
            blk = blk + sau(z[..., rho * t_prime + 1])
        for k in range(2, t_prime):
            if rho * t_prime + k >= seg_count:
                break
            x = red(sau(z[..., rho * t_prime + k]))
            for _ in range(k - 1):
                x = red(sau(x))
            blk = blk + x
        blk = red(blk)
        if rho == 0:
            acc = acc + blk
        else:
            acc = acc + (blk * ch.block_consts[rho]) % qi
    return modmath.barrett_reduce(acc, qi, epsa, sa1, sa2)


def compose_finalize(acc: torch.Tensor, q_limbs, *, w: int, t: int) -> torch.Tensor:
    """Raw limb-product sums (..., L) (each < t * 2^{v+w}) -> canonical
    base-2^w limbs of the composed value mod q.  ``q_limbs``: L host ints."""
    q_limbs = [int(x) for x in q_limbs]
    L = acc.shape[-1]
    mask = (1 << w) - 1
    outs = []
    carry = torch.zeros_like(acc[..., 0])
    for i in range(L):
        s = acc[..., i] + carry
        outs.append(s & mask)
        carry = s >> w
    acc = torch.stack(outs, dim=-1)
    for _ in range(t - 1):
        ge = torch.ones(acc.shape[:-1], dtype=torch.bool, device=acc.device)
        decided = torch.zeros_like(ge)
        for i in range(L - 1, -1, -1):
            gt = acc[..., i] > q_limbs[i]
            lt = acc[..., i] < q_limbs[i]
            ge = torch.where(~decided & gt, True, ge)
            ge = torch.where(~decided & lt, False, ge)
            decided = decided | gt | lt
        borrow = torch.zeros_like(acc[..., 0])
        subbed = []
        for i in range(L):
            d = acc[..., i] - q_limbs[i] - borrow
            neg = d < 0
            subbed.append(torch.where(neg, d + (1 << w), d))
            borrow = neg.to(acc.dtype)
        acc = torch.where(ge[..., None], torch.stack(subbed, dim=-1), acc)
    return acc
