"""RLWE/BFV somewhat-homomorphic layer on the PaReNTT multiplier (PyTorch
port of ``repro.core.bfv``).

The paper builds the modular polynomial multiplier that dominates HE
evaluation; this module is the HE scheme that consumes it, for the two
applications of the repo:

  * additively homomorphic secure gradient aggregation (enc / add / dec),
    :mod:`repro_torch.train.aggregation`;
  * encrypted linear-layer inference (ct x plaintext),
    ``python -m repro_torch.examples.encrypted_inference``.

Everything stays in RNS residue form ``(t, ..., n)`` on the plan's
device; composition to big integers happens only inside :func:`decrypt`
(client side).  Every homomorphic product runs
:func:`repro_torch.api.negacyclic_mul` on the context's plan (the fused
cascade kernel K1 on the card) and every decrypt composes through
:func:`repro_torch.api.compose` (K6).  ct x ct multiplication with
relinearization lives in the host bigint reference
:mod:`repro_torch.core.bfv_ref`.

Sampling draws from an explicit ``torch.Generator`` on the plan's device;
the arithmetic sits in :func:`_keygen_with` and :func:`_encrypt_with`,
which take the samples.

SECURITY NOTE: parameters here are sized for systems evaluation, not for
a production 128-bit security level.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.params import ParenttParams


class BfvContext(NamedTuple):
    plan: api.Plan
    pt_mod: int  # plaintext modulus p_t
    delta_res: torch.Tensor  # (t,) floor(q / p_t) mod q_i, on the plan's device
    noise_bound: int  # max magnitude of fresh noise samples

    @property
    def params(self) -> ParenttParams:
        return self.plan.params


@dataclasses.dataclass
class Ciphertext:
    """BFV ciphertext in RNS coefficient form: c: (2, t, ..., n)."""

    c: torch.Tensor

    @property
    def batch_shape(self) -> torch.Size:
        return self.c.shape[2:-1]


class KeyPair(NamedTuple):
    sk: torch.Tensor  # (t, n) residues of the ternary secret
    pk: torch.Tensor  # (2, t, n)


def make_context(
    n: int = 4096, t: int = 6, v: int = 30, pt_mod: int = 1 << 24,
    backend: str = "auto", device=None,
) -> BfvContext:
    """A BFV context on :func:`repro_torch.plan` ``(n, t, v)``.  The
    default ``backend="auto"`` runs every product on K1 and every compose
    on K6 on the card; ``"torch"`` is the plain datapath (the
    reference's ``"jnp"``).  ``device=None`` means the card, and raises
    without one unless ``device="cpu"`` is passed."""
    plan = api.plan(n=n, t=t, v=v, backend=backend, device=device)
    delta = plan.q // pt_mod
    delta_res = torch.tensor([delta % int(q) for q in plan.params.qs], dtype=torch.int64,
                             device=plan.device)
    return BfvContext(plan=plan, pt_mod=pt_mod, delta_res=delta_res, noise_bound=8)


def _qs(ctx: BfvContext, ndim: int) -> torch.Tensor:
    """The channel moduli shaped (t, 1, ..., 1) against ``ndim`` more axes."""
    return ctx.params.plan.qs_d.view((-1,) + (1,) * ndim)


def _lift(x: torch.Tensor, ctx: BfvContext) -> torch.Tensor:
    """Small signed values (...) -> per-channel residues (t, ...)."""
    x = torch.as_tensor(x, dtype=torch.int64, device=ctx.plan.device)
    return x[None] % _qs(ctx, x.dim())


def _over_channels(x: torch.Tensor, lead: tuple, ctx: BfvContext) -> torch.Tensor:
    """(t, n) -> a (t, *lead, n) view that repeats it over the batch."""
    t, n = ctx.params.t, ctx.params.n
    return x.reshape((t,) + (1,) * len(lead) + (n,)).expand((t,) + tuple(lead) + (n,))


# --------------------------------------------------------------------------
# sampling: ternary in {-1, 0, 1}, noise the difference of two uniforms on
# [0, bound], uniform residues drawn per channel on [0, q_i)
# --------------------------------------------------------------------------


def _randint(gen: torch.Generator, low: int, high: int, shape, ctx: BfvContext) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen, device=ctx.plan.device,
                         dtype=torch.int64)


def _ternary(gen: torch.Generator, shape, ctx: BfvContext) -> torch.Tensor:
    return _randint(gen, -1, 2, shape, ctx)


def _noise(gen: torch.Generator, shape, ctx: BfvContext) -> torch.Tensor:
    """Signed noise in [-bound, bound]: the difference of two uniforms."""
    bound = ctx.noise_bound
    return _randint(gen, 0, bound + 1, shape, ctx) - _randint(gen, 0, bound + 1, shape, ctx)


def _uniform_res(gen: torch.Generator, shape, ctx: BfvContext) -> torch.Tensor:
    """Uniform element of R_q in residue form (t, *shape)."""
    return torch.stack([_randint(gen, 0, int(q), shape, ctx) for q in ctx.params.qs])


# --------------------------------------------------------------------------
# keygen / encrypt / decrypt
# --------------------------------------------------------------------------


def keygen(gen: torch.Generator, ctx: BfvContext) -> KeyPair:
    """Secret and public key drawn from ``gen`` (a generator on the
    plan's device)."""
    n = ctx.params.n
    s = _ternary(gen, (n,), ctx)
    a = _uniform_res(gen, (n,), ctx)
    e = _noise(gen, (n,), ctx)
    return _keygen_with(s, a, e, ctx)


def _keygen_with(s: torch.Tensor, a: torch.Tensor, e: torch.Tensor,
                 ctx: BfvContext) -> KeyPair:
    """s: (n,) ternary, a: (t, n) uniform residues, e: (n,) signed noise
    -> sk = s, pk = (-(a s + e), a) in residue form."""
    s_res = _lift(s, ctx)
    e_res = _lift(e, ctx)
    a = torch.as_tensor(a, dtype=torch.int64, device=ctx.plan.device)
    q_b = _qs(ctx, 1)
    as_ = api.negacyclic_mul(ctx.plan, a, s_res)
    pk0 = (q_b - (as_ + e_res) % q_b) % q_b
    return KeyPair(sk=s_res, pk=torch.stack([pk0, a]))


def encrypt(gen: torch.Generator, m, kp: KeyPair, ctx: BfvContext) -> Ciphertext:
    """m: (..., n) ints in [0, pt_mod) -> ct (2, t, ..., n), with u, e1
    and e2 drawn from ``gen``."""
    shape = tuple(m.shape)
    u = _ternary(gen, shape, ctx)
    e1 = _noise(gen, shape, ctx)
    e2 = _noise(gen, shape, ctx)
    return _encrypt_with(m, u, e1, e2, kp, ctx)


def _encrypt_with(m, u: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor, kp: KeyPair,
                  ctx: BfvContext) -> Ciphertext:
    """c0 = pk0 u + e1 + Delta m, c1 = pk1 u + e2 (u ternary, e1 and e2
    signed noise, all (..., n))."""
    m = torch.as_tensor(m, dtype=torch.int64, device=ctx.plan.device)
    lead = tuple(m.shape[:-1])
    u, e1, e2 = (_lift(x, ctx) for x in (u, e1, e2))
    q_b = _qs(ctx, len(lead) + 1)
    pk0 = _over_channels(kp.pk[0], lead, ctx)
    pk1 = _over_channels(kp.pk[1], lead, ctx)
    dm = (m[None] % ctx.pt_mod) * ctx.delta_res.view(q_b.shape)  # < 2^24 * 2^31
    c0 = (api.negacyclic_mul(ctx.plan, pk0, u) + e1 + dm % q_b) % q_b
    c1 = (api.negacyclic_mul(ctx.plan, pk1, u) + e2) % q_b
    return Ciphertext(c=torch.stack([c0, c1]))


def _phase(ct: Ciphertext, kp: KeyPair, ctx: BfvContext) -> torch.Tensor:
    """c0 + c1 s, canonical residues (t, ..., n): what compose takes."""
    lead = tuple(ct.batch_shape)
    sk = _over_channels(kp.sk, lead, ctx)
    c1s = api.negacyclic_mul(ctx.plan, ct.c[1], sk)
    return (ct.c[0] + c1s) % _qs(ctx, len(lead) + 1)


def _phase_limbs(ct: Ciphertext, kp: KeyPair, ctx: BfvContext) -> torch.Tensor:
    """The device part of a decrypt: the phase composed to base-2^w limbs
    (..., n, L) on the plan's device."""
    return api.compose(ctx.plan, _phase(ct, kp, ctx))


def _phase_ints(limbs: torch.Tensor, ctx: BfvContext) -> np.ndarray:
    """(..., L) limbs -> the composed values as an object array of Python
    ints (exact), one copy off the device."""
    arr = limbs.cpu().numpy()
    x = np.zeros(arr.shape[:-1], dtype=object)
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << ctx.params.plan.w) + arr[..., i].astype(object)
    return x


def _round(x: np.ndarray, ctx: BfvContext) -> np.ndarray:
    """Host rounding of composed phases: round(pt x / q) mod pt, exact."""
    q, pt = ctx.params.q, ctx.pt_mod
    return (((pt * x + q // 2) // q) % pt).astype(np.int64)


def decrypt(ct: Ciphertext, kp: KeyPair, ctx: BfvContext) -> np.ndarray:
    """Client-side decryption: the phase and its compose on the plan's
    device, then exact Python-int rounding on the host.  Returns (..., n)
    int64 in [0, pt_mod)."""
    return _round(_phase_ints(_phase_limbs(ct, kp, ctx), ctx), ctx)


def noise_budget_bits(ct: Ciphertext, kp: KeyPair, ctx: BfvContext, m) -> float:
    """log2(q / (2 |noise|)) of the worst coefficient: the remaining
    headroom (diagnostic, host)."""
    x = _phase_ints(_phase_limbs(ct, kp, ctx), ctx).reshape(-1)
    mm = np.asarray(torch.as_tensor(m).cpu(), dtype=np.int64).reshape(-1)
    if mm.shape != x.shape:
        raise ValueError(f"noise_budget_bits: {mm.size} plaintext values for {x.size} "
                         "coefficients")
    q = ctx.params.q
    noise = (x - (q // ctx.pt_mod) * mm.astype(object)) % q
    worst = max(int(np.minimum(noise, q - noise).max()), 1)
    return math.log2(q) - 1 - math.log2(worst)


# --------------------------------------------------------------------------
# homomorphic ops (evaluation side: what the untrusted server runs; every
# polynomial product goes through the PaReNTT cascade)
# --------------------------------------------------------------------------


def add(a: Ciphertext, b: Ciphertext, ctx: BfvContext) -> Ciphertext:
    return Ciphertext(c=(a.c + b.c) % _qs(ctx, a.c.dim() - 2)[None])


def add_many(cts: Sequence[Ciphertext], ctx: BfvContext) -> Ciphertext:
    q_b = _qs(ctx, cts[0].c.dim() - 2)[None]
    acc = cts[0].c
    for ct in cts[1:]:
        acc = (acc + ct.c) % q_b
    return Ciphertext(c=acc)


def mul_plain(ct: Ciphertext, pt_poly, ctx: BfvContext) -> Ciphertext:
    """ct x plaintext polynomial (small signed ints).  pt_poly: (..., n),
    broadcast against the ciphertext batch.  Both ciphertext components
    ride the PaReNTT multiplier."""
    w = _lift(pt_poly, ctx)  # (t, ..., n)
    tgt = ct.c.shape[1:]  # (t, ..., n)
    while w.dim() < len(tgt):
        w = w[:, None]
    w = w.expand(tgt)
    c0 = api.negacyclic_mul(ctx.plan, ct.c[0], w)
    c1 = api.negacyclic_mul(ctx.plan, ct.c[1], w)
    return Ciphertext(c=torch.stack([c0, c1]))
