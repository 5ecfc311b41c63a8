"""Negative-wrapped-convolution NTT / iNTT with the no-shuffle cascade
(PyTorch port of ``repro.core.ntt``, radix-2 schedule).

* Forward: decimation-in-time (CT) butterflies with the weights
  psi^(2k+1) merged into the twiddles; natural-order input,
  **bit-reversed** output.
* Inverse: the forward flow graph retraced in reverse stage order with
  the inverse twiddles, halving both butterfly outputs in every stage
  (Eq 24), so n^-1 is folded in; bit-reversed input, natural output.
* ``intt(ntt(a) * ntt(b))`` therefore needs no permutation at all.

The strict transforms here (Barrett, or ``%`` when the configuration has
no Barrett constants) are the reference datapath of ``backend="torch"``.
The Harvey lazy butterflies of the kernels' plain versions run through
the same stage loops (:func:`ct_stages`, :func:`gs_stages`) with other
butterfly closures.

:class:`ChannelTables` keeps the host numpy tables and their device
copies, uploaded once when the object is built.  The four-step row
tables of the reference are a TPU lane-layout device and are not part of
the port.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import modmath
from repro_torch.core import primes as primes_mod
from repro_torch.core.modmath import add_mod, div2_mod, mul_mod, sub_mod


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reverse of i over log2(n) bits."""
    m = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros_like(idx)
    for b in range(m):
        out |= ((idx >> b) & 1) << (m - 1 - b)
    return out


class NttTables(NamedTuple):
    """Per-modulus twiddle tables for the merged-weight NWC transforms."""

    q: int
    n: int
    psi: int  # primitive 2n-th root of unity mod q
    fwd: np.ndarray  # (n,)  fwd[i] = psi^{brv(i)}
    inv: np.ndarray  # (n,)  inv[i] = psi^{-brv(i)}
    half: int  # (q + 1) / 2, for the div-by-2 PE (Eq 24)
    mul_eps: int | None = None
    mul_shifts: tuple[int, int] | None = None


@functools.lru_cache(maxsize=None)
def make_tables(q: int, n: int) -> NttTables:
    """Precompute twiddles (host-side Python bigints, cached)."""
    psi = primes_mod.root_of_unity(q, 2 * n)
    brv = bit_reverse_indices(n)
    fwd = np.array([pow(psi, int(b), q) for b in brv], dtype=np.int64)
    psi_inv = pow(psi, q - 2, q)
    inv = np.array([pow(psi_inv, int(b), q) for b in brv], dtype=np.int64)
    eps, shifts = modmath.mul_barrett_constants([q])
    return NttTables(
        q=q,
        n=n,
        psi=psi,
        fwd=fwd,
        inv=inv,
        half=(q + 1) // 2,
        mul_eps=int(eps[0]) if eps is not None else None,
        mul_shifts=shifts,
    )


# --------------------------------------------------------------------------
# stage loops (last-axis transforms; the butterfly closure slices its own
# twiddle tables with the stage's [lo, hi) block range)
# --------------------------------------------------------------------------

Butterfly = Callable[[torch.Tensor, torch.Tensor, int, int], tuple]


def twiddles(tab: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Stage twiddle block ``tab[..., lo:hi]`` laid out (..., m, 1) to
    broadcast over the (..., m, pair_stride) butterfly view."""
    return tab[..., lo:hi].unsqueeze(-1)


def ct_stages(a: torch.Tensor, ct: Butterfly) -> torch.Tensor:
    """CT/DIT stages: pair stride n/2 .. 1, block m uses twiddle m + i."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    m, h = 1, n
    while m < n:
        h //= 2
        x = a.reshape(lead + (m, 2, h))
        hi, lo = ct(x[..., 0, :], x[..., 1, :], m, 2 * m)
        a = torch.stack([hi, lo], dim=-2).reshape(lead + (n,))
        m *= 2
    return a


def gs_stages(a: torch.Tensor, gs: Butterfly) -> torch.Tensor:
    """Mirror-order GS stages: pair stride 1 .. n/2, block i uses twiddle
    h + i with h = n/2 .. 1."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    h, s = n // 2, 1
    while h >= 1:
        x = a.reshape(lead + (h, 2, s))
        u, v = gs(x[..., 0, :], x[..., 1, :], h, 2 * h)
        a = torch.stack([u, v], dim=-2).reshape(lead + (n,))
        h //= 2
        s *= 2
    return a


def ntt_raw(a, fwd, q, eps=None, shifts=None) -> torch.Tensor:
    """Forward NWC NTT, natural-in, bit-reversed-out, on the last axis.

    ``fwd``'s leading dims broadcast against ``a``'s; ``q``/``eps`` are
    python ints or tensors shaped ``(..., 1, 1)`` against them."""

    def ct(u, v, lo, hi):
        p = mul_mod(v, twiddles(fwd, lo, hi), q, eps, shifts)
        return add_mod(u, p, q), sub_mod(u, p, q)

    return ct_stages(a, ct)


def intt_raw(a, inv, q, half, eps=None, shifts=None) -> torch.Tensor:
    """Inverse NWC NTT, bit-reversed-in, natural-out; n^-1 folded into the
    per-stage halving (paper Fig 9 / Eq 20-25)."""

    def gs(u, v, lo, hi):
        s = add_mod(u, v, q)
        d = mul_mod(sub_mod(u, v, q), twiddles(inv, lo, hi), q, eps, shifts)
        return div2_mod(s, half), div2_mod(d, half)

    return gs_stages(a, gs)


# --------------------------------------------------------------------------
# multi-channel (RNS) tables and transforms: leading axis = channel
# --------------------------------------------------------------------------

_DEVICE_FIELDS = ("qs", "fwd", "inv", "half", "mul_eps", "fwd_shoup", "inv_shoup")


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelTables:
    """Stacked per-channel twiddle tables, Barrett constants and the
    Harvey lazy-reduction (Shoup) tables with their window.

    The numpy fields are the canonical host values; ``<field>_d`` are
    their int64 copies on ``device``, uploaded once in ``__post_init__``.
    """

    qs: np.ndarray  # (t,)
    fwd: np.ndarray  # (t, n)
    inv: np.ndarray  # (t, n)
    half: np.ndarray  # (t,)
    mul_eps: np.ndarray | None = None  # (t,) Barrett eps, None outside envelope
    mul_shifts: tuple[int, int] | None = None  # shift pair shared by channels
    fwd_shoup: np.ndarray | None = None  # (t, n), None outside the lazy envelope
    inv_shoup: np.ndarray | None = None
    lazy_window: int | None = None  # butterfly values stay in [0, window*q)
    shoup_beta: int | None = None
    device: torch.device = torch.device("cpu")

    @property
    def n(self) -> int:
        return self.fwd.shape[-1]

    @property
    def t(self) -> int:
        return self.fwd.shape[0]

    @property
    def lazy(self) -> tuple[int, int] | None:
        """(window, beta) for the lazy butterflies, or None (strict)."""
        if self.lazy_window is None or self.mul_shifts is None:
            return None
        return self.lazy_window, self.shoup_beta

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))
        if self.lazy_window is not None:
            for q in np.atleast_1d(self.qs):
                modmath.validate_lazy_envelope(int(q), self.lazy_window, self.shoup_beta)
        for name in _DEVICE_FIELDS:
            host = getattr(self, name)
            dev = None if host is None else torch.as_tensor(host, device=self.device)
            object.__setattr__(self, name + "_d", dev)


def make_channel_tables(qs, n: int, device="cpu") -> ChannelTables:
    tabs = [make_tables(int(q), n) for q in qs]
    eps, shifts = modmath.mul_barrett_constants([tb.q for tb in tabs])
    fwd = np.stack([tb.fwd for tb in tabs])
    inv = np.stack([tb.inv for tb in tabs])
    window, beta = modmath.lazy_params([tb.q for tb in tabs])
    shoups = {}
    if window is not None:
        for name, tab in (("fwd_shoup", fwd), ("inv_shoup", inv)):
            shoups[name] = np.stack(
                [modmath.shoup_constants(tab[i], tb.q, beta) for i, tb in enumerate(tabs)]
            )
    return ChannelTables(
        qs=np.array([tb.q for tb in tabs], dtype=np.int64),
        fwd=fwd,
        inv=inv,
        half=np.array([tb.half for tb in tabs], dtype=np.int64),
        mul_eps=eps,
        mul_shifts=shifts,
        lazy_window=window,
        shoup_beta=beta,
        device=device,
        **shoups,
    )


def channel_scalars(ct: ChannelTables, ndim: int):
    """(q, half, eps) device tensors shaped (t,) + (1,) * (ndim - 1) to
    broadcast against a (t, ...) tensor of ``ndim`` dims (eps None when
    the tables have no Barrett constants)."""
    shape = (ct.t,) + (1,) * (ndim - 1)
    eps = None if ct.mul_eps_d is None else ct.mul_eps_d.view(shape)
    return ct.qs_d.view(shape), ct.half_d.view(shape), eps


def ntt_channels(a: torch.Tensor, ct: ChannelTables) -> torch.Tensor:
    """a: (t, ..., n) -> (t, ..., n), channel c transformed mod qs[c]."""
    a3 = a.reshape(ct.t, -1, ct.n)
    q, _, eps = channel_scalars(ct, 4)
    out = ntt_raw(a3, ct.fwd_d[:, None, :], q, eps, ct.mul_shifts)
    return out.reshape(a.shape)


def intt_channels(a: torch.Tensor, ct: ChannelTables) -> torch.Tensor:
    a3 = a.reshape(ct.t, -1, ct.n)
    q, half, eps = channel_scalars(ct, 4)
    out = intt_raw(a3, ct.inv_d[:, None, :], q, half, eps, ct.mul_shifts)
    return out.reshape(a.shape)


def negacyclic_mul_channels(a: torch.Tensor, b: torch.Tensor, ct: ChannelTables) -> torch.Tensor:
    """(t, ..., n) x (t, ..., n): the RNS-parallel no-shuffle cascade."""
    q, _, eps = channel_scalars(ct, a.dim())
    fa = ntt_channels(a, ct)
    fb = ntt_channels(b, ct)
    return intt_channels(mul_mod(fa, fb, q, eps, ct.mul_shifts), ct)
