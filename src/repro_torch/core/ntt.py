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

The four-step (Bailey) layer regroups the same flow graph: the length-n
polynomial viewed as an (n1, n2) tile runs log2(n1) column stages (the
``fwd[:n1]`` prefix), then log2(n2) row stages whose twist correction is
merged into per-row twiddles (:func:`four_step_row_indices`), recursing
into a hierarchical chain of column splits (:func:`four_step_chain`).
:func:`ntt_raw_hier` / :func:`intt_raw_hier` follow the reference's
grouping and tables exactly and equal :func:`ntt_raw` / :func:`intt_raw`
bit for bit at every depth; ``backend="torch"`` runs them when the plan's
schedule is four-step.  The chain's factors (128 lanes, 8 sublanes) are
the TPU's; the card's multi-block kernels choose their own split
(:func:`repro_torch.kernels.ntt.fs_split`).

:class:`ChannelTables` keeps the host numpy tables and their device
copies, uploaded once when the object is built.
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


def _powers(base: int, n: int, q: int) -> np.ndarray:
    """base^k mod q for k = 0 .. n - 1: by doubling in int64 lanes where
    every product stays below 2^63 (q < 2^31), else with host bigints;
    the same integers either way."""
    if q >= 1 << 31:
        return np.array([pow(base, k, q) for k in range(n)], dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    out[0] = 1
    m, step = 1, base % q
    while m < n:
        k = min(m, n - m)
        out[m:m + k] = out[:k] * step % q
        step = step * step % q
        m *= 2
    return out


@functools.lru_cache(maxsize=None)
def make_tables(q: int, n: int) -> NttTables:
    """Precompute twiddles (cached): psi^brv(i) and psi^-brv(i) mod q."""
    psi = primes_mod.root_of_unity(q, 2 * n)
    brv = bit_reverse_indices(n)
    fwd = _powers(psi, n, q)[brv]
    psi_inv = pow(psi, q - 2, q)
    inv = _powers(psi_inv, n, q)[brv]
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
# four-step (Bailey) schedule: the same flow graph as the radix-2 loops,
# regrouped into column and row transforms of an (n1, n2) tile
# --------------------------------------------------------------------------


def four_step_split(n: int) -> tuple[int, int]:
    """(n1, n2) tile of the reference's level 0: n2 = 128 (the TPU lane
    width) when n >= 256, else n // 2 so at least one column stage
    exists.  Requires n a power of two >= 4."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"four_step schedule needs a power-of-two n >= 4, got n={n}")
    n2 = 128 if n >= 256 else n // 2
    return n // n2, n2


# Column lengths above MAX_FS_COL re-split into a further four-step level
# (the hierarchical schedule) with SUB_ROW_FACTOR rows: the TPU's sublane
# height, kept so the chain, and every spec built on it, equals the
# reference's.
MAX_FS_COL = 32
SUB_ROW_FACTOR = 8


def four_step_chain(n: int) -> tuple[tuple[int, int], ...]:
    """The canonical hierarchical split chain of a length-n transform:
    per-level ``(columns, rows)``, outermost first.  Level 0 is
    :func:`four_step_split`; while the column length exceeds
    ``MAX_FS_COL`` it re-splits with ``SUB_ROW_FACTOR`` rows, so
    ``chain[l][0] == prod(chain[l+1:])``.  n=4096 -> ((32, 128),);
    n=8192 -> ((64, 128), (8, 8)); n=65536 -> ((512, 128), (64, 8), (8, 8))."""
    n1, n2 = four_step_split(n)
    chain = [(n1, n2)]
    c = n1
    while c > MAX_FS_COL:
        c //= SUB_ROW_FACTOR
        chain.append((c, SUB_ROW_FACTOR))
    return tuple(chain)


def four_step_row_indices(n1: int, n2: int) -> np.ndarray:
    """(n2, n1) gather into a length-n stage table: the row-stage twiddle
    of transposed-tile entry (m', j), m' = 2^k + l the DIT block index of a
    length-n2 transform and j the original row, is
    ``base[((n1 + j) << k) + l]``.  Entry m' = 0 is never read."""
    idx = np.zeros((n2, n1), dtype=np.int64)
    j = np.arange(n1, dtype=np.int64)
    for mp in range(1, n2):
        k = mp.bit_length() - 1
        idx[mp] = ((n1 + j) << k) + (mp - (1 << k))
    return idx


def stage_lane_strides(n: int, schedule) -> tuple[int, ...]:
    """Butterfly pair distance along the lane (last tile) axis per stage of
    one transform: radix2 pairs at strides n/2 .. 1 in the flat axis;
    four_step pairs only along sublane-side axes at any depth, 0 at every
    stage.  ``schedule`` is a concrete string or a resolved spec."""
    stages = n.bit_length() - 1
    kind = getattr(schedule, "kind", schedule)
    if kind == "four_step":
        four_step_split(n)  # validate n
        return (0,) * stages
    if kind != "radix2":
        raise ValueError(f"unknown concrete schedule {schedule!r}")
    return tuple(n >> (s + 1) for s in range(stages))


# The transforms below take ``a`` shaped lead + (n,), twiddle tables whose
# leading dims broadcast against ``lead`` (``fwd`` lead' + (n,), row tables
# lead' + (rows, cols)), and q / half / eps as python ints or tensors that
# broadcast against ``lead``: _lanes views them against a stage's dims.


def _lanes(extra: int, *xs):
    """Scalars broadcasting against the leading dims, viewed against
    ``extra`` more trailing dims (python ints and None pass through)."""
    return tuple(x.reshape(x.shape + (1,) * extra) if torch.is_tensor(x) else x for x in xs)


def _ct(u, v, w, q, eps, shifts):
    p = mul_mod(v, w, q, eps, shifts)
    return torch.stack([add_mod(u, p, q), sub_mod(u, p, q)], dim=-3)


def _gs(u, v, w, q, half, eps, shifts):
    s = add_mod(u, v, q)
    d = mul_mod(sub_mod(u, v, q), w, q, eps, shifts)
    return torch.stack([div2_mod(s, half), div2_mod(d, half)], dim=-3)


def _hier_cols_fwd(x, fwd, sub_tabs, q, eps, shifts):
    """Length-c forward NWC NTT along axis -2 of a lead + (c, B) tile.
    ``sub_tabs``: the twist-merged sub-row tables of the remaining splits
    of c (outermost first, each lead' + (sr, sc)).  None left: radix-2
    column stages on the ``fwd[:c]`` prefix; else view c = sc * sr, run
    the length-sc sub-columns with sr folded into the batch axis, then
    the length-sr sub-rows with per-sub-column twist tables."""
    c, B = x.shape[-2:]
    lead = x.shape[:-2]
    if not sub_tabs:
        qq, ee = _lanes(3, q, eps)
        m, tc = 1, c
        while m < c:
            tc //= 2
            y = x.reshape(lead + (m, 2, tc, B))
            w = fwd[..., m:2 * m, None, None]
            x = _ct(y[..., 0, :, :], y[..., 1, :, :], w, qq, ee, shifts).reshape(lead + (c, B))
            m *= 2
        return x
    rtab = sub_tabs[0]
    sr, sc = rtab.shape[-2:]
    x = x.reshape(lead + (sc, sr * B))
    x = _hier_cols_fwd(x, fwd, sub_tabs[1:], q, eps, shifts).reshape(lead + (sc, sr, B))
    qq, ee = _lanes(4, q, eps)
    m, tr = 1, sr
    while m < sr:
        tr //= 2
        y = x.reshape(lead + (sc, m, 2, tr, B))
        w = rtab[..., m:2 * m, :].transpose(-1, -2)[..., None, None]  # (sc, m, 1, 1)
        x = _ct(y[..., 0, :, :], y[..., 1, :, :], w, qq, ee, shifts).reshape(lead + (sc, sr, B))
        m *= 2
    return x.reshape(lead + (c, B))


def _hier_cols_inv(x, inv, sub_tabs, q, half, eps, shifts):
    """Inverse mirror of :func:`_hier_cols_fwd`: sub-row GS stages first,
    then the sub-column recursion, in reverse stage order (the per-stage
    halving folds in the length factor)."""
    c, B = x.shape[-2:]
    lead = x.shape[:-2]
    if not sub_tabs:
        qq, hh, ee = _lanes(3, q, half, eps)
        h, tc = c // 2, 1
        while h >= 1:
            y = x.reshape(lead + (h, 2, tc, B))
            w = inv[..., h:2 * h, None, None]
            x = _gs(y[..., 0, :, :], y[..., 1, :, :], w, qq, hh, ee, shifts).reshape(lead + (c, B))
            h //= 2
            tc *= 2
        return x
    rtab = sub_tabs[0]
    sr, sc = rtab.shape[-2:]
    x = x.reshape(lead + (sc, sr, B))
    qq, hh, ee = _lanes(4, q, half, eps)
    h, tr = sr // 2, 1
    while h >= 1:
        y = x.reshape(lead + (sc, h, 2, tr, B))
        w = rtab[..., h:2 * h, :].transpose(-1, -2)[..., None, None]  # (sc, h, 1, 1)
        x = _gs(y[..., 0, :, :], y[..., 1, :, :], w, qq, hh, ee, shifts)
        x = x.reshape(lead + (sc, sr, B))
        h //= 2
        tr *= 2
    x = _hier_cols_inv(x.reshape(lead + (sc, sr * B)), inv, sub_tabs[1:], q, half, eps, shifts)
    return x.reshape(lead + (c, B))


def ntt_raw_hier(a, fwd, row_tabs, q, eps=None, shifts=None) -> torch.Tensor:
    """Forward NWC NTT through the (possibly hierarchical) four-step
    schedule, equal to :func:`ntt_raw` at any depth.  ``row_tabs``: the
    per-level twist-merged row tables, outermost first: ``row_tabs[0]`` the
    level-0 (n2, n1) table ``fwd[four_step_row_indices(n1, n2)]``,
    ``row_tabs[1:]`` the (r_l, c_l) sub-level tables of the column
    recursion.  Level-0 rows pair along the former n2 axis after one
    tile transpose."""
    n = a.shape[-1]
    n2, n1 = row_tabs[0].shape[-2:]
    lead = a.shape[:-1]
    x = _hier_cols_fwd(a.reshape(lead + (n1, n2)), fwd, tuple(row_tabs[1:]), q, eps, shifts)
    xt = x.transpose(-1, -2)  # (n2, n1): the row stages pair along axis -2
    qq, ee = _lanes(3, q, eps)
    m, tr = 1, n2
    while m < n2:
        tr //= 2
        y = xt.reshape(lead + (m, 2, tr, n1))
        w = row_tabs[0][..., m:2 * m, None, :]  # (m, 1, n1): per-row twiddles
        xt = _ct(y[..., 0, :, :], y[..., 1, :, :], w, qq, ee, shifts).reshape(lead + (n2, n1))
        m *= 2
    return xt.transpose(-1, -2).reshape(lead + (n,))


def intt_raw_hier(a, inv, row_tabs, q, half, eps=None, shifts=None) -> torch.Tensor:
    """Inverse mirror of :func:`ntt_raw_hier`, equal to :func:`intt_raw`
    at any depth: the level-0 row stages (transposed tile) first, then
    the hierarchical column inverse."""
    n = a.shape[-1]
    n2, n1 = row_tabs[0].shape[-2:]
    lead = a.shape[:-1]
    xt = a.reshape(lead + (n1, n2)).transpose(-1, -2)  # (n2, n1)
    qq, hh, ee = _lanes(3, q, half, eps)
    h, tr = n2 // 2, 1
    while h >= 1:
        y = xt.reshape(lead + (h, 2, tr, n1))
        w = row_tabs[0][..., h:2 * h, None, :]  # (h, 1, n1)
        xt = _gs(y[..., 0, :, :], y[..., 1, :, :], w, qq, hh, ee, shifts)
        xt = xt.reshape(lead + (n2, n1))
        h //= 2
        tr *= 2
    x = _hier_cols_inv(xt.transpose(-1, -2), inv, tuple(row_tabs[1:]), q, half, eps, shifts)
    return x.reshape(lead + (n,))


def ntt_raw_four_step(a, fwd, row_fwd, q, eps=None, shifts=None) -> torch.Tensor:
    """Depth-1 four-step forward NTT (:func:`ntt_raw_hier` with one level)."""
    return ntt_raw_hier(a, fwd, (row_fwd,), q, eps, shifts)


def intt_raw_four_step(a, inv, row_inv, q, half, eps=None, shifts=None) -> torch.Tensor:
    """Depth-1 four-step inverse NTT (see :func:`intt_raw_hier`)."""
    return intt_raw_hier(a, inv, (row_inv,), q, half, eps, shifts)


# --------------------------------------------------------------------------
# multi-channel (RNS) tables and transforms: leading axis = channel
# --------------------------------------------------------------------------

DEVICE_FIELDS = ("qs", "fwd", "inv", "half", "mul_eps", "fwd_shoup", "inv_shoup",
                  "fs_row_fwd", "fs_row_inv", "fs_row_fwd_shoup", "fs_row_inv_shoup")
DEVICE_LEVELS = ("fs_sub_fwd", "fs_sub_inv", "fs_sub_fwd_shoup", "fs_sub_inv_shoup")


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelTables:
    """Stacked per-channel twiddle tables, Barrett constants, the
    four-step row tables of the reference's chain and the Harvey
    lazy-reduction (Shoup) tables with their window.

    The numpy fields are the canonical host values; ``<field>_d`` are
    their int64 copies on ``device`` (tuples of them for the per-level
    fields), uploaded once in ``__post_init__``.
    """

    qs: np.ndarray  # (t,)
    fwd: np.ndarray  # (t, n)
    inv: np.ndarray  # (t, n)
    half: np.ndarray  # (t,)
    mul_eps: np.ndarray | None = None  # (t,) Barrett eps, None outside envelope
    mul_shifts: tuple[int, int] | None = None  # shift pair shared by channels
    # four-step: (t, n2, n1) twist-merged level-0 row tables (the columns
    # use the fwd/inv prefixes); None when n < 4
    fs_row_fwd: np.ndarray | None = None
    fs_row_inv: np.ndarray | None = None
    # levels >= 1 of the canonical chain: per-level (t, r_l, c_l) sub-row
    # tables; () at depth 1
    fs_sub_fwd: tuple[np.ndarray, ...] = ()
    fs_sub_inv: tuple[np.ndarray, ...] = ()
    # Shoup constants, same layouts as their twiddle tables; None outside
    # the lazy envelope
    fwd_shoup: np.ndarray | None = None
    inv_shoup: np.ndarray | None = None
    fs_row_fwd_shoup: np.ndarray | None = None
    fs_row_inv_shoup: np.ndarray | None = None
    fs_sub_fwd_shoup: tuple[np.ndarray, ...] | None = None
    fs_sub_inv_shoup: tuple[np.ndarray, ...] | None = None
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
    def fs_split(self) -> tuple[int, int]:
        return four_step_split(self.n)

    @property
    def fs_chain(self) -> tuple[tuple[int, int], ...]:
        return four_step_chain(self.n)

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
        up = lambda host: torch.as_tensor(host, device=self.device)
        for name in DEVICE_FIELDS:
            host = getattr(self, name)
            object.__setattr__(self, name + "_d", None if host is None else up(host))
        for name in DEVICE_LEVELS:
            host = getattr(self, name)
            object.__setattr__(self, name + "_d",
                               None if host is None else tuple(up(h) for h in host))


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
        **four_step_tables(fwd, inv, shoups.get("fwd_shoup"), shoups.get("inv_shoup")),
    )


def slice_channel_tables(ct: ChannelTables, c0: int, c1: int) -> ChannelTables:
    """The tables of channels ``[c0, c1)`` of ``ct``: every per-channel
    field sliced (the four-step and Shoup tables too), the regime's shared
    constants (Barrett shifts, lazy window, Shoup beta) kept; uploaded to
    ``ct``'s device as one set of tables of its own."""
    cut = slice(c0, c1)
    part = {}
    for name in DEVICE_FIELDS:
        host = getattr(ct, name)
        part[name] = None if host is None else np.ascontiguousarray(host[cut])
    for name in DEVICE_LEVELS:
        host = getattr(ct, name)
        part[name] = None if host is None else tuple(np.ascontiguousarray(h[cut]) for h in host)
    return dataclasses.replace(ct, **part)


def four_step_tables(fwd: np.ndarray, inv: np.ndarray, fwd_shoup: np.ndarray | None = None,
                     inv_shoup: np.ndarray | None = None) -> dict:
    """The four-step fields of :class:`ChannelTables` from the (t, n) stage
    tables: the level-0 row tables and the sub-level tables of the
    canonical chain, and their Shoup tables where the Shoup stage tables
    are given.  Each is a gather of its stage table (a deeper level splits
    a level-(l-1) column, whose twiddles are a prefix of it); empty below
    n = 4."""
    n = fwd.shape[-1]
    if n < 4:
        return {}
    chain = four_step_chain(n)
    idx = four_step_row_indices(*chain[0])
    sub = [four_step_row_indices(c, r) for c, r in chain[1:]]
    four = {}
    for d, tab, sh in (("fwd", fwd, fwd_shoup), ("inv", inv, inv_shoup)):
        four[f"fs_row_{d}"] = tab[:, idx]
        four[f"fs_sub_{d}"] = tuple(tab[:, s] for s in sub)
        if sh is not None:
            four[f"fs_row_{d}_shoup"] = sh[:, idx]
            four[f"fs_sub_{d}_shoup"] = tuple(sh[:, s] for s in sub)
    return four


def channel_scalars(ct: ChannelTables, ndim: int):
    """(q, half, eps) device tensors shaped (t,) + (1,) * (ndim - 1) to
    broadcast against a (t, ...) tensor of ``ndim`` dims (eps None when
    the tables have no Barrett constants)."""
    shape = (ct.t,) + (1,) * (ndim - 1)
    eps = None if ct.mul_eps_d is None else ct.mul_eps_d.view(shape)
    return ct.qs_d.view(shape), ct.half_d.view(shape), eps


def _hier_depth(ct: ChannelTables, schedule) -> int:
    """The four-step depth of a schedule string or resolved spec: a spec
    carries its depth; the plain ``"four_step"`` string means the full
    canonical chain."""
    depth = getattr(schedule, "depth", None)
    if depth is None:
        depth = 1 + len(ct.fs_sub_fwd)
    return depth


def _is_four_step(schedule) -> bool:
    return getattr(schedule, "kind", schedule) == "four_step"


def _row_tables(ct: ChannelTables, schedule, direction: str) -> tuple:
    """The per-level row tables of one direction, truncated to the
    schedule's depth, each laid out (t, 1, rows, cols) against (t, R, n)."""
    if ct.fs_row_fwd_d is None:
        raise ValueError(f"four_step schedule unavailable for n={ct.n}: no row tables")
    depth = _hier_depth(ct, schedule)
    row = getattr(ct, f"fs_row_{direction}_d")
    subs = getattr(ct, f"fs_sub_{direction}_d")[: depth - 1]
    return tuple(x[:, None] for x in (row,) + tuple(subs))


def ntt_channels(a: torch.Tensor, ct: ChannelTables, schedule="radix2") -> torch.Tensor:
    """a: (t, ..., n) -> (t, ..., n), channel c transformed mod qs[c].
    ``schedule``: a concrete string (``"radix2"`` / ``"four_step"``) or a
    resolved :class:`repro_torch.core.schedule.ScheduleSpec`."""
    a3 = a.reshape(ct.t, -1, ct.n)
    if _is_four_step(schedule):
        q, _, eps = channel_scalars(ct, 2)
        out = ntt_raw_hier(a3, ct.fwd_d[:, None, :], _row_tables(ct, schedule, "fwd"), q, eps,
                           ct.mul_shifts)
        return out.reshape(a.shape)
    q, _, eps = channel_scalars(ct, 4)
    out = ntt_raw(a3, ct.fwd_d[:, None, :], q, eps, ct.mul_shifts)
    return out.reshape(a.shape)


def intt_channels(a: torch.Tensor, ct: ChannelTables, schedule="radix2") -> torch.Tensor:
    a3 = a.reshape(ct.t, -1, ct.n)
    if _is_four_step(schedule):
        q, half, eps = channel_scalars(ct, 2)
        out = intt_raw_hier(a3, ct.inv_d[:, None, :], _row_tables(ct, schedule, "inv"), q, half,
                            eps, ct.mul_shifts)
        return out.reshape(a.shape)
    q, half, eps = channel_scalars(ct, 4)
    out = intt_raw(a3, ct.inv_d[:, None, :], q, half, eps, ct.mul_shifts)
    return out.reshape(a.shape)


def negacyclic_mul_channels(a: torch.Tensor, b: torch.Tensor, ct: ChannelTables,
                            schedule="radix2") -> torch.Tensor:
    """(t, ..., n) x (t, ..., n): the RNS-parallel no-shuffle cascade."""
    q, _, eps = channel_scalars(ct, a.dim())
    fa = ntt_channels(a, ct, schedule)
    fb = ntt_channels(b, ct, schedule)
    return intt_channels(mul_mod(fa, fb, q, eps, ct.mul_shifts), ct, schedule)
