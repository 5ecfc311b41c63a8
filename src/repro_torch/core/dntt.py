"""Four-step (n = n1 x n2) negacyclic NTT, the distributed/blocked form
(the port of ``repro.core.dntt``).

The paper raises throughput by adding datapath lanes; at machine scale
the analogous lever splits ONE long polynomial across devices.
Decomposition (cyclic DFT after the negacyclic pre-weight):

    a_hat = a ⊙ psi^j                      (elementwise)
    X[j1, j2] = a_hat[j1*n2 + j2]
    C = DFT_n1 over j1 (columns)           (local: shard j2)
    C = C ⊙ omega^{brv(p1) * j2}           (twiddle correction)
    T = transpose(C)                       (the ONLY communication:
                                            an (n1, n2) all-to-all)
    Y = DFT_n2 over j2 (columns of T)      (local: shard p1)

Both operands of a product use the same scrambled output order
(bit-reversed within each factor, factors transposed), so the pointwise
product needs no reordering.

Inner transforms: cyclic radix-2 DIF (natural-in, bit-reversed-out) and
its DIT mirror (bit-reversed-in, natural-out) with the per-stage halving
trick (Eq 24) folding in m^{-1}.  Plain PyTorch on int64, on the
operands' device, as the reference's are plain ``jnp``: no kernel.

Distribution (:func:`make_shard_constrain`): over a mesh axis of M ranks
(M dividing n1 and n2) each rank holds a column block of the (n1, n2)
view, ``(..., n1, n2/M)``, for the first DFT, and a column block of the
transposed view, ``(..., n2, n1/M)``, for the second.  The transpose
between them is one ``torch.distributed.all_to_all_single`` over the
axis' group: its split dim is the leading one (p1 forward, j2 back),
made contiguous, and the received blocks are laid back in place by one
local permute.  The entry points take their operands whole, the same on
every rank (as a jax global array is): each rank slices its own column
block, so no reshard precedes the first DFT (the reference's dry run
takes ``P("model")`` over n, a row layout that its compiler reshards to
columns first).  One forward or inverse transform issues exactly ONE
all-to-all; the entry points then all-gather the result's column blocks
once, so each returns the whole tensor: :func:`fourstep_ntt` and
:func:`fourstep_intt` 1 all-to-all and 1 all-gather, and
:func:`negacyclic_mul_fourstep` 3 all-to-alls (two forward, one inverse)
and 1 all-gather.  Without a constrain, or where M does not divide n1
and n2, every rank computes the whole transform locally.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import primes as primes_mod
from repro_torch.core.modmath import mul_mod
from repro_torch.core.ntt import bit_reverse_indices

__all__ = [
    "FourStepTables",
    "cyclic_dif",
    "cyclic_dit_inv",
    "fourstep_intt",
    "fourstep_ntt",
    "make_fourstep_tables",
    "make_shard_constrain",
    "negacyclic_mul_fourstep",
]


# --------------------------------------------------------------------------
# cyclic DIF / DIT kernels (last-axis transforms, per-stage twiddle tuples)
# --------------------------------------------------------------------------


def _powers(w: int, m: int, q: int) -> np.ndarray:
    """w^0, ..., w^(m-1) mod q (q < 2^31), by doubling the computed prefix."""
    out = np.ones(m, dtype=np.int64)
    k = 1
    while k < m:
        take = min(k, m - k)
        out[k:k + take] = out[:take] * pow(w, k, q) % q
        k *= 2
    return out


def _stage_tables(q: int, m: int, w: int) -> tuple[np.ndarray, ...]:
    """DIF stage twiddles for a length-m cyclic transform with root w:
    stage sizes m, m/2, ..., 2; stage s has (size/2) twiddles w^{j*(m/size)}."""
    wp = _powers(w, m, q)
    out = []
    size = m
    while size >= 2:
        half, stride = size // 2, m // size
        out.append(wp[: half * stride: stride].copy())
        size //= 2
    return tuple(out)


def cyclic_dif(a: torch.Tensor, stages, q: int) -> torch.Tensor:
    """Cyclic DFT, natural-in -> bit-reversed-out, over the last axis
    (``stages``: the device tensors of :func:`_stage_tables`)."""
    n = a.shape[-1]
    lead = tuple(a.shape[:-1])
    size = n
    for W in stages:
        half = size // 2
        x = a.reshape(lead + (n // size, size))
        u, v = x[..., :half], x[..., half:]
        s = (u + v) % q
        d = mul_mod((u - v) % q, W, q)
        a = torch.cat([s, d], dim=-1).reshape(lead + (n,))
        size //= 2
    return a


def cyclic_dit_inv(a: torch.Tensor, inv_stages, q: int, half_q: int) -> torch.Tensor:
    """Inverse cyclic DFT, bit-reversed-in -> natural-out, m^{-1} folded via
    the per-stage halving (paper Eq 24)."""
    n = a.shape[-1]
    lead = tuple(a.shape[:-1])
    size = 2
    for Wi in reversed(inv_stages):
        half = size // 2
        x = a.reshape(lead + (n // size, size))
        p, r = x[..., :half], mul_mod(x[..., half:], Wi, q)
        s = (p + r) % q
        d = (p - r) % q
        s = (s >> 1) + (s & 1) * half_q
        d = (d >> 1) + (d & 1) * half_q
        a = torch.cat([s, d], dim=-1).reshape(lead + (n,))
        size *= 2
    return a


def _dif_cols(x: torch.Tensor, stages, q: int) -> torch.Tensor:
    """:func:`cyclic_dif` over the second-last axis."""
    return cyclic_dif(x.transpose(-1, -2), stages, q).transpose(-1, -2)


def _dit_cols(x: torch.Tensor, inv_stages, q: int, half_q: int) -> torch.Tensor:
    return cyclic_dit_inv(x.transpose(-1, -2), inv_stages, q, half_q).transpose(-1, -2)


# --------------------------------------------------------------------------
# four-step tables
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class FourStepTables:
    """Host tables of one (q, n, n1) four-step transform (numpy int64), the
    reference's fields; :meth:`on` keeps their copies per device."""

    q: int
    n: int
    n1: int
    n2: int
    psi_w: np.ndarray  # (n,) psi^j       negacyclic pre-weight
    psi_iw: np.ndarray  # (n,) psi^{-j}    post-weight (n^{-1} is in the stages)
    st1: tuple  # DIF stages, length n1
    ist1: tuple
    st2: tuple  # DIF stages, length n2
    ist2: tuple
    tw: np.ndarray  # (n1, n2) omega^{brv(p1) * j2}
    itw: np.ndarray
    half: int
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    def on(self, device) -> dict:
        """The tables as int64 tensors on ``device`` (uploaded once): the
        weights and twiddles shaped (n1, n2), the stages as tuples."""
        device = torch.device(device)
        got = self._on.get(device)
        if got is None:
            up = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
            got = {
                "psi_w": up(self.psi_w.reshape(self.n1, self.n2)),
                "psi_iw": up(self.psi_iw.reshape(self.n1, self.n2)),
                "tw": up(self.tw),
                "itw": up(self.itw),
                **{k: tuple(up(s) for s in getattr(self, k))
                   for k in ("st1", "ist1", "st2", "ist2")},
            }
            self._on[device] = got
        return got


@functools.lru_cache(maxsize=None)
def make_fourstep_tables(q: int, n: int, n1: int) -> FourStepTables:
    n2 = n // n1
    if not (n1 * n2 == n and n1 & (n1 - 1) == 0 and n2 & (n2 - 1) == 0):
        raise ValueError(f"four-step split n={n} = {n1} x {n2}: both factors powers of two")
    if q >= 1 << 31:
        raise ValueError(f"q={q}: the int64 products of the four-step transforms need q < 2^31")
    psi = primes_mod.root_of_unity(q, 2 * n)
    omega = pow(psi, 2, q)
    omega_inv = pow(omega, q - 2, q)
    psi_inv = pow(psi, q - 2, q)
    w1, w2 = pow(omega, n2, q), pow(omega, n1, q)
    # omega^{brv(p1) * j2}: exponents below n1 * n2 = n, the order of omega
    e = np.outer(bit_reverse_indices(n1), np.arange(n2, dtype=np.int64))
    return FourStepTables(
        q=q, n=n, n1=n1, n2=n2,
        psi_w=_powers(psi, n, q), psi_iw=_powers(psi_inv, n, q),
        st1=_stage_tables(q, n1, w1),
        ist1=_stage_tables(q, n1, pow(w1, q - 2, q)),
        st2=_stage_tables(q, n2, w2),
        ist2=_stage_tables(q, n2, pow(w2, q - 2, q)),
        tw=_powers(omega, n, q)[e], itw=_powers(omega_inv, n, q)[e], half=(q + 1) // 2,
    )


# --------------------------------------------------------------------------
# layouts: whole on every rank, or column blocks over a mesh axis
# --------------------------------------------------------------------------


class _Whole:
    """Every rank computes the whole transform; the transpose is local."""

    def local(self, x):
        return x

    def transpose(self, x):
        return x.transpose(-1, -2)

    def join(self, x):
        return x


_WHOLE = _Whole()


class ShardConstrain:
    """Column blocks of the transforms' 2-D views over one mesh axis; built
    by :func:`make_shard_constrain`."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.shape[axis]

    def applies(self, t: FourStepTables) -> bool:
        return t.n1 % self.size == 0 and t.n2 % self.size == 0

    def local(self, x):
        """This rank's block of the trailing axis of a whole (..., r, c) view."""
        c = x.shape[-1] // self.size
        return x.narrow(-1, self.mesh.index(self.axis) * c, c)

    def transpose(self, x):
        """(..., R, C/M) column block -> (..., C, R/M) column block of the
        transposed view: ONE all-to-all of the row blocks (the leading,
        contiguous split dim), then the received blocks permuted in place."""
        from repro_torch.sharding import ctx  # deferred: the core stays collective-free

        lead = tuple(x.shape[:-2])
        R, cl = x.shape[-2:]
        M, k = self.size, len(lead)
        got = ctx.all_to_all_leading(x.movedim(-2, 0), self.mesh.group(self.axis), M)
        got = got.reshape((M, R // M) + lead + (cl,))  # [source, r, lead, c]
        got = got.permute(*range(2, 2 + k), 0, 2 + k, 1)  # [lead, source, c, r]
        return got.reshape(lead + (M * cl, R // M))

    def join(self, x):
        """The whole (..., r, c) view from this rank's (..., r, c/M) block."""
        from repro_torch.sharding import ctx

        return ctx.all_gather_dim(x, x.dim() - 1, self.mesh.group(self.axis), self.size)


def make_shard_constrain(mesh, axis: str = "model") -> ShardConstrain:
    """Shard the trailing axis of the (..., m, k) views over ``axis``: the
    inner transforms become device-local, and the transpose between them
    is one all-to-all (see the module notes)."""
    return ShardConstrain(mesh, axis)


def _layout(constrain, t: FourStepTables):
    if constrain is None or not constrain.applies(t):
        return _WHOLE
    return constrain


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------


def _forward(a, t: FourStepTables, c):
    """a: whole (..., n) -> this rank's (..., n2, n1 / M) spectrum block
    (order (p2, p1))."""
    d, q = t.on(a.device), t.q
    x = c.local(a.reshape(tuple(a.shape[:-1]) + (t.n1, t.n2)))
    x = mul_mod(x, c.local(d["psi_w"]), q)
    x = _dif_cols(x, d["st1"], q)  # (p1, j2)
    x = mul_mod(x, c.local(d["tw"]), q)
    x = c.transpose(x)  # ALL-TO-ALL: (p1, j2) -> (j2, p1)
    return _dif_cols(x, d["st2"], q)  # (p2, p1)


def _inverse(y, t: FourStepTables, c):
    """This rank's (..., n2, n1 / M) spectrum block -> its (..., n1, n2 / M)
    block of the natural-order product."""
    d, q = t.on(y.device), t.q
    x = _dit_cols(y, d["ist2"], q, t.half)
    x = c.transpose(x)  # all-to-all back: (j2, p1) -> (p1, j2)
    x = mul_mod(x, c.local(d["itw"]), q)
    x = _dit_cols(x, d["ist1"], q, t.half)
    return mul_mod(x, c.local(d["psi_iw"]), q)


def fourstep_ntt(a, t: FourStepTables, constrain=None):
    """a: (..., n) -> scrambled NWC spectrum (..., n) (order: (p2, p1))."""
    c = _layout(constrain, t)
    return c.join(_forward(a, t, c)).reshape(a.shape)


def fourstep_intt(y, t: FourStepTables, constrain=None):
    c = _layout(constrain, t)
    x = c.local(y.reshape(tuple(y.shape[:-1]) + (t.n2, t.n1)))
    return c.join(_inverse(x, t, c)).reshape(y.shape)


def negacyclic_mul_fourstep(a, b, t: FourStepTables, constrain=None):
    c = _layout(constrain, t)
    prod = mul_mod(_forward(a, t, c), _forward(b, t, c), t.q)
    return c.join(_inverse(prod, t, c)).reshape(a.shape)
