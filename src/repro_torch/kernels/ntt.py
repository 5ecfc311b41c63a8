"""The transform CUDA kernels of the port, their wrappers, launch
counters and plain PyTorch versions (port of ``repro.kernels.ntt``).

* :func:`fused_polymul_cuda` (``csrc/fused_polymul.cu``, K1) replaces the
  TPU kernel ``fused_polymul_pallas`` (``repro/kernels/ntt.py:757``): the
  per-channel no-shuffle cascade NTT(a) (.) NTT(b) -> iNTT, one CTA per
  (channel, row), both operands in shared memory, on K2's register
  passes (:func:`pass_threads` threads, :func:`pass_group` stages a
  pass).
* :func:`fused_e2e_polymul_cuda` (``csrc/fused_e2e_polymul.cu``, K2)
  replaces ``fused_e2e_polymul_pallas`` (``repro/kernels/ntt.py:802``):
  SAU decompose -> cascade -> Eq-10 compose in one launch, one
  thread-block cluster of min(t, 8) CTAs per row (:func:`e2e_cluster`);
  each CTA owns channels (ceil(t / 8) slots past t = 8) and a coefficient
  slice (:func:`e2e_channels`, :func:`e2e_slice`), and the residues move
  between the CTAs through distributed shared memory, never through
  device memory.  Its shared memory (:func:`e2e_geom`) holds the slots'
  residues, the channels' circuits and a staging whose decompose and
  compose chunks shrink to what is left of 227 KB.
  ``fused_e2e_polymul_cuda.cluster`` is the cluster size of its last
  launch.
* :func:`ntt_channels_cuda` (``csrc/ntt_channels.cu``, K3) replaces
  ``ntt_channels_pallas`` (``repro/kernels/ntt.py:680``): the forward
  transform per channel, natural in, bit-reversed and canonical out, on
  the same register passes with one operand.
* :func:`intt_channels_cuda` (``csrc/intt_channels.cu``, K4) replaces
  ``intt_channels_pallas`` (``repro/kernels/ntt.py:721``): the inverse
  with the Eq-24 halving, bit-reversed in, natural and canonical out, on
  the inverse register passes with one operand.

* :func:`ntt_channels_fs_cuda` (``csrc/ntt_channels_fs.cu``, K3-fs) and
  :func:`intt_channels_fs_cuda` (``csrc/intt_channels_fs.cu``, K4-fs)
  replace the four-step bodies of the TPU kernels ``ntt_channels_pallas``
  and ``intt_channels_pallas`` (``repro/kernels/ntt.py:158-204``, ``:266``,
  ``:282``): the transforms as multi-block kernels for polynomials that do
  not fit one CTA, on the card's own split n = n1 n2 (:func:`fs_split`):
  one persistent launch a call, :func:`fs_stream_grid` CTAs that take the
  column and the row tiles (:data:`FS_TILE` elements) of every polynomial
  from one ordered queue (:func:`fs_queue`), a producer warp loading each
  tile with TMA while :func:`fs_threads` consumer threads run the
  previous one's passes; lazy 32-bit values sit in a scratch tensor (in
  L2) between a polynomial's two phases.  ``.launches`` counts calls, each
  one CUDA launch.
* :func:`fused_polymul_fs_cuda` (``csrc/fused_polymul_fs.cu``, K1-fs)
  replaces the four-step body of ``fused_polymul_pallas``
  (``repro/kernels/ntt.py:312-371``): the cascade past one CTA as ONE
  launch, a thread-block cluster of :func:`fs_cluster` CTAs per (channel,
  row), a function of n alone, that holds the row's two polynomials in
  shared memory
  (:func:`cascade_fs_smem_bytes`); the transposes between its column and
  row stages go through distributed shared memory, so no scratch is
  allocated.
* :func:`fused_e2e_polymul_fs_cuda` (``csrc/fused_e2e_polymul_fs.cu``,
  K2-fs) replaces the four-step body of ``fused_e2e_polymul_pallas``: K2's
  function past one CTA (where K2's CTA does not hold (n, t)), three
  streaming launches with only 32-bit words between them
  (:func:`e2e_fs_geom`): the decompose of both operands, double-buffered
  (:func:`e2e_fs_decompose_cuda`); the cascade on the 32-bit residues with
  y = p q~ mod q stored over the first operand's (K1-fs's cluster, or K1's
  one-CTA body where it holds a pair: :func:`e2e_fs_cascade_cuda`); K6's
  compose on the y words (:func:`e2e_fs_compose_cuda`).  Each launch has
  its own wrapper and plain version, so the card can hold them one at a
  time; :func:`e2e_fs_cluster` is the cascade's cluster size (1 for K1's
  body).
  The plain versions of the multi-block kernels are the four-step plain
  PyTorch of :mod:`repro_torch.core.ntt` in the reference's grouping: the
  outputs are canonical, so they agree whatever the split.

Each wrapper runs its plain version (the ``*_ref`` functions) only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
``<wrapper>.launches`` counts the launches, and nothing else adds to it.
What bounds each kernel on the card, and what its design does about it,
is noted in its source.  K1, K3 and K4 keep the constants of their
launches that depend only on the tables on the ``ChannelTables``, as K2
keeps its on the plan.  K3 and K4 keep the residues as 32-bit words:
they are exact for canonical input below q < 2^31, the domain the
reference's lazy butterflies assume too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import modmath
from repro_torch.core import ntt as ntt_mod
from repro_torch.core.modmath import add_mod, div2_mod, mul_mod, sub_mod
from repro_torch.core.ntt import ChannelTables, channel_scalars, ct_stages, gs_stages, twiddles
from repro_torch.core.rns import RnsPlan, limb_sums
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand, ptr
from repro_torch.kernels.crt import (
    MAX_SMEM_BYTES,
    check_dec_limits,
    compose_finalize,
    compose_rows,
    compose_smem_bytes,
    decompose_ref,
    decompose_table_bytes,
    fit_chunk,
    narrow_moduli,
    require_dec,
)
RESIDUE_BYTES = 4  # residues are stored as 32-bit words in shared memory

# reduction regimes (csrc/parentt.cuh: Mode)
MODE_LAZY, MODE_BARRETT, MODE_REM = 0, 1, 2


def padded_words(n: int) -> int:
    """Words of a residue polynomial in the register passes' shared layout:
    one pad word per 16 (csrc/parentt.cuh ``padded``)."""
    return n + n // 16


def stage_smem_bytes(n: int) -> int:
    """Shared memory of one stage-transform block (K3 or K4): one padded
    polynomial."""
    return padded_words(n) * RESIDUE_BYTES


def cascade_smem_bytes(n: int) -> int:
    """Shared memory of one fused-cascade block (K1): both operands, padded."""
    return 2 * padded_words(n) * RESIDUE_BYTES


def stage_fits(n: int) -> bool:
    """Whether one CTA of K3 or K4 holds an n-point polynomial; past it the
    multi-block K3-fs and K4-fs serve."""
    return stage_smem_bytes(n) <= MAX_SMEM_BYTES


def cascade_fits(n: int) -> bool:
    """Whether one CTA of K1 holds both n-point operands; past it K1-fs
    serves."""
    return cascade_smem_bytes(n) <= MAX_SMEM_BYTES


# the multi-block kernels (csrc/parentt.cuh, "Multi-block transforms")
FS_TILE = 4096  # elements a tile of a multi-block kernel holds (kLogFsTile)
# the largest n a kernel backend admits: the reference's largest servable
# n at t = 6, and the largest the multi-block kernels are held at on the card
FS_MAX_N = 65536


def fs_split(n: int) -> tuple[int, int]:
    """(n1, n2) of the multi-block kernels: n2 = 2^ceil(log2(n) / 2) row
    length, n1 = n / n2 rows (csrc/parentt.cuh ``fs_geom``); 256 x 256 at
    n = 65536, 128 x 256 at 32768."""
    log_n = _check_n(n, "fs_split")
    n2 = 1 << ((log_n + 1) // 2)
    return n // n2, n2


def fs_tile(n: int) -> int:
    """Elements a tile of K3-fs or K4-fs holds: min(n, FS_TILE); a column
    tile is n1 rows x fs_tile / n1 columns, a row tile fs_tile / n2 whole
    rows."""
    return min(n, FS_TILE)


# the tile streams' consumer threads a CTA (csrc/parentt.cuh
# kFsStreamThreads; a producer warp sits beside them), and the stages a
# pass takes in each (kFsStreamGroup: K3-fs four, K4-fs three, whatever n)
FS_STREAM_THREADS = 256
FS_STREAM_GROUP = {"ntt_channels_fs": 4, "intt_channels_fs": 3}


def fs_threads(n: int) -> int:
    """Threads of a K3-fs or K4-fs CTA that run a tile's passes (a
    producer warp sits beside them); a pass's groups are spread over them,
    whatever n."""
    return FS_STREAM_THREADS


def fs_blocks(t: int, rows: int, n: int) -> int:
    """Tiles of one phase of K3-fs or K4-fs over t x rows polynomials."""
    return t * rows * (n // fs_tile(n))


def fs_stream_smem_bytes(n: int) -> int:
    """Shared memory of a K3-fs or K4-fs CTA (csrc/parentt.cuh
    ``fs_stream_smem``): 128 bytes of alignment slack, two staging slots
    of fs_tile int64 words, the padded tile (rounded to 8 bytes), two full
    and two done mbarriers and the slots' two tickets; 83,112 bytes at
    n >= 4096."""
    E = fs_tile(n)
    return 128 + 2 * 8 * E + (padded_words(E) * RESIDUE_BYTES + 7) // 8 * 8 + 4 * 8 + 2 * 4


def fs_lag(n: int, grid: int) -> int:
    """First-phase tiles the queue of K3-fs or K4-fs hands out before its
    first second-phase tile (csrc/parentt.cuh ``fs_stream_lag``): a
    polynomial's tiles and one a CTA of the ``grid``."""
    return n // fs_tile(n) + grid


def fs_ticket(k: int, tiles: int, lag: int, phases: int = 3) -> tuple[int, int]:
    """Ticket ``k`` of a queue over ``tiles`` tiles a phase ->
    (phase: 0 first, 1 second; the tile's index among its phase's,
    polynomial-major) (csrc/parentt.cuh ``fs_ticket``).  Both phases: the
    first ``lag`` first-phase tiles, then one of each in turn, then the
    rest of the second phase; ``phases`` 1 or 2: that phase's tiles in
    order."""
    if phases != 3:
        return int(phases == 2), k
    d = min(lag, tiles)
    if k < d:
        return 0, k
    if k < 2 * tiles - d:
        second = (k - d) & 1
        return second, ((k - d) >> 1) if second else d + ((k - d) >> 1)
    return 1, k - tiles


def fs_queue(t: int, rows: int, n: int, grid: int, phases: int = 3) -> list[tuple[int, int, int]]:
    """The queue of one K3-fs or K4-fs call with ``grid`` CTAs: (phase,
    polynomial, tile of the polynomial) of each ticket in the order the
    CTAs take them."""
    per = n // fs_tile(n)
    tiles = fs_blocks(t, rows, n)
    lag = fs_lag(n, grid)
    out = []
    for k in range((2 if phases == 3 else 1) * tiles):
        second, tile = fs_ticket(k, tiles, lag, phases)
        out.append((second, tile // per, tile % per))
    return out


def fs_col_box(n: int, word: int) -> dict:
    """How K3-fs and K4-fs move a column tile of ``word``-byte (4 or 8)
    words: past n = 4096 a TMA box (``kind`` "tensor") of ``box`` = (C
    columns, n1 rows) of the 2-D view ``dims`` = (n2 words, polys n1 rows)
    with row stride ``stride`` bytes (csrc/parentt.cuh ``fs_col_map``);
    at n <= 4096 the whole polynomial, a contiguous span of ``bytes``
    (``kind`` "bulk") like every row tile."""
    n1, n2 = fs_split(n)
    E = fs_tile(n)
    if E == n:
        return {"kind": "bulk", "bytes": E * word}
    return {"kind": "tensor", "box": (E // n1, n1), "dims": (n2, n1), "stride": n2 * word,
            "bytes": E * word}


# the cascade cluster (csrc/parentt.cuh kLogCascadeCluster): the portable
# cluster size of CTAs per (channel, row), or the non-portable
# WIDE_CASCADE_CLUSTER where a CTA of 8 would hold more than FS_TILE
# elements of each operand
CASCADE_CLUSTER = 8
WIDE_CASCADE_CLUSTER = 16


def fs_cluster(n: int) -> int:
    """C, the CTAs of K1-fs's cluster per (channel, row), which every
    cluster launch of the cascade takes (the C entry points are given it):
    min(8, n1), and 16 (a non-portable size) past n = 32768, so a CTA
    takes FS_TILE elements of each operand.  A card that holds no such
    cluster is refused at plan time (:func:`cascade_fs_clusters_resident`),
    not served by another size."""
    n1 = fs_split(n)[0]
    if n // CASCADE_CLUSTER > FS_TILE and n1 >= WIDE_CASCADE_CLUSTER:
        return WIDE_CASCADE_CLUSTER
    return min(CASCADE_CLUSTER, n1)


def cascade_fs_threads(n: int, cluster: int | None = None) -> int:
    """Threads of a CTA of K1-fs's cluster: pass_threads of its n / C
    elements an operand."""
    return pass_threads(n // (cluster or fs_cluster(n)))


def cascade_fs_smem_bytes(n: int, cluster: int | None = None) -> int:
    """Shared memory of a CTA of K1-fs's cluster of C (default
    :func:`fs_cluster`) CTAs: three padded buffers of n / C words (the two
    operands' column blocks and a row block; csrc/parentt.cuh
    ``cascade_fs_smem``), 104,448 bytes at n = 65536, C = 8."""
    return 3 * padded_words(n // (cluster or fs_cluster(n))) * RESIDUE_BYTES


def e2e_geom(n: int, t: int, S: int, L: int) -> tuple[int, int, int]:
    """(shared memory, dc, cc) of one K2 CTA (csrc/fused_e2e_polymul.cu
    ``e2e_geom``): its slots' two residue polynomials (one pad word per
    16, rounded to 16 bytes), the channels' circuits, and a staging of dc
    coefficients' segments an operand (up to half the threads) or cc
    coefficients' limbs (up to all of them), as many as what is left of
    MAX_SMEM_BYTES holds."""
    _, slots = e2e_cluster(t)
    threads = pass_threads(n)
    res = -(-slots * 2 * padded_words(n) * RESIDUE_BYTES // 16) * 16
    fixed = res + decompose_table_bytes(t)
    dc = fit_chunk(threads // 2, MAX_SMEM_BYTES - fixed, 2 * S * 8)
    cc = fit_chunk(threads, MAX_SMEM_BYTES - fixed, L * 8)
    return fixed + max(2 * dc * S, cc * L) * 8, dc, cc


def e2e_smem_bytes(n: int, t: int, S: int, L: int) -> int:
    """Shared memory of one K2 CTA at (n, t, S, L) (:func:`e2e_geom`)."""
    return e2e_geom(n, t, S, L)[0]


def e2e_fits(n: int, t: int, S: int, L: int) -> bool:
    """Whether the fused e2e kernel K2 holds (n, t, S, L): its slots'
    polynomials, the circuits and a staging of at least one coefficient a
    CTA (and K1's operands, which its stage entry points run)."""
    smem, dc, cc = e2e_geom(n, t, S, L)
    return cascade_fits(n) and dc >= 1 and cc >= 1 and smem <= MAX_SMEM_BYTES


# the smallest n K2-fs takes (the smallest n the multi-block kernels are
# held at on the card)
E2E_FS_MIN_N = 16
# K2-fs's decompose launch (csrc/fused_e2e_polymul_fs.cu): threads of a
# CTA at most
E2E_FS_DEC_THREADS = 256


def dec_groups(t: int) -> int:
    """G, the channel groups of a K2-fs decompose CTA: min(8, ceil(t / 3)),
    so a thread decomposes about three channels of its coefficient
    (csrc/fused_e2e_polymul_fs.cu ``dec_groups``): 2 at t = 6, 5 at 15,
    8 at 30."""
    return min(8, -(-t // 3))


def e2e_fs_geom(n: int, t: int, S: int, L: int) -> tuple[tuple[int, int, int], int, int]:
    """((shared memory of its decompose, cascade and compose CTAs), TR, R)
    of K2-fs (csrc/fused_e2e_polymul_fs.cu ``dec_geom`` and the launches):
    a decompose CTA holds the circuits and two tiles of TR coefficients'
    segments (up to E2E_FS_DEC_THREADS / dec_groups(t)); the cascade is
    K1's CTA where one holds a channel's pair, else a CTA of K1-fs's
    cluster; a compose CTA is K6's, R coefficients' limbs beside the
    channels' constants.  None grows with t but for the tables."""
    table = decompose_table_bytes(t)
    tr = fit_chunk(E2E_FS_DEC_THREADS // dec_groups(t), (MAX_SMEM_BYTES - table) // 2, S * 8)
    cascade = cascade_smem_bytes(n) if cascade_fits(n) else cascade_fs_smem_bytes(n)
    rows = compose_rows(t, L)
    return (table + 2 * tr * S * 8, cascade, compose_smem_bytes(t, L)), tr, rows


def e2e_fs_smem_bytes(n: int, t: int, S: int, L: int) -> int:
    """Shared memory of a K2-fs CTA at most (:func:`e2e_fs_geom`)."""
    return max(e2e_fs_geom(n, t, S, L)[0])


def e2e_fs_fits(n: int, t: int, S: int, L: int) -> bool:
    """Whether the multi-block e2e kernel K2-fs holds (n, t, S, L): n >= 16,
    and each of its CTAs within one block's shared memory with at least
    one coefficient a decompose tile and a compose CTA."""
    smem, tr, rows = e2e_fs_geom(n, t, S, L)
    return n >= E2E_FS_MIN_N and tr >= 1 and rows >= 1 and max(smem) <= MAX_SMEM_BYTES


def e2e_serves(n: int, t: int, S: int, L: int) -> bool:
    """Whether backend ``cuda_fused_e2e`` has a kernel for (n, t, S, L):
    K2, or K2-fs past it."""
    return e2e_fits(n, t, S, L) or e2e_fs_fits(n, t, S, L)


def main_path_kernel_smem(backend: str, n: int, t: int, S: int, L: int) -> tuple[bool, int]:
    """(multi_block, shared memory of one CTA) of the kernel a kernel
    backend's main path launches at (n, t, S, L): K3 / K4 or K3-fs / K4-fs
    (``"cuda"``), K1 or K1-fs (``"cuda_fused"``), K2 or K2-fs
    (``"cuda_fused_e2e"``; admission refuses what neither holds)."""
    if backend == "cuda":
        return (False, stage_smem_bytes(n)) if stage_fits(n) else (True, fs_stream_smem_bytes(n))
    if backend == "cuda_fused":
        return ((False, cascade_smem_bytes(n)) if cascade_fits(n)
                else (True, cascade_fs_smem_bytes(n)))
    if backend == "cuda_fused_e2e":
        if e2e_fits(n, t, S, L):
            return False, max(cascade_smem_bytes(n), e2e_smem_bytes(n, t, S, L))
        return True, e2e_fs_smem_bytes(n, t, S, L)
    raise ValueError(f"main_path_kernel_smem: {backend!r} is not a kernel backend")


# K2's cluster (csrc/fused_e2e_polymul.cu): at most the portable cluster
# size of CTAs per row
MAX_CLUSTER = 8


def e2e_cluster(t: int) -> tuple[int, int]:
    """(C, slots) of K2: C = min(t, 8) CTAs per row, each owning at most
    ``slots`` = ceil(t / C) channels.  The kernel's launch derives them
    itself; this copy serves plan admission and the tests."""
    c = min(t, MAX_CLUSTER)
    return c, -(-t // c)


def e2e_channels(t: int, cluster: int, rank: int) -> range:
    """The channels CTA ``rank`` of a cluster owns: rank, rank + C, ..."""
    return range(rank, t, cluster)


def e2e_slice(n: int, cluster: int, rank: int) -> range:
    """The coefficients CTA ``rank`` decomposes and composes:
    [ceil(rank n / C), ceil((rank + 1) n / C))."""
    return range(-(-rank * n // cluster), -(-(rank + 1) * n // cluster))


def pass_threads(n: int) -> int:
    """Threads of one CTA of K1, K2, K3 or K4 (csrc/parentt.cuh
    ``pass_threads``): n / 16 within [32, 512], at most n / 2."""
    return min(n // 2, max(32, min(512, n // 16)))


def pass_group(n: int) -> int:
    """K: the transform stages one thread of K1-K4 runs from
    registers between two trips through shared memory, log2(n / threads)
    capped at 3 (csrc/parentt.cuh ``pass_group``)."""
    return min((n // pass_threads(n)).bit_length() - 1, 3)


def reduction_mode(tables: ChannelTables) -> tuple[int, int, int, int, int]:
    """(mode, window, beta, s1, s2) of a table set: lazy butterflies when
    the tables carry Shoup constants, strict Barrett when they carry only
    Barrett constants, the generic ``%`` otherwise (q of 31 bits)."""
    s1, s2 = tables.mul_shifts or (0, 0)
    if tables.lazy is not None:
        window, beta = tables.lazy
        return MODE_LAZY, window, beta, s1, s2
    if tables.mul_shifts is not None:
        return MODE_BARRETT, 0, 0, s1, s2
    return MODE_REM, 0, 0, 0, 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _butterflies(tables: ChannelTables):
    """(ct, gs) closures over (t, rows, m, stride) stage views, with the
    regime of :func:`reduction_mode`."""
    q, half, eps = channel_scalars(tables, 4)
    shifts = tables.mul_shifts
    fwd, inv = tables.fwd_d[:, None, :], tables.inv_d[:, None, :]
    if tables.lazy is not None:
        window, beta = tables.lazy
        fsh, ish = tables.fwd_shoup_d[:, None, :], tables.inv_shoup_d[:, None, :]

        def ct(u, v, lo, hi):
            return modmath.lazy_ct_butterfly(
                u, v, twiddles(fwd, lo, hi), twiddles(fsh, lo, hi), q, beta=beta, window=window
            )

        def gs(u, v, lo, hi):
            return modmath.lazy_gs_butterfly(
                u, v, twiddles(inv, lo, hi), twiddles(ish, lo, hi), q, half,
                beta=beta, window=window,
            )

        return ct, gs

    def ct(u, v, lo, hi):
        p = mul_mod(v, twiddles(fwd, lo, hi), q, eps, shifts)
        return add_mod(u, p, q), sub_mod(u, p, q)

    def gs(u, v, lo, hi):
        s = add_mod(u, v, q)
        d = mul_mod(sub_mod(u, v, q), twiddles(inv, lo, hi), q, eps, shifts)
        return div2_mod(s, half), div2_mod(d, half)

    return ct, gs


def _canonicalize(x: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """The exit reduce of a (t, rows, n) lazy transform; strict values are
    already canonical."""
    if tables.lazy is None:
        return x
    q, _, _ = channel_scalars(tables, 3)
    return modmath.canonicalize(x, q, tables.lazy[0])


def ntt_channels_ref(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """Plain version of K3: (t, rows, n) canonical residues -> canonical
    bit-reversed spectra, with the kernels' butterflies and one
    canonicalize at exit."""
    ct, _ = _butterflies(tables)
    return _canonicalize(ct_stages(a, ct), tables)


def intt_channels_ref(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """Plain version of K4: (t, rows, n) canonical bit-reversed spectra ->
    canonical natural-order residues (Eq-24 halving in every stage)."""
    _, gs = _butterflies(tables)
    return _canonicalize(gs_stages(a, gs), tables)


def fused_polymul_ref(a: torch.Tensor, b: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """Plain version of the fused cascade: (t, rows, n) x (t, rows, n) ->
    (t, rows, n) canonical negacyclic products, with the kernel's
    butterflies (lazy window, one canonicalize before the product and one
    at exit)."""
    q, _, eps = channel_scalars(tables, 3)
    prod = mul_mod(ntt_channels_ref(a, tables), ntt_channels_ref(b, tables), q, eps,
                   tables.mul_shifts)
    return intt_channels_ref(prod, tables)


def ntt_channels_fs_ref(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """Plain version of K3-fs: the four-step forward transform of
    :mod:`repro_torch.core.ntt` in the reference's grouping, (t, rows, n)
    canonical residues -> canonical bit-reversed spectra."""
    return ntt_mod.ntt_channels(a, tables, "four_step")


def intt_channels_fs_ref(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """Plain version of K4-fs: the four-step inverse transform."""
    return ntt_mod.intt_channels(a, tables, "four_step")


def fused_polymul_fs_ref(a: torch.Tensor, b: torch.Tensor, tables: ChannelTables
                         ) -> torch.Tensor:
    """Plain version of K1-fs: the four-step no-shuffle cascade."""
    return ntt_mod.negacyclic_mul_channels(a, b, tables, "four_step")


def fused_e2e_polymul_ref(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                          plan: RnsPlan, cascade=fused_polymul_ref) -> torch.Tensor:
    """Plain version of the e2e kernel: segments (rows, n, S) x 2 ->
    product limbs (rows, n, L), through the per-channel SAU circuits, the
    cascade (``cascade``: K1's plain version) and the Eq-10 compose."""
    p = cascade(decompose_ref(za, plan), decompose_ref(zb, plan), tables)  # (t, rows, n)
    q, _, eps = channel_scalars(tables, 3)
    y = mul_mod(p, plan.qi_tilde_d.view(plan.t, 1, 1), q, eps, tables.mul_shifts)
    acc = limb_sums(y, plan.qi_star_limbs_d.view(plan.t, 1, 1, plan.L), plan.w)
    return compose_finalize(acc, plan.q_limbs, w=plan.w, t=plan.t)


def fused_e2e_polymul_fs_ref(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                             plan: RnsPlan) -> torch.Tensor:
    """Plain version of K2-fs: K2's over the four-step cascade (K1-fs's
    plain version)."""
    return fused_e2e_polymul_ref(za, zb, tables, plan, cascade=fused_polymul_fs_ref)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_STAGE_ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]
_CASCADE_ARGTYPES = [_P] * 10 + [_I] * 8 + [_P]
_CASCADE_FS_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]
_E2E_ARGTYPES = [_P] * 18 + [_I] * 12 + [_P]
_LL = ctypes.c_longlong
_E2E_FS_ARGTYPES = [_P] * 20 + [_I] * 14 + [_P]
_E2E_FS_DECOMPOSE_ARGTYPES = [_P] * 10 + [_LL] + [_I] * 4 + [_P]
_E2E_FS_CASCADE_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]
_E2E_FS_COMPOSE_ARGTYPES = [_P] * 5 + [_LL] + [_I] * 3 + [_P]
_FS_STAGE_ARGTYPES = [_P] * 8 + [_I] * 9 + [_P]
# each K1/K3/K4 source's shared memory a CTA, one-block and multi-block
_SMEM = {
    "fused_polymul": cascade_smem_bytes, "ntt_channels": stage_smem_bytes,
    "intt_channels": stage_smem_bytes, "fused_polymul_fs": cascade_fs_smem_bytes,
    "ntt_channels_fs": fs_stream_smem_bytes, "intt_channels_fs": fs_stream_smem_bytes,
}


def _check_tables_device(tables: ChannelTables, device: torch.device, fn: str) -> None:
    if tables.qs_d.device != device:
        raise ValueError(f"{fn}: tables live on {tables.qs_d.device}, operands on {device}")


def _optional_tables(tables: ChannelTables):
    """(eps, fwd_shoup, inv_shoup) device tensors for the kernel's pointer
    arguments; a table the regime does not read is passed as a stand-in
    (Barrett eps under ``%``, Shoup tables under strict butterflies)."""
    eps = tables.mul_eps_d if tables.mul_eps_d is not None else tables.qs_d
    fsh = tables.fwd_shoup_d if tables.fwd_shoup_d is not None else tables.fwd_d
    ish = tables.inv_shoup_d if tables.inv_shoup_d is not None else tables.inv_d
    return eps, fsh, ish


def _check_n(n: int, fn: str) -> int:
    if n < 4 or n & (n - 1):
        raise ValueError(f"{fn}: n must be a power of two >= 4, got {n}")
    return n.bit_length() - 1


def _table_constants(tables: ChannelTables, source: str, fn_name: str) -> tuple[tuple, tuple]:
    """The checked (table pointers, ints after ``rows``) of a K1, K3 or K4
    launch, or of their multi-block forms: worked out at the tables' first
    launch of ``source`` and kept on the tables, so a short call does not
    pay for them again."""
    kept = tables.__dict__.get("_launch")
    if kept is None:
        kept = {}
        object.__setattr__(tables, "_launch", kept)
    if source in kept:
        return kept[source]
    n = tables.n
    log_n = _check_n(n, fn_name)
    if _SMEM[source](n) > MAX_SMEM_BYTES:
        raise ValueError(f"{fn_name}: n={n} does not fit one block's shared memory")
    eps, fsh, ish = _optional_tables(tables)
    head = (tables.qs_d, tables.half_d, eps)
    tabs = {
        "fused_polymul": (tables.fwd_d, tables.inv_d, fsh, ish),
        "ntt_channels": (tables.fwd_d, fsh),
        "intt_channels": (tables.inv_d, ish),
    }[source.removesuffix("_fs")]
    kept[source] = (tuple(ptr(x) for x in head + tabs), (log_n, *reduction_mode(tables)))
    return kept[source]


def _launch_stage(a: torch.Tensor, tables: ChannelTables, source: str, fn_name: str
                  ) -> torch.Tensor:
    """One launch of a single-transform kernel (K3 or K4) on (t, rows, n)."""
    t, n = tables.t, tables.n
    rows = a.shape[1] if a.dim() == 3 else -1
    check_operand(a, (t, rows, n), "a", fn_name)
    pointers, ints = _table_constants(tables, source, fn_name)
    launch = _build.load(source, f"parentt_{source}", _STAGE_ARGTYPES)
    _check_tables_device(tables, a.device, fn_name)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    with torch.cuda.device(a.device):
        code = launch(ptr(a), ptr(out), *pointers, t, rows, *ints, _build.stream_of(a))
    _build.check(source, code)
    return out


def ntt_channels_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """(t, rows, n) canonical residues -> (t, rows, n) canonical spectra in
    bit-reversed order.  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/ntt_channels.cu`` on the current stream."""
    if a.device.type == "cpu":
        return ntt_channels_ref(a, tables)
    out = _launch_stage(a, tables, "ntt_channels", "ntt_channels_cuda")
    ntt_channels_cuda.launches += 1
    return out


ntt_channels_cuda.launches = 0


def intt_channels_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """(t, rows, n) canonical bit-reversed spectra -> (t, rows, n)
    canonical residues in natural order.  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/intt_channels.cu``."""
    if a.device.type == "cpu":
        return intt_channels_ref(a, tables)
    out = _launch_stage(a, tables, "intt_channels", "intt_channels_cuda")
    intt_channels_cuda.launches += 1
    return out


intt_channels_cuda.launches = 0


def fused_polymul_cuda(a: torch.Tensor, b: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """(t, rows, n) x (t, rows, n) canonical residues -> (t, rows, n)
    negacyclic products per channel.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/fused_polymul.cu`` on the current stream."""
    if a.device.type == "cpu":
        return fused_polymul_ref(a, b, tables)
    fn_name = "fused_polymul_cuda"
    t, n = tables.t, tables.n
    rows = a.shape[1] if a.dim() == 3 else -1
    check_operand(a, (t, rows, n), "a", fn_name)
    check_operand(b, (t, rows, n), "b", fn_name)
    if b.device != a.device:
        raise ValueError(f"{fn_name}: operands on {a.device} and {b.device}")
    pointers, ints = _table_constants(tables, "fused_polymul", fn_name)
    launch = _build.load("fused_polymul", "parentt_fused_polymul", _CASCADE_ARGTYPES)
    _check_tables_device(tables, a.device, fn_name)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    with torch.cuda.device(a.device):
        code = launch(ptr(a), ptr(b), ptr(out), *pointers, t, rows, *ints, _build.stream_of(a))
    _build.check("fused_polymul", code)
    fused_polymul_cuda.launches += 1
    return out


fused_polymul_cuda.launches = 0


def _blocks_per_sm(tables: ChannelTables, source: str) -> int:
    """How many CTAs of ``csrc/<source>.cu`` (K1, K3 or K4) an SM of the
    current card holds at once at these tables' n and regime
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    launch = _build.load(source, f"parentt_{source}_blocks_per_sm", [_I] * 3)
    mode, window = reduction_mode(tables)[:2]
    count = launch(tables.n.bit_length() - 1, mode, window)
    if count < 0:
        _build.check(source, -count)
    return count


def fs_stream_grid(tables: ChannelTables, source: str) -> int:
    """CTAs of a K3-fs or K4-fs launch (``source``): as many as the current
    card holds at once at these tables' n and regime, its CTAs an SM
    (:func:`ntt_fs_blocks_per_sm`) times its SMs; kept on the tables."""
    kept = tables.__dict__.get("_launch")
    if kept is None:
        kept = {}
        object.__setattr__(tables, "_launch", kept)
    key = (source, "grid")
    if key not in kept:
        sms = torch.cuda.get_device_properties(tables.qs_d.device).multi_processor_count
        kept[key] = _fs_blocks_per_sm(tables, source) * sms
    return kept[key]


def _launch_fs(a: torch.Tensor, tables: ChannelTables, source: str, fn_name: str
               ) -> torch.Tensor:
    """One call of a multi-block transform (K3-fs or K4-fs) on (t, rows, n):
    its output and one int32 tensor allocated here, the 32-bit words
    between its phases and after them the queue's counters (zeroed by the
    C entry point), its one launch in the C entry point.  TMA reads ``a``
    in 16-byte units, so an operand that starts off a 16-byte boundary is
    copied first."""
    t, n = tables.t, tables.n
    rows = a.shape[1] if a.dim() == 3 else -1
    check_operand(a, (t, rows, n), "a", fn_name)
    pointers, ints = _table_constants(tables, source, fn_name)
    launch = _build.load(source, f"parentt_{source}", _FS_STAGE_ARGTYPES)
    _check_tables_device(tables, a.device, fn_name)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    if a.data_ptr() % 16:
        a = a.clone()
    scratch = torch.empty(t * rows * (n + 1) + 1, dtype=torch.int32, device=a.device)
    grid = fs_stream_grid(tables, source)
    with torch.cuda.device(a.device):
        code = launch(ptr(a), ptr(scratch), ptr(out), *pointers, t, rows, *ints, grid,
                      _build.stream_of(a))
    _build.check(source, code)
    return out


def ntt_channels_fs_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """K3-fs: (t, rows, n) canonical residues -> (t, rows, n) canonical
    spectra in bit-reversed order, as a multi-block transform.  CPU tensors
    run the plain version; CUDA tensors launch ``csrc/ntt_channels_fs.cu``
    (one launch) on the current stream."""
    if a.device.type == "cpu":
        return ntt_channels_fs_ref(a, tables)
    out = _launch_fs(a, tables, "ntt_channels_fs", "ntt_channels_fs_cuda")
    ntt_channels_fs_cuda.launches += 1
    return out


ntt_channels_fs_cuda.launches = 0


def intt_channels_fs_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """K4-fs: (t, rows, n) canonical bit-reversed spectra -> (t, rows, n)
    canonical residues in natural order, as a multi-block transform.  CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/intt_channels_fs.cu`` (one launch)."""
    if a.device.type == "cpu":
        return intt_channels_fs_ref(a, tables)
    out = _launch_fs(a, tables, "intt_channels_fs", "intt_channels_fs_cuda")
    intt_channels_fs_cuda.launches += 1
    return out


intt_channels_fs_cuda.launches = 0


def fused_polymul_fs_cuda(a: torch.Tensor, b: torch.Tensor, tables: ChannelTables
                          ) -> torch.Tensor:
    """K1-fs: (t, rows, n) x (t, rows, n) canonical residues -> (t, rows, n)
    negacyclic products per channel, as one cluster launch of
    ``csrc/fused_polymul_fs.cu`` whose NTT-domain product never reaches
    device memory (no scratch).  CPU tensors run the plain version."""
    if a.device.type == "cpu":
        return fused_polymul_fs_ref(a, b, tables)
    fn_name = "fused_polymul_fs_cuda"
    t, n = tables.t, tables.n
    rows = a.shape[1] if a.dim() == 3 else -1
    check_operand(a, (t, rows, n), "a", fn_name)
    check_operand(b, (t, rows, n), "b", fn_name)
    if b.device != a.device:
        raise ValueError(f"{fn_name}: operands on {a.device} and {b.device}")
    pointers, ints = _table_constants(tables, "fused_polymul_fs", fn_name)
    launch = _build.load("fused_polymul_fs", "parentt_fused_polymul_fs", _CASCADE_FS_ARGTYPES)
    _check_tables_device(tables, a.device, fn_name)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    with torch.cuda.device(a.device):
        code = launch(ptr(a), ptr(b), ptr(out), *pointers, t, rows, *ints,
                      fs_cluster(n).bit_length() - 1, _build.stream_of(a))
    _build.check("fused_polymul_fs", code)
    fused_polymul_fs_cuda.launches += 1
    return out


fused_polymul_fs_cuda.launches = 0


def _clusters_resident(source: str, tables: ChannelTables, cluster: int) -> int:
    """Clusters of ``cluster`` CTAs of ``csrc/<source>.cu``'s cascade
    launch the current card holds at once at these tables' n and regime
    (``cudaOccupancyMaxActiveClusters``; ``cluster`` 1, K2-fs's one-CTA
    body: its CTAs an SM holds, times the SMs)."""
    launch = _build.load(source, f"parentt_{source}_max_clusters", [_I] * 4)
    mode, window = reduction_mode(tables)[:2]
    count = launch(tables.n.bit_length() - 1, mode, window, cluster.bit_length() - 1)
    if count < 0:
        _build.check(source, -count)
    return count


def cascade_fs_clusters_resident(tables: ChannelTables, cluster: int | None = None) -> int:
    """K1-fs's clusters of ``cluster`` CTAs (default :func:`fs_cluster`,
    the size its launch takes) the current card holds at once.
    :func:`repro_torch.plan` refuses the backends whose paths run K1-fs
    where it is 0."""
    return _clusters_resident("fused_polymul_fs", tables, cluster or fs_cluster(tables.n))


def _fs_blocks_per_sm(tables: ChannelTables, source: str) -> int:
    """CTAs an SM of the current card holds at once of the multi-block
    transform ``csrc/<source>.cu`` (K3-fs or K4-fs) at these tables' n and
    regime."""
    launch = _build.load(source, f"parentt_{source}_blocks_per_sm", [_I] * 3)
    mode, window = reduction_mode(tables)[:2]
    count = launch(tables.n.bit_length() - 1, mode, window)
    if count < 0:
        _build.check(source, -count)
    return count


def ntt_fs_blocks_per_sm(tables: ChannelTables) -> int:
    """K3-fs's CTAs an SM holds."""
    return _fs_blocks_per_sm(tables, "ntt_channels_fs")


def intt_fs_blocks_per_sm(tables: ChannelTables) -> int:
    """K4-fs's CTAs an SM holds."""
    return _fs_blocks_per_sm(tables, "intt_channels_fs")


def cascade_blocks_per_sm(tables: ChannelTables) -> int:
    """K1's CTAs an SM holds (:func:`_blocks_per_sm`)."""
    return _blocks_per_sm(tables, "fused_polymul")


def ntt_blocks_per_sm(tables: ChannelTables) -> int:
    """K3's CTAs an SM holds (:func:`_blocks_per_sm`)."""
    return _blocks_per_sm(tables, "ntt_channels")


def intt_blocks_per_sm(tables: ChannelTables) -> int:
    """K4's CTAs an SM holds (:func:`_blocks_per_sm`)."""
    return _blocks_per_sm(tables, "intt_channels")


def _e2e_constants(tables: ChannelTables, plan: RnsPlan, fn_name: str,
                   fits=e2e_fits) -> tuple[tuple, tuple]:
    """The checked (pointers, ints) of a K2 or K2-fs (``fn_name``, which
    holds what ``fits(n, t, S, L)`` says) launch that depend only on the
    plan and its tables: worked out at the plan's first launch of that
    kernel with ``tables`` and kept on the plan, so a short call does not
    pay for them again."""
    kept = plan.__dict__.get("_e2e_launch")
    if kept is None:
        kept = {}
        object.__setattr__(plan, "_e2e_launch", kept)
    if fn_name in kept and kept[fn_name][0] is tables:
        return kept[fn_name][1]
    t, n, S, L = plan.t, plan.n, plan.seg_count, plan.L
    log_n = _check_n(n, fn_name)
    if not fits(n, t, S, L):
        raise ValueError(f"{fn_name}: n={n}, t={t}, S={S}, L={L} do not fit one CTA's shared "
                         "memory")
    dec = require_dec(plan)
    check_dec_limits(plan, fn_name)
    if plan.qs_d.device != tables.qs_d.device or tables.t != t or tables.n != n:
        raise ValueError(f"{fn_name}: plan and tables do not match")
    mode, window, beta, s1, s2 = reduction_mode(tables)
    eps, fsh, ish = _optional_tables(tables)
    d = plan.dec_d
    pointers = tuple(ptr(x) for x in (
        tables.qs_d, tables.half_d, eps, plan.qi_tilde_d, tables.fwd_d, tables.inv_d, fsh, ish,
        d["beta"], d["sau_eps"], d["sau_s2"], d["horner"], d["block_m"],
        plan.qi_star_limbs_d, plan.q_limbs_d,
    ))
    ints = (log_n, t, S, L, dec[0].acc_barrett[1], plan.w, mode, window, beta, s1, s2)
    kept[fn_name] = (tables, (pointers, ints))
    return pointers, ints


def _check_segments(za: torch.Tensor, zb: torch.Tensor, plan: RnsPlan, fn_name: str) -> int:
    """The rows of two (rows, n, S) segment operands a K2 or K2-fs launch
    takes; raises on what the kernel does not take."""
    rows = za.shape[0] if za.dim() == 3 else -1
    check_operand(za, (rows, plan.n, plan.seg_count), "za", fn_name)
    check_operand(zb, (rows, plan.n, plan.seg_count), "zb", fn_name)
    if zb.device != za.device:
        raise ValueError(f"{fn_name}: operands on {za.device} and {zb.device}")
    return rows


def _check_plan_device(plan: RnsPlan, device: torch.device, fn_name: str) -> None:
    if plan.qs_d.device != device:
        raise ValueError(f"{fn_name}: plan and tables live on {plan.qs_d.device}, operands on "
                         f"{device}")


def fused_e2e_polymul_cuda(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                           plan: RnsPlan) -> torch.Tensor:
    """Segments (rows, n, S) x 2 -> product limbs (rows, n, L) in one
    launch of ``csrc/fused_e2e_polymul.cu``.  CPU tensors run the plain
    version."""
    if za.device.type == "cpu":
        return fused_e2e_polymul_ref(za, zb, tables, plan)
    fn_name = "fused_e2e_polymul_cuda"
    rows = _check_segments(za, zb, plan, fn_name)
    pointers, ints = _e2e_constants(tables, plan, fn_name)
    launch = _build.load("fused_e2e_polymul", "parentt_fused_e2e_polymul", _E2E_ARGTYPES)
    _check_plan_device(plan, za.device, fn_name)
    out = torch.empty((rows, plan.n, plan.L), dtype=torch.int64, device=za.device)
    if rows == 0:
        return out
    with torch.cuda.device(za.device):
        code = launch(ptr(za), ptr(zb), ptr(out), *pointers, rows, *ints, _build.stream_of(za))
    _build.check("fused_e2e_polymul", code)
    fused_e2e_polymul_cuda.launches += 1
    fused_e2e_polymul_cuda.cluster = e2e_cluster(plan.t)[0]
    return out


fused_e2e_polymul_cuda.launches = 0
fused_e2e_polymul_cuda.cluster = 0  # CTAs per row of the last launch


def e2e_max_active_clusters(tables: ChannelTables, plan: RnsPlan) -> int:
    """How many clusters of the e2e kernel the current card holds at once
    at this configuration (``cudaOccupancyMaxActiveClusters``)."""
    launch = _build.load("fused_e2e_polymul", "parentt_fused_e2e_max_clusters", [_I] * 6)
    mode, window = reduction_mode(tables)[:2]
    count = launch(plan.n.bit_length() - 1, plan.t, plan.seg_count, plan.L, mode, window)
    if count < 0:
        _build.check("fused_e2e_polymul", -count)
    return count


def e2e_fs_decompose_ref(za: torch.Tensor, zb: torch.Tensor, plan: RnsPlan
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2-fs's first launch: segments (rows, n, S) x 2 ->
    canonical residues (t, rows, n) x 2 as 32-bit words."""
    return tuple(decompose_ref(z, plan).to(torch.int32) for z in (za, zb))


def e2e_fs_cascade_ref(ra: torch.Tensor, rb: torch.Tensor, tables: ChannelTables,
                       plan: RnsPlan) -> torch.Tensor:
    """Plain version of K2-fs's cascade launch: 32-bit residues (t, rows, n)
    x 2 -> y = p q~ mod q (t, rows, n) as 32-bit words, p the four-step
    cascade's product (K1-fs's plain version)."""
    p = fused_polymul_fs_ref(ra.to(torch.int64), rb.to(torch.int64), tables)
    q, _, eps = channel_scalars(tables, 3)
    return mul_mod(p, plan.qi_tilde_d.view(plan.t, 1, 1), q, eps,
                   tables.mul_shifts).to(torch.int32)


def e2e_fs_compose_ref(y: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Plain version of K2-fs's compose launch: y (t, rows, n) 32-bit words
    -> limbs (rows, n, L), the Eq-10 limb sums and tail."""
    acc = limb_sums(y.to(torch.int64), plan.qi_star_limbs_d.view(plan.t, 1, 1, plan.L), plan.w)
    return compose_finalize(acc, plan.q_limbs, w=plan.w, t=plan.t)


def e2e_fs_decompose_cuda(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                          plan: RnsPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """K2-fs's first launch alone: segments (rows, n, S) x 2 -> canonical
    residues (t, rows, n) x 2 as 32-bit words.  CPU tensors run the plain
    version."""
    if za.device.type == "cpu":
        return e2e_fs_decompose_ref(za, zb, plan)
    fn_name = "e2e_fs_decompose_cuda"
    rows = _check_segments(za, zb, plan, fn_name)
    pointers, ints = _e2e_constants(tables, plan, "fused_e2e_polymul_fs_cuda", e2e_fs_fits)
    _, t, S, _, dec_s1 = ints[:5]
    launch = _build.load("fused_e2e_polymul_fs", "parentt_e2e_fs_decompose",
                         _E2E_FS_DECOMPOSE_ARGTYPES)
    _check_plan_device(plan, za.device, fn_name)
    ra, rb = (torch.empty((t, rows, plan.n), dtype=torch.int32, device=za.device)
              for _ in range(2))
    if rows == 0:
        return ra, rb
    d = pointers[8:13]  # the SAU circuits: beta, eps, s2, horner, block_m
    with torch.cuda.device(za.device):
        code = launch(ptr(za), ptr(zb), ptr(ra), ptr(rb), pointers[0], *d, rows * plan.n, t, S,
                      dec_s1, int(narrow_moduli(plan)), _build.stream_of(za))
    _build.check("fused_e2e_polymul_fs", code)
    e2e_fs_decompose_cuda.launches += 1
    return ra, rb


e2e_fs_decompose_cuda.launches = 0


def e2e_fs_cascade_cuda(ra: torch.Tensor, rb: torch.Tensor, tables: ChannelTables,
                        plan: RnsPlan) -> torch.Tensor:
    """K2-fs's cascade launch alone: 32-bit residues (t, rows, n) x 2 -> y =
    p q~ mod q (t, rows, n), 32-bit, written over a copy of ``ra``.  CPU
    tensors run the plain version."""
    if ra.device.type == "cpu":
        return e2e_fs_cascade_ref(ra, rb, tables, plan)
    fn_name = "e2e_fs_cascade_cuda"
    rows = ra.shape[1] if ra.dim() == 3 else -1
    for name, x in (("ra", ra), ("rb", rb)):
        check_operand(x, (plan.t, rows, plan.n), name, fn_name, dtypes=(torch.int32,))
    if rb.device != ra.device:
        raise ValueError(f"{fn_name}: operands on {ra.device} and {rb.device}")
    pointers, ints = _e2e_constants(tables, plan, "fused_e2e_polymul_fs_cuda", e2e_fs_fits)
    launch = _build.load("fused_e2e_polymul_fs", "parentt_e2e_fs_cascade",
                         _E2E_FS_CASCADE_ARGTYPES)
    _check_plan_device(plan, ra.device, fn_name)
    y = ra.clone()
    if rows == 0:
        return y
    with torch.cuda.device(ra.device):
        code = launch(ptr(y), ptr(rb), *pointers[:8], plan.t, rows, ints[0], *ints[6:],
                      e2e_fs_cluster(plan.n).bit_length() - 1, _build.stream_of(ra))
    _build.check("fused_e2e_polymul_fs", code)
    e2e_fs_cascade_cuda.launches += 1
    return y


e2e_fs_cascade_cuda.launches = 0


def e2e_fs_compose_cuda(y: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """K2-fs's compose launch alone: y (t, rows, n) 32-bit words -> limbs
    (rows, n, L).  CPU tensors run the plain version."""
    if y.device.type == "cpu":
        return e2e_fs_compose_ref(y, plan)
    fn_name = "e2e_fs_compose_cuda"
    rows = y.shape[1] if y.dim() == 3 else -1
    check_operand(y, (plan.t, rows, plan.n), "y", fn_name, dtypes=(torch.int32,))
    if not e2e_fs_fits(plan.n, plan.t, plan.seg_count, plan.L):
        raise ValueError(f"{fn_name}: t={plan.t}, L={plan.L}: one CTA cannot hold a "
                         "coefficient's limbs beside the channels' constants")
    launch = _build.load("fused_e2e_polymul_fs", "parentt_e2e_fs_compose",
                         _E2E_FS_COMPOSE_ARGTYPES)
    _check_plan_device(plan, y.device, fn_name)
    out = torch.empty((rows, plan.n, plan.L), dtype=torch.int64, device=y.device)
    if rows == 0:
        return out
    with torch.cuda.device(y.device):
        code = launch(ptr(y), ptr(out), ptr(plan.qs_d), ptr(plan.qi_star_limbs_d),
                      ptr(plan.q_limbs_d), rows * plan.n, plan.t, plan.L, plan.w,
                      _build.stream_of(y))
    _build.check("fused_e2e_polymul_fs", code)
    e2e_fs_compose_cuda.launches += 1
    return out


e2e_fs_compose_cuda.launches = 0


def fused_e2e_polymul_fs_cuda(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                              plan: RnsPlan) -> torch.Tensor:
    """K2-fs: segments (rows, n, S) x 2 -> product limbs (rows, n, L) as the
    multi-block e2e kernel, the three launches of
    ``csrc/fused_e2e_polymul_fs.cu`` in one C call, with the 32-bit
    residues between them allocated here (y goes over the first operand's).
    Takes what :func:`e2e_fs_fits` holds.  CPU tensors run the plain
    version."""
    if za.device.type == "cpu":
        return fused_e2e_polymul_fs_ref(za, zb, tables, plan)
    fn_name = "fused_e2e_polymul_fs_cuda"
    rows = _check_segments(za, zb, plan, fn_name)
    pointers, ints = _e2e_constants(tables, plan, fn_name, e2e_fs_fits)
    launch = _build.load("fused_e2e_polymul_fs", "parentt_fused_e2e_polymul_fs", _E2E_FS_ARGTYPES)
    _check_plan_device(plan, za.device, fn_name)
    out = torch.empty((rows, plan.n, plan.L), dtype=torch.int64, device=za.device)
    if rows == 0:
        return out
    ra, rb = (torch.empty((plan.t, rows, plan.n), dtype=torch.int32, device=za.device)
              for _ in range(2))
    with torch.cuda.device(za.device):
        code = launch(ptr(za), ptr(zb), ptr(ra), ptr(rb), ptr(out), *pointers, rows, *ints,
                      int(narrow_moduli(plan)), e2e_fs_cluster(plan.n).bit_length() - 1,
                      _build.stream_of(za))
    _build.check("fused_e2e_polymul_fs", code)
    fused_e2e_polymul_fs_cuda.launches += 1
    return out


fused_e2e_polymul_fs_cuda.launches = 0


def e2e_fs_cluster(n: int) -> int:
    """The CTAs a cluster of K2-fs's cascade launch takes at n: 1 where
    K1's one-CTA body holds a pair (n <= 16384), else :func:`fs_cluster`."""
    return 1 if cascade_fits(n) else fs_cluster(n)


def e2e_fs_clusters_resident(tables: ChannelTables, plan: RnsPlan) -> int:
    """K2-fs's cascade launch's clusters of :func:`e2e_fs_cluster` CTAs the
    current card holds at once (CTAs resident where K1's one-CTA body runs
    it)."""
    return _clusters_resident("fused_e2e_polymul_fs", tables, e2e_fs_cluster(plan.n))


def e2e_clusters_resident(tables: ChannelTables, plan: RnsPlan) -> int:
    """Clusters the current card holds at once of the cluster launches that
    backend ``cuda_fused_e2e`` runs at the plan's (n, t, S, L): K2's where
    it holds the plan; else K2-fs's cascade's, and past one CTA also
    K1-fs's (its ``negacyclic_mul``), the fewer of the two.
    :func:`repro_torch.plan` refuses ``cuda_fused_e2e`` where it is 0, so
    no launch fails for want of a place to run."""
    if e2e_fits(plan.n, plan.t, plan.seg_count, plan.L):
        return e2e_max_active_clusters(tables, plan)
    resident = e2e_fs_clusters_resident(tables, plan)
    if not cascade_fits(plan.n):
        resident = min(resident, cascade_fs_clusters_resident(tables))
    return resident
