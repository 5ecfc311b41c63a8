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

* :func:`fused_polymul_fs_cuda` (``csrc/fused_polymul_fs.cu``, K1-fs),
  :func:`ntt_channels_fs_cuda` (``csrc/ntt_channels_fs.cu``, K3-fs) and
  :func:`intt_channels_fs_cuda` (``csrc/intt_channels_fs.cu``, K4-fs)
  replace the four-step bodies of those three TPU kernels
  (``repro/kernels/ntt.py:312-371``, ``:158-204``, ``:266``, ``:282``): the
  same transforms as multi-block kernels for polynomials that do not fit
  one CTA, on the card's own split n = n1 n2 (:func:`fs_split`).  A
  column launch and a row launch (three launches for the cascade: forward
  columns, one row pass around the product, inverse columns) of
  :func:`fs_threads` threads a CTA over :data:`FS_TILE`-element tiles
  keep lazy 32-bit values in a scratch tensor between launches.  Their
  plain versions are the four-step plain PyTorch of
  :mod:`repro_torch.core.ntt` in the reference's grouping: the outputs
  are canonical, so they agree whatever the split.  ``.launches`` counts
  calls, each of two (K3-fs, K4-fs) or three (K1-fs) CUDA launches.
* :func:`fused_e2e_polymul_fs_cuda` (``csrc/fused_e2e_polymul_fs.cu``,
  K2-fs) replaces the four-step body of ``fused_e2e_polymul_pallas``: K2's
  function past one CTA (where K2's CTA does not hold (n, t)), three
  launches over the same tiles: the forward columns with the decompose
  fused in, as a cluster of min(t, 8) CTAs per (row, column tile), each
  owning K2's slots of channels, whose residues move through distributed
  shared memory; K1-fs's row launch; the inverse columns with the compose
  fused in, as the same clusters (:func:`e2e_fs_geom`).  Only 32-bit
  lazy words reach device memory between the launches.  Its plain version
  is K2's over the four-step cascade; ``.launches`` counts calls and
  ``.cluster`` is the cluster size of the last.

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
    decompose_ref,
    decompose_table_bytes,
    fit_chunk,
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
FS_TILE = 4096  # elements a CTA of a multi-block launch takes (kLogFsTile)
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
    """Elements one CTA of a multi-block launch takes: min(n, FS_TILE); a
    column CTA takes n1 rows x fs_tile / n1 columns, a row CTA
    fs_tile / n2 whole rows."""
    return min(n, FS_TILE)


def fs_threads(n: int) -> int:
    """Threads of a multi-block CTA: pass_threads of its tile."""
    return pass_threads(fs_tile(n))


def fs_blocks(t: int, rows: int, n: int) -> int:
    """CTAs of one multi-block launch over t x rows polynomials."""
    return t * rows * (n // fs_tile(n))


def ntt_fs_smem_bytes(n: int) -> int:
    """Shared memory of a K3-fs CTA (either launch): one padded tile."""
    return padded_words(fs_tile(n)) * RESIDUE_BYTES


def intt_fs_smem_bytes(n: int) -> int:
    """Shared memory of a K4-fs CTA (either launch): one padded tile."""
    return padded_words(fs_tile(n)) * RESIDUE_BYTES


def cascade_fs_smem_bytes(n: int) -> int:
    """Shared memory of a K1-fs CTA at most: two padded tiles (its forward
    column and row launches; the inverse column launch holds one)."""
    return 2 * padded_words(fs_tile(n)) * RESIDUE_BYTES


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


# the smallest n K2-fs takes (a column tile of 16 elements, 8 threads a CTA)
E2E_FS_MIN_N = 16


def e2e_fs_geom(n: int, t: int, S: int, L: int) -> tuple[tuple[int, int, int], int, int]:
    """((shared memory of its forward column, row and inverse column
    launches' CTAs), dc, cc) of K2-fs (csrc/fused_e2e_polymul_fs.cu
    ``e2e_fs_geom``): the forward column CTA holds both operands' padded
    tiles of each of its slots, the circuits and dc coefficients'
    segments an operand; the row CTA is K1-fs's (two tiles); the inverse
    column CTA one y tile a slot, the circuits and cc coefficients'
    limbs."""
    words, threads = padded_words(fs_tile(n)), fs_threads(n)
    _, slots = e2e_cluster(t)
    tiles = lambda k: -(-k * words * RESIDUE_BYTES // 16) * 16
    cols = tiles(2 * slots) + decompose_table_bytes(t)
    dc = fit_chunk(threads // 2, MAX_SMEM_BYTES - cols, 2 * S * 8)
    inv_cols = tiles(slots) + decompose_table_bytes(t)
    cc = fit_chunk(threads, MAX_SMEM_BYTES - inv_cols, L * 8)
    return (cols + 2 * dc * S * 8, cascade_fs_smem_bytes(n), inv_cols + cc * L * 8), dc, cc


def e2e_fs_smem_bytes(n: int, t: int, S: int, L: int) -> int:
    """Shared memory of a K2-fs CTA at most (:func:`e2e_fs_geom`)."""
    return max(e2e_fs_geom(n, t, S, L)[0])


def e2e_fs_fits(n: int, t: int, S: int, L: int) -> bool:
    """Whether the multi-block e2e kernel K2-fs holds (n, t, S, L): n >= 16,
    and each of its CTAs within one block's shared memory with a staging
    of at least one coefficient."""
    smem, dc, cc = e2e_fs_geom(n, t, S, L)
    return n >= E2E_FS_MIN_N and dc >= 1 and cc >= 1 and max(smem) <= MAX_SMEM_BYTES


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
        return (False, stage_smem_bytes(n)) if stage_fits(n) else (True, ntt_fs_smem_bytes(n))
    if backend == "cuda_fused":
        return ((False, cascade_smem_bytes(n)) if cascade_fits(n)
                else (True, cascade_fs_smem_bytes(n)))
    if backend == "cuda_fused_e2e":
        if e2e_fits(n, t, S, L):
            return False, max(cascade_smem_bytes(n), e2e_smem_bytes(n, t, S, L))
        return True, e2e_fs_smem_bytes(n, t, S, L)
    raise ValueError(f"main_path_kernel_smem: {backend!r} is not a kernel backend")


# the fused e2e kernel's cluster (csrc/fused_e2e_polymul.cu): at most the
# portable cluster size of CTAs per row
MAX_CLUSTER = 8


def e2e_cluster(t: int) -> tuple[int, int]:
    """(C, slots) of the e2e kernels: C = min(t, 8) CTAs per row (K2) or
    per (row, column tile) (K2-fs), each owning at most ``slots`` =
    ceil(t / C) channels.  The kernels' launch derives them itself; this
    copy serves plan admission and the tests."""
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
_E2E_ARGTYPES = [_P] * 18 + [_I] * 12 + [_P]
_E2E_FS_ARGTYPES = [_P] * 20 + [_I] * 12 + [_P]
_FS_STAGE_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
_FS_CASCADE_ARGTYPES = [_P] * 12 + [_I] * 8 + [_P]
# each K1/K3/K4 source's shared memory a CTA, one-block and multi-block
_SMEM = {
    "fused_polymul": cascade_smem_bytes, "ntt_channels": stage_smem_bytes,
    "intt_channels": stage_smem_bytes, "fused_polymul_fs": cascade_fs_smem_bytes,
    "ntt_channels_fs": ntt_fs_smem_bytes, "intt_channels_fs": intt_fs_smem_bytes,
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


def _launch_fs(operands: tuple, tables: ChannelTables, source: str, fn_name: str
               ) -> torch.Tensor:
    """One call of a multi-block kernel (K1-fs on two operands, K3-fs or
    K4-fs on one) on (t, rows, n): its 32-bit scratch (one tensor an
    operand) and its output allocated here, its two or three launches in
    the C entry point."""
    t, n = tables.t, tables.n
    a = operands[0]
    rows = a.shape[1] if a.dim() == 3 else -1
    for name, x in zip("ab", operands):
        check_operand(x, (t, rows, n), name, fn_name)
        if x.device != a.device:
            raise ValueError(f"{fn_name}: operands on {a.device} and {x.device}")
    pointers, ints = _table_constants(tables, source, fn_name)
    argtypes = _FS_CASCADE_ARGTYPES if len(operands) == 2 else _FS_STAGE_ARGTYPES
    launch = _build.load(source, f"parentt_{source}", argtypes)
    _check_tables_device(tables, a.device, fn_name)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    scratch = [torch.empty((t, rows, n), dtype=torch.int32, device=a.device) for _ in operands]
    with torch.cuda.device(a.device):
        code = launch(*(ptr(x) for x in operands), *(ptr(x) for x in scratch), ptr(out),
                      *pointers, t, rows, *ints, _build.stream_of(a))
    _build.check(source, code)
    return out


def ntt_channels_fs_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """K3-fs: (t, rows, n) canonical residues -> (t, rows, n) canonical
    spectra in bit-reversed order, as a multi-block transform.  CPU tensors
    run the plain version; CUDA tensors launch ``csrc/ntt_channels_fs.cu``
    (two launches) on the current stream."""
    if a.device.type == "cpu":
        return ntt_channels_fs_ref(a, tables)
    out = _launch_fs((a,), tables, "ntt_channels_fs", "ntt_channels_fs_cuda")
    ntt_channels_fs_cuda.launches += 1
    return out


ntt_channels_fs_cuda.launches = 0


def intt_channels_fs_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """K4-fs: (t, rows, n) canonical bit-reversed spectra -> (t, rows, n)
    canonical residues in natural order, as a multi-block transform.  CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/intt_channels_fs.cu`` (two launches)."""
    if a.device.type == "cpu":
        return intt_channels_fs_ref(a, tables)
    out = _launch_fs((a,), tables, "intt_channels_fs", "intt_channels_fs_cuda")
    intt_channels_fs_cuda.launches += 1
    return out


intt_channels_fs_cuda.launches = 0


def fused_polymul_fs_cuda(a: torch.Tensor, b: torch.Tensor, tables: ChannelTables
                          ) -> torch.Tensor:
    """K1-fs: (t, rows, n) x (t, rows, n) canonical residues -> (t, rows, n)
    negacyclic products per channel, as a multi-block cascade whose
    NTT-domain product never reaches device memory.  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/fused_polymul_fs.cu`` (three
    launches)."""
    if a.device.type == "cpu":
        return fused_polymul_fs_ref(a, b, tables)
    out = _launch_fs((a, b), tables, "fused_polymul_fs", "fused_polymul_fs_cuda")
    fused_polymul_fs_cuda.launches += 1
    return out


fused_polymul_fs_cuda.launches = 0


def _fs_blocks_per_sm(tables: ChannelTables, source: str, passes: int) -> tuple[int, ...]:
    """CTAs an SM of the current card holds at once of each launch of the
    multi-block kernel ``csrc/<source>.cu`` at these tables' n and regime."""
    launch = _build.load(source, f"parentt_{source}_blocks_per_sm", [_I] * 4)
    mode, window = reduction_mode(tables)[:2]
    counts = []
    for p in range(passes):
        count = launch(p, tables.n.bit_length() - 1, mode, window)
        if count < 0:
            _build.check(source, -count)
        counts.append(count)
    return tuple(counts)


def cascade_fs_blocks_per_sm(tables: ChannelTables) -> tuple[int, int, int]:
    """K1-fs's CTAs an SM holds: (forward columns, rows, inverse columns)."""
    return _fs_blocks_per_sm(tables, "fused_polymul_fs", 3)


def ntt_fs_blocks_per_sm(tables: ChannelTables) -> tuple[int, int]:
    """K3-fs's CTAs an SM holds: (columns, rows)."""
    return _fs_blocks_per_sm(tables, "ntt_channels_fs", 2)


def intt_fs_blocks_per_sm(tables: ChannelTables) -> tuple[int, int]:
    """K4-fs's CTAs an SM holds: (rows, columns)."""
    return _fs_blocks_per_sm(tables, "intt_channels_fs", 2)


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


def fused_e2e_polymul_fs_cuda(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                              plan: RnsPlan) -> torch.Tensor:
    """K2-fs: segments (rows, n, S) x 2 -> product limbs (rows, n, L) as the
    multi-block e2e kernel, three launches of ``csrc/fused_e2e_polymul_fs.cu``
    (two of them clusters of min(t, 8) CTAs) with 32-bit scratch between
    them, allocated here.  Takes what :func:`e2e_fs_fits` holds.  CPU
    tensors run the plain version."""
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
    scratch = [torch.empty((plan.t, rows, plan.n), dtype=torch.int32, device=za.device)
               for _ in range(2)]
    with torch.cuda.device(za.device):
        code = launch(ptr(za), ptr(zb), *(ptr(x) for x in scratch), ptr(out), *pointers, rows,
                      *ints, _build.stream_of(za))
    _build.check("fused_e2e_polymul_fs", code)
    fused_e2e_polymul_fs_cuda.launches += 1
    fused_e2e_polymul_fs_cuda.cluster = e2e_cluster(plan.t)[0]
    return out


fused_e2e_polymul_fs_cuda.launches = 0
fused_e2e_polymul_fs_cuda.cluster = 0  # CTAs per (row, column tile) of the last call


def e2e_fs_max_active_clusters(tables: ChannelTables, plan: RnsPlan) -> tuple[int, int]:
    """How many clusters of K2-fs's two cluster launches (forward columns,
    inverse columns) the current card holds at once at this configuration
    (``cudaOccupancyMaxActiveClusters``); its row launch is K1-fs's
    (:func:`cascade_fs_blocks_per_sm`)."""
    launch = _build.load("fused_e2e_polymul_fs", "parentt_fused_e2e_polymul_fs_max_clusters",
                         [_I] * 7)
    mode, window = reduction_mode(tables)[:2]
    counts = []
    for p in (0, 2):
        count = launch(p, plan.n.bit_length() - 1, plan.t, plan.seg_count, plan.L, mode, window)
        if count < 0:
            _build.check("fused_e2e_polymul_fs", -count)
        counts.append(count)
    return tuple(counts)


def e2e_clusters_resident(tables: ChannelTables, plan: RnsPlan) -> int:
    """Clusters of the e2e kernel that serves the plan's (n, t, S, L) the
    current card holds at once: K2's, or the fewer of K2-fs's two cluster
    launches'.  :func:`repro_torch.plan` refuses ``cuda_fused_e2e`` where
    it is 0, so no launch fails for want of a place to run."""
    if e2e_fits(plan.n, plan.t, plan.seg_count, plan.L):
        return e2e_max_active_clusters(tables, plan)
    return min(e2e_fs_max_active_clusters(tables, plan))
