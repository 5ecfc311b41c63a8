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
  each CTA owns channels and a coefficient slice (:func:`e2e_channels`,
  :func:`e2e_slice`), and the residues move between the CTAs through
  distributed shared memory, never through device memory.
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
from repro_torch.core.modmath import add_mod, div2_mod, mul_mod, sub_mod
from repro_torch.core.ntt import ChannelTables, channel_scalars, ct_stages, gs_stages, twiddles
from repro_torch.core.rns import RnsPlan
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand, ptr
from repro_torch.kernels.crt import (
    MAX_LIMBS,
    MAX_SEGMENTS,
    check_dec_limits,
    compose_finalize,
    decompose_ref,
    require_dec,
)

# shared memory one block may opt in to on an H100 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
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


# the fused e2e kernel's cluster (csrc/fused_e2e_polymul.cu): at most the
# portable cluster size of CTAs per row
MAX_CLUSTER = 8
# static shared memory of a decompose circuit table (parentt.cuh
# DecomposeShared: 16 channels), an upper bound
DECOMPOSE_SHARED_BYTES = 2048


def e2e_cluster(t: int) -> tuple[int, int]:
    """(C, slots) of the e2e kernel: C = min(t, 8) CTAs per row, each owning
    at most ``slots`` = ceil(t / C) channels.  The kernel's launch derives
    them itself; this copy serves plan admission and the tests."""
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


def e2e_smem_bytes(n: int, t: int, S: int = MAX_SEGMENTS, L: int = MAX_LIMBS) -> int:
    """Shared memory of one e2e CTA: its channels' two residue polynomials
    (one pad word per 16), the staging of half a block's threads'
    segments per operand or of every thread's limbs, and the decompose
    circuit table.  ``S`` and ``L``
    default to the kernel's largest counts (an upper bound for admission)."""
    _, slots = e2e_cluster(t)
    threads = pass_threads(n)
    res = -(-slots * 2 * padded_words(n) * RESIDUE_BYTES // 16) * 16
    stage = max(2 * (threads // 2) * S, threads * L) * 8
    return res + stage + DECOMPOSE_SHARED_BYTES


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


def fused_e2e_polymul_ref(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                          plan: RnsPlan) -> torch.Tensor:
    """Plain version of the e2e kernel: segments (rows, n, S) x 2 ->
    product limbs (rows, n, L), through the per-channel SAU circuits, the
    cascade and the Eq-10 compose."""
    p = fused_polymul_ref(decompose_ref(za, plan), decompose_ref(zb, plan), tables)  # (t, rows, n)
    q, _, eps = channel_scalars(tables, 3)
    y = mul_mod(p, plan.qi_tilde_d.view(plan.t, 1, 1), q, eps, tables.mul_shifts)
    acc = (y[..., None] * plan.qi_star_limbs_d.view(plan.t, 1, 1, plan.L)).sum(dim=0)
    return compose_finalize(acc, plan.q_limbs, w=plan.w, t=plan.t)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_STAGE_ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]
_CASCADE_ARGTYPES = [_P] * 10 + [_I] * 8 + [_P]
_E2E_ARGTYPES = [_P] * 19 + [_I] * 14 + [_P]


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
    launch: worked out at the tables' first launch of ``source`` and kept
    on the tables, so a short call does not pay for them again."""
    kept = tables.__dict__.get("_launch")
    if kept is None:
        kept = {}
        object.__setattr__(tables, "_launch", kept)
    if source in kept:
        return kept[source]
    n = tables.n
    log_n = _check_n(n, fn_name)
    smem = cascade_smem_bytes(n) if source == "fused_polymul" else stage_smem_bytes(n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{fn_name}: n={n} does not fit one block's shared memory")
    eps, fsh, ish = _optional_tables(tables)
    head = (tables.qs_d, tables.half_d, eps)
    tabs = {
        "fused_polymul": (tables.fwd_d, tables.inv_d, fsh, ish),
        "ntt_channels": (tables.fwd_d, fsh),
        "intt_channels": (tables.inv_d, ish),
    }[source]
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


def cascade_blocks_per_sm(tables: ChannelTables) -> int:
    """K1's CTAs an SM holds (:func:`_blocks_per_sm`)."""
    return _blocks_per_sm(tables, "fused_polymul")


def ntt_blocks_per_sm(tables: ChannelTables) -> int:
    """K3's CTAs an SM holds (:func:`_blocks_per_sm`)."""
    return _blocks_per_sm(tables, "ntt_channels")


def intt_blocks_per_sm(tables: ChannelTables) -> int:
    """K4's CTAs an SM holds (:func:`_blocks_per_sm`)."""
    return _blocks_per_sm(tables, "intt_channels")


def _e2e_constants(tables: ChannelTables, plan: RnsPlan, fn_name: str) -> tuple[tuple, tuple]:
    """The checked (pointers, ints) of a K2 launch that depend only on the
    plan and its tables: worked out at the plan's first launch with
    ``tables`` and kept on the plan, so a short call does not pay for them
    again."""
    kept = plan.__dict__.get("_e2e_launch")
    if kept is not None and kept[0] is tables:
        return kept[1]
    t, n, S, L = plan.t, plan.n, plan.seg_count, plan.L
    log_n = _check_n(n, fn_name)
    if S > MAX_SEGMENTS or L > MAX_LIMBS:
        raise ValueError(f"{fn_name}: S={S}, L={L} exceed the kernel's {MAX_SEGMENTS}/{MAX_LIMBS}")
    if e2e_smem_bytes(n, t, S, L) > MAX_SMEM_BYTES:
        raise ValueError(f"{fn_name}: n={n}, t={t} do not fit one CTA's shared memory")
    dec = require_dec(plan)
    check_dec_limits(plan, fn_name)
    if plan.qs_d.device != tables.qs_d.device or tables.t != t or tables.n != n:
        raise ValueError(f"{fn_name}: plan and tables do not match")
    mode, window, beta, s1, s2 = reduction_mode(tables)
    eps, fsh, ish = _optional_tables(tables)
    d = plan.dec_d
    pointers = tuple(ptr(x) for x in (
        tables.qs_d, tables.half_d, eps, plan.qi_tilde_d, tables.fwd_d, tables.inv_d, fsh, ish,
        d["beta"], d["sau_eps"], d["sau_s2"], d["acc_eps"], d["block_m"], d["block_consts"],
        plan.qi_star_limbs_d, plan.q_limbs_d,
    ))
    ints = (log_n, t, S, L, plan.n_blocks, dec[0].acc_barrett[1], dec[0].acc_barrett[2], plan.w,
            mode, window, beta, s1, s2)
    object.__setattr__(plan, "_e2e_launch", (tables, (pointers, ints)))
    return pointers, ints


def fused_e2e_polymul_cuda(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                           plan: RnsPlan) -> torch.Tensor:
    """Segments (rows, n, S) x 2 -> product limbs (rows, n, L) in one
    launch of ``csrc/fused_e2e_polymul.cu``.  CPU tensors run the plain
    version."""
    if za.device.type == "cpu":
        return fused_e2e_polymul_ref(za, zb, tables, plan)
    fn_name = "fused_e2e_polymul_cuda"
    rows = za.shape[0] if za.dim() == 3 else -1
    check_operand(za, (rows, plan.n, plan.seg_count), "za", fn_name)
    check_operand(zb, (rows, plan.n, plan.seg_count), "zb", fn_name)
    if zb.device != za.device:
        raise ValueError(f"{fn_name}: operands on {za.device} and {zb.device}")
    pointers, ints = _e2e_constants(tables, plan, fn_name)
    launch = _build.load("fused_e2e_polymul", "parentt_fused_e2e_polymul", _E2E_ARGTYPES)
    if plan.qs_d.device != za.device:
        raise ValueError(f"{fn_name}: plan and tables live on {plan.qs_d.device}, operands on "
                         f"{za.device}")
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
