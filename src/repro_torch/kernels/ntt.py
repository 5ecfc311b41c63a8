"""The transform CUDA kernels of the port, their wrappers, launch
counters and plain PyTorch versions (port of ``repro.kernels.ntt``).

* :func:`fused_polymul_cuda` (``csrc/fused_polymul.cu``, K1) replaces the
  TPU kernel ``fused_polymul_pallas`` (``repro/kernels/ntt.py:757``): the
  per-channel no-shuffle cascade NTT(a) (.) NTT(b) -> iNTT, one block per
  (channel, row), both operands in shared memory.
* :func:`fused_e2e_polymul_cuda` (``csrc/fused_e2e_polymul.cu``, K2)
  replaces ``fused_e2e_polymul_pallas`` (``repro/kernels/ntt.py:802``):
  SAU decompose -> cascade -> Eq-10 compose in one launch, one block per
  row looping over the t channels (Hopper blocks run in no order, so the
  block's own loop takes the place of the TPU's ordered channel grid).
* :func:`ntt_channels_cuda` (``csrc/ntt_channels.cu``, K3) replaces
  ``ntt_channels_pallas`` (``repro/kernels/ntt.py:680``): the forward
  transform per channel, natural in, bit-reversed and canonical out.
* :func:`intt_channels_cuda` (``csrc/intt_channels.cu``, K4) replaces
  ``intt_channels_pallas`` (``repro/kernels/ntt.py:721``): the inverse
  with the Eq-24 halving, bit-reversed in, natural and canonical out.

Each wrapper runs its plain version (the ``*_ref`` functions) only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
``<wrapper>.launches`` counts the launches, and nothing else adds to it.
What bounds each kernel on the card, and what its design does about it,
is noted in its source.  K3 and K4 keep the residues as 32-bit words:
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
    compose_finalize,
    decompose_ref,
    require_dec,
)

# shared memory one block may opt in to on an H100 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
RESIDUE_BYTES = 4  # residues are stored as 32-bit words in shared memory

# reduction regimes (csrc/parentt.cuh: Mode)
MODE_LAZY, MODE_BARRETT, MODE_REM = 0, 1, 2


def stage_smem_bytes(n: int) -> int:
    """Shared memory of one stage-transform block (K3, K4): one polynomial."""
    return n * RESIDUE_BYTES


def cascade_smem_bytes(n: int) -> int:
    """Shared memory of one fused-cascade block: both operands."""
    return 2 * n * RESIDUE_BYTES


def e2e_smem_bytes(n: int, t: int) -> int:
    """Shared memory of one e2e block: both operands in all t channels."""
    return 2 * t * n * RESIDUE_BYTES


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
_E2E_ARGTYPES = [_P] * 19 + [_I] * 16 + [_P]


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


def _launch_stage(a: torch.Tensor, tables: ChannelTables, source: str, fn_name: str,
                  tab: torch.Tensor, tab_shoup: torch.Tensor | None) -> torch.Tensor:
    """One launch of a single-transform kernel (K3 or K4) on (t, rows, n)."""
    t, n = tables.t, tables.n
    rows = a.shape[1] if a.dim() == 3 else -1
    check_operand(a, (t, rows, n), "a", fn_name)
    log_n = _check_n(n, fn_name)
    if stage_smem_bytes(n) > MAX_SMEM_BYTES:
        raise ValueError(f"{fn_name}: n={n} does not fit one block's shared memory")
    launch = _build.load(source, f"parentt_{source}", _STAGE_ARGTYPES)
    _check_tables_device(tables, a.device, fn_name)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    mode, window, beta, s1, s2 = reduction_mode(tables)
    eps = _optional_tables(tables)[0]
    with torch.cuda.device(a.device):
        code = launch(
            ptr(a), ptr(out), ptr(tables.qs_d), ptr(tables.half_d), ptr(eps), ptr(tab),
            ptr(tab if tab_shoup is None else tab_shoup),
            t, rows, log_n, mode, window, beta, s1, s2, _build.stream_of(a),
        )
    _build.check(source, code)
    return out


def ntt_channels_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """(t, rows, n) canonical residues -> (t, rows, n) canonical spectra in
    bit-reversed order.  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/ntt_channels.cu`` on the current stream."""
    if a.device.type == "cpu":
        return ntt_channels_ref(a, tables)
    out = _launch_stage(a, tables, "ntt_channels", "ntt_channels_cuda", tables.fwd_d,
                        tables.fwd_shoup_d)
    ntt_channels_cuda.launches += 1
    return out


ntt_channels_cuda.launches = 0


def intt_channels_cuda(a: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """(t, rows, n) canonical bit-reversed spectra -> (t, rows, n)
    canonical residues in natural order.  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/intt_channels.cu``."""
    if a.device.type == "cpu":
        return intt_channels_ref(a, tables)
    out = _launch_stage(a, tables, "intt_channels", "intt_channels_cuda", tables.inv_d,
                        tables.inv_shoup_d)
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
    log_n = _check_n(n, fn_name)
    if cascade_smem_bytes(n) > MAX_SMEM_BYTES:
        raise ValueError(f"{fn_name}: n={n} does not fit one block's shared memory")
    launch = _build.load("fused_polymul", "parentt_fused_polymul", _CASCADE_ARGTYPES)
    _check_tables_device(tables, a.device, fn_name)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    mode, window, beta, s1, s2 = reduction_mode(tables)
    eps, fsh, ish = _optional_tables(tables)
    with torch.cuda.device(a.device):
        code = launch(
            ptr(a), ptr(b), ptr(out), ptr(tables.qs_d), ptr(tables.half_d), ptr(eps),
            ptr(tables.fwd_d), ptr(tables.inv_d), ptr(fsh), ptr(ish),
            t, rows, log_n, mode, window, beta, s1, s2, _build.stream_of(a),
        )
    _build.check("fused_polymul", code)
    fused_polymul_cuda.launches += 1
    return out


fused_polymul_cuda.launches = 0


def fused_e2e_polymul_cuda(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                           plan: RnsPlan) -> torch.Tensor:
    """Segments (rows, n, S) x 2 -> product limbs (rows, n, L) in one
    launch of ``csrc/fused_e2e_polymul.cu``.  CPU tensors run the plain
    version."""
    if za.device.type == "cpu":
        return fused_e2e_polymul_ref(za, zb, tables, plan)
    fn_name = "fused_e2e_polymul_cuda"
    t, n, S, L = plan.t, plan.n, plan.seg_count, plan.L
    rows = za.shape[0] if za.dim() == 3 else -1
    check_operand(za, (rows, n, S), "za", fn_name)
    check_operand(zb, (rows, n, S), "zb", fn_name)
    if zb.device != za.device:
        raise ValueError(f"{fn_name}: operands on {za.device} and {zb.device}")
    log_n = _check_n(n, fn_name)
    if e2e_smem_bytes(n, t) > MAX_SMEM_BYTES:
        raise ValueError(f"{fn_name}: n={n}, t={t} do not fit one block's shared memory")
    if S > MAX_SEGMENTS or L > MAX_LIMBS:
        raise ValueError(f"{fn_name}: S={S}, L={L} exceed the kernel's {MAX_SEGMENTS}/{MAX_LIMBS}")
    dec = require_dec(plan)
    launch = _build.load("fused_e2e_polymul", "parentt_fused_e2e_polymul", _E2E_ARGTYPES)
    _check_tables_device(tables, za.device, fn_name)
    if plan.qs_d.device != za.device or tables.t != t or tables.n != n:
        raise ValueError(f"{fn_name}: plan and tables do not match the operands")
    out = torch.empty((rows, n, L), dtype=torch.int64, device=za.device)
    if rows == 0:
        return out
    mode, window, beta, s1, s2 = reduction_mode(tables)
    eps, fsh, ish = _optional_tables(tables)
    d = plan.dec_d
    dec_s1, acc_s2 = dec[0].acc_barrett[1], dec[0].acc_barrett[2]
    with torch.cuda.device(za.device):
        code = launch(
            ptr(za), ptr(zb), ptr(out),
            ptr(tables.qs_d), ptr(tables.half_d), ptr(eps), ptr(plan.qi_tilde_d),
            ptr(tables.fwd_d), ptr(tables.inv_d), ptr(fsh), ptr(ish),
            ptr(d["sau_eps"]), ptr(d["sau_s2"]), ptr(d["acc_eps"]),
            ptr(d["beta_e"]), ptr(d["beta_s"]), ptr(d["block_consts"]),
            ptr(plan.qi_star_limbs_d), ptr(plan.q_limbs_d),
            rows, log_n, t, S, L, d["beta_e"].shape[1], plan.n_blocks, plan.t_prime,
            dec_s1, acc_s2, plan.w, mode, window, beta, s1, s2, _build.stream_of(za),
        )
    _build.check("fused_e2e_polymul", code)
    fused_e2e_polymul_cuda.launches += 1
    return out


fused_e2e_polymul_cuda.launches = 0
