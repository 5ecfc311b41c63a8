"""The slice's two CUDA kernels, their wrappers, launch counters and plain
PyTorch versions (port of ``repro.kernels.ntt``'s fused kernels).

* :func:`fused_polymul_cuda` (``csrc/fused_polymul.cu``) replaces the TPU
  kernel ``fused_polymul_pallas`` (``repro/kernels/ntt.py:757``): the
  per-channel no-shuffle cascade NTT(a) (.) NTT(b) -> iNTT, one block per
  (channel, row), both operands in shared memory.
* :func:`fused_e2e_polymul_cuda` (``csrc/fused_e2e_polymul.cu``) replaces
  ``fused_e2e_polymul_pallas`` (``repro/kernels/ntt.py:802``): SAU
  decompose -> cascade -> Eq-10 compose in one launch, one block per row
  looping over the t channels (Hopper blocks run in no order, so the
  block's own loop takes the place of the TPU's ordered channel grid).

Each wrapper runs its plain version (:func:`fused_polymul_ref`,
:func:`fused_e2e_polymul_ref`) only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.  ``<wrapper>.launches`` counts
the launches, and nothing else adds to it.  What bounds each kernel on
the card, and what its design does about it, is noted in its source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import modmath
from repro_torch.core.modmath import add_mod, div2_mod, mul_mod, sub_mod
from repro_torch.core.ntt import ChannelTables, channel_scalars, ct_stages, gs_stages, twiddles
from repro_torch.core.rns import RnsPlan
from repro_torch.kernels import _build
from repro_torch.kernels.crt import compose_finalize, decompose_stage

# shared memory one block may opt in to on an H100 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
# per-coefficient register arrays of the e2e kernel (csrc/parentt.cuh)
MAX_SEGMENTS = 16
MAX_LIMBS = 16
RESIDUE_BYTES = 4  # residues are stored as 32-bit words in shared memory

# reduction regimes (csrc/parentt.cuh: Mode)
MODE_LAZY, MODE_BARRETT, MODE_REM = 0, 1, 2


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


def fused_polymul_ref(a: torch.Tensor, b: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """Plain version of the fused cascade: (t, rows, n) x (t, rows, n) ->
    (t, rows, n) canonical negacyclic products, with the kernel's
    butterflies (lazy window, one canonicalize before the product and one
    at exit)."""
    q, _, eps = channel_scalars(tables, 3)
    ct, gs = _butterflies(tables)
    if tables.lazy is not None:
        window = tables.lazy[0]

        def canon(x):
            return modmath.canonicalize(x, q, window)
    else:

        def canon(x):
            return x

    fa = canon(ct_stages(a, ct))
    fb = canon(ct_stages(b, ct))
    prod = mul_mod(fa, fb, q, eps, tables.mul_shifts)
    return canon(gs_stages(prod, gs))


def fused_e2e_polymul_ref(za: torch.Tensor, zb: torch.Tensor, tables: ChannelTables,
                          plan: RnsPlan) -> torch.Tensor:
    """Plain version of the e2e kernel: segments (rows, n, S) x 2 ->
    product limbs (rows, n, L), through the per-channel SAU circuits, the
    cascade and the Eq-10 compose."""
    dec = require_dec(plan)
    ra = torch.stack(
        [decompose_stage(za, ch, seg_count=plan.seg_count, t_prime=plan.t_prime) for ch in dec]
    )
    rb = torch.stack(
        [decompose_stage(zb, ch, seg_count=plan.seg_count, t_prime=plan.t_prime) for ch in dec]
    )
    p = fused_polymul_ref(ra, rb, tables)  # (t, rows, n)
    q, _, eps = channel_scalars(tables, 3)
    y = mul_mod(p, plan.qi_tilde_d.view(plan.t, 1, 1), q, eps, tables.mul_shifts)
    acc = (y[..., None] * plan.qi_star_limbs_d.view(plan.t, 1, 1, plan.L)).sum(dim=0)
    return compose_finalize(acc, plan.q_limbs, w=plan.w, t=plan.t)


def require_dec(plan: RnsPlan):
    if plan.dec is None:
        raise ValueError(
            f"plan (v={plan.v}) has no in-kernel decompose constants: the int64 "
            "kernels need v <= 31 and SAU words inside the 63-bit Barrett window"
        )
    return plan.dec


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_CASCADE_ARGTYPES = [_P] * 10 + [_I] * 8 + [_P]
_E2E_ARGTYPES = [_P] * 19 + [_I] * 16 + [_P]


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _check_operand(x, shape: tuple, name: str, fn: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor like the first operand, "
                         f"got one on {x.device}")
    if x.dtype != torch.int64:
        raise ValueError(f"{fn}: {name} must be int64, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{fn}: expected {name} of shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


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


def fused_polymul_cuda(a: torch.Tensor, b: torch.Tensor, tables: ChannelTables) -> torch.Tensor:
    """(t, rows, n) x (t, rows, n) canonical residues -> (t, rows, n)
    negacyclic products per channel.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/fused_polymul.cu`` on the current stream."""
    if a.device.type == "cpu":
        return fused_polymul_ref(a, b, tables)
    fn_name = "fused_polymul_cuda"
    t, n = tables.t, tables.n
    rows = a.shape[1] if a.dim() == 3 else -1
    _check_operand(a, (t, rows, n), "a", fn_name)
    _check_operand(b, (t, rows, n), "b", fn_name)
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
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = launch(
            _ptr(a), _ptr(b), _ptr(out), _ptr(tables.qs_d), _ptr(tables.half_d), _ptr(eps),
            _ptr(tables.fwd_d), _ptr(tables.inv_d), _ptr(fsh), _ptr(ish),
            t, rows, log_n, mode, window, beta, s1, s2, ctypes.c_void_p(stream),
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
    _check_operand(za, (rows, n, S), "za", fn_name)
    _check_operand(zb, (rows, n, S), "zb", fn_name)
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
        stream = torch.cuda.current_stream(za.device).cuda_stream
        code = launch(
            _ptr(za), _ptr(zb), _ptr(out),
            _ptr(tables.qs_d), _ptr(tables.half_d), _ptr(eps), _ptr(plan.qi_tilde_d),
            _ptr(tables.fwd_d), _ptr(tables.inv_d), _ptr(fsh), _ptr(ish),
            _ptr(d["sau_eps"]), _ptr(d["sau_s2"]), _ptr(d["acc_eps"]),
            _ptr(d["beta_e"]), _ptr(d["beta_s"]), _ptr(d["block_consts"]),
            _ptr(plan.qi_star_limbs_d), _ptr(plan.q_limbs_d),
            rows, log_n, t, S, L, d["beta_e"].shape[1], plan.n_blocks, plan.t_prime,
            dec_s1, acc_s2, plan.w, mode, window, beta, s1, s2, ctypes.c_void_p(stream),
        )
    _build.check("fused_e2e_polymul", code)
    fused_e2e_polymul_cuda.launches += 1
    return out


fused_e2e_polymul_cuda.launches = 0
