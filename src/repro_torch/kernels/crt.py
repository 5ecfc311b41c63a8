"""RNS stages of the port: the decompose and compose CUDA kernels, their
wrappers, launch counters and plain PyTorch versions (port of
``repro.kernels.crt``).

* :func:`decompose_cuda` (``csrc/decompose.cu``, K5) replaces the TPU
  kernel ``decompose_pallas`` (``repro/kernels/crt.py:180``): Alg-2 SAU
  residues, segments ``(rows, S)`` -> residues ``(t, rows)``, one launch
  for all t channels (the TPU version makes one ``pallas_call`` per
  channel): a block stages a tile of 256 rows' segments and the
  channels' circuits in shared memory, then one thread per coefficient
  runs every channel, its block products reduced by the Barrett of
  :func:`repro_torch.core.rns.block_barrett_constant`.
* :func:`compose_cuda` (``csrc/compose.cu``, K6) replaces
  ``compose_pallas`` (``repro/kernels/crt.py:266``): the Eq-10 inverse
  CRT, residues ``(t, rows)`` -> base-2^w limbs ``(rows, L)``, one thread
  per coefficient on the fused e2e kernel's compose tail: y = r q~ mod q
  by the same block Barrett, the quotient floor(value / q) from a double
  sum and one correction, the limbs staged in shared memory and written
  coalesced.

:func:`decompose_stage` is one channel's Alg-2 SAU circuit and
:func:`compose_finalize` the Eq-10 tail (carry ripple, then t-1
conditional big-integer subtractions of q); the plain versions
:func:`decompose_ref` and :func:`compose_ref`, and the fused e2e
kernel's plain version, are built from them.  The device functions
``decompose``, ``crt_limb_sums`` and ``compose_finalize_quotient`` in
``csrc/parentt.cuh`` compute the same values.

Each wrapper runs its plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.  ``<wrapper>.launches``
counts the launches, and nothing else adds to it.  Both kernels take
canonical values, as the reference's kernels do: compose's block
Barrett is exact for r q~ < 2^(2b), b = bit_length(q), which every
canonical residue meets (the reference's ``%`` also reduces larger ones).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import modmath
from repro_torch.core.rns import ChannelDecompose, RnsPlan
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand, ptr

# the kernels' limits (csrc/parentt.cuh): segments and limbs of a
# coefficient, channels and Alg-2 blocks of a decompose circuit, the
# block width
MAX_SEGMENTS = 16
MAX_LIMBS = 16
MAX_CHANNELS = 16
MAX_BLOCKS = 6
KERNEL_T_PRIME = 3  # the Alg-2 block width of every plan (core/rns.py make_plan)


def require_dec(plan: RnsPlan):
    """The plan's in-kernel decompose circuits, or raise: every kernel that
    decomposes needs them."""
    if plan.dec is None:
        raise ValueError(
            f"plan (v={plan.v}) has no in-kernel decompose constants: the int64 "
            "kernels need v <= 31 and SAU words inside the 32-bit Barrett window"
        )
    return plan.dec


def check_dec_limits(plan: RnsPlan, fn: str) -> None:
    """Raise unless the plan's decompose circuits fit the kernels' shared
    table (parentt.cuh ``DecomposeShared``)."""
    require_dec(plan)
    if plan.t > MAX_CHANNELS or plan.n_blocks > MAX_BLOCKS or plan.t_prime != KERNEL_T_PRIME:
        raise ValueError(
            f"{fn}: t={plan.t}, {plan.n_blocks} Alg-2 blocks of t'={plan.t_prime} segments: the "
            f"kernels take t <= {MAX_CHANNELS}, <= {MAX_BLOCKS} blocks of t'={KERNEL_T_PRIME}"
        )


def narrow_moduli(plan: RnsPlan) -> bool:
    """Every q below 2^30: the kernels' decompose keeps its Barrett
    remainders (< 4q) in 32 bits."""
    return max(int(q).bit_length() for q in plan.qs) <= 30


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


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


def decompose_ref(z: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Plain version of the decompose kernel: segments (..., S) ->
    residues (t, ...), the channels' SAU circuits stacked."""
    return torch.stack([
        decompose_stage(z, ch, seg_count=plan.seg_count, t_prime=plan.t_prime)
        for ch in require_dec(plan)
    ])


def compose_ref(residues: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Plain version of the compose kernel: residues (t, rows) -> limbs
    (rows, L), the body of the reference's ``compose_pallas``."""
    y = (residues * plan.qi_tilde_d[:, None]) % plan.qs_d[:, None]  # (t, rows)
    acc = (y[:, :, None] * plan.qi_star_limbs_d[:, None, :]).sum(dim=0)  # (rows, L)
    return compose_finalize(acc, plan.q_limbs, w=plan.w, t=plan.t)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DECOMPOSE_ARGTYPES = [_P] * 9 + [_LL] + [_I] * 6 + [_P]
_COMPOSE_ARGTYPES = [_P] * 7 + [_LL] + [_I] * 5 + [_P]


def _check_plan_device(plan: RnsPlan, device: torch.device, fn: str) -> None:
    if plan.qs_d.device != device:
        raise ValueError(f"{fn}: plan lives on {plan.qs_d.device}, operand on {device}")


def _decompose_constants(plan: RnsPlan, fn_name: str) -> tuple[tuple, tuple]:
    """The checked (pointers, ints) of a K5 launch that depend only on the
    plan: worked out at its first launch and kept on the plan."""
    kept = plan.__dict__.get("_decompose_launch")
    if kept is not None:
        return kept
    S = plan.seg_count
    if S > MAX_SEGMENTS:
        raise ValueError(f"{fn_name}: S={S} exceeds the kernel's {MAX_SEGMENTS}")
    dec = require_dec(plan)
    check_dec_limits(plan, fn_name)
    d = plan.dec_d
    pointers = tuple(ptr(x) for x in (plan.qs_d, d["beta"], d["sau_eps"], d["sau_s2"],
                                      d["acc_eps"], d["block_m"], d["block_consts"]))
    ints = (plan.t, S, plan.n_blocks, dec[0].acc_barrett[1], dec[0].acc_barrett[2],
            int(narrow_moduli(plan)))
    object.__setattr__(plan, "_decompose_launch", (pointers, ints))
    return pointers, ints


def decompose_cuda(z: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Segments (rows, S) -> residues (t, rows) in one launch of
    ``csrc/decompose.cu``.  CPU tensors run the plain version."""
    if z.device.type == "cpu":
        return decompose_ref(z, plan)
    fn_name = "decompose_cuda"
    rows = z.shape[0] if z.dim() == 2 else -1
    check_operand(z, (rows, plan.seg_count), "z", fn_name)
    pointers, ints = _decompose_constants(plan, fn_name)
    launch = _build.load("decompose", "parentt_decompose", _DECOMPOSE_ARGTYPES)
    _check_plan_device(plan, z.device, fn_name)
    out = torch.empty((plan.t, rows), dtype=torch.int64, device=z.device)
    if rows == 0:
        return out
    with torch.cuda.device(z.device):
        code = launch(ptr(z), ptr(out), *pointers, rows, *ints, _build.stream_of(z))
    _build.check("decompose", code)
    decompose_cuda.launches += 1
    return out


decompose_cuda.launches = 0


def _compose_constants(plan: RnsPlan, fn_name: str) -> tuple[tuple, tuple]:
    """The checked (pointers, ints) of a K6 launch that depend only on the
    plan: worked out at its first launch and kept on the plan."""
    kept = plan.__dict__.get("_compose_launch")
    if kept is not None:
        return kept
    if plan.L > MAX_LIMBS or plan.t > MAX_CHANNELS:
        raise ValueError(f"{fn_name}: t={plan.t}, L={plan.L}: the kernel takes t <= "
                         f"{MAX_CHANNELS}, L <= {MAX_LIMBS}")
    dec = require_dec(plan)
    pointers = tuple(ptr(x) for x in (plan.qs_d, plan.qi_tilde_d, plan.dec_d["block_m"],
                                      plan.qi_star_limbs_d, plan.q_limbs_d))
    ints = (plan.t, plan.L, plan.w, dec[0].acc_barrett[1], int(narrow_moduli(plan)))
    object.__setattr__(plan, "_compose_launch", (pointers, ints))
    return pointers, ints


def compose_cuda(residues: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Canonical residues (t, rows) -> limbs (rows, L) in one launch of
    ``csrc/compose.cu``.  CPU tensors run the plain version."""
    if residues.device.type == "cpu":
        return compose_ref(residues, plan)
    fn_name = "compose_cuda"
    rows = residues.shape[1] if residues.dim() == 2 else -1
    check_operand(residues, (plan.t, rows), "residues", fn_name)
    pointers, ints = _compose_constants(plan, fn_name)
    launch = _build.load("compose", "parentt_compose", _COMPOSE_ARGTYPES)
    _check_plan_device(plan, residues.device, fn_name)
    out = torch.empty((rows, plan.L), dtype=torch.int64, device=residues.device)
    if rows == 0:
        return out
    with torch.cuda.device(residues.device):
        code = launch(ptr(residues), ptr(out), *pointers, rows, *ints,
                      _build.stream_of(residues))
    _build.check("compose", code)
    compose_cuda.launches += 1
    return out


compose_cuda.launches = 0
