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
  by the same block Barrett, the limb sums carry-normalised every 15
  channels, the quotient floor(value / q) from a double sum and one
  correction, the limbs staged in shared memory (:func:`compose_rows`
  rows a CTA) and written coalesced, in 16-limb chunks past 16 limbs.

Neither kernel caps t, S or L: what they keep per channel, segment or
limb lives in dynamic shared memory, and a shape whose CTA cannot hold
it (:func:`decompose_fits`, :func:`compose_fits`) is refused, at plan
time by :func:`repro_torch.plan` and before a launch by the wrappers.

:func:`decompose_stage` is one channel's Alg-2 SAU circuit and
:func:`compose_finalize` the Eq-10 tail (carry ripple, then t-1
conditional big-integer subtractions of q); the plain versions
:func:`decompose_ref` and :func:`compose_ref`, and the fused e2e
kernel's plain version, are built from them (the limb sums through
:func:`repro_torch.core.rns.limb_sums`, exact for every t).  The device
functions ``decompose``, ``crt_limb_sums`` and ``crt_compose`` in
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
from repro_torch.core.rns import ChannelDecompose, RnsPlan, limb_sums
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand, ptr

KERNEL_T_PRIME = 3  # the Alg-2 block width of every plan (core/rns.py make_plan)
# dynamic shared memory one block may opt in to on an H100 (232,448 bytes;
# csrc/parentt.cuh kMaxSmem)
MAX_SMEM_BYTES = 227 * 1024
# bytes of one channel's circuit in the kernels' shared table
# (csrc/parentt.cuh Decompose) and of one channel's compose constants
# (csrc/compose.cu ComposeChannel)
DECOMPOSE_CHANNEL_BYTES = 32
COMPOSE_CHANNEL_BYTES = 24


def fit_chunk(cap: int, room: int, per: int) -> int:
    """Items of ``per`` bytes a staging area of ``room`` bytes holds, at
    most ``cap``: cap if all fit, else a multiple of 32 where room allows
    32 or more, else what fits (0 when not one does); csrc/parentt.cuh
    ``fit_chunk``."""
    k = room // per if room > 0 else 0
    if k >= cap:
        return cap
    return k & ~31 if k >= 32 else k


def tile_rows(words: int, fixed: int) -> int:
    """Rows of a K5 or K6 tile whose ``words`` int64 words a row sit in
    shared memory beside ``fixed`` bytes: up to 256 within 64 KB, 32 past
    it while one block's shared memory holds them (csrc/parentt.cuh
    ``tile_rows``)."""
    per = 8 * words
    budget = min(max(64 * 1024, 32 * per), MAX_SMEM_BYTES - fixed)
    return fit_chunk(256, budget, per)


def decompose_table_bytes(t: int) -> int:
    """Shared memory of t channels' decompose circuits (K2, K2-fs, K5)."""
    return t * DECOMPOSE_CHANNEL_BYTES


def compose_table_bytes(t: int) -> int:
    """Shared memory of K6's t channel constants, rounded to 16."""
    return -(-t * COMPOSE_CHANNEL_BYTES // 16) * 16


def decompose_rows(t: int, S: int) -> int:
    """Rows of a K5 block: its (rows, S) slab beside the circuits."""
    return tile_rows(S, decompose_table_bytes(t))


def compose_rows(t: int, L: int) -> int:
    """Rows of a K6 CTA: its (rows, L) limb stage beside the channels."""
    return tile_rows(L, compose_table_bytes(t))


def decompose_smem_bytes(t: int, S: int) -> int:
    return decompose_table_bytes(t) + decompose_rows(t, S) * S * 8


def compose_smem_bytes(t: int, L: int) -> int:
    return compose_table_bytes(t) + compose_rows(t, L) * L * 8


def decompose_fits(t: int, S: int) -> bool:
    """Whether a K5 block holds one row's segments beside t circuits."""
    return decompose_rows(t, S) >= 1


def compose_fits(t: int, L: int) -> bool:
    """Whether a K6 CTA holds one row's limbs beside t channels."""
    return compose_rows(t, L) >= 1


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
    """Raise unless the plan's decompose circuits are what the kernels'
    block body is written for (blocks of t' = 3 segments)."""
    require_dec(plan)
    if plan.t_prime != KERNEL_T_PRIME:
        raise ValueError(f"{fn}: Alg-2 blocks of t'={plan.t_prime} segments: the kernels take "
                         f"t'={KERNEL_T_PRIME}")


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
    (rows, L), the body of the reference's ``compose_pallas`` with the
    limb sums exact for every t."""
    y = (residues * plan.qi_tilde_d[:, None]) % plan.qs_d[:, None]  # (t, rows)
    acc = limb_sums(y, plan.qi_star_limbs_d[:, None, :], plan.w)  # (rows, L)
    return compose_finalize(acc, plan.q_limbs, w=plan.w, t=plan.t)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DECOMPOSE_ARGTYPES = [_P] * 8 + [_LL] + [_I] * 4 + [_P]
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
    if not decompose_fits(plan.t, S):
        raise ValueError(f"{fn_name}: t={plan.t}, S={S}: one block's shared memory cannot hold "
                         "a row's segments beside the channels' circuits")
    dec = require_dec(plan)
    check_dec_limits(plan, fn_name)
    d = plan.dec_d
    pointers = tuple(ptr(x) for x in (plan.qs_d, d["beta"], d["sau_eps"], d["sau_s2"],
                                      d["horner"], d["block_m"]))
    ints = (plan.t, S, dec[0].acc_barrett[1], int(narrow_moduli(plan)))
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
    if not compose_fits(plan.t, plan.L):
        raise ValueError(f"{fn_name}: t={plan.t}, L={plan.L}: one CTA's shared memory cannot "
                         "hold a row's limbs beside the channels' constants")
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
