"""The NTT schedule of a plan and the paper's folding-set model of the
2-parallel NTT -> iNTT cascade (PyTorch port of ``repro.core.schedule``).

Two parts:

* The paper's FPGA cycle model (§III, Eq 1/2 and 11-13, Tables I/II,
  Fig 17): :func:`bpp_cycles`, :func:`latency_cycles`,
  :func:`total_cycles`, the folding orders and :func:`simulate_cascade`,
  which shows that consuming the forward NTT's output with the
  bit-reversed folding set needs no buffer and no added latency, where
  the conventional same-order schedule parks n/4 pairs.  Pure host
  arithmetic, as in the reference.
* The resolved schedule of a plan, :class:`ScheduleSpec`, frozen into
  ``PlanConfig.schedule`` so :func:`repro_torch.plan_key` carries it.
  ``kind``, ``splits``, ``depth``, ``canonical`` and ``str()`` are the
  reference's (the chain of :func:`repro_torch.core.ntt.four_step_chain`).
  The reference's VMEM fields (``row_blk``, ``vmem_budget``,
  ``tile_bytes``) account for a TPU core and are not the card's; in their
  place :func:`resolve_spec` records the card's own accounting of the
  kernel that serves the backend's main path at n (see the field notes).
  :func:`tile_bytes_model` is the reference's TPU footprint model, kept
  as a function of its arguments only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.ntt import bit_reverse_indices, four_step_chain
from repro_torch.errors import UnknownKnobError, UnservableConfigError

# --------------------------------------------------------------------------
# Timing model (Eq 11-13)
# --------------------------------------------------------------------------


def bpp_cycles(n: int) -> int:
    """Block processing period of the 2-parallel multiplier (Eq 11)."""
    return n // 2


def latency_cycles(n: int, t_pipe: int = 0, with_shuffle: bool = False) -> int:
    """Latency of one modular polynomial multiplication (Eq 12); the
    conventional shuffled cascade pays an extra n/4 (Fig 17)."""
    extra = n // 4 if with_shuffle else 0
    return (n - 2) + extra + t_pipe


def total_cycles(n: int, L: int, t_pipe: int = 0, with_shuffle: bool = False) -> int:
    """Clock cycles for L back-to-back multiplications (Eq 13)."""
    return latency_cycles(n, t_pipe, with_shuffle) + bpp_cycles(n) * L


# --------------------------------------------------------------------------
# Folding sets (Tables I and II)
# --------------------------------------------------------------------------


def ntt_folding_order(n: int, s: int) -> np.ndarray:
    """Table I: the node PE_s processes at folding clock l,
    (2^{m-s-1} + l) mod n/2."""
    m = n.bit_length() - 1
    half = n // 2
    l = np.arange(half)
    return (2 ** (m - s - 1) + l) % half if s < m - 1 else (l + 1) % half


def intt_folding_order(n: int, s: int) -> np.ndarray:
    """Table II: the node iNTT PE_s processes at folding clock l; <x> is
    the bit-reverse over (m-1) bits."""
    half = n // 2
    brv = bit_reverse_indices(half)
    l = np.arange(half)
    if s == 0:
        return brv[(l + 1) % half]
    return brv[(2 - 2**s + l) % half]


# --------------------------------------------------------------------------
# Cascade buffer simulation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CascadeSim:
    n: int
    max_buffer_pairs: int  # peak product pairs parked between NTT and iNTT
    added_latency: int  # extra clocks before the iNTT can start consuming


def simulate_cascade(n: int, bit_reversed_intt: bool = True) -> CascadeSim:
    """Clock-accurate production/consumption simulation at the NTT -> iNTT
    boundary of the 2-parallel cascade."""
    half = n // 2
    brv_half = bit_reverse_indices(half)
    # forward PE_{m-1} emits physical pair k at clock (k - 1) mod half
    prod_clock = np.empty(half, dtype=np.int64)
    for clock, node in enumerate(ntt_folding_order(n, n.bit_length() - 2)):
        prod_clock[node] = clock
    # iNTT drawn node j needs physical pair rev(j)
    cons_clock = np.empty(half, dtype=np.int64)
    if bit_reversed_intt:
        intt_order = intt_folding_order(n, 0)  # Table II PE_0
    else:
        intt_order = (np.arange(half) + 1) % half  # the NTT's folding set
    for clock, node in enumerate(intt_order):
        cons_clock[brv_half[node]] = clock
    # a pair produced at p and consumed at c >= p occupies the buffer during
    # [p, c); a consumption before its production slips the schedule by
    # whole clocks, counted as added latency
    slip = int(np.max(prod_clock - cons_clock).clip(min=0))
    cons_eff = cons_clock + slip
    occupancy = np.zeros(2 * half + 1, dtype=np.int64)
    for p, c in zip(prod_clock, cons_eff):
        occupancy[p] += 1
        occupancy[c] -= 1
    peak = int(np.max(np.cumsum(occupancy))) - 1  # the pass-through pair is not buffered
    return CascadeSim(n=n, max_buffer_pairs=max(peak, 0), added_latency=slip)


# --------------------------------------------------------------------------
# Resolved schedule specs: the plan-time form of the schedule= knob
# --------------------------------------------------------------------------

SCHEDULE_STRINGS = ("auto", "radix2", "four_step", "four_step:h")


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """A fully-resolved NTT schedule, the hashable value frozen into
    ``PlanConfig.schedule``.

    The reference's fields:

    kind:
        ``"radix2"`` or ``"four_step"``, never ``"auto"``.
    splits:
        Per-level ``(columns, rows)`` of the canonical four-step chain,
        outermost first (``()`` for radix2): what ``backend="torch"``
        runs, in the reference's grouping.

    The port's own (the card's accounting, filled by :func:`resolve_spec`
    for the kernel that serves the backend's main path at n; zero and
    empty for ``backend="torch"`` and for :func:`concrete_spec`):

    multi_block:
        True when that kernel is a multi-block transform (the polynomial
        does not fit one CTA's shared memory), False for a one-block
        kernel.
    card_split:
        The multi-block kernels' own ``(n1, n2)``
        (:func:`repro_torch.kernels.ntt.fs_split`); ``()`` for one block.
        The card's split, not the TPU chain above: both give the same
        canonical outputs.
    smem_bytes:
        Shared memory of one CTA of that kernel.
    smem_budget:
        What one CTA may use on the card
        (:data:`repro_torch.kernels.ntt.MAX_SMEM_BYTES`).
    """

    kind: str
    splits: tuple[tuple[int, int], ...] = ()
    multi_block: bool = False
    card_split: tuple[int, ...] = ()
    smem_bytes: int = 0
    smem_budget: int = 0

    @property
    def depth(self) -> int:
        return len(self.splits)

    @property
    def canonical(self) -> str:
        """The string this spec is the resolution of."""
        if self.kind != "four_step":
            return self.kind
        if self.depth <= 1:
            return "four_step"
        return "four_step:h"

    def __str__(self) -> str:
        if self.kind != "four_step":
            return self.kind
        tiles = "x".join(f"{c}.{r}" for c, r in self.splits)
        return f"four_step[{tiles}]"


def parse_schedule(schedule) -> tuple[str, bool]:
    """Validate a schedule string -> ``(request, hier_required)`` with
    request one of ``"auto"``, ``"radix2"``, ``"four_step"``."""
    if not isinstance(schedule, str):
        raise UnknownKnobError(
            f"unknown schedule {schedule!r}: expected one of {SCHEDULE_STRINGS} or a "
            "ScheduleSpec",
            knob="schedule", value=schedule, alternatives=SCHEDULE_STRINGS,
        )
    if schedule == "four_step:h":
        return "four_step", True
    if schedule in ("auto", "radix2", "four_step"):
        return schedule, False
    raise UnknownKnobError(
        f"unknown schedule {schedule!r}: expected one of {SCHEDULE_STRINGS}",
        knob="schedule", value=schedule, alternatives=SCHEDULE_STRINGS,
    )


def concrete_spec(n: int, schedule) -> ScheduleSpec:
    """A string or spec -> a ScheduleSpec with the canonical splits for n
    (the card's accounting left empty: :func:`resolve_spec` fills it)."""
    if isinstance(schedule, ScheduleSpec):
        return schedule
    kind, hier = parse_schedule(schedule)
    if kind == "auto":
        kind = "four_step" if n >= 256 else "radix2"
    if kind == "radix2":
        return ScheduleSpec(kind="radix2")
    splits = four_step_chain(n)
    if hier and len(splits) < 2:
        raise UnservableConfigError(
            f"schedule='four_step:h' requires a hierarchical chain but n={n} resolves to the "
            f"single-level split {splits[0]} (hierarchy starts at n=8192)",
            knob="schedule", value="four_step:h", alternatives=("four_step", "auto"),
        )
    return ScheduleSpec(kind="four_step", splits=splits)


def tile_bytes_model(
    kind: str,
    n: int,
    splits: tuple[tuple[int, int], ...],
    row_blk: int,
    seg_count: int,
    limb_count: int,
    lazy: bool,
) -> int:
    """The reference's per-grid-step VMEM footprint of its channel-tiled
    fused-e2e TPU kernel (int64 elements x 8 bytes): one channel's twiddle
    tables (4n entries for four_step, 2n for radix2, plus the sub-row
    tables; doubled with the Shoup companions when lazy) plus ``row_blk``
    rows of the two decomposed operands and the output limbs.  A model of
    the TPU kernel, not of any kernel on the card."""
    if kind == "four_step":
        tables = 4 * n + 2 * sum(c * r for c, r in splits[1:])
    else:
        tables = 2 * n
    if lazy:
        tables *= 2
    data = row_blk * n * (2 * seg_count + limb_count)
    return 8 * (tables + data)


def resolve_spec(n: int, schedule, *, tiling=None, backend: str = "torch",
                 t: int = 1, seg_count: int = 1, limbs: int = 2) -> ScheduleSpec:
    """Plan-time resolution of ``schedule`` and ``tiling`` into a
    :class:`ScheduleSpec` with the card's accounting for ``backend`` at
    (n, t) and the plan's S (``seg_count``) and L (``limbs``).

    ``tiling``: a tuple of per-level ``(columns, rows)`` pairs asserts the
    canonical chain (a mismatch is unservable, knob ``tiling``: the chain
    is a function of n alone); an integer row-block request is the
    reference's TPU knob and is not ported (knob ``tiling``).  The card's
    fields describe the kernel the backend's main path launches at n: K3
    and K4 (``"cuda"``), K1 (``"cuda_fused"``), each one-block where the
    polynomial fits a CTA and multi-block past it, or K2 and K2-fs
    (``"cuda_fused_e2e"``: one channel's polynomials a CTA, multi-block
    past it).  Whether that kernel serves (n, t) is the caller's
    admission."""
    spec = concrete_spec(n, schedule)
    if tiling is not None:
        if isinstance(tiling, int):
            raise UnservableConfigError(
                f"tiling={tiling}: an integer tiling is the reference's row-block request of "
                "its TPU kernel, not ported; pass the chain as a tuple or leave tiling=None",
                knob="tiling", value=tiling, alternatives=(None, spec.splits),
            )
        tiling = tuple(tuple(map(int, lvl)) for lvl in tiling)
        if tiling != spec.splits:
            raise UnservableConfigError(
                f"tiling hint {tiling} does not match the canonical chain {spec.splits} for "
                f"n={n}, schedule={spec.canonical!r} (splits are plan-time-static functions of n)",
                knob="tiling", value=tiling, alternatives=(spec.splits,),
            )
    if backend == "torch":
        return spec
    from repro_torch.kernels import ntt as ntt_kernels

    multi, smem = ntt_kernels.main_path_kernel_smem(backend, n, t, seg_count, limbs)
    return dataclasses.replace(
        spec, multi_block=multi, card_split=ntt_kernels.fs_split(n) if multi else (),
        smem_bytes=smem, smem_budget=ntt_kernels.MAX_SMEM_BYTES,
    )
