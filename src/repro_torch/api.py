"""The plan/execute front door of the PyTorch port (counterpart of
``repro.api`` at the int64 width, v <= 31).

Usage::

    import repro_torch

    pl = repro_torch.plan(n=4096, t=6, v=30)     # paper's preferred point
    limbs = repro_torch.polymul(pl, za, zb)      # (..., n, S) -> (..., n, L)
    limbs = repro_torch.execute(pl, za, zb)      # the serving layer's hook

:func:`plan` resolves every knob once into a frozen :class:`PlanConfig`
and uploads the tables to the plan's device; :func:`plan_from_params`
wraps an existing :class:`ParenttParams` (honouring its ``backend`` and
``schedule`` fields and its device) through the same admission.  Plans
run on the CUDA card unless the caller passes ``device="cpu"``; with no
card and no device asked for, :func:`plan` raises.  ``backend="auto"``
resolves at plan time, and the result is what ``PlanConfig.backend``
holds: ``"cuda_fused_e2e"`` on the card where K2 holds the plan, or the
multi-block K2-fs at t <= 8, with S and L <= 16
(:func:`repro_torch.kernels.ops.auto_backend`), ``"cuda_fused"`` past
it, and ``"torch"`` on the CPU.  The kernel
backends serve every n up to 65536 (one-block kernels where a polynomial
fits a CTA, multi-block kernels past it) and every t, S and L whose CTAs
one block's shared memory holds; past that a plan is refused at plan
time (knob ``t``, naming the backends that do serve), never at launch.
``schedule`` (``"auto"``,
``"radix2"``, ``"four_step"``, ``"four_step:h"`` or a
:class:`ScheduleSpec`) and a ``tiling`` chain resolve, as in the
reference, into the :class:`ScheduleSpec` of ``PlanConfig.schedule``,
which :func:`plan_key` carries; ``backend="torch"`` runs the four-step
schedule it names, the kernel backends record it (the card's own split
and shared memory are in the spec).  ``use_sau=False`` runs the
reference's generic decompose on ``backend="torch"``; the kernel backends
decompose through the Alg-2 SAU circuits whatever it says, as the
reference's Pallas backends do.  The reference's other knobs are taken
and checked as it checks them: ``channel_grid`` (``None`` or ``True``: the
e2e kernels spread the channels over a cluster's CTAs) and
``tuning="off"`` serve; a ``row_blk``, ``channel_grid=False`` and the
tuning tables are TPU knobs the card has no use for and are refused
(:class:`UnservableConfigError` with their own knob).  :func:`execute` is
:func:`polymul` under the reference's
serving signature.  Besides the multiplier, the stage entry points
:func:`ntt`, :func:`intt`, :func:`decompose`, :func:`compose` and
:func:`negacyclic_mul` run one stage each on the plan's backend; the BFV
layer (:mod:`repro_torch.core.bfv`) runs every homomorphic product
through :func:`negacyclic_mul` and every decrypt through :func:`compose`.
The reference's integer ``tiling`` and its wide and oracle widths
(v > 31) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import bigint
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.params import ParenttParams, make_params
from repro_torch.core.schedule import ScheduleSpec
from repro_torch.errors import UnknownKnobError, UnservableConfigError
from repro_torch.kernels import ntt as ntt_kernels
from repro_torch.kernels import ops as ops_mod
from repro_torch.kernels.ops import BACKENDS, KERNEL_BACKENDS

__all__ = [
    "BACKENDS",
    "Plan",
    "PlanConfig",
    "ScheduleSpec",
    "compose",
    "decompose",
    "execute",
    "from_limbs",
    "intt",
    "negacyclic_mul",
    "ntt",
    "plan",
    "plan_from_params",
    "plan_key",
    "polymul",
    "polymul_ints",
    "to_segments",
]

_V_MIN, _V_MAX = 8, 60
_V_INT64_MAX = 31


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Frozen, fully-resolved execution config; no ``"auto"`` survives."""

    n: int
    t: int
    v: int
    backend: str  # BACKENDS entry
    schedule: ScheduleSpec  # the resolved NTT schedule, with the card's accounting
    device: str  # torch device string the plan's tables live on
    seg_count: int  # S: base-2^v segments per input coefficient
    w: int  # output limb width (base 2^w)
    L: int  # output limb count
    use_sau: bool = True  # Alg-2 SAU decompose (False: generic, backend "torch" only)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """An executable multiplier plan; build with :func:`plan`."""

    config: PlanConfig
    params: ParenttParams

    @property
    def n(self) -> int:
        return self.config.n

    @property
    def t(self) -> int:
        return self.config.t

    @property
    def v(self) -> int:
        return self.config.v

    @property
    def q(self) -> int:
        return self.params.q

    @property
    def device(self) -> torch.device:
        return self.params.device


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise UnservableConfigError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch datapath",
                knob="device", value=None, alternatives=("cpu",),
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise UnservableConfigError(
            f"device={device!r} asked for, but no CUDA device is available",
            knob="device", value=device, alternatives=("cpu",),
        )
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda"):
        raise UnknownKnobError(
            f"device must be a CPU or CUDA device, got {device!r}",
            knob="device", value=device, alternatives=("cpu", "cuda"),
        )
    return dev


def plan(
    n: int = 4096,
    t: int = 6,
    v: int = 30,
    *,
    backend: str = "auto",
    schedule="auto",
    tiling=None,
    row_blk: int | None = None,
    channel_grid: bool | None = None,
    use_sau: bool = True,
    tuning: Any = "off",
    device=None,
) -> Plan:
    """Build an executable plan: search the primes, precompute and upload
    every table, and resolve the knobs into a frozen :class:`PlanConfig`.

    ``schedule`` resolves as in the reference (``"auto"``: four-step from
    n = 256; ``"four_step:h"`` asserts the hierarchical chain, from
    n = 8192); a tuple ``tiling`` asserts the canonical chain.
    ``row_blk``, ``channel_grid``, ``use_sau`` and ``tuning`` are the
    reference's knobs, checked as it checks them (see the module notes for
    what the port serves of each).

    Raises :class:`repro_torch.UnknownKnobError` for a knob outside its
    vocabulary and :class:`repro_torch.UnservableConfigError` for a valid
    combination the port cannot serve (v > 31, no card, n above 65536 on a
    kernel backend, a t, S or L whose CTAs one block's shared memory
    cannot hold on the backend asked for, ``"four_step:h"`` below
    n = 8192, a mismatched ``tiling``, a ``row_blk``, ``channel_grid`` off
    the e2e backend or False, a tuning table), each with the same ``knob``
    as the reference."""
    if not isinstance(n, int) or n < 4 or n & (n - 1):
        raise UnknownKnobError(
            f"n must be a power of two >= 4, got n={n!r}", knob="n", value=n, alternatives=()
        )
    if not isinstance(t, int) or t < 1:
        raise UnknownKnobError(
            f"t must be a positive int, got t={t!r}", knob="t", value=t, alternatives=()
        )
    if not isinstance(v, int) or not (_V_MIN <= v <= _V_MAX):
        raise UnknownKnobError(
            f"v must be an int in [{_V_MIN}, {_V_MAX}], got v={v!r}",
            knob="v", value=v, alternatives=(),
        )
    _check_tpu_knobs(row_blk, channel_grid, tuning)
    _check_use_sau(use_sau)
    _check_width(v)
    dev = _resolve_device(device)
    resolved = ops_mod.resolve_backend(backend, dev, n, t, v)
    schedule_mod.resolve_spec(n, schedule, tiling=tiling)  # the schedule's knobs, before the search
    resolved, params = _admit(resolved, n, t, v, dev, auto=backend == "auto")
    _check_channel_grid(channel_grid, resolved)
    return _plan_of(params, resolved, schedule, tiling, dev, use_sau)


def _check_width(v: int) -> None:
    if v > _V_INT64_MAX:
        raise UnservableConfigError(
            f"the port serves the int64 width (v <= {_V_INT64_MAX}); v={v} needs the "
            "wide or oracle datapath, which is not ported yet",
            knob="v", value=v, alternatives=(30,),
        )


def _check_tpu_knobs(row_blk, channel_grid, tuning) -> None:
    """The reference's TPU knobs: an invalid value is unknown (as the
    reference raises), a valid one the card has no use for unservable."""
    if tuning is not None and not isinstance(tuning, str):
        raise UnknownKnobError(
            f"tuning must be 'auto', 'off' or a table path, got {tuning!r}",
            knob="tuning", value=tuning, alternatives=("auto", "off"),
        )
    if tuning is not None and tuning != "off":
        raise UnservableConfigError(
            f"tuning={tuning!r}: the tuning tables rank TPU kernel knobs, which the card's "
            "kernels do not have; only tuning='off' is served",
            knob="tuning", value=tuning, alternatives=("off",),
        )
    if row_blk is not None:
        if not isinstance(row_blk, int) or row_blk < 1:
            raise UnknownKnobError(
                f"row_blk must be >= 1, got {row_blk}",
                knob="row_blk", value=row_blk, alternatives=(1, 2, 4, 8),
            )
        raise UnservableConfigError(
            f"row_blk={row_blk}: the rows a TPU grid step takes; the card's kernels take one "
            "row (or a cluster of CTAs) a block and have no row block to set",
            knob="row_blk", value=row_blk, alternatives=(None,),
        )
    if channel_grid is not None and not isinstance(channel_grid, bool):
        raise UnknownKnobError(
            f"channel_grid must be True, False or None, got {channel_grid!r}",
            knob="channel_grid", value=channel_grid, alternatives=(True, False, None),
        )


def _check_channel_grid(channel_grid, backend: str) -> None:
    """channel_grid is a knob of the fused e2e backend only (as in the
    reference); of its values the e2e kernels serve None and True (the
    channels over a cluster's CTAs), not False (every channel in one
    program)."""
    if channel_grid is None:
        return
    if backend != "cuda_fused_e2e":
        raise UnservableConfigError(
            f"channel_grid= schedules the fused-e2e kernel's RNS channels; backend={backend!r} "
            "has no such grid (use backend='cuda_fused_e2e' or leave channel_grid=None)",
            knob="channel_grid", value=channel_grid, alternatives=(None,),
        )
    if channel_grid is False:
        raise UnservableConfigError(
            "channel_grid=False: the e2e kernels spread the channels over a cluster's CTAs and "
            "have no form that runs them all in one program",
            knob="channel_grid", value=False, alternatives=(None, True),
        )


def _check_use_sau(use_sau) -> None:
    if not isinstance(use_sau, bool):
        raise UnknownKnobError(
            f"use_sau must be True or False, got {use_sau!r}",
            knob="use_sau", value=use_sau, alternatives=(True, False),
        )


def _admit(backend: str, n: int, t: int, v: int, dev: torch.device,
           params: ParenttParams | None = None, auto: bool = False
           ) -> tuple[str, ParenttParams]:
    """The kernel backends' admission, shared by :func:`plan` and
    :func:`plan_from_params`: refuse n above the multi-block kernels'
    reach (before the prime search), build the params unless given, then
    refuse a backend whose kernels one block's shared memory cannot hold
    at the plan's (t, S, L), or whose e2e clusters the card cannot hold at
    once (knob ``t``, naming the backends that serve).  Under ``auto`` an
    e2e choice the card cannot serve falls back to ``cuda_fused``.
    Returns the backend and the params."""
    if backend in KERNEL_BACKENDS and n > ntt_kernels.FS_MAX_N:
        raise UnservableConfigError(
            f"backend={backend!r} serves n <= {ntt_kernels.FS_MAX_N}, got n={n}",
            knob="n", value=n, alternatives=("backend='torch'",),
        )
    if params is None:
        params = make_params(n=n, t=t, v=v, device=dev)
    if backend not in KERNEL_BACKENDS:
        return backend, params
    rp = params.plan
    if rp.dec is None:
        raise UnservableConfigError(
            f"the kernels' decompose cannot hold t={t}, v={v}: no in-kernel decompose constants "
            "(an SAU word past the 32-bit Barrett window)",
            knob="t", value=t, alternatives=("backend='torch'",),
        )
    serving = ops_mod.serving_backends(n, t, rp.seg_count, rp.L)
    if backend == "cuda_fused_e2e" and backend in serving and dev.type == "cuda" \
            and ntt_kernels.e2e_clusters_resident(params.tables, rp) < 1:
        serving = tuple(b for b in serving if b != backend)
    if auto and backend not in serving:
        backend = "cuda_fused"
    if backend not in serving:
        raise UnservableConfigError(
            f"backend={backend!r} cannot hold t={t} (S={rp.seg_count}, L={rp.L}) at n={n}: its "
            "CTAs' shared memory (or, for cuda_fused_e2e, a cluster on this card) does not "
            "fit what they keep per channel, segment and limb",
            knob="t", value=t,
            alternatives=tuple(f"backend={b!r}" for b in serving) + ("backend='torch'",),
        )
    return backend, params


def _plan_of(params: ParenttParams, backend: str, schedule, tiling, dev: torch.device,
             use_sau: bool) -> Plan:
    """The plan of admitted params: the schedule resolved with the card's
    accounting of the kernel that serves (n, t, S, L)."""
    rp = params.plan
    spec = schedule_mod.resolve_spec(params.n, schedule, tiling=tiling, backend=backend,
                                     t=params.t, seg_count=rp.seg_count, limbs=rp.L)
    if backend in KERNEL_BACKENDS and spec.smem_bytes > spec.smem_budget:
        raise UnservableConfigError(
            f"backend={backend!r}: n={params.n}, t={params.t} need {spec.smem_bytes} bytes of "
            f"shared memory a CTA, above the {spec.smem_budget} one CTA may use",
            knob="n", value=params.n, alternatives=("backend='cuda_fused'", "backend='torch'"),
        )
    cfg = PlanConfig(
        n=params.n, t=params.t, v=params.v, backend=backend, schedule=spec, device=str(dev),
        seg_count=rp.seg_count, w=rp.w, L=rp.L, use_sau=use_sau,
    )
    return Plan(config=cfg, params=params)


def plan_from_params(
    params: ParenttParams,
    *,
    backend: str | None = None,
    use_sau: bool = True,
) -> Plan:
    """Wrap an existing :class:`ParenttParams` into a :class:`Plan` on the
    params' device: ``backend`` if given, else ``params.backend``
    (``"auto"`` resolves as in :func:`plan`), with ``params.schedule``,
    through the same admission as :func:`plan`; ``use_sau`` as in
    :func:`plan`."""
    _check_use_sau(use_sau)
    _check_width(params.v)
    dev = _resolve_device(params.device)
    asked = params.backend if backend is None else backend
    resolved = ops_mod.resolve_backend(asked, dev, params.n, params.t, params.v)
    resolved, _ = _admit(resolved, params.n, params.t, params.v, dev, params=params,
                         auto=asked == "auto")
    return _plan_of(params, resolved, params.schedule, None, dev, use_sau)


def _require_plan(pl: Plan, fn: str) -> PlanConfig:
    if not isinstance(pl, Plan):
        raise TypeError(
            f"{fn}: first argument must be a repro_torch.Plan (build one with "
            f"repro_torch.plan(...)), got {type(pl).__name__}"
        )
    return pl.config


def polymul(pl: Plan, za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """za, zb: ``(..., n, S)`` base-2^v segments -> ``(..., n, L)`` base-2^w
    limbs of ``a * b mod (x^n + 1, q)``: the whole Fig-10 pipeline on the
    plan's backend.  Operands must lie on the plan's device."""
    cfg = _require_plan(pl, "polymul")
    return ops_mod.fused_polymul_e2e(za, zb, pl.params, backend=cfg.backend,
                                     schedule=cfg.schedule, use_sau=cfg.use_sau)


def execute(pl: Plan, za: torch.Tensor, zb: torch.Tensor, *,
            donate: bool = False) -> torch.Tensor:
    """:func:`polymul` under the reference's serving signature (the hook
    a serving engine or stage profiler calls).  Eager PyTorch keeps no
    compiled entry per :func:`plan_key` and donates no buffers, so
    ``donate`` is accepted for call sites ported one to one and changes
    nothing: ``za`` and ``zb`` stay valid."""
    del donate
    return polymul(pl, za, zb)


def ntt(pl: Plan, a: torch.Tensor) -> torch.Tensor:
    """a: ``(t, ..., n)`` canonical residues -> forward NTT per RNS channel
    (natural-order in, bit-reversed out: the no-shuffle convention)."""
    cfg = _require_plan(pl, "ntt")
    return ops_mod.ntt_forward(a, pl.params, backend=cfg.backend, schedule=cfg.schedule)


def intt(pl: Plan, a: torch.Tensor) -> torch.Tensor:
    """a: ``(t, ..., n)`` canonical bit-reversed spectra -> natural-order
    residues (n^-1 folded into the per-stage halving)."""
    cfg = _require_plan(pl, "intt")
    return ops_mod.ntt_inverse(a, pl.params, backend=cfg.backend, schedule=cfg.schedule)


def negacyclic_mul(pl: Plan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(t, ..., n) x (t, ..., n)`` canonical residues -> per-channel
    negacyclic products (the residue-domain cascade)."""
    cfg = _require_plan(pl, "negacyclic_mul")
    return ops_mod.negacyclic_mul(a, b, pl.params, backend=cfg.backend,
                                  schedule=cfg.schedule)


def decompose(pl: Plan, z: torch.Tensor) -> torch.Tensor:
    """z: ``(..., S)`` base-2^v segments -> residues ``(t, ...)``."""
    cfg = _require_plan(pl, "decompose")
    return ops_mod.rns_decompose(z, pl.params, backend=cfg.backend, use_sau=cfg.use_sau)


def compose(pl: Plan, residues: torch.Tensor) -> torch.Tensor:
    """residues: canonical ``(t, ...)`` -> ``(..., L)`` base-2^w limbs of
    the CRT-composed value (canonical, < q)."""
    cfg = _require_plan(pl, "compose")
    return ops_mod.rns_compose(residues, pl.params, backend=cfg.backend)


def to_segments(pl: Plan, xs: Any) -> torch.Tensor:
    """Python ints (length n) -> ``(n, S)`` base-2^v segments on the plan's device."""
    cfg = _require_plan(pl, "to_segments")
    return torch.as_tensor(bigint.ints_to_limbs(xs, cfg.v, cfg.seg_count), device=pl.device)


def from_limbs(pl: Plan, limbs: Any) -> list[int]:
    """``(..., L)`` base-2^w output limbs -> flat list of Python ints."""
    cfg = _require_plan(pl, "from_limbs")
    return bigint.limbs_to_ints(limbs, cfg.w)


def polymul_ints(pl: Plan, a: Any, b: Any) -> list[int]:
    """Host convenience: Python-int coefficients in and out, through the
    plan's device pipeline."""
    _require_plan(pl, "polymul_ints")
    return from_limbs(pl, polymul(pl, to_segments(pl, a), to_segments(pl, b)))


def plan_key(pl: Plan) -> PlanConfig:
    """The hashable bucket/cache key of a plan: its frozen config."""
    return _require_plan(pl, "plan_key")
