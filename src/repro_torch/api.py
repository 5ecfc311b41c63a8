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
holds: ``"cuda_fused_e2e"`` on the card where its kernels hold (n, t)
(K2 up to n = 16384, the multi-block K2-fs past it, at t <= 8; K2 alone
at larger t), ``"cuda_fused"`` past them, and
``"torch"`` on the CPU.  The kernel backends serve every n up to 65536
(one-block kernels where a polynomial fits a CTA, multi-block kernels
past it) and refuse larger n at plan time; an explicit
``"cuda_fused_e2e"`` past K2's reach at t > 8 is refused (knob ``t``):
K2-fs's clusters hold one channel a CTA.  ``schedule`` (``"auto"``,
``"radix2"``, ``"four_step"``, ``"four_step:h"`` or a
:class:`ScheduleSpec`) and a ``tiling`` chain resolve, as in the
reference, into the :class:`ScheduleSpec` of ``PlanConfig.schedule``,
which :func:`plan_key` carries; ``backend="torch"`` runs the four-step
schedule it names, the kernel backends record it (the card's own split
and shared memory are in the spec).  Every datapath decomposes through
the Alg-2 SAU circuits.  :func:`execute` is :func:`polymul` under the reference's
serving signature.  Besides the multiplier, the stage entry points
:func:`ntt`, :func:`intt`, :func:`decompose`, :func:`compose` and
:func:`negacyclic_mul` run one stage each on the plan's backend; the BFV
layer (:mod:`repro_torch.core.bfv`) runs every homomorphic product
through :func:`negacyclic_mul` and every decrypt through :func:`compose`.
The reference's ``row_blk``, integer ``tiling``, ``channel_grid`` and
``tuning`` knobs, ``use_sau=False`` and its wide and oracle widths
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
from repro_torch.kernels import crt as crt_kernels
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
    device=None,
) -> Plan:
    """Build an executable plan: search the primes, precompute and upload
    every table, and resolve the knobs into a frozen :class:`PlanConfig`.

    ``schedule`` resolves as in the reference (``"auto"``: four-step from
    n = 256; ``"four_step:h"`` asserts the hierarchical chain, from
    n = 8192); a tuple ``tiling`` asserts the canonical chain.

    Raises :class:`repro_torch.UnknownKnobError` for a knob outside its
    vocabulary and :class:`repro_torch.UnservableConfigError` for a valid
    combination the port cannot serve (v > 31, no card, n above 65536 on a
    kernel backend, t > 8 past K2's reach on ``"cuda_fused_e2e"``,
    ``"four_step:h"`` below n = 8192, a mismatched ``tiling``), each with
    the same ``knob`` as the reference."""
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
    _check_width(v)
    dev = _resolve_device(device)
    backend = ops_mod.resolve_backend(backend, dev, n, t)
    spec = schedule_mod.resolve_spec(n, schedule, tiling=tiling, backend=backend, t=t)
    params = _admit(backend, spec, n, t, v, dev)
    return _plan_of(params, backend, spec, dev)


def _check_width(v: int) -> None:
    if v > _V_INT64_MAX:
        raise UnservableConfigError(
            f"the port serves the int64 width (v <= {_V_INT64_MAX}); v={v} needs the "
            "wide or oracle datapath, which is not ported yet",
            knob="v", value=v, alternatives=(30,),
        )


def _admit(backend: str, spec: ScheduleSpec, n: int, t: int, v: int, dev: torch.device,
           params: ParenttParams | None = None) -> ParenttParams:
    """The kernel backends' admission, shared by :func:`plan` and
    :func:`plan_from_params`: refuse n above the multi-block kernels'
    reach, ``cuda_fused_e2e`` where neither K2 nor K2-fs holds (n, t), or
    a kernel whose CTA the spec's accounting does not fit (before the
    prime search), build the params unless given, and refuse S or L past
    the kernels' limb arrays."""
    if backend in KERNEL_BACKENDS and n > ntt_kernels.FS_MAX_N:
        raise UnservableConfigError(
            f"backend={backend!r} serves n <= {ntt_kernels.FS_MAX_N}, got n={n}",
            knob="n", value=n, alternatives=("backend='torch'",),
        )
    if backend == "cuda_fused_e2e" and not (ntt_kernels.e2e_fits(n, t)
                                            or ntt_kernels.e2e_fs_fits(n, t)):
        raise UnservableConfigError(
            f"backend='cuda_fused_e2e' past one CTA (n={n} at t={t}) runs the multi-block "
            f"K2-fs, whose clusters hold t <= {ntt_kernels.MAX_CLUSTER} channels, one a CTA",
            knob="t", value=t, alternatives=("backend='cuda_fused'", "backend='torch'"),
        )
    if backend in KERNEL_BACKENDS and spec.smem_bytes > spec.smem_budget:
        raise UnservableConfigError(
            f"backend={backend!r} keeps one channel's residues a CTA in shared memory: "
            f"n={n}, t={t} need {spec.smem_bytes} bytes, above the {spec.smem_budget} one "
            "CTA may use (backend='cuda_fused' serves it on multi-block kernels)",
            knob="n", value=n, alternatives=("backend='cuda_fused'", "backend='torch'"),
        )
    if params is None:
        params = make_params(n=n, t=t, v=v, device=dev)
    rp = params.plan
    if backend in KERNEL_BACKENDS and (
        rp.dec is None
        or rp.seg_count > crt_kernels.MAX_SEGMENTS
        or rp.L > crt_kernels.MAX_LIMBS
    ):
        raise UnservableConfigError(
            f"the decompose and compose kernels cannot hold t={t}, v={v} "
            f"(S={rp.seg_count}, L={rp.L}, in-kernel decompose constants: "
            f"{rp.dec is not None})",
            knob="t", value=t, alternatives=("backend='torch'",),
        )
    return params


def _plan_of(params: ParenttParams, backend: str, spec: ScheduleSpec,
             dev: torch.device) -> Plan:
    rp = params.plan
    cfg = PlanConfig(
        n=params.n, t=params.t, v=params.v, backend=backend, schedule=spec, device=str(dev),
        seg_count=rp.seg_count, w=rp.w, L=rp.L,
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
    through the same admission as :func:`plan`.  ``use_sau=False`` (the generic
    decompose) is not ported yet and raises."""
    if use_sau is not True:
        raise UnservableConfigError(
            f"use_sau={use_sau!r}: the port decomposes through the Alg-2 SAU circuits "
            "only; the generic decompose is not ported yet",
            knob="use_sau", value=use_sau, alternatives=(True,),
        )
    _check_width(params.v)
    dev = _resolve_device(params.device)
    backend = ops_mod.resolve_backend(params.backend if backend is None else backend, dev,
                                      params.n, params.t)
    spec = schedule_mod.resolve_spec(params.n, params.schedule, backend=backend, t=params.t)
    _admit(backend, spec, params.n, params.t, params.v, dev, params=params)
    return _plan_of(params, backend, spec, dev)


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
                                     schedule=cfg.schedule)


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
    return ops_mod.rns_decompose(z, pl.params, backend=cfg.backend)


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
