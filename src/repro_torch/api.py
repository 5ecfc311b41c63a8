"""The plan/execute front door of the PyTorch port (counterpart of
``repro.api`` at the int64 width, v <= 31).

Usage::

    import repro_torch

    pl = repro_torch.plan(n=4096, t=6, v=30)     # paper's preferred point
    limbs = repro_torch.polymul(pl, za, zb)      # (..., n, S) -> (..., n, L)

:func:`plan` resolves every knob once into a frozen :class:`PlanConfig`
and uploads the tables to the plan's device.  Plans run on the CUDA card
unless the caller passes ``device="cpu"``; with no card and no device
asked for, :func:`plan` raises.  ``backend="auto"`` resolves to
``"cuda_fused_e2e"`` on the card and ``"torch"`` on the CPU.  A kernel
backend refuses, at plan time, an ``n`` whose shared-memory working set
does not fit one block.  Every datapath decomposes through the Alg-2
SAU circuits.  The reference's ``schedule``, ``tiling``,
``channel_grid``, ``tuning`` and ``use_sau`` knobs and its wide and
oracle widths (v > 31) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import bigint
from repro_torch.core.params import ParenttParams, make_params
from repro_torch.errors import UnknownKnobError, UnservableConfigError
from repro_torch.kernels import ntt as ntt_kernels
from repro_torch.kernels import ops as ops_mod
from repro_torch.kernels.ops import BACKENDS, KERNEL_BACKENDS

__all__ = [
    "BACKENDS",
    "Plan",
    "PlanConfig",
    "plan",
    "plan_key",
    "polymul",
    "polymul_ints",
    "negacyclic_mul",
    "to_segments",
    "from_limbs",
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
    device=None,
) -> Plan:
    """Build an executable plan: search the primes, precompute and upload
    every table, and resolve the knobs into a frozen :class:`PlanConfig`.

    Raises :class:`repro_torch.UnknownKnobError` for a knob outside its
    vocabulary and :class:`repro_torch.UnservableConfigError` for a valid
    combination the port cannot serve (v > 31, no card, an ``n`` whose
    kernel working set exceeds one block's shared memory)."""
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
    if v > _V_INT64_MAX:
        raise UnservableConfigError(
            f"the port serves the int64 width (v <= {_V_INT64_MAX}); v={v} needs the "
            "wide or oracle datapath, which is not ported yet",
            knob="v", value=v, alternatives=(30,),
        )
    dev = _resolve_device(device)
    backend = ops_mod.resolve_backend(backend, dev)
    if backend in KERNEL_BACKENDS:
        need = max(ntt_kernels.cascade_smem_bytes(n),
                   ntt_kernels.e2e_smem_bytes(n, t) if backend == "cuda_fused_e2e" else 0)
        if need > ntt_kernels.MAX_SMEM_BYTES:
            raise UnservableConfigError(
                f"backend={backend!r} keeps a block's residues in shared memory: n={n}, "
                f"t={t} need {need} bytes, above the {ntt_kernels.MAX_SMEM_BYTES} one "
                "block may use (multi-block transforms are not ported yet)",
                knob="n", value=n, alternatives=("backend='torch'",),
            )
    params = make_params(n=n, t=t, v=v, device=dev)
    rp = params.plan
    if backend == "cuda_fused_e2e" and (
        rp.dec is None
        or rp.seg_count > ntt_kernels.MAX_SEGMENTS
        or rp.L > ntt_kernels.MAX_LIMBS
    ):
        raise UnservableConfigError(
            f"the e2e kernel cannot hold t={t}, v={v} (S={rp.seg_count}, L={rp.L}, "
            f"in-kernel decompose constants: {rp.dec is not None})",
            knob="t", value=t, alternatives=("backend='cuda_fused'",),
        )
    cfg = PlanConfig(
        n=n, t=t, v=v, backend=backend, device=str(dev),
        seg_count=rp.seg_count, w=rp.w, L=rp.L,
    )
    return Plan(config=cfg, params=params)


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
    return ops_mod.fused_polymul_e2e(za, zb, pl.params, backend=cfg.backend)


def negacyclic_mul(pl: Plan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(t, ..., n) x (t, ..., n)`` canonical residues -> per-channel
    negacyclic products (the residue-domain cascade)."""
    cfg = _require_plan(pl, "negacyclic_mul")
    return ops_mod.negacyclic_mul(a, b, pl.params, backend=cfg.backend)


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
