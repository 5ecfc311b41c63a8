"""The plan/execute front door of the PyTorch port (counterpart of
``repro.api``).

Usage::

    import repro_torch

    pl = repro_torch.plan(n=4096, t=6, v=30)     # paper's preferred point
    limbs = repro_torch.polymul(pl, za, zb)      # (..., n, S) -> (..., n, L)
    limbs = repro_torch.execute(pl, za, zb)      # the serving layer's hook

    pl45 = repro_torch.plan(n=4096, t=4, v=45)   # wide-word alternative:
    limbs = repro_torch.polymul(pl45, za, zb)    # same signature and limbs

Width dispatch (resolved once, inside :func:`plan`, into
``PlanConfig.width``, as the reference resolves it):

* ``v <= 31`` — ``"int64"``: the kernel backends below (and ``torch``);
* ``31 < v <= 46`` — ``"wide"``: the digit-split datapath of
  :mod:`repro_torch.core.wide` in plain PyTorch on the plan's device (the
  card unless ``device="cpu"``).  Its one backend is named ``"torch"``:
  the reference's wide width is pure jnp, with no Pallas kernel to port,
  so there is no CUDA kernel behind it either;
* ``v > 46`` — ``"oracle"``: the exact host Python-int pipeline
  (``backend="oracle"``); operands and results lie on the plan's device,
  the arithmetic runs on the host.

All three share one contract: segments in (``(..., n, S)`` base-2^v),
product limbs out (``(..., n, L)`` base-2^w, w = 28), bit-exact against
the bigint oracle.  Each width refuses the reference's knobs: a kernel
backend or a four-step schedule or a ``tiling`` on the wide width, any
backend but ``oracle`` on the oracle width, and t, v past the wide
inverse CRT's int64 envelope (knob ``t``).

:func:`plan` resolves every knob once into a frozen :class:`PlanConfig`
and uploads the tables to the plan's device; :func:`plan_from_params`
wraps an existing :class:`ParenttParams` (honouring its ``backend`` and
``schedule`` fields and its device) through the same admission.  Plans
run on the CUDA card unless the caller passes ``device="cpu"``; with no
card and no device asked for, :func:`plan` raises.  ``backend="auto"``
resolves at plan time, and the result is what ``PlanConfig.backend``
holds: ``"cuda_fused_e2e"`` on the card where K2 holds the plan with S
and L <= 16, or where the multi-block K2-fs serves past K2 from t = 29
(:func:`repro_torch.kernels.ops.auto_backend`), ``"cuda_fused"``
elsewhere, and ``"torch"`` on the CPU.  The kernel
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
e2e kernels spread the channels over a cluster's CTAs) serves; a
``row_blk`` and ``channel_grid=False`` are TPU knobs the card has no use
for and are refused (:class:`UnservableConfigError` with their own knob).
``tuning`` serves as in the reference (:mod:`repro_torch.tune`): ``"off"``
(the default) keeps the static defaults, ``"auto"`` reads the port's
committed ``tune/TUNING_default.json`` (and degrades to the defaults
where it has no entry), a path or a :class:`repro_torch.tune.TuningTable`
that table; the entry is the one of the PLAN's device kind (``"gpu"`` on
the card, ``"cpu"`` under ``device="cpu"``) and (n, t, v), smallest batch
first, and fills only the knobs left at their defaults (explicit knob >
table > static default), through the same admission as a hand-set knob.
:func:`execute` is
:func:`polymul` under the reference's
serving signature.  Besides the multiplier, the stage entry points
:func:`ntt`, :func:`intt`, :func:`decompose`, :func:`compose` and
:func:`negacyclic_mul` run one stage each on the plan's backend; the BFV
layer (:mod:`repro_torch.core.bfv`) runs every homomorphic product
through :func:`negacyclic_mul` and every decrypt through :func:`compose`.
The reference's integer ``tiling`` is not ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core import bigint
from repro_torch.core import ntt as ntt_mod
from repro_torch.core import polymul as polymul_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core import wide as wide_mod
from repro_torch.core.params import ParenttParams, make_params
from repro_torch.core.schedule import ScheduleSpec
from repro_torch.errors import UnknownKnobError, UnservableConfigError
from repro_torch.kernels import ntt as ntt_kernels
from repro_torch.kernels import ops as ops_mod
from repro_torch.kernels.ops import BACKENDS, KERNEL_BACKENDS

__all__ = [
    "BACKENDS",
    "ORACLE_BACKEND",
    "WIDE_BACKEND",
    "WIDTHS",
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
    "width_for",
]

_V_MIN, _V_MAX = 8, 60

# Width paths, in increasing modulus width (see the module notes).
WIDTHS = ("int64", "wide", "oracle")

# The one backend of each width past int64: the wide width's plain
# PyTorch datapath, and the oracle width's host sentinel.
WIDE_BACKEND = "torch"
ORACLE_BACKEND = "oracle"


def width_for(v: int) -> str:
    """The datapath a modulus width rides: the int64 kernels need
    q_i < 2^31, the digit-split wide path serves the 46-bit fold window,
    wider moduli fall back to the exact host oracle."""
    if v <= 31:
        return "int64"
    if v <= 46:
        return "wide"
    return "oracle"


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
    width: str = "int64"  # WIDTHS entry: the datapath v rides


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """An executable multiplier plan; build with :func:`plan`.  ``consts``
    holds the wide width's device tensors (the reference's ``wide_*``
    leaves) and is empty at the other widths, whose tables live on
    ``params``."""

    config: PlanConfig
    params: ParenttParams
    consts: dict = dataclasses.field(default_factory=dict)

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
    what the port serves of each).  ``tuning`` (``"off"``, ``"auto"``, a
    table path or a :class:`repro_torch.tune.TuningTable`) fills
    ``backend``, ``schedule``, ``row_blk`` and ``channel_grid`` where they
    are left at their defaults from the table's entry for the plan's
    device kind and (n, t, v); the filled knobs are admitted as if the
    caller had set them.  v picks the width (:func:`width_for`):
    past v = 31 the plan is a wide or oracle plan on the same device.

    Raises :class:`repro_torch.UnknownKnobError` for a knob outside its
    vocabulary and :class:`repro_torch.UnservableConfigError` for a valid
    combination the port cannot serve (no card, n above 65536 on a
    kernel backend, a kernel backend, a four-step schedule or a ``tiling``
    on the wide width, a backend but ``oracle`` past v = 46, t and v past
    the wide inverse CRT's envelope, a t, S or L whose CTAs one block's shared memory
    cannot hold on the backend asked for, ``"four_step:h"`` below
    n = 8192, a mismatched ``tiling``, a ``row_blk``, ``channel_grid`` off
    the e2e backend or False, from the caller or from a tuning table's
    winner), each with the same ``knob`` as the reference;
    :class:`repro_torch.tune.TuningTableError` for a tuning table path
    that is missing or does not validate."""
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
    _check_use_sau(use_sau)
    dev = _resolve_device(device)
    tuned = _tuning_winner(tuning, n, t, v, dev)
    if tuned is not None:
        # explicit knob > tuning table > static default: the table fills
        # only knobs the caller left at their defaults.
        if backend == "auto" and tuned.get("backend"):
            backend = tuned["backend"]
        if isinstance(schedule, str) and schedule == "auto" and tuned.get("schedule"):
            schedule = tuned["schedule"]
        if row_blk is None and tiling is None and tuned.get("row_blk") is not None:
            row_blk = tuned["row_blk"]
        if channel_grid is None and tuned.get("channel_grid") is not None:
            channel_grid = tuned["channel_grid"]
    _check_tpu_knobs(row_blk, channel_grid)
    width = width_for(v)
    if width != "int64":
        resolved = _resolve_wide_backend(width, backend)
        _check_channel_grid(channel_grid, resolved)
        spec = _wide_spec(width, schedule, tiling)
        _check_wide_envelope(width, t, v)
        return _wide_plan_of(make_params(n=n, t=t, v=v, device=dev), width, resolved, spec,
                             dev, use_sau)
    resolved = ops_mod.resolve_backend(backend, dev, n, t, v)
    schedule_mod.resolve_spec(n, schedule, tiling=tiling)  # the schedule's knobs, before the search
    resolved, params = _admit(resolved, n, t, v, dev, auto=backend == "auto")
    _check_channel_grid(channel_grid, resolved)
    return _plan_of(params, resolved, schedule, tiling, dev, use_sau)


def _resolve_wide_backend(width: str, backend: str) -> str:
    """The one backend of the wide or oracle width: ``"auto"`` resolves
    to it, any other name is refused with knob ``backend``."""
    one = WIDE_BACKEND if width == "wide" else ORACLE_BACKEND
    if backend not in ("auto", one):
        what = ("the wide (v in (31, 46]) datapath is plain PyTorch" if width == "wide"
                else "v > 46 is served by the host bigint oracle only")
        raise UnservableConfigError(
            f"{what}: backend={backend!r} is not available (use 'auto' or {one!r})",
            knob="backend", value=backend, alternatives=("auto", one),
        )
    return one


def _wide_spec(width: str, schedule, tiling) -> ScheduleSpec:
    """The wide and oracle widths have no kernel schedule: they serve
    radix2 and take no ``tiling``."""
    kind = getattr(schedule, "kind", schedule)
    if kind not in ("auto", "radix2"):
        raise UnservableConfigError(
            f"the {width} datapath serves schedule='radix2' only, got {schedule!r}",
            knob="schedule", value=schedule, alternatives=("auto", "radix2"),
        )
    if tiling is not None:
        raise UnservableConfigError(
            f"tiling= is a kernel-schedule hint; the {width} datapath has no tile schedule",
            knob="tiling", value=tiling, alternatives=(),
        )
    return ScheduleSpec(kind="radix2")


def _check_wide_envelope(width: str, t: int, v: int) -> None:
    """The wide inverse CRT's t-fold sum of y (< 2^v) x limb (< 2^POST_W)
    products must stay inside int64: refused at plan time, never wrapped
    at execution time."""
    if width == "wide" and t * (1 << (v + wide_mod.POST_W)) > (1 << 63):
        raise UnservableConfigError(
            f"t={t} channels of v={v}-bit moduli overflow the wide datapath's int64 "
            f"inverse-CRT accumulator (need t * 2^(v+{wide_mod.POST_W}) <= 2^63); use "
            "fewer or narrower channels",
            knob="t", value=t, alternatives=(),
        )


def _wide_plan_of(params: ParenttParams, width: str, backend: str, spec: ScheduleSpec,
                  dev: torch.device, use_sau: bool) -> Plan:
    rp = params.plan
    cfg = PlanConfig(
        n=params.n, t=params.t, v=params.v, backend=backend, schedule=spec, device=str(dev),
        seg_count=rp.seg_count, w=rp.w, L=rp.L, use_sau=use_sau, width=width,
    )
    consts = _wide_consts(params) if width == "wide" else {}
    return Plan(config=cfg, params=params, consts=consts)


@functools.lru_cache(maxsize=None)
def _wide_consts(params: ParenttParams) -> dict[str, torch.Tensor]:
    """The wide datapath's tensors on the params' device, uploaded once per
    params object: stacked per-channel twiddle tables (plain int64, built
    with host bigints for q >= 2^31) and the POST_W-limb CRT constants."""
    rp, dev = params.plan, params.device
    tabs = [ntt_mod.make_tables(int(q), params.n) for q in rp.qs]
    W = wide_mod.POST_W
    L14 = -(-(rp.q.bit_length() + rp.t.bit_length()) // W)
    host = {
        "wide_fwd": np.stack([tb.fwd for tb in tabs]),
        "wide_inv": np.stack([tb.inv for tb in tabs]),
        "wide_qi_star_limbs": bigint.ints_to_limbs([rp.q // int(qi) for qi in rp.qs], W, L14),
        "wide_q_limbs": bigint.int_to_limbs(rp.q, W, L14),
        "wide_betas": np.array([p.beta for p in params.primes], dtype=np.int64),
    }
    consts = {k: torch.as_tensor(x, dtype=torch.int64, device=dev) for k, x in host.items()}
    consts.update(wide_beta_pows=rp.beta_pows_d, wide_qi_tilde=rp.qi_tilde_d, wide_qs=rp.qs_d)
    return consts


@functools.lru_cache(maxsize=None)
def _wide_specs(params: ParenttParams) -> tuple[wide_mod.WideSpec, ...]:
    return tuple(wide_mod.from_special(p) for p in params.primes)


# --------------------------------------------------------------------------
# plan leaves and the shard-local plan (the mesh layer's view of a plan)
# --------------------------------------------------------------------------

_RNS_LEAVES = ("qs", "beta_pows", "qi_tilde", "qi_star_limbs", "q_limbs")


def plan_leaves(pl: Plan) -> dict[str, torch.Tensor]:
    """A plan's device tables by the reference's leaf names: an int64
    plan's :class:`~repro_torch.core.ntt.ChannelTables` fields as
    ``ntt_<field>`` (a four-step sub-level as ``ntt_<field><level>``) and
    its RNS constants as ``rns_<field>``; a wide plan's ``consts``; nothing
    for the oracle width."""
    if pl.config.width == "wide":
        return dict(pl.consts)
    if pl.config.width != "int64":
        return {}
    ct, rp = pl.params.tables, pl.params.plan
    out = {}
    for name in ntt_mod.DEVICE_FIELDS:
        dev = getattr(ct, name + "_d")
        if dev is not None:
            out["ntt_" + name] = dev
    for name in ntt_mod.DEVICE_LEVELS:
        for lvl, arr in enumerate(getattr(ct, name + "_d") or ()):
            out[f"ntt_{name}{lvl}"] = arr
    for name in _RNS_LEAVES:
        out["rns_" + name] = getattr(rp, name + "_d")
    return out


_SHARD_PLANS: dict[tuple[PlanConfig, int, int], Plan] = {}


def shard_plan(pl: Plan, c0: int, c1: int) -> Plan:
    """The plan of channels ``[c0, c1)`` of ``pl`` (the reference's
    shard-local view, ``_bound_params`` and ``_wide_exec_specs``): its
    ``t`` is ``c1 - c0`` and every per-channel table is the slice of
    ``pl``'s, so the kernels launch over the local channels only.  The
    ChannelTables (twiddle, Barrett, Shoup and four-step tables), the RNS
    plan's per-channel constants (with its in-kernel decompose constants)
    and a wide plan's ``(t, ...)`` consts are sliced; the composed modulus
    q, S and L stay ``pl``'s, so a local decompose takes the whole
    operands' segments.  A local plan composes nothing: compose runs on
    ``pl`` over all channels.  Built once per (:func:`plan_key`, channel
    range), the plan's device included, and kept: a dispatch never
    uploads tables.  The whole range is ``pl`` itself."""
    cfg = _require_plan(pl, "shard_plan")
    if cfg.width not in ("int64", "wide"):
        raise ValueError(f"shard_plan: the {cfg.width} width has no device channels to shard")
    if not 0 <= c0 < c1 <= cfg.t:
        raise ValueError(f"shard_plan: channels [{c0}, {c1}) outside [0, {cfg.t})")
    if (c0, c1) == (0, cfg.t):
        return pl
    key = (cfg, c0, c1)
    local = _SHARD_PLANS.get(key)
    if local is None:
        local = _SHARD_PLANS.setdefault(key, _slice_plan(pl, c0, c1))
    return local


def _slice_plan(pl: Plan, c0: int, c1: int) -> Plan:
    params, cut = pl.params, slice(c0, c1)
    rp = params.plan
    plan_l = dataclasses.replace(
        rp, t=c1 - c0, qs=rp.qs[cut], beta_terms=rp.beta_terms[cut], beta_pows=rp.beta_pows[cut],
        block_consts=rp.block_consts[cut], qi_tilde=rp.qi_tilde[cut],
        qi_star_limbs=rp.qi_star_limbs[cut], dec=None if rp.dec is None else rp.dec[cut])
    tables_l = None if params.tables is None else ntt_mod.slice_channel_tables(params.tables, c0, c1)
    params_l = dataclasses.replace(params, t=c1 - c0, primes=params.primes[cut], plan=plan_l,
                                   tables=tables_l)
    consts = {name: x if name == "wide_q_limbs" else x[cut] for name, x in pl.consts.items()}
    return Plan(config=dataclasses.replace(pl.config, t=c1 - c0), params=params_l, consts=consts)


def _tuning_winner(tuning, n: int, t: int, v: int, dev: torch.device) -> dict[str, Any] | None:
    """The ``tuning=`` knob resolved into the table's winner-knob dict for
    (n, t, v) on the plan's device kind (``None`` for no tuning or no
    matching entry): ``"off"`` / ``None`` look nothing up; ``"auto"``
    reads the port's committed table and degrades to the static defaults
    when the file or the entry is missing; an explicit path (or a
    :class:`repro_torch.tune.TuningTable`) must exist and validate;
    anything else is unknown, as the reference raises.  The lookup returns
    the smallest-batch entry for (n, t, v)."""
    if tuning is None or tuning == "off":
        return None
    from repro_torch.tune import table as table_mod  # deferred: keep plan() light

    if isinstance(tuning, table_mod.TuningTable):
        tab = tuning
    elif tuning == "auto":
        tab = table_mod.load_default()
        if tab is None:
            return None
    elif isinstance(tuning, str):
        tab = table_mod.load_cached(tuning)
    else:
        raise UnknownKnobError(
            f"tuning must be 'auto', 'off', a table path or a TuningTable, got {tuning!r}",
            knob="tuning", value=tuning, alternatives=("auto", "off"),
        )
    winner = tab.lookup(n=n, t=t, v=v, kind=table_mod.device_kind(dev))
    return dict(winner) if winner is not None else None


def _check_tpu_knobs(row_blk, channel_grid) -> None:
    """The reference's TPU knobs: an invalid value is unknown (as the
    reference raises), a valid one the card has no use for unservable."""
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
    at the plan's (t, S, L), or whose clusters (K2's, K2-fs's, K1-fs's)
    the card cannot hold at once (knob ``t``, naming the backends that
    serve).  Under ``auto`` an e2e choice the card cannot serve falls back
    to ``cuda_fused``.
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
    # on a card, the cluster launches of a backend's paths must fit it: K2's
    # or K2-fs's (and K1-fs's) under cuda_fused_e2e, K1-fs's under
    # cuda_fused past one CTA
    if dev.type == "cuda" and backend == "cuda_fused_e2e" and backend in serving \
            and ntt_kernels.e2e_clusters_resident(params.tables, rp) < 1:
        serving = tuple(b for b in serving if b != backend)
    if auto and backend not in serving:
        backend = "cuda_fused"
    if dev.type == "cuda" and backend == "cuda_fused" and backend in serving \
            and not ntt_kernels.cascade_fits(n) \
            and ntt_kernels.cascade_fs_clusters_resident(params.tables) < 1:
        serving = tuple(b for b in serving if b not in ("cuda_fused", "cuda_fused_e2e"))
    if backend not in serving:
        raise UnservableConfigError(
            f"backend={backend!r} cannot hold t={t} (S={rp.seg_count}, L={rp.L}) at n={n}: its "
            "CTAs' shared memory (or a cluster of them on this card) does not "
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
    dev = _resolve_device(params.device)
    asked = params.backend if backend is None else backend
    width = width_for(params.v)
    if width != "int64":
        spec = _wide_spec(width, params.schedule, None)
        _check_wide_envelope(width, params.t, params.v)
        return _wide_plan_of(params, width, _resolve_wide_backend(width, asked), spec, dev,
                             use_sau)
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


def _check_residues(x: torch.Tensor, cfg: PlanConfig, fn: str) -> None:
    if x.dim() < 2 or x.shape[0] != cfg.t or x.shape[-1] != cfg.n:
        raise ValueError(
            f"{fn}: expected residues (t={cfg.t}, ..., n={cfg.n}), got shape {tuple(x.shape)}"
        )


def _check_poly_segments(z: torch.Tensor, cfg: PlanConfig, fn: str, name: str) -> None:
    if z.dim() < 2 or z.shape[-2] != cfg.n or z.shape[-1] != cfg.seg_count:
        raise ValueError(
            f"{fn}: expected {name} segments (..., n={cfg.n}, S={cfg.seg_count}), got shape "
            f"{tuple(z.shape)}"
        )


def _no_device_transform(fn: str) -> ValueError:
    return ValueError(
        f"{fn}: the oracle width has no device transform; v > 46 plans serve "
        "polymul/decompose/compose on the host only"
    )


def polymul(pl: Plan, za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """za, zb: ``(..., n, S)`` base-2^v segments -> ``(..., n, L)`` base-2^w
    limbs of ``a * b mod (x^n + 1, q)``: the whole Fig-10 pipeline on the
    plan's datapath.  Operands must lie on the plan's device; an oracle
    plan copies them to the host and its result back."""
    cfg = _require_plan(pl, "polymul")
    if cfg.width == "int64":
        return ops_mod.fused_polymul_e2e(za, zb, pl.params, backend=cfg.backend,
                                         schedule=cfg.schedule, use_sau=cfg.use_sau)
    _check_poly_segments(za, cfg, "polymul", "za")
    _check_poly_segments(zb, cfg, "polymul", "zb")
    if za.shape != zb.shape:
        raise ValueError(
            f"polymul: operand shapes differ: {tuple(za.shape)} vs {tuple(zb.shape)}"
        )
    if cfg.width == "wide":
        c = pl.consts
        rp = wide_mod.negacyclic_mul_channels(_wide_decompose(pl, za), _wide_decompose(pl, zb),
                                              c["wide_fwd"], c["wide_inv"], _wide_specs(pl.params))
        return _wide_compose(pl, rp)
    return _oracle_polymul(pl, za, zb)


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
    if cfg.width == "int64":
        return ops_mod.ntt_forward(a, pl.params, backend=cfg.backend, schedule=cfg.schedule)
    if cfg.width == "wide":
        _check_residues(a, cfg, "ntt")
        return wide_mod.ntt_channels(a, pl.consts["wide_fwd"], _wide_specs(pl.params))
    raise _no_device_transform("ntt")


def intt(pl: Plan, a: torch.Tensor) -> torch.Tensor:
    """a: ``(t, ..., n)`` canonical bit-reversed spectra -> natural-order
    residues (n^-1 folded into the per-stage halving)."""
    cfg = _require_plan(pl, "intt")
    if cfg.width == "int64":
        return ops_mod.ntt_inverse(a, pl.params, backend=cfg.backend, schedule=cfg.schedule)
    if cfg.width == "wide":
        _check_residues(a, cfg, "intt")
        return wide_mod.intt_channels(a, pl.consts["wide_inv"], _wide_specs(pl.params))
    raise _no_device_transform("intt")


def negacyclic_mul(pl: Plan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(t, ..., n) x (t, ..., n)`` canonical residues -> per-channel
    negacyclic products (the residue-domain cascade)."""
    cfg = _require_plan(pl, "negacyclic_mul")
    if cfg.width == "int64":
        return ops_mod.negacyclic_mul(a, b, pl.params, backend=cfg.backend,
                                      schedule=cfg.schedule)
    if cfg.width == "wide":
        _check_residues(a, cfg, "negacyclic_mul")
        _check_residues(b, cfg, "negacyclic_mul")
        if a.shape != b.shape:
            raise ValueError(
                f"negacyclic_mul: operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}"
            )
        c = pl.consts
        return wide_mod.negacyclic_mul_channels(a, b, c["wide_fwd"], c["wide_inv"],
                                                _wide_specs(pl.params))
    raise _no_device_transform("negacyclic_mul")


def decompose(pl: Plan, z: torch.Tensor) -> torch.Tensor:
    """z: ``(..., S)`` base-2^v segments -> residues ``(t, ...)``."""
    cfg = _require_plan(pl, "decompose")
    if cfg.width == "int64":
        return ops_mod.rns_decompose(z, pl.params, backend=cfg.backend, use_sau=cfg.use_sau)
    if z.dim() < 1 or z.shape[-1] != cfg.seg_count:
        raise ValueError(
            f"decompose: expected base-2^{cfg.v} segments (..., S={cfg.seg_count}), got shape "
            f"{tuple(z.shape)}"
        )
    if cfg.width == "wide":
        return _wide_decompose(pl, z)
    rp = pl.params.plan
    flat = z.reshape(-1, z.shape[-1]).cpu().numpy()
    out = np.empty((cfg.t, flat.shape[0]), dtype=np.int64)
    for r in range(flat.shape[0]):
        x = bigint.limbs_to_int(flat[r], cfg.v)
        for i in range(cfg.t):
            out[i, r] = x % int(rp.qs[i])
    return torch.as_tensor(out.reshape((cfg.t,) + tuple(z.shape[:-1])), device=z.device)


def compose(pl: Plan, residues: torch.Tensor) -> torch.Tensor:
    """residues: canonical ``(t, ...)`` -> ``(..., L)`` base-2^w limbs of
    the CRT-composed value (canonical, < q)."""
    cfg = _require_plan(pl, "compose")
    if cfg.width == "int64":
        return ops_mod.rns_compose(residues, pl.params, backend=cfg.backend)
    if residues.dim() < 1 or residues.shape[0] != cfg.t:
        raise ValueError(
            f"compose: expected residues (t={cfg.t}, ...), got shape {tuple(residues.shape)}"
        )
    if cfg.width == "wide":
        return _wide_compose(pl, residues)
    rp = pl.params.plan
    flat = residues.reshape(cfg.t, -1).cpu().numpy()
    out = np.empty((flat.shape[1], cfg.L), dtype=np.int64)
    for r in range(flat.shape[1]):
        acc = 0
        for i in range(cfg.t):
            qi = int(rp.qs[i])
            y = (int(flat[i, r]) * int(rp.qi_tilde[i])) % qi
            acc = (acc + y * (rp.q // qi)) % rp.q
        out[r] = bigint.int_to_limbs(acc, cfg.w, cfg.L)
    return torch.as_tensor(out.reshape(tuple(residues.shape[1:]) + (cfg.L,)),
                           device=residues.device)


def _wide_decompose(pl: Plan, z: torch.Tensor) -> torch.Tensor:
    return wide_mod.decompose_channels(z, _wide_specs(pl.params), pl.consts["wide_beta_pows"])


def _wide_compose(pl: Plan, residues: torch.Tensor) -> torch.Tensor:
    c = pl.consts
    limbs14 = wide_mod.compose_channels(residues, _wide_specs(pl.params), c["wide_qi_tilde"],
                                        c["wide_qi_star_limbs"], c["wide_q_limbs"])
    out = wide_mod.repack_limbs(limbs14, wide_mod.POST_W, pl.config.w)
    assert out.shape[-1] == pl.config.L, (out.shape, pl.config.L)
    return out


def _oracle_polymul(pl: Plan, za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """The exact host pipeline, one row at a time: segments to Python
    ints, :func:`repro_torch.core.polymul.oracle_multiply`, limbs back to
    the operands' device."""
    cfg = pl.config
    lead = tuple(za.shape[:-2])
    a3 = za.reshape((-1,) + tuple(za.shape[-2:])).cpu().numpy()
    b3 = zb.reshape((-1,) + tuple(zb.shape[-2:])).cpu().numpy()
    out = np.empty((a3.shape[0], cfg.n, cfg.L), dtype=np.int64)
    for r in range(a3.shape[0]):
        a_ints = bigint.limbs_to_ints(a3[r], cfg.v)
        b_ints = bigint.limbs_to_ints(b3[r], cfg.v)
        p_ints = polymul_mod.oracle_multiply(a_ints, b_ints, pl.params)
        out[r] = bigint.ints_to_limbs(p_ints, cfg.w, cfg.L)
    return torch.as_tensor(out.reshape(lead + (cfg.n, cfg.L)), device=za.device)


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
