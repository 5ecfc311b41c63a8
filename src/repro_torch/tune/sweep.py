"""Sweep harness of the port (counterpart of ``repro.tune.sweep``):
enumerate servable candidate configs per workload, measure each on the
plan's device, pick the winner, cross-check the cost model.

A *workload* is ``(n, t, v, batch)``; a *candidate* is an assignment of
the four tunable plan knobs (``backend``, ``schedule``, ``row_blk``,
``channel_grid``).  For each candidate the harness:

1. builds the plan on the sweep's device —
   :class:`repro_torch.errors.PlanError` subclasses (UnknownKnobError /
   UnservableConfigError) PRUNE the candidate with the taxonomy's
   knob/alternatives recorded, they never abort a sweep;
2. dedupes by :func:`repro_torch.plan_key` — ``backend="auto"`` and its
   resolution measure once;
3. on the card, builds and loads the kernels of the plan's path first
   (:func:`repro_torch.kernels.ops.load_path_kernels`; ``compile_s`` is
   those seconds), then warms up and takes the median of synchronised
   walls (``mode="cuda"``); on the CPU the host clock (``mode="cpu"``,
   the kernel backends' wrappers running their plain versions).  A
   candidate whose kernels fail to build or launch, or whose product
   differs from the default candidate's by one bit, is ``failed`` in the
   report: no wrapper falls back to a plain version on the card, so a
   failure never turns into a quiet ``torch`` measurement.

The winner is the fastest measured config, with a stability bias: the
static default keeps the crown unless a challenger beats it by more than
:data:`WINNER_MARGIN` (so the tuned choice is never slower than the
default on the box that swept, and plan caches don't churn over noise).
Winner knobs are recorded RESOLVED (concrete backend string, canonical
schedule string), so ``plan(tuning=<table>)`` reproduces the measured
:class:`repro_torch.PlanConfig` exactly.  On the card each entry also
carries ``device_name`` and ``power_limit`` as ``nvidia-smi`` reports
them.
"""
from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import api
from repro_torch.errors import PlanError
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.tune import costcheck, table as table_mod

# A challenger must beat the static default by this factor to dethrone it.
WINNER_MARGIN = 0.02

_INT64_BACKENDS = ("torch", "cuda", "cuda_fused", "cuda_fused_e2e")
_SCHEDULES = ("radix2", "four_step", "four_step:h")


@dataclasses.dataclass(frozen=True)
class Workload:
    n: int
    t: int
    v: int
    batch: int

    @property
    def key(self) -> str:
        return table_mod.workload_key(self.n, self.t, self.v, self.batch)

    @classmethod
    def from_key(cls, key: str) -> "Workload":
        return cls(**table_mod.parse_workload_key(key))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One assignment of the tunable knobs (None = static default)."""

    backend: str = "auto"
    schedule: str = "auto"
    row_blk: int | None = None
    channel_grid: bool | None = None

    @property
    def name(self) -> str:
        rb = "-" if self.row_blk is None else str(self.row_blk)
        cg = "-" if self.channel_grid is None else ("1" if self.channel_grid else "0")
        return f"{self.backend}/{self.schedule}/rb{rb}/cg{cg}"

    def knobs(self) -> dict[str, Any]:
        return {
            "backend": self.backend,
            "schedule": self.schedule,
            "row_blk": self.row_blk,
            "channel_grid": self.channel_grid,
        }


DEFAULT_CANDIDATE = Candidate()


def default_candidates(v: int, *, quick: bool = False) -> tuple[Candidate, ...]:
    """The candidate grid for a modulus width.

    The static default is always first (the winner baseline).  The int64
    width sweeps the port's backends; ``schedule`` varies only on
    ``torch``, the one backend where it reaches a datapath (the kernel
    backends choose their kernels by what fits a CTA and take
    ``"auto"``), as the reference varies ``row_blk`` only where it
    reaches a kernel.  ``row_blk`` and ``channel_grid`` stay ``None``:
    the port refuses the rest.  The wide and oracle widths have one
    datapath, so only the schedule vocabulary exercises the pruner.
    ``quick`` is the CI grid: ``torch`` and ``cuda_fused_e2e``, with the
    hierarchical schedule kept in to demonstrate taxonomy pruning at
    small n.
    """
    width = api.width_for(v)
    out: list[Candidate] = [DEFAULT_CANDIDATE]
    if width != "int64":
        # one datapath; radix2 is the only servable schedule, the rest
        # exist to exercise (and document) the pruning path
        out.extend(Candidate(backend=api.WIDE_BACKEND if width == "wide"
                             else api.ORACLE_BACKEND, schedule=s)
                   for s in ("radix2", "four_step"))
        return tuple(out)
    backends = ("torch", "cuda_fused_e2e") if quick else _INT64_BACKENDS
    for be in backends:
        if be == "torch":
            out.extend(Candidate(be, sched) for sched in _SCHEDULES)
        else:
            out.append(Candidate(be))
    return tuple(out)


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------


def make_operands(wl: Workload, seg_count: int, *, seed: int = 0,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Two ``(batch, n, S)`` operands of base-2^v segments, made with numpy
    from ``seed`` (the reference's), on ``device``."""
    rng = np.random.default_rng(seed)
    shape = (wl.batch, wl.n, seg_count)
    za = rng.integers(0, 1 << wl.v, size=shape, dtype=np.int64)
    zb = rng.integers(0, 1 << wl.v, size=shape, dtype=np.int64)
    return torch.as_tensor(za, device=device), torch.as_tensor(zb, device=device)


def measure_plan(
    pl: api.Plan,
    za: torch.Tensor,
    zb: torch.Tensor,
    *,
    iters: int = 3,
    warmup: int = 1,
    fn: Callable[..., Any] = api.polymul,
) -> dict[str, Any]:
    """Warm-up-excluded wall-clock of one plan.

    On the card the kernels of the plan's path are built and loaded
    before anything runs (``compile_s``: those seconds), and each timed
    call is synchronised; on the CPU the host clock (``compile_s`` None).
    Returns ``us_per_poly`` (median over ``iters`` timed calls, divided
    by the batch), ``compile_s``, ``mode`` ("cuda" | "cpu"), ``calls``
    (every call of ``fn`` made, warm-up included) and ``out`` (the last
    call's result)."""
    batch = za.shape[0] if za.dim() >= 3 else 1
    cfg = api.plan_key(pl)
    on_card = pl.device.type == "cuda"
    compile_s = None
    if on_card:
        t0 = time.perf_counter()
        if cfg.width == "int64":
            ops.load_path_kernels(cfg.backend, cfg.n, cfg.t, cfg.seg_count, cfg.L)
        compile_s = time.perf_counter() - t0

    def run():
        out = fn(pl, za, zb)
        if on_card:
            torch.cuda.synchronize(pl.device)
        return out

    out = None
    for _ in range(max(warmup, 0)):
        out = run()
    samples = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        out = run()
        samples.append(time.perf_counter() - t0)
    return {
        "us_per_poly": statistics.median(samples) * 1e6 / batch,
        "compile_s": compile_s,
        "mode": "cuda" if on_card else "cpu",
        "calls": max(warmup, 0) + max(iters, 1),
        "out": out,
    }


def _config_summary(cfg: api.PlanConfig) -> dict[str, Any]:
    """The winner knobs of a resolved config: the port's PlanConfig holds
    no row block or channel grid (it refuses the first, and its e2e
    kernels always spread the channels over a cluster)."""
    return {
        "backend": cfg.backend,
        "schedule": cfg.schedule.canonical,
        "schedule_detail": str(cfg.schedule),
        "row_blk": None,
        "channel_grid": None,
    }


def card_info() -> dict[str, Any]:
    """``device_name`` and ``power_limit`` of the card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (the name from torch and a None limit without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[torch.cuda.current_device()]
        name, limit = (s.strip() for s in out.rsplit(",", 1))
        return {"device_name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"device_name": torch.cuda.get_device_name(), "power_limit": None}


# --------------------------------------------------------------------------
# per-workload sweep
# --------------------------------------------------------------------------


def sweep_workload(
    wl: Workload,
    candidates: tuple[Candidate, ...] | None = None,
    *,
    quick: bool = False,
    iters: int = 3,
    warmup: int = 1,
    kind: str | None = None,
    device=None,
    log: Callable[[str], None] | None = None,
) -> dict[str, Any]:
    """Sweep one workload on ``device`` (None: the card where there is
    one, as :func:`repro_torch.plan`); returns the report entry (see
    module docs).

    The report's ``entry`` field is the tuning-table payload
    (``TuningTable.put(**entry)`` ready)."""
    kind = kind or table_mod.device_kind(device)
    if candidates is None:
        candidates = default_candidates(wl.v, quick=quick)
    say = log or (lambda _msg: None)

    plans: list[tuple[Candidate, api.Plan]] = []
    records: list[dict[str, Any]] = []
    seen: dict[api.PlanConfig, str] = {}
    for cand in candidates:
        rec: dict[str, Any] = {"name": cand.name, "knobs": cand.knobs()}
        try:
            pl = api.plan(
                n=wl.n, t=wl.t, v=wl.v, backend=cand.backend,
                schedule=cand.schedule, row_blk=cand.row_blk,
                channel_grid=cand.channel_grid, device=device,
            )
        except PlanError as e:
            rec.update(
                status="pruned",
                error=type(e).__name__,
                knob=e.knob,
                reason=str(e),
                alternatives=[str(a) for a in getattr(e, "alternatives", ()) or ()],
            )
            records.append(rec)
            continue
        cfg = api.plan_key(pl)
        rec["config"] = _config_summary(cfg)
        first = seen.get(cfg)
        if first is not None:
            rec.update(status="duplicate", same_as=first)
            records.append(rec)
            continue
        seen[cfg] = cand.name
        rec["status"] = "measured"
        plans.append((cand, pl))
        records.append(rec)

    if not plans:
        raise PlanError(
            f"sweep {wl.key}: every candidate was pruned — nothing servable",
            knob="workload", value=wl.key, alternatives=(),
        )

    # measure (default candidate is plans[0] by construction); each
    # product is held against the default's, bit for bit
    seg_count = api.plan_key(plans[0][1]).seg_count
    za, zb = make_operands(wl, seg_count, device=plans[0][1].device)
    by_name = {r["name"]: r for r in records}
    default_out = None
    for cand, pl in plans:
        say(f"  measuring {cand.name} ...")
        rec = by_name[cand.name]
        try:
            m = measure_plan(pl, za, zb, iters=iters, warmup=warmup)
        except (RuntimeError, OSError) as e:  # a kernel that fails to build, load or launch
            if default_out is None:
                raise
            rec.update(status="failed", error=type(e).__name__, reason=str(e))
            continue
        out = m.pop("out")
        if default_out is None:
            default_out = out
        rec["equal_to_default"] = bool(out.shape == default_out.shape
                                       and torch.equal(out, default_out))
        rec.update(m)
        if not rec["equal_to_default"]:
            rec.update(status="failed", error="OutputMismatch",
                       reason="its product differs from the default candidate's")
            continue
        if api.plan_key(pl).width == "int64":
            rec.update(costcheck.predicted_cost(pl, wl.batch, kind))

    # candidate outcomes land in the process registry beside the serve
    # metrics, so a tuning run is scrapeable like any soak
    cand_counter = obs_metrics.registry().counter(
        "repro_tune_candidates_total",
        "sweep candidate outcomes",
        ("status",),
    )
    for r in records:
        cand_counter.labels(status=r["status"]).inc()

    measured = [r for r in records if r["status"] == "measured"]
    check = costcheck.cross_check(
        [
            {
                "name": r["name"],
                "measured_us": r.get("us_per_poly"),
                "model_us": r.get("model_us"),
            }
            for r in measured
        ]
    )

    default_rec = measured[0]  # DEFAULT_CANDIDATE is always first
    winner_rec = min(measured, key=lambda r: r["us_per_poly"])
    if winner_rec["us_per_poly"] >= default_rec["us_per_poly"] * (1 - WINNER_MARGIN):
        winner_rec = default_rec  # stability bias: default keeps the crown
    winner_cfg = dict(winner_rec["config"])
    winner_cfg.pop("schedule_detail", None)

    entry = {
        "n": wl.n, "t": wl.t, "v": wl.v, "batch": wl.batch,
        "winner": winner_cfg,
        "winner_us": winner_rec["us_per_poly"],
        "default_us": default_rec["us_per_poly"],
        "mode": winner_rec["mode"],
        "candidates_measured": len(measured),
        "candidates_pruned": sum(1 for r in records if r["status"] == "pruned"),
        "rank_correlation": check["rank_correlation"],
    }
    if kind == "gpu":
        entry.update(card_info())
    return {
        "key": wl.key,
        "workload": dataclasses.asdict(wl),
        "device_kind": kind,
        "entry": entry,
        "winner": winner_rec["name"],
        "candidates": records,
        "costcheck": check,
    }


def sweep(
    workloads: list[Workload],
    *,
    quick: bool = False,
    iters: int = 3,
    warmup: int = 1,
    table: table_mod.TuningTable | None = None,
    device=None,
    log: Callable[[str], None] | None = None,
) -> tuple[table_mod.TuningTable, dict[str, Any]]:
    """Sweep several workloads on ``device`` into one table + one report
    dict.

    Pass an existing ``table`` to merge (entries for swept workloads are
    overwritten, everything else is kept — including other device
    kinds)."""
    kind = table_mod.device_kind(device)
    tab = table if table is not None else table_mod.TuningTable()
    say = log or (lambda _msg: None)
    report: dict[str, Any] = {
        "schema": "repro.tune.sweep-report/v1",
        "device_kind": kind,
        "quick": quick,
        "iters": iters,
        "warmup": warmup,
        "workloads": [],
    }
    for wl in workloads:
        say(f"sweep {wl.key} [{kind}] ...")
        res = sweep_workload(
            wl, quick=quick, iters=iters, warmup=warmup, kind=kind, device=device, log=log
        )
        tab.put(kind=kind, **res["entry"])
        report["workloads"].append(res)
        say(
            f"  -> winner {res['winner']} "
            f"({res['entry']['winner_us']:.1f} us/poly vs default "
            f"{res['entry']['default_us']:.1f}), rank-corr "
            f"{res['entry']['rank_correlation']}"
        )
    return tab, report
