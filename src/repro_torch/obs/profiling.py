"""Per-stage device profiling (the port's copy of ``repro.obs.profiling``):
a stage-timing harness that reports MEASURED stage shares beside the
static model predictions
(:func:`repro_torch.kernels.ops.hbm_traffic_model`,
:func:`repro_torch.kernels.ops.transform_cost_model`), with
model-vs-measured drift exposed as registry gauges.

The pipeline has three stage boundaries the api layer can dispatch
independently (``decompose -> cascade -> compose``, where *cascade* is
the NTT -> ⊙ -> iNTT datapath of :func:`repro_torch.negacyclic_mul`).
Each stage runs through its entry point on the plan's backend and is
timed, alongside the whole :func:`repro_torch.execute` — so the report
also shows what fusion buys (``stage_sum_s`` vs ``e2e_s``).  On the card
the path's kernels are built and loaded before the clock starts and
each timed call is synchronised (the median of synchronised walls); on
the CPU the host clock times the plain versions.  The decompose stage
decomposes both operands, as one multiply does (the reference times one
operand's).

Predicted shares come from an explicit per-stage attribution of the
same byte counts :func:`hbm_traffic_model` totals.  Boundary tensors are
attributed to BOTH touching stages (the decompose output is a decompose
write and a cascade read), which is exactly how the model's total is
built, so :func:`predicted_stage_bytes` cross-checks that its stages sum
to the model's ``hbm_bytes`` and raises if a model change breaks the
attribution.  A ``cuda_fused_e2e`` plan's stage entry points run K5, K1
(or K1-fs) and K6, so its attribution is ``cuda_fused``'s, as the
reference attributes ``pallas_fused_e2e``: K2-fs's 32-bit words between
its launches cross no stage boundary the timer can see.

Bytes predict time shares only to the extent the pipeline is
memory-bound; on the card the decompose and the cascade are bound by
their integer work (PERF.md), and the drift gauges
(``repro_stage_share_drift``) make "the model says X, the device says Y"
a queryable number.

Registry series written per run (labels ``{stage, backend}``)::

    repro_stage_seconds                 measured median stage latency
    repro_stage_share_measured          stage / sum-of-stages
    repro_stage_share_predicted         byte-attribution share
    repro_stage_share_drift             |measured - predicted|
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import api
from repro_torch.kernels import ops as ops_mod
from repro_torch.obs.metrics import MetricsRegistry, registry as default_registry

__all__ = [
    "STAGES",
    "predicted_stage_bytes",
    "stage_timings",
]

STAGES = ("decompose", "cascade", "compose")


def _stage_view(backend: str) -> str:
    """The backend whose model the stage entry points' kernels follow."""
    return "cuda_fused" if backend == "cuda_fused_e2e" else backend


def predicted_stage_bytes(pl: api.Plan, rows: int) -> dict[str, int]:
    """Per-stage device-memory byte attribution for ``rows`` polynomials on
    the plan's backend, consistent with ``hbm_traffic_model`` by
    construction: boundary tensors count for both touching stages, and
    the stage sum is asserted equal to the model's ``hbm_bytes``."""
    cfg = api.plan_key(pl)
    if cfg.width != "int64":
        raise ValueError(
            f"predicted_stage_bytes: the traffic model covers the int64 kernel "
            f"datapaths only, plan width is {cfg.width!r}"
        )
    params = pl.params
    view = _stage_view(cfg.backend)
    model = ops_mod.hbm_traffic_model(params, rows, backend=view, schedule=cfg.schedule)
    B = 8
    seg = rows * params.n * params.plan.seg_count * B
    res = params.t * rows * params.n * B
    limb = rows * params.n * params.plan.L * B
    # K5 reads each operand's segments once for all t channels
    stages = {"decompose": 2 * seg + 2 * res, "compose": res + limb}
    if view == "cuda_fused":
        stages["cascade"] = 3 * res  # K1 / K1-fs: 2 res in, res out
    else:
        # torch / cuda: NTT x 2 (2 res / 2 res), the pointwise product
        # (2 res / res), iNTT (res / res): 9 residue-tensor crossings
        stages["cascade"] = 9 * res
    if sum(stages.values()) != model["hbm_bytes"]:
        raise AssertionError(
            f"stage byte attribution ({sum(stages.values())}) != "
            f"hbm_traffic_model total ({model['hbm_bytes']}) for "
            f"backend {cfg.backend!r} — attribution out of sync"
        )
    return {stage: stages[stage] for stage in STAGES}


def _time(fn: Callable[[], Any], iters: int, warmup: int, sync: Callable[[], None]) -> float:
    """Median wall seconds of ``fn``, each call followed by ``sync``."""
    for _ in range(warmup):
        fn()
        sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def stage_timings(
    pl: api.Plan,
    *,
    batch: int = 4,
    iters: int = 10,
    warmup: int = 2,
    seed: int = 0,
    registry: MetricsRegistry | None = None,
) -> dict[str, Any]:
    """Measure per-stage latency for a plan on its device and report it
    beside the static model predictions.

    Returns one JSON-ready record (the reference's keys; ``calls`` adds
    the calls of each stage and of ``execute`` made, warm-up and the
    first call that makes the next stage's inputs included) and writes
    the four ``repro_stage_*`` gauge families to ``registry`` (default:
    the process registry)."""
    reg = registry if registry is not None else default_registry()
    cfg = api.plan_key(pl)
    dev = pl.device
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    shape = (batch, pl.params.n, cfg.seg_count)
    za = torch.as_tensor(rng.integers(0, 1 << cfg.v, size=shape, dtype=np.int64), device=dev)
    zb = torch.as_tensor(rng.integers(0, 1 << cfg.v, size=shape, dtype=np.int64), device=dev)

    if on_card:  # every kernel built and loaded before the clock starts
        for backend in {cfg.backend, _stage_view(cfg.backend)}:
            ops_mod.load_path_kernels(backend, cfg.n, cfg.t, cfg.seg_count, cfg.L)
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)

    dec = lambda: (api.decompose(pl, za), api.decompose(pl, zb))  # noqa: E731
    ra, rb = dec()
    rp = api.negacyclic_mul(pl, ra, rb)
    api.compose(pl, rp)
    sync()

    measured = {
        "decompose": _time(dec, iters, warmup, sync),
        "cascade": _time(lambda: api.negacyclic_mul(pl, ra, rb), iters, warmup, sync),
        "compose": _time(lambda: api.compose(pl, rp), iters, warmup, sync),
    }
    e2e = _time(lambda: api.execute(pl, za, zb), iters, warmup, sync)

    stage_sum = sum(measured.values())
    bytes_by_stage = predicted_stage_bytes(pl, batch)
    byte_sum = sum(bytes_by_stage.values())

    g_sec = reg.gauge(
        "repro_stage_seconds",
        "measured median per-stage latency (batch input)",
        ("stage", "backend"),
    )
    g_meas = reg.gauge(
        "repro_stage_share_measured",
        "measured stage share of sum-of-stages time",
        ("stage", "backend"),
    )
    g_pred = reg.gauge(
        "repro_stage_share_predicted",
        "hbm_traffic_model byte-attribution stage share",
        ("stage", "backend"),
    )
    g_drift = reg.gauge(
        "repro_stage_share_drift",
        "abs(measured - predicted) stage share: model-vs-device drift",
        ("stage", "backend"),
    )

    stages_out: dict[str, Any] = {}
    for stage in STAGES:
        m_share = measured[stage] / stage_sum if stage_sum else 0.0
        p_share = bytes_by_stage[stage] / byte_sum if byte_sum else 0.0
        drift = abs(m_share - p_share)
        lbl = dict(stage=stage, backend=cfg.backend)
        g_sec.labels(**lbl).set(measured[stage])
        g_meas.labels(**lbl).set(m_share)
        g_pred.labels(**lbl).set(p_share)
        g_drift.labels(**lbl).set(drift)
        stages_out[stage] = {
            "seconds": measured[stage],
            "share_measured": m_share,
            "share_predicted": p_share,
            "drift": drift,
            "hbm_bytes_predicted": bytes_by_stage[stage],
        }

    tc = ops_mod.transform_cost_model(pl.params, schedule=cfg.schedule)
    return {
        "n": pl.params.n,
        "t": pl.params.t,
        "v": cfg.v,
        "backend": cfg.backend,
        "schedule": str(cfg.schedule),
        "batch": batch,
        "iters": iters,
        "seed": seed,
        "stages": stages_out,
        "stage_sum_s": stage_sum,
        "e2e_s": e2e,
        "fusion_speedup": (stage_sum / e2e) if e2e > 0 else None,
        "max_drift": max(s["drift"] for s in stages_out.values()),
        "transform_cost_model": {
            k: tc[k]
            for k in ("sublane_stages", "reduction_ops", "vmem_transposes")
            if k in tc
        },
        "calls": {"stage": 1 + warmup + iters, "execute": warmup + iters},
    }
