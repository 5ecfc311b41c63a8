"""Cost-model cross-check: does the port's traffic and work model order
candidates the way the stopwatch does?  (The port's copy of
``repro.tune.costcheck``.)

The reference folds the flops and bytes of each candidate's optimized
XLA HLO into a roofline time; the port emits no HLO (its kernels are
hand-written CUDA), so :func:`predicted_cost` reads the plan instead:
the bytes, integer operations and kernel launches of
:func:`repro_torch.kernels.ops.hbm_traffic_model` on the plan's backend,
folded into ``max(bytes / bandwidth, operations / rate)``.
:func:`cross_check` then reports the Spearman rank correlation between
the model's ordering and the measured ordering per workload key, and
flags candidates whose normalized rank disagrees badly — the "model says
fast, stopwatch says slow" cases worth a human look (the plain ``torch``
backend is the usual flag: the model counts the function's work, not the
plain datapath's many small launches).

The ``gpu`` row is the card's peaks (``kernels.cost``: 3.35 TB/s, 67
TOP/s scalar), as chip_smoke's per-kernel bounds use them; the ``cpu``
row is the reference's round numbers.  Only the ORDERING feeds the
cross-check, so absolute calibration cancels out.
"""
from __future__ import annotations

from typing import Any

from repro_torch.kernels import cost

# Device throughputs (bytes/s, integer op/s) per device kind — ordering
# fodder (see module docstring).
NOMINAL = {
    "cpu": {"bytes_per_s": 2.0e10, "ops_per_s": 5.0e10},
    "gpu": {"bytes_per_s": cost.HBM_BYTES_PER_S, "ops_per_s": cost.SCALAR_OPS_PER_S},
}

# Normalized-rank disagreement beyond this flags the candidate.
FLAG_RANK_GAP = 0.5


def predicted_cost(pl, rows: int, kind: str = "cpu") -> dict[str, Any]:
    """Roofline-style model time (us) of one end-to-end multiply of
    ``rows`` rows on an int64-width plan: ``max(bytes / BW, operations /
    rate)`` of :func:`repro_torch.kernels.ops.hbm_traffic_model` on the
    plan's backend, with its bytes, operations and kernel launches."""
    cfg = pl.config
    m = cost.hbm_traffic_model(pl.params, rows, backend=cfg.backend, schedule=cfg.schedule)
    nominal = NOMINAL.get(kind, NOMINAL["cpu"])
    bytes_s = m["hbm_bytes"] / nominal["bytes_per_s"]
    ops_s = m["operations"] / nominal["ops_per_s"]
    return {
        "hbm_bytes": m["hbm_bytes"],
        "operations": m["operations"],
        "kernel_launches": m["kernel_launches"],
        "model_us": max(bytes_s, ops_s) * 1e6,
    }


def _ranks(xs: list[float]) -> list[float]:
    """Average ranks (1-based, ties averaged — standard Spearman)."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def spearman(xs: list[float], ys: list[float]) -> float | None:
    """Spearman rank correlation (Pearson over average ranks); ``None``
    when fewer than two points or either side is constant."""
    if len(xs) != len(ys):
        raise ValueError(f"length mismatch: {len(xs)} vs {len(ys)}")
    n = len(xs)
    if n < 2:
        return None
    rx, ry = _ranks(xs), _ranks(ys)
    mx, my = sum(rx) / n, sum(ry) / n
    sxx = sum((a - mx) ** 2 for a in rx)
    syy = sum((b - my) ** 2 for b in ry)
    if sxx == 0.0 or syy == 0.0:
        return None
    sxy = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    return sxy / (sxx * syy) ** 0.5


def cross_check(candidates: list[dict[str, Any]]) -> dict[str, Any]:
    """Rank-correlate model vs stopwatch over one workload's measured
    candidates.

    Each input dict needs ``name``, ``measured_us`` and ``model_us``
    (candidates without a model prediction — the wide and oracle widths,
    which the model does not cover — are skipped and counted).  Returns ``rank_correlation`` (Spearman,
    ``None`` when undefined), and ``flagged``: candidates whose
    normalized rank under the model vs the stopwatch differs by more
    than :data:`FLAG_RANK_GAP`.
    """
    scored = [
        c for c in candidates
        if c.get("model_us") is not None and c.get("measured_us") is not None
    ]
    out: dict[str, Any] = {
        "rank_correlation": None,
        "flagged": [],
        "modeled": len(scored),
        "unmodeled": len(candidates) - len(scored),
    }
    if len(scored) < 2:
        return out
    measured = [float(c["measured_us"]) for c in scored]
    modeled = [float(c["model_us"]) for c in scored]
    out["rank_correlation"] = spearman(modeled, measured)
    rm, rp = _ranks(measured), _ranks(modeled)
    span = float(len(scored) - 1)
    for c, a, b in zip(scored, rm, rp):
        gap = abs(a - b) / span
        if gap > FLAG_RANK_GAP:
            out["flagged"].append(
                {
                    "name": c.get("name"),
                    "measured_us": float(c["measured_us"]),
                    "model_us": float(c["model_us"]),
                    "rank_gap": gap,
                }
            )
    return out
