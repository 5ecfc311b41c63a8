"""Observability report CLI: render latency / throughput / lifecycle
breakdowns from a span log, audit span conservation, and validate
exporter output (the port of ``repro.launch.obs_report``).

    PYTHONPATH=src python -m repro_torch.launch.obs_report spans.jsonl
    PYTHONPATH=src python -m repro_torch.launch.obs_report spans.jsonl --check
    PYTHONPATH=src python -m repro_torch.launch.obs_report --prom metrics.prom

``--check`` is the span-conservation gate: every admitted request span
must carry exactly one terminal status (``resolved`` / ``shed`` /
``failed``); any violation exits non-zero with the offending trace IDs.
``--prom`` parses a Prometheus text-format file through the strict
validator (:func:`repro_torch.obs.parse_prometheus`) and exits non-zero
on malformed expositions.  ``--stages N:T:V`` runs the per-stage
profiling harness (:func:`repro_torch.obs.stage_timings`) on one plan
preset, on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.obs_report --stages 4096:6:30
    PYTHONPATH=src python -m repro_torch.launch.obs_report --stages 64:3:30 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any

import numpy as np

from repro_torch import obs

__all__ = ["lifecycle_report", "main"]


def _percentiles(xs: list[float]) -> dict[str, float | None]:
    if not xs:
        return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
    a = np.asarray(xs) * 1e3
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p99_ms": float(np.percentile(a, 99)),
        "mean_ms": float(a.mean()),
    }


def lifecycle_report(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate a span log into the report record: conservation audit,
    per-status counts, latency/queue-wait percentiles, throughput, and
    per-bucket + engine-event breakdowns."""
    cons = obs.conservation(records)
    spans = [
        r for r in records
        if r["kind"] == "span" and r["name"] == "request"
    ]
    resolved = [s for s in spans if s["status"] == "resolved"]

    latencies, queue_waits, dispatch_waits = [], [], []
    retries = 0
    by_bucket: dict[str, dict[str, int]] = {}
    for s in spans:
        bucket = s["attrs"].get("bucket", "?")
        bb = by_bucket.setdefault(bucket, {})
        bb[s["status"]] = bb.get(s["status"], 0) + 1
        first_dispatch = next(
            (e for e in s["events"] if e["name"] == "dispatch"), None
        )
        if first_dispatch is not None:
            queue_waits.append(first_dispatch["t"] - s["t_start"])
        retries += sum(1 for e in s["events"] if e["name"] == "retry")
        if s["status"] == "resolved" and s["t_end"] is not None:
            latencies.append(s["t_end"] - s["t_start"])
            if first_dispatch is not None:
                dispatch_waits.append(s["t_end"] - first_dispatch["t"])

    t_lo = min((s["t_start"] for s in spans), default=None)
    t_hi = max(
        (s["t_end"] for s in spans if s["t_end"] is not None), default=None
    )
    wall = (t_hi - t_lo) if (t_lo is not None and t_hi is not None) else None
    events: dict[str, int] = {}
    for r in records:
        if r["kind"] == "event":
            events[r["name"]] = events.get(r["name"], 0) + 1
    return {
        "records": len(records),
        "spans": cons["spans"],
        "admitted": cons["admitted"],
        "by_status": cons["by_status"],
        "violations": cons["violations"],
        "retry_events": retries,
        "engine_events": events,
        "wall_s": wall,
        "throughput_rps": (
            len(resolved) / wall if wall else None
        ),
        "latency": _percentiles(latencies),
        "queue_wait": _percentiles(queue_waits),
        "dispatch_to_resolve": _percentiles(dispatch_waits),
        "by_bucket": by_bucket,
    }


def _fmt_ms(v: float | None) -> str:
    return "-" if v is None else f"{v:.3f}ms"


def _print_report(rep: dict[str, Any]) -> None:
    print(f"spans: {rep['spans']} ({rep['admitted']} admitted) "
          f"over {rep['records']} records")
    for status, count in sorted(rep["by_status"].items()):
        print(f"  {status:<10} {count}")
    if rep["engine_events"]:
        ev = ", ".join(
            f"{k}={v}" for k, v in sorted(rep["engine_events"].items())
        )
        print(f"engine events: {ev}")
    if rep["retry_events"]:
        print(f"retry events: {rep['retry_events']}")
    if rep["wall_s"]:
        print(f"throughput: {rep['throughput_rps']:.1f} resolved/s "
              f"over {rep['wall_s']:.3f}s")
    for label, key in (("latency", "latency"),
                       ("queue wait", "queue_wait"),
                       ("dispatch->resolve", "dispatch_to_resolve")):
        p = rep[key]
        print(f"{label:<18} p50={_fmt_ms(p['p50_ms'])} "
              f"p99={_fmt_ms(p['p99_ms'])} mean={_fmt_ms(p['mean_ms'])}")
    for bucket, counts in sorted(rep["by_bucket"].items()):
        cs = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        print(f"bucket {bucket}: {cs}")
    for v in rep["violations"]:
        print(f"[VIOLATION] {v}", file=sys.stderr)


def _run_stages(spec: str, *, batch: int, iters: int, device, as_json: bool) -> int:
    import repro_torch

    n, t, v = (int(x) for x in spec.split(":"))
    try:
        pl = repro_torch.plan(n=n, t=t, v=v, device=device)
    except repro_torch.PlanError as e:
        print(f"[FAIL] --stages {spec}: {e}", file=sys.stderr)
        return 1
    rec = obs.stage_timings(pl, batch=batch, iters=iters)
    if as_json:
        print(json.dumps(rec, indent=1))
        return 0
    print(f"stage timings n={n} t={t} v={v} backend={rec['backend']} "
          f"batch={rec['batch']} device={pl.device}")
    print(f"{'stage':<12}{'measured':>12}{'share':>8}{'model':>8}"
          f"{'drift':>8}")
    for stage in obs.STAGES:
        s = rec["stages"][stage]
        print(f"{stage:<12}{s['seconds'] * 1e6:>10.1f}us"
              f"{s['share_measured']:>8.1%}{s['share_predicted']:>8.1%}"
              f"{s['drift']:>8.1%}")
    print(f"sum-of-stages {rec['stage_sum_s'] * 1e6:.1f}us, "
          f"e2e {rec['e2e_s'] * 1e6:.1f}us "
          f"(fusion speedup {rec['fusion_speedup']:.2f}x)")
    tc = rec["transform_cost_model"]
    print(f"transform_cost_model: {tc}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("span_log", nargs="?", default=None,
                    help="JSONL span log (repro_torch.obs.SpanLog output)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on span-conservation violations")
    ap.add_argument("--prom", default=None, metavar="FILE",
                    help="validate a Prometheus text-format exposition")
    ap.add_argument("--stages", default=None, metavar="N:T:V",
                    help="run the per-stage profiling harness for one plan preset")
    ap.add_argument("--batch", type=int, default=4,
                    help="profiling batch rows (--stages)")
    ap.add_argument("--iters", type=int, default=10,
                    help="profiling timing iterations (--stages)")
    ap.add_argument("--device", default=None,
                    help="the plan's device (--stages): the card unless 'cpu'")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)

    if args.span_log is None and args.prom is None and args.stages is None:
        ap.error("nothing to do: pass a span log, --prom, or --stages")

    rc = 0
    if args.prom is not None:
        with open(args.prom) as f:
            text = f.read()
        try:
            families = obs.parse_prometheus(text)
        except ValueError as e:
            print(f"[FAIL] {args.prom}: {e}", file=sys.stderr)
            return 1
        print(f"{args.prom}: valid Prometheus text format "
              f"({len(families)} families, "
              f"{sum(len(f['samples']) for f in families.values())} "
              f"samples)")

    if args.span_log is not None:
        records = obs.read_jsonl(args.span_log)
        rep = lifecycle_report(records)
        if args.json:
            print(json.dumps(rep, indent=1))
        else:
            _print_report(rep)
        if args.check and rep["violations"]:
            rc = 1

    if args.stages is not None:
        rc = max(rc, _run_stages(args.stages, batch=args.batch, iters=args.iters,
                                 device=args.device, as_json=args.json))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
