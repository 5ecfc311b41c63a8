"""Observability of the serving engine: metrics registry, request-scoped
tracing, per-stage device profiling and exporters (the port's copy of
``repro.obs``).

Quickstart::

    from repro_torch import obs
    from repro_torch.serve import PolymulEngine

    reg = obs.registry()                       # process-wide registry
    log = obs.SpanLog("spans.jsonl")           # JSONL span sink
    eng = PolymulEngine(span_log=log)          # traces every request
    ...
    log.flush()
    print(obs.to_prometheus(reg))              # scrape-ready text
    obs.conservation(obs.read_jsonl("spans.jsonl"))  # lifecycle audit

``python -m repro_torch.launch.obs_report spans.jsonl`` renders the
latency/throughput report and runs the conservation gate from the CLI;
``--stages N:T:V`` runs :func:`stage_timings` on the card.
"""
from repro_torch.obs.export import parse_prometheus, to_json, to_prometheus
from repro_torch.obs.metrics import (
    HIST_GROWTH,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_buckets,
    registry,
    reset_default_registry,
)
from repro_torch.obs.profiling import STAGES, predicted_stage_bytes, stage_timings
from repro_torch.obs.tracing import (
    TERMINAL_STATUSES,
    Span,
    SpanLog,
    conservation,
    read_jsonl,
)

__all__ = [
    "HIST_GROWTH",
    "STAGES",
    "TERMINAL_STATUSES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanLog",
    "conservation",
    "default_buckets",
    "parse_prometheus",
    "predicted_stage_bytes",
    "read_jsonl",
    "registry",
    "reset_default_registry",
    "stage_timings",
    "to_json",
    "to_prometheus",
]
