"""Metric exporters: Prometheus text format 0.0.4 and JSON, plus a
strict parser that validates exporter output without a Prometheus
binary (the port's copy of ``repro.obs.export``).

The Prometheus rendering follows the exposition-format rules that
matter for scrapability: one ``# HELP``/``# TYPE`` pair per family,
histogram families exposed as cumulative ``_bucket{le=...}`` series
(including the mandatory ``le="+Inf"``) plus ``_sum``/``_count``,
label values escaped (``\\\\``, ``\\"``, ``\\n``), counters suffixed
``_total`` by naming convention (the registry enforces nothing here).
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry as default_registry,
)

__all__ = [
    "parse_prometheus",
    "to_json",
    "to_prometheus",
]


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...],
                extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_esc(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_esc(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def to_prometheus(reg: MetricsRegistry | None = None) -> str:
    """Render a registry in Prometheus text exposition format 0.0.4."""
    reg = reg if reg is not None else default_registry()
    out: list[str] = []
    for m in reg.metrics():
        out.append(f"# HELP {m.name} {_esc(m.help) if m.help else m.name}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key, child in m.children():
                cum = 0
                for i, bound in enumerate(child.bounds):
                    cum += child.counts[i]
                    lbl = _fmt_labels(
                        m.labelnames, key, (("le", _fmt_value(bound)),)
                    )
                    out.append(f"{m.name}_bucket{lbl} {cum}")
                cum += child.counts[-1]
                lbl = _fmt_labels(m.labelnames, key, (("le", "+Inf"),))
                out.append(f"{m.name}_bucket{lbl} {cum}")
                base = _fmt_labels(m.labelnames, key)
                out.append(f"{m.name}_sum{base} {_fmt_value(child.sum)}")
                out.append(f"{m.name}_count{base} {child.count}")
        elif isinstance(m, (Counter, Gauge)):
            for key, child in m.children():
                lbl = _fmt_labels(m.labelnames, key)
                out.append(f"{m.name}{lbl} {_fmt_value(child.value)}")
    return "\n".join(out) + ("\n" if out else "")


def to_json(reg: MetricsRegistry | None = None) -> dict[str, Any]:
    """Registry contents as one JSON-ready dict (the ``--json`` CLI
    output)."""
    reg = reg if reg is not None else default_registry()
    families: list[dict[str, Any]] = []
    for m in reg.metrics():
        fam: dict[str, Any] = {
            "name": m.name,
            "kind": m.kind,
            "help": m.help,
            "labels": list(m.labelnames),
            "series": [],
        }
        for key, child in m.children():
            series: dict[str, Any] = {
                "labels": dict(zip(m.labelnames, key)),
            }
            if isinstance(m, Histogram):
                series.update(
                    count=child.count,
                    sum=child.sum,
                    bounds=list(child.bounds),
                    counts=list(child.counts),
                    p50=child.quantile(0.50),
                    p99=child.quantile(0.99),
                )
            else:
                series["value"] = float(child.value)
            fam["series"].append(series)
        families.append(fam)
    return {"schema": "repro_torch.obs/v1", "families": families}


# --------------------------------------------------------------------------
# validating parser (a stand-in for a real scraper)
# --------------------------------------------------------------------------

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?$"
)
_LABEL_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"\s*(,|$)'
)


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)  # raises ValueError on garbage


def parse_prometheus(text: str) -> dict[str, Any]:
    """Parse (and thereby validate) Prometheus text format.

    Returns ``{family: {"type": ..., "samples": [(name, labels, value)]}}``
    and raises ``ValueError`` with the offending line number on any
    malformed line, unknown sample for a typed family, non-cumulative
    histogram buckets, or a histogram family missing its ``+Inf``
    bucket / ``_sum`` / ``_count`` series — the failure modes that make
    real scrapers drop an exposition."""
    families: dict[str, dict[str, Any]] = {}

    def fam(name: str) -> dict[str, Any]:
        return families.setdefault(name, {"type": None, "help": None,
                                          "samples": []})

    for ln, raw in enumerate(text.split("\n"), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3 or not _NAME_RE.fullmatch(parts[2]):
                raise ValueError(f"line {ln}: malformed HELP: {raw!r}")
            fam(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped"
            ):
                raise ValueError(f"line {ln}: malformed TYPE: {raw!r}")
            f = fam(parts[2])
            if f["samples"]:
                raise ValueError(
                    f"line {ln}: TYPE for {parts[2]} after its samples"
                )
            f["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample: {raw!r}")
        labels: dict[str, str] = {}
        body = m.group("labels")
        if body is not None:
            pos = 0
            while pos < len(body):
                lm = _LABEL_RE.match(body, pos)
                if lm is None:
                    raise ValueError(
                        f"line {ln}: malformed labels: {{{body}}}"
                    )
                labels[lm.group("name")] = lm.group("value")
                pos = lm.end()
        try:
            value = _parse_value(m.group("value"))
        except ValueError as e:
            raise ValueError(
                f"line {ln}: bad sample value {m.group('value')!r}"
            ) from e
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[: -len(suffix)] if name.endswith(suffix) else None
            if stem and families.get(stem, {}).get("type") == "histogram":
                base = stem
                break
        f = families.get(base)
        if f is None:
            f = fam(base)
        elif f["type"] == "histogram" and base == name:
            raise ValueError(
                f"line {ln}: bare sample {name!r} for histogram family"
            )
        f["samples"].append((name, labels, value))

    # histogram family structural checks
    for name, f in families.items():
        if f["type"] != "histogram":
            continue
        series: dict[tuple[tuple[str, str], ...], list[tuple[float, float]]]
        series = {}
        sums, counts = set(), set()
        for sname, labels, value in f["samples"]:
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"
            ))
            if sname == name + "_bucket":
                if "le" not in labels:
                    raise ValueError(
                        f"{name}: _bucket sample without le label"
                    )
                series.setdefault(key, []).append(
                    (_parse_value(labels["le"]), value)
                )
            elif sname == name + "_sum":
                sums.add(key)
            elif sname == name + "_count":
                counts.add(key)
        for key, buckets in series.items():
            if not any(math.isinf(le) and le > 0 for le, _ in buckets):
                raise ValueError(f"{name}{dict(key)}: missing +Inf bucket")
            ordered = sorted(buckets, key=lambda b: b[0])
            if any(b1[1] > b2[1] for b1, b2 in zip(ordered, ordered[1:])):
                raise ValueError(
                    f"{name}{dict(key)}: bucket counts not cumulative"
                )
            if key not in sums or key not in counts:
                raise ValueError(f"{name}{dict(key)}: missing _sum/_count")
    return families
