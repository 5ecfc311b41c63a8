"""Request-scoped tracing: spans with trace IDs, an append-only span
log, and a JSONL wire format the report CLI consumes (the port's copy of
``repro.obs.tracing``).

A *span* is one request's lifecycle: minted at
``PolymulEngine.submit()`` (the trace ID lands on the returned future as
``fut.trace_id``), carried through queueing, EDF dispatch, retries and
breaker transitions as timestamped *events*, and closed exactly once
with a terminal status.  The span-conservation invariant — every
admitted request has exactly ONE terminal span, one of
``resolved`` / ``shed`` / ``failed`` — is what ``obs_report --check``
asserts over a soak run's log (:mod:`repro_torch.launch.obs_report`).

Span state machine::

    submit -> [rejected]                      # backpressure, never admitted
    submit -> admit -> (queue ...) -> dispatch -> resolved
                    \\-> shed                  # deadline passed / unmeetable
                    \\-> ... retry/breaker_open events ... -> failed

Engine-level happenings that are not tied to one request (circuit
breaker opening/closing, probe dispatches) are logged as *event*
records, so a log line is one of two kinds::

    {"kind": "span",  "trace_id": "...", "name": "request", "status": ...,
     "t_start": ..., "t_end": ..., "attrs": {...}, "events": [...]}
    {"kind": "event", "name": "breaker_open", "t": ..., "attrs": {...}}

Timestamps are ``time.perf_counter()`` seconds (monotonic, same clock
as the engine's deadlines) plus one ``t_unix`` wall anchor on each
record — derived from a single per-log wall/monotonic anchor pair, not
a syscall per span — so logs from one process are internally orderable
and roughly placeable in wall time.

Overhead: recording is append-to-list under one lock, no I/O; the JSONL
serialization happens only at :meth:`SpanLog.flush`.  Trace IDs come
from one ``itertools.count`` (``next()`` is atomic under the GIL — no
extra lock) behind a precomputed ``prefix-pid-`` string.  With no span
log installed the engine's tracing branches are single ``is None``
checks.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, IO, Iterable

__all__ = [
    "Span",
    "SpanLog",
    "TERMINAL_STATUSES",
    "conservation",
    "read_jsonl",
]

# The one-terminal-per-admitted-request vocabulary (conservation gate).
TERMINAL_STATUSES = ("resolved", "shed", "failed")
# "rejected" spans exist too, but the request was never admitted (no
# future obligations), so conservation counts them separately.

# next() on itertools.count is atomic in CPython; no lock needed.
_trace_counter = itertools.count()


def _mint_trace_id(prefix: str) -> str:
    return f"{prefix}-{os.getpid():x}-{next(_trace_counter):08x}"


class Span:
    """One in-flight request trace.  Engine-internal mutation only; the
    record becomes immutable once :meth:`finish` hands it to the log."""

    __slots__ = ("trace_id", "name", "t_start", "attrs",
                 "events", "status", "t_end", "_log")

    def __init__(self, log: "SpanLog", name: str, trace_id: str,
                 attrs: dict[str, Any]) -> None:
        self._log = log
        self.trace_id = trace_id
        self.name = name
        self.t_start = time.perf_counter()
        self.attrs = attrs
        self.events: list[dict[str, Any]] = []
        self.status: str | None = None
        self.t_end: float | None = None

    def event(self, name: str, **attrs: Any) -> None:
        """Append a timestamped event; no-op after the span finished
        (a late event cannot reopen a terminal span)."""
        if self.status is not None:
            return
        ev = {"t": time.perf_counter(), "name": name}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)

    def finish(self, status: str, **attrs: Any) -> None:
        """Close the span exactly once and emit it to the log.  A second
        finish raises — the tracing twin of the future's resolve-once
        invariant."""
        if self.status is not None:
            raise RuntimeError(
                f"span {self.trace_id} finished twice "
                f"({self.status!r} then {status!r})"
            )
        self.status = status
        self.t_end = time.perf_counter()
        if attrs:
            self.attrs.update(attrs)
        self._log._emit(self.to_record())

    def to_record(self) -> dict[str, Any]:
        return {
            "kind": "span",
            "trace_id": self.trace_id,
            "name": self.name,
            "status": self.status,
            "t_start": self.t_start,
            "t_end": self.t_end,
            # wall placement from the log's one-time anchor pair: no
            # time.time() syscall on the per-span hot path
            "t_unix": self._log.to_unix(self.t_start),
            "attrs": self.attrs,
            "events": self.events,
        }


class SpanLog:
    """Thread-safe span/event collector with an optional JSONL sink.

    ``path=None`` keeps records in memory only (tests, ad-hoc probes);
    with a path, :meth:`flush` appends every record accumulated since
    the last flush.  ``SpanLog`` is also a context manager (flushes on
    exit)."""

    def __init__(self, path: str | os.PathLike[str] | None = None,
                 *, trace_prefix: str = "req") -> None:
        self.path = os.fspath(path) if path is not None else None
        self.trace_prefix = trace_prefix
        # precomputed so minting a trace ID is one format, zero syscalls
        self._id_prefix = f"{trace_prefix}-{os.getpid():x}-"
        # one wall/monotonic anchor pair; every record's t_unix derives
        # from it instead of a per-record time.time() call
        self._anchor_perf = time.perf_counter()
        self._anchor_unix = time.time()
        self._lock = threading.Lock()
        self._records: list[dict[str, Any]] = []
        self._unflushed: list[dict[str, Any]] = []

    def to_unix(self, t_perf: float) -> float:
        """Map a ``perf_counter`` timestamp to wall time via the log's
        anchor pair."""
        return self._anchor_unix + (t_perf - self._anchor_perf)

    # -- recording -----------------------------------------------------
    def start_span(self, name: str, **attrs: Any) -> Span:
        tid = f"{self._id_prefix}{next(_trace_counter):08x}"
        return Span(self, name, tid, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an engine-level (non-request) event."""
        t = time.perf_counter()
        self._emit({
            "kind": "event",
            "name": name,
            "t": t,
            "t_unix": self.to_unix(t),
            "attrs": attrs,
        })

    def _emit(self, record: dict[str, Any]) -> None:
        with self._lock:
            self._records.append(record)
            self._unflushed.append(record)

    # -- reading / sinking ---------------------------------------------
    @property
    def records(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def spans(self, status: str | None = None) -> list[dict[str, Any]]:
        return [
            r for r in self.records
            if r["kind"] == "span" and (status is None or r["status"] == status)
        ]

    def flush(self, fp: IO[str] | None = None) -> int:
        """Append unflushed records as JSONL to ``fp`` or ``self.path``;
        returns the number of records written (0 when neither sink
        exists — records stay readable in memory)."""
        if fp is None and self.path is None:
            return 0
        with self._lock:
            batch, self._unflushed = self._unflushed, []
        if not batch:
            return 0
        lines = "".join(json.dumps(r, sort_keys=True) + "\n" for r in batch)
        if fp is not None:
            fp.write(lines)
        else:
            assert self.path is not None
            with open(self.path, "a") as f:
                f.write(lines)
        return len(batch)

    def __enter__(self) -> "SpanLog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.flush()


def read_jsonl(path: str | os.PathLike[str]) -> list[dict[str, Any]]:
    """Parse a span-log JSONL file back into records (the report CLI's
    input).  Raises ``ValueError`` naming the offending line on
    malformed input — a truncated log should fail loudly."""
    out: list[dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not valid JSON: {e}") from e
            if not isinstance(rec, dict) or rec.get("kind") not in (
                "span", "event"
            ):
                raise ValueError(
                    f"{path}:{i}: not a span/event record: {line[:80]}"
                )
            out.append(rec)
    return out


def conservation(records: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """Span-conservation accounting over a log: every admitted request
    span must carry exactly one terminal status.  Returns the counts and
    a ``violations`` list (empty = the invariant holds) — the core of
    ``obs_report --check`` (see :mod:`repro_torch.launch.obs_report`)."""
    by_status: dict[str, int] = {}
    violations: list[str] = []
    seen_ids: set[str] = set()
    admitted = 0
    for r in records:
        if r.get("kind") != "span" or r.get("name") != "request":
            continue
        tid = r.get("trace_id", "?")
        if tid in seen_ids:
            violations.append(f"trace {tid}: more than one span record")
        seen_ids.add(tid)
        status = r.get("status")
        by_status[status] = by_status.get(status, 0) + 1
        if status == "rejected":
            continue  # never admitted: no terminal obligation
        admitted += 1
        if status not in TERMINAL_STATUSES:
            violations.append(
                f"trace {tid}: non-terminal status {status!r} "
                f"(want one of {TERMINAL_STATUSES})"
            )
    terminal = sum(by_status.get(s, 0) for s in TERMINAL_STATUSES)
    if terminal != admitted:
        violations.append(
            f"{admitted} admitted spans but {terminal} terminal statuses"
        )
    return {
        "spans": len(seen_ids),
        "admitted": admitted,
        "by_status": by_status,
        "violations": violations,
    }
