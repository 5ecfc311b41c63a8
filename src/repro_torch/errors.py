"""Plan-time error taxonomy of the PyTorch port (mirrors ``repro.errors``).

* :class:`PlanError` — base class; subclasses ``ValueError``.
* :class:`UnknownKnobError` — a knob's value is outside its vocabulary
  (unknown backend string, malformed ``n``/``v``).
* :class:`UnservableConfigError` — every knob is valid on its own but no
  datapath of the port serves the combination (a width above the int64
  envelope, an ``n`` whose working set does not fit one block's shared
  memory, no card for a CUDA backend).

All three carry the offending ``knob`` name, the rejected ``value`` and a
tuple of nearest valid ``alternatives`` (possibly empty).

Serving-time errors (:mod:`repro_torch.serve`) derive from
:class:`EngineError` (a ``RuntimeError``: the request was well formed,
serving it failed), so every admitted request's future resolves to a
value or to exactly one typed error:

* :class:`QueueFullError` — the bounded submission queue stayed full
  past the submit timeout (the request was never admitted);
* :class:`DeadlineExceededError` — admission control shed the request
  because its deadline passed or could not be met;
* :class:`BackendFailedError` — every dispatch attempt failed, bounded
  retries and the circuit breaker's fallback backends included (the last
  exception chained as ``__cause__``).
"""
from __future__ import annotations

from typing import Any, Iterable


class PlanError(ValueError):
    """A configuration was rejected at plan time."""

    def __init__(
        self,
        message: str,
        *,
        knob: str | None = None,
        value: Any = None,
        alternatives: Iterable[Any] = (),
    ) -> None:
        super().__init__(message)
        self.knob = knob
        self.value = value
        self.alternatives = tuple(alternatives)


class UnknownKnobError(PlanError):
    """A single knob's value is outside its vocabulary."""


class UnservableConfigError(PlanError):
    """Individually-valid knobs combine into a config no datapath serves."""


class EngineError(RuntimeError):
    """A request failed at serving time.

    ``request_seq`` is the engine's submission sequence number of the
    affected request, or ``None`` when the request was never admitted
    (:class:`QueueFullError`)."""

    def __init__(self, message: str, *, request_seq: int | None = None) -> None:
        super().__init__(message)
        self.request_seq = request_seq


class QueueFullError(EngineError):
    """The bounded submission queue stayed full past the submit timeout;
    ``queue_depth`` is the queue at that moment, ``max_pending`` the
    engine's bound."""

    def __init__(self, message: str, *, queue_depth: int = 0, max_pending: int = 0) -> None:
        super().__init__(message)
        self.queue_depth = queue_depth
        self.max_pending = max_pending


class DeadlineExceededError(EngineError):
    """Admission control shed the request before dispatch: ``deadline_s``
    is the absolute deadline (engine clock) it carried, ``late_s`` how far
    past it (>= 0) the shed decision fell."""

    def __init__(self, message: str, *, request_seq: int | None = None,
                 deadline_s: float = 0.0, late_s: float = 0.0) -> None:
        super().__init__(message, request_seq=request_seq)
        self.deadline_s = deadline_s
        self.late_s = late_s


class BackendFailedError(EngineError):
    """Every dispatch attempt of the request failed, its bounded retries
    and the bucket's degradation included; ``backend`` is the backend of
    the last attempt, ``attempts`` the attempts the request rode."""

    def __init__(self, message: str, *, request_seq: int | None = None,
                 backend: str = "", attempts: int = 0) -> None:
        super().__init__(message, request_seq=request_seq)
        self.backend = backend
        self.attempts = attempts
