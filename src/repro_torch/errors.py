"""Plan-time error taxonomy of the PyTorch port (mirrors ``repro.errors``).

* :class:`PlanError` — base class; subclasses ``ValueError``.
* :class:`UnknownKnobError` — a knob's value is outside its vocabulary
  (unknown backend string, malformed ``n``/``v``).
* :class:`UnservableConfigError` — every knob is valid on its own but no
  datapath of the port serves the combination (a width above the int64
  envelope, an ``n`` whose working set does not fit one block's shared
  memory, no card for a CUDA backend).

All three carry the offending ``knob`` name, the rejected ``value`` and a
tuple of nearest valid ``alternatives`` (possibly empty).  The serving
errors of the reference package arrive with the serving slice.
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
