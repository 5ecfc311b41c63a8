"""Process-wide metrics registry: counters, gauges, histograms — with
labels, lock-protected, zero-dependency (the port's copy of
``repro.obs.metrics``).

The serving engine and the fault injector count things behind one
vocabulary, so every exporter (:mod:`repro_torch.obs.export`), the
engine's versioned ``snapshot()`` and ``launch/obs_report.py`` read the
same numbers.

Naming convention: ``repro_<subsystem>_<noun>[_<unit>]``
with counters suffixed ``_total`` and histograms carrying a base unit
(``_seconds``).  Labels are a fixed tuple declared at metric creation;
every observation goes through a :meth:`Metric.labels` child keyed by
the label values.

Histogram resolution bound
--------------------------
Histograms use exponential bucket bounds with growth factor
:data:`HIST_GROWTH` (default sqrt(2)).  :meth:`Histogram.quantile`
follows ``numpy.percentile``'s linear convention: it estimates the two
order statistics around the requested rank, each at a point inside the
bucket that holds it, and interpolates between them with numpy's
weights.  Each estimate lies within a factor GROWTH of its observation
(or below the first bound), so by linearity the documented accuracy
contract is::

    exact / GROWTH - lowest_bound <= quantile(q) <= exact * GROWTH + lowest_bound

i.e. relative error bounded by the bucket growth factor, plus an
absolute floor of the first bucket bound for values below resolution,
against the exact ``numpy.percentile`` of the observed series, for
observations below the last bound.  (The reference interpolates inside
the one bucket that holds the rank, which misses the contract where the
exact quantile falls between two distant observations, e.g. 3e-6, 3e-6
and 9.0 at q = 0.9.)

Thread safety: one registry lock serializes metric creation and child
lookup; each child carries its own lock for observations, so hot-path
``inc()``/``observe()`` calls from the engine's dispatcher thread and
submitting threads never contend on the registry lock.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Iterator

__all__ = [
    "HIST_GROWTH",
    "Counter",
    "Gauge",
    "Histogram",
    "Metric",
    "MetricsRegistry",
    "default_buckets",
    "registry",
    "reset_default_registry",
]

# Exponential bucket growth factor: the histogram-quantile relative
# error bound (see module docstring).
HIST_GROWTH = math.sqrt(2.0)


def default_buckets(
    lo: float = 1e-6, hi: float = 64.0, growth: float = HIST_GROWTH
) -> tuple[float, ...]:
    """Exponential bucket upper bounds from ``lo`` to >= ``hi``: the
    default latency/queue-wait scale (1 microsecond .. ~1 minute in
    seconds).  The implicit final bucket is +inf."""
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * growth)
    return tuple(out)


class _Child:
    """One labeled time series of a metric.  Base for value holders."""

    __slots__ = ("_lock",)

    def __init__(self) -> None:
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self) -> None:
        super().__init__()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        with self._lock:
            self.value += amount

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self) -> None:
        super().__init__()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


class _HistogramChild(_Child):
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]) -> None:
        super().__init__()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * len(self.counts)
            self.sum = 0.0
            self.count = 0

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated sample quantile (None when empty).  See
        the module docstring for the accuracy contract vs the exact
        ``numpy.percentile`` of the observed series."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return None
        rank = q * (total - 1)  # numpy 'linear' convention
        k = int(rank)
        lo = self._order_statistic(counts, k)
        if k == rank:
            return lo
        return lo + (self._order_statistic(counts, k + 1) - lo) * (rank - k)

    def _order_statistic(self, counts: list[int], k: int) -> float:
        """Estimate of the k-th smallest observation (0-based): a point
        inside the bucket that holds it, by its position among the
        bucket's observations."""
        seen = 0
        for i, c in enumerate(counts):
            if seen + c > k:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else lo * HIST_GROWTH
                return lo + (hi - lo) * (k - seen + 1) / c
            seen += c
        raise AssertionError(f"rank {k} past {seen} observations")


class Metric:
    """One named metric family: fixed label names, one child per label
    value tuple.  Unlabeled metrics have a single anonymous child."""

    kind = "untyped"

    def __init__(
        self, name: str, help: str, labelnames: tuple[str, ...], **kw: Any
    ) -> None:
        _validate_name(name)
        for ln in labelnames:
            _validate_name(ln)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kw = kw
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def _new_child(self) -> Any:
        raise NotImplementedError

    def labels(self, **labels: Any) -> Any:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    @property
    def _anon(self) -> Any:
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                f"use .labels(...)"
            )
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._children[()] = self._new_child()
            return child

    def children(self) -> Iterator[tuple[tuple[str, ...], Any]]:
        with self._lock:
            items = list(self._children.items())
        yield from items

    def reset(self) -> None:
        for _, child in self.children():
            child.reset()


class Counter(Metric):
    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._anon.inc(amount)

    @property
    def value(self) -> float:
        return float(self._anon.value)


class Gauge(Metric):
    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._anon.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._anon.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._anon.dec(amount)

    @property
    def value(self) -> float:
        return float(self._anon.value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: tuple[str, ...],
        buckets: tuple[float, ...] | None = None,
    ) -> None:
        bounds = tuple(buckets) if buckets is not None else default_buckets()
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"{name}: bucket bounds must strictly increase")
        super().__init__(name, help, labelnames, buckets=bounds)
        self.buckets = bounds

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._anon.observe(value)

    def quantile(self, q: float) -> float | None:
        return self._anon.quantile(q)


def _validate_name(name: str) -> None:
    if not name or not (name[0].isalpha() or name[0] == "_"):
        raise ValueError(f"invalid metric/label name {name!r}")
    if not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(f"invalid metric/label name {name!r}")


class MetricsRegistry:
    """A set of named metrics.  One process-wide default instance lives
    behind :func:`registry`; tests and harnesses may build private ones.

    Re-registering a name returns the existing metric when the kind,
    labels, and bucket bounds match (so two engines share one family),
    and raises on any mismatch — silent redefinition is how dashboards
    break."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _get_or_make(self, cls: type, name: str, help: str,
                     labelnames: tuple[str, ...], **kw: Any) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (
                    type(existing) is not cls
                    or existing.labelnames != tuple(labelnames)
                    or existing._kw != (existing._kw | kw)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames} — "
                        f"conflicting re-registration"
                    )
                return existing
            m = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        return self._get_or_make(
            Histogram, name, help, labelnames,
            **({} if buckets is None else {"buckets": tuple(buckets)}),
        )

    def get(self, name: str) -> Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Zero every child of every metric (benchmark warm-up hygiene);
        families and label children stay registered."""
        for m in self.metrics():
            m.reset()


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry — what the engine, the fault
    injector, the sweep harness, and the exporters use unless handed a
    private one."""
    return _DEFAULT


def reset_default_registry() -> None:
    """Zero the default registry's values (tests, benchmark warm-up)."""
    _DEFAULT.reset()
