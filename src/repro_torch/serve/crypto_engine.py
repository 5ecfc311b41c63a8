"""Batched HE-polymul serving engine: shape-bucketed continuous batching
and fault-tolerant async serving over the plan/execute API (the port of
``repro.serve.crypto_engine``).

Users of an HE service send many small products; the throughput lies in
batching them into one device dispatch per plan:

* **Shape buckets.**  Requests arrive with heterogeneous plans; the
  frozen, hashable :class:`repro_torch.api.PlanConfig`
  (``api.plan_key``) is the bucket key.  The engine records each
  distinct config at its first dispatch (``trace_count`` /
  ``traced_configs``: one entry per config, where the reference counts
  its jit traces; eager PyTorch compiles nothing per config).
* **Fixed batch slots.**  Each dispatch pads its bucket's pending
  requests to ``batch_slots`` rows with zero polynomials in ONE host
  buffer, makes one host-to-device copy of it, runs ``api.execute`` on
  the plan's device, and makes one device-to-host copy of the
  ``(slots, n, L)`` result; a future resolves to its CPU int64 ``(n, L)``
  row only after that copy has completed, so latencies measure the
  product and not the host's issue time.  Oracle-width buckets dispatch
  unpadded (their arithmetic runs on the host).
* **Deadlines, priorities, EDF.**  ``submit(..., deadline=, priority=)``
  attaches scheduling metadata; dispatch picks the bucket whose head
  request is earliest-deadline-first (deadline-less requests order FIFO
  behind any deadline, priority breaks ties).  Admission control sheds
  requests whose deadline has passed or cannot be met — each shed
  future resolves with :class:`repro_torch.errors.DeadlineExceededError`,
  never silently dropped.
* **Backpressure.**  ``max_pending=`` bounds the submission queue;
  ``submit(timeout=)`` blocks for space (raising
  :class:`repro_torch.errors.QueueFullError` on expiry) and
  ``try_submit`` returns ``None`` instead of waiting.
* **Failure semantics.**  A dispatch that raises fails or requeues
  exactly the popped requests: bounded per-request retries with
  exponential per-bucket backoff, then
  :class:`repro_torch.errors.BackendFailedError` (underlying exception
  chained as ``__cause__``).  Every admitted request resolves exactly
  once — a value or a typed :class:`repro_torch.errors.EngineError`.
* **Circuit breaker / degradation.**  ``breaker_threshold`` consecutive
  dispatch failures re-plan the bucket one step down
  :data:`FALLBACK_NEXT` (``cuda_fused_e2e -> cuda_fused -> cuda``) via
  :func:`repro_torch.api.plan` with the same n/t/v and device, so
  degraded results stay bit-exact; after ``breaker_cooldown_s`` the next
  dispatch probes the original backend and restores it on success.
  ``cuda`` ends the chain: the plain versions of the kernels serve
  nothing on the card's main path, so past its retries a request fails
  with ``BackendFailedError``.  Every degradation is counted
  (``breaker_opened``, ``degraded_buckets``, ``bucket_backends``).
* **Kernels at plan time.**  :meth:`PolymulEngine.plan` on a card builds
  and loads the kernels of the plan's backend and of its fallbacks when
  the plan is built, so a kernel that does not build raises from
  ``plan()`` and never becomes a dispatch failure the breaker would
  absorb.
* **Async front end.**  ``start()`` launches a background dispatcher
  thread driving :meth:`PolymulEngine.step`; submission then overlaps
  host batching with device execution and futures support
  ``result(timeout=)`` blocking waits.  The kernel wrappers launch under
  a device guard on the calling thread's current stream of the
  operands' device.  The synchronous ``step()`` / ``run_until_idle()``
  closed loop works unchanged.

* **Mesh mode.**  With ``mesh=`` (a :class:`repro_torch.launch.mesh.Mesh`
  over ``torch.distributed``), dispatches run :func:`polymul_sharded`:
  each rank decomposes its ``data`` shard of the padded batch with the
  shard-local plan of its ``model`` slice of the RNS channels
  (:func:`repro_torch.api.shard_plan`, cached per plan and channel range),
  runs that plan's residue cascade (K1, K1-fs at n = 65536), all-gathers
  the channels over ``model`` for compose (K6) and the limbs over the data
  axes.  Int64 and wide plans serve; ``submit`` refuses the oracle width,
  a t that the model axis does not divide and a plan on another device
  kind than the mesh's, with the reference's messages.  On one card the
  mesh is world size 1 (``make_local_mesh()``, NCCL); across ranks every
  rank drives its own engine with the same requests in the same order,
  as the collectives pair up dispatch by dispatch.

Usage::

    eng = PolymulEngine(batch_slots=8, max_pending=64)
    with eng:                               # background dispatcher
        pl = eng.plan(n=4096, t=6, v=30)
        fut = eng.submit(pl, za, zb, deadline=0.5)   # za, zb: (n, S)
        limbs = fut.result(timeout=5.0)     # (n, L), or raises EngineError

Fault injection for soak testing wraps ``engine.executor``
(:mod:`repro_torch.serve.faults`); the soak driver is
``repro_torch.launch.serve_soak``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch import api
from repro_torch.errors import (
    BackendFailedError,
    DeadlineExceededError,
    QueueFullError,
    UnservableConfigError,
)
from repro_torch.kernels import ops as ops_mod
from repro_torch.launch.mesh import Mesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.sharding import ctx as ctx_mod
from repro_torch.sharding import partition

__all__ = [
    "FALLBACK_NEXT",
    "SNAPSHOT_KEYS",
    "SNAPSHOT_SCHEMA_VERSION",
    "PolymulEngine",
    "PolymulFuture",
    "negacyclic_mul_sharded",
    "polymul_sharded",
]


# --------------------------------------------------------------------------
# mesh-sharded execution (the model x data layout)
# --------------------------------------------------------------------------


def _mesh_sizes(mesh) -> tuple[int, int]:
    """(model_size, data_batch_size) of a serving mesh."""
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1
    return msize, partition._axes_size(mesh, partition.batch_axes(mesh))


def _check_mesh_device(cfg: api.PlanConfig, mesh, fn: str) -> None:
    if torch.device(cfg.device).type != mesh.device.type:
        raise ValueError(
            f"{fn}: the plan lives on {cfg.device}, the mesh's process group "
            f"serves {mesh.device.type} tensors; plan on the mesh's device"
        )


def _check_mesh_plan(cfg: api.PlanConfig, mesh, fn: str) -> tuple[int, int]:
    """The sharded path's checks of a plan against a mesh (the reference's
    width and ``t % model`` checks, and the device the mesh's process
    group serves); returns :func:`_mesh_sizes`."""
    if cfg.width not in ("int64", "wide"):
        raise ValueError(
            f"{fn} serves int64/wide-width plans only "
            f"(got width={cfg.width!r}); the oracle datapath is host-only "
            f"and cannot be sharded"
        )
    msize, bsize = _mesh_sizes(mesh)
    if cfg.t % msize:
        raise ValueError(
            f"t={cfg.t} RNS channels do not divide the model axis "
            f"({msize}-way): shrink the axis or pick t a multiple of it"
        )
    _check_mesh_device(cfg, mesh, fn)
    return msize, bsize


def _check_batch(batch: int, bsize: int) -> None:
    if batch % bsize:
        raise ValueError(
            f"batch {batch} does not divide the data axes "
            f"({bsize}-way); pad the batch (the engine's slot padding "
            f"guarantees this)"
        )


def _local_plan(pl: api.Plan, mesh, msize: int) -> api.Plan:
    """The shard-local plan of this rank's ``model`` slice of the channels."""
    k = mesh.index("model") if "model" in mesh.axis_names else 0
    tl = pl.t // msize
    return api.shard_plan(pl, k * tl, (k + 1) * tl)


def negacyclic_mul_sharded(pl: api.Plan, a, b, *, mesh):
    """The residue cascade over a mesh: ``a``, ``b`` are whole ``(t, B, n)``
    residue tensors, the same on every rank; each rank takes its block
    (channels over ``model``, batch over the data axes), runs the
    shard-local plan's :func:`repro_torch.api.negacyclic_mul` (the kernels
    launch over its t / model channels), and the blocks are all-gathered
    back into the whole product on every rank.

    Bit-exact against :func:`repro_torch.api.negacyclic_mul`: the
    per-channel cascades are independent (the RNS parallelism the paper's
    t datapaths exploit), so sharding channels is a pure layout decision.
    Device widths only (int64 and wide); the oracle width is host-only."""
    cfg = api.plan_key(pl)
    msize, bsize = _check_mesh_plan(cfg, mesh, "negacyclic_mul_sharded")
    if a.dim() != 3 or a.shape[0] != cfg.t or a.shape[-1] != cfg.n:
        raise ValueError(
            f"negacyclic_mul_sharded: expected residues (t={cfg.t}, B, "
            f"n={cfg.n}), got shape {tuple(a.shape)}"
        )
    if a.shape != b.shape:
        raise ValueError(
            f"negacyclic_mul_sharded: operand shapes differ: "
            f"{tuple(a.shape)} vs {tuple(b.shape)}"
        )
    _check_batch(a.shape[1], bsize)
    pol = ctx_mod.make_crypto_policy(mesh, pl)
    local = _local_plan(pl, mesh, msize)
    return pol.gather(api.negacyclic_mul(local, pol(a, "residues"), pol(b, "residues")),
                      "residues")


def polymul_sharded(pl: api.Plan, za, zb, *, mesh):
    """Mesh-mode end-to-end polymul: whole ``(B, n, S)`` segments, the same
    on every rank -> whole ``(B, n, L)`` limbs on every rank.  Each rank
    decomposes its data shard of the batch into its ``model`` slice of the
    channels (the shard-local plan), runs the local residue cascade, and
    all-gathers the channels over ``model`` for compose (the one
    cross-``model`` collective), then the limbs over the data axes."""
    cfg = api.plan_key(pl)
    msize, bsize = _check_mesh_plan(cfg, mesh, "polymul_sharded")
    for name, z in (("za", za), ("zb", zb)):
        if z.dim() != 3 or tuple(z.shape[1:]) != (cfg.n, cfg.seg_count):
            raise ValueError(
                f"polymul_sharded: expected {name} segments (B, n={cfg.n}, "
                f"S={cfg.seg_count}), got shape {tuple(z.shape)}"
            )
    if za.shape != zb.shape:
        raise ValueError(
            f"polymul_sharded: operand shapes differ: {tuple(za.shape)} vs {tuple(zb.shape)}"
        )
    _check_batch(za.shape[0], bsize)
    pol = ctx_mod.make_crypto_policy(mesh, pl)
    local = _local_plan(pl, mesh, msize)
    rp = api.negacyclic_mul(local, api.decompose(local, pol(za, "segments")),
                            api.decompose(local, pol(zb, "segments")))
    channels = partition.P(pol.specs["residues"][0], None, None)
    return pol.gather(api.compose(pl, ctx_mod.gather(rp, channels, mesh)), "limbs")


# --------------------------------------------------------------------------
# request plumbing
# --------------------------------------------------------------------------


class PolymulFuture:
    """Handle for one submitted product, with a three-state lifecycle:

    ``PENDING`` (queued or in flight) -> ``DONE`` (``result()`` returns
    the ``(n, L)`` limbs as a CPU int64 tensor; ``latency_s`` holds submit-to-resolve
    wall time) or ``FAILED`` (``result()`` re-raises the stored
    :class:`repro_torch.errors.EngineError`; ``exception()`` returns it).

    ``result(timeout=)``/``exception(timeout=)`` block up to ``timeout``
    seconds for resolution (raising ``TimeoutError`` on expiry).  With
    no timeout, a future submitted while the engine's background
    dispatcher is running blocks until resolved; otherwise an unserved
    future raises immediately — drive the engine (``step()`` /
    ``run_until_idle()``).  A future resolves exactly once; a second
    resolution attempt is an engine bug and raises.
    """

    PENDING = "PENDING"
    DONE = "DONE"
    FAILED = "FAILED"

    __slots__ = (
        "_value", "_exc", "_state", "_event", "_async",
        "latency_s", "dispatch_index", "trace_id",
    )

    def __init__(self):
        self._value = None
        self._exc = None
        self._state = PolymulFuture.PENDING
        self._event = threading.Event()
        self._async = False
        self.latency_s = None
        self.dispatch_index = None  # executor call index that resolved it
        self.trace_id = None  # obs span id (engines with a span_log)

    @property
    def state(self) -> str:
        return self._state

    def done(self) -> bool:
        return self._state != PolymulFuture.PENDING

    def exception(self, timeout: float | None = None):
        """The stored EngineError of a FAILED future, None when DONE."""
        self._wait(timeout)
        return self._exc

    def result(self, timeout: float | None = None):
        self._wait(timeout)
        if self._state == PolymulFuture.DONE:
            return self._value
        if self._state == PolymulFuture.FAILED:
            raise self._exc
        raise RuntimeError(
            "request not served yet — drive the engine "
            "(step() / run_until_idle()), or pass result(timeout=)"
        )

    def _wait(self, timeout: float | None) -> None:
        if self._state != PolymulFuture.PENDING:
            return
        if timeout is not None:
            if not self._event.wait(timeout):
                raise TimeoutError(
                    f"request still PENDING after {timeout}s"
                )
        elif self._async:
            self._event.wait()

    # -- engine side ---------------------------------------------------
    def _check_unresolved(self) -> None:
        if self._state != PolymulFuture.PENDING:
            raise RuntimeError(
                f"future resolved twice (state={self._state}) — "
                f"engine invariant violation"
            )

    def _resolve(self, value, latency_s: float, dispatch_index=None):
        self._check_unresolved()
        self._value = value
        self.latency_s = latency_s
        self.dispatch_index = dispatch_index
        self._state = PolymulFuture.DONE
        self._event.set()

    def _fail(self, exc: Exception, latency_s=None, dispatch_index=None):
        self._check_unresolved()
        self._exc = exc
        self.latency_s = latency_s
        self.dispatch_index = dispatch_index
        self._state = PolymulFuture.FAILED
        self._event.set()


@dataclasses.dataclass
class _Request:
    za: torch.Tensor  # (n, S), CPU int64
    zb: torch.Tensor  # (n, S), CPU int64
    future: PolymulFuture
    seq: int
    t_submit: float
    deadline: float | None = None  # absolute engine-clock deadline
    priority: int = 0  # higher dispatches sooner among equal deadlines
    attempts: int = 0  # failed dispatch attempts ridden so far
    span: obs_tracing.Span | None = None  # request trace (span_log engines)


def _order_key(req: _Request) -> tuple:
    """Heap key: earliest deadline first (deadline-less requests sort
    behind every deadline), then priority (higher first), then FIFO."""
    dl = req.deadline if req.deadline is not None else math.inf
    return (dl, -req.priority, req.seq)


@dataclasses.dataclass
class _Bucket:
    """One PlanConfig's queue + breaker state.  ``chain[0]`` is the
    original plan; ``chain[level]`` is the currently-active (possibly
    degraded) plan.  ``failures`` counts consecutive dispatch failures
    at the current level; ``not_before`` is the backoff gate."""

    key: api.PlanConfig
    chain: list  # [Plan, ...] original + lazily-built fallbacks
    heap: list = dataclasses.field(default_factory=list)
    level: int = 0
    failures: int = 0
    not_before: float = 0.0
    opened_at: float = 0.0  # when the breaker last opened / probe failed
    ewma_service_s: float = 0.0

    def push(self, req: _Request) -> None:
        heapq.heappush(self.heap, (*_order_key(req), req))

    def pop(self) -> _Request:
        return heapq.heappop(self.heap)[3]

    @property
    def plan(self) -> api.Plan:  # the original, pre-degradation plan
        return self.chain[0]

    @property
    def active_plan(self) -> api.Plan:
        return self.chain[self.level]


# Backend degradation chain (circuit breaker): each entry's fallback runs
# more, simpler kernels; all are bit-exact against each other, so
# degrading never changes results.  It ends at "cuda": the plain versions
# of the kernels are no fallback on the card.
FALLBACK_NEXT = {
    "cuda_fused_e2e": "cuda_fused",
    "cuda_fused": "cuda",
}


# --------------------------------------------------------------------------
# observability vocabulary
# --------------------------------------------------------------------------

# The engine's counters, registered as `repro_engine_<key>_total` counter
# families labeled {engine=<name>} in the process metrics registry
# (repro_torch.obs.metrics).  `PolymulEngine.stats` is a live dict view over
# this engine's children; exporters read the same numbers.
_STAT_KEYS = (
    "submitted",  # admitted + DOA-shed requests (rejected NOT included)
    "served",  # futures resolved with a result
    "dispatches",  # successful executor calls
    "padded_slots",  # zero rows padded across successful dispatches
    "rejected",  # backpressure: never admitted (no future created)
    "shed",  # futures resolved with DeadlineExceededError
    "retried",  # request requeues after failed dispatches
    "failed",  # futures resolved with BackendFailedError
    "dispatch_failures",  # executor calls that raised
    "breaker_opened",  # bucket degradations down FALLBACK_NEXT
    "breaker_recovered",  # successful probes restoring the original
    "probes",  # original-backend probe dispatches while degraded
)

# snapshot() wire contract: the exact key set a snapshot dict carries at
# SNAPSHOT_SCHEMA_VERSION (the reference's, key for key).  Changing the
# schema means bumping the version AND this tuple in the same commit —
# downstream dashboards key on it.
SNAPSHOT_SCHEMA_VERSION = 1
SNAPSHOT_KEYS = _STAT_KEYS + (
    "schema_version",  # int, == SNAPSHOT_SCHEMA_VERSION
    "engine",  # engine instance name (metrics label value)
    "queue_depth",  # queued, not yet dispatched
    "inflight",  # popped, dispatch outcome pending
    "latency_p50_ms",  # submit->result p50 over latency_window (or None)
    "latency_p99_ms",  # submit->result p99 over latency_window (or None)
    "degraded_buckets",  # buckets currently serving a fallback backend
    "bucket_backends",  # {bucket key str: active backend str}
)

_engine_names = itertools.count()


def _bucket_key_str(cfg: api.PlanConfig) -> str:
    """Human-stable bucket label used in snapshot()['bucket_backends']
    and span attrs: enough of the PlanConfig to tell buckets apart."""
    return f"n{cfg.n}_t{cfg.t}_v{cfg.v}_{cfg.backend}"


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class PolymulEngine:
    """Shape-bucketed continuous-batching engine over the Plan API, with
    deadline/priority scheduling, bounded-queue backpressure, bounded
    retry, per-bucket circuit breaking onto fallback backends, and an
    optional background dispatcher thread (see module docstring).

    Parameters
    ----------
    batch_slots:
        Fixed rows per dispatch.  Every micro-batch is padded to this
        many polynomials, so each distinct ``PlanConfig`` runs one shape.
    mesh:
        Optional :class:`repro_torch.launch.mesh.Mesh` with ``model`` and
        data axes; when set, dispatches run :func:`polymul_sharded`.
        ``batch_slots`` must divide the data axes so the padded batch
        always shards.  Anything else but ``None`` is refused
        (:class:`repro_torch.errors.UnservableConfigError`, knob ``mesh``).
    donate:
        Passed to :func:`repro_torch.api.execute`, where it changes
        nothing (eager PyTorch donates no buffers).
    max_pending:
        Bound on queued (not yet dispatched) requests; ``None`` (the
        default) leaves the queue unbounded.  With a bound set,
        ``submit`` blocks for space and ``try_submit`` returns ``None``
        when full.
    max_retries:
        How many times one request may be re-queued after a failed
        dispatch before its future fails with ``BackendFailedError``
        (probe dispatches of the original backend don't count).
    breaker_threshold:
        Consecutive dispatch failures at the bucket's current backend
        before the circuit breaker degrades it one step down
        ``FALLBACK_NEXT``.
    breaker_cooldown_s:
        How long a degraded bucket serves its fallback before the next
        dispatch probes the original backend again.
    backoff_base_s:
        Base of the per-bucket exponential dispatch backoff
        (``base * 2^(failures-1)``, capped at 1 s).
    name:
        Metrics label for this engine instance (``engine=<name>`` on
        every ``repro_engine_*`` series); auto-minted when omitted.
    registry:
        The :class:`repro_torch.obs.metrics.MetricsRegistry` to count
        into (default: the process-wide registry).
    span_log:
        Optional :class:`repro_torch.obs.tracing.SpanLog`.  When set, every
        ``submit()`` mints a request span (trace id on the returned
        future as ``fut.trace_id``) and the full lifecycle — admit,
        dispatch, retry, breaker transitions, terminal resolve/shed/
        fail — lands in the log.  ``None`` (default) keeps the hot
        paths tracing-free.
    """

    def __init__(self, *, batch_slots: int = 8, mesh=None,
                 donate: bool = False, max_pending: int | None = None,
                 max_retries: int = 3, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 backoff_base_s: float = 0.01,
                 latency_window: int = 4096,
                 name: str | None = None,
                 registry: obs_metrics.MetricsRegistry | None = None,
                 span_log: obs_tracing.SpanLog | None = None):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise UnservableConfigError(
                    f"mesh= takes a repro_torch.launch.mesh.Mesh (make_mesh, "
                    f"make_local_mesh), got {type(mesh).__name__}",
                    knob="mesh", value=mesh, alternatives=(None,),
                )
            _, bsize = _mesh_sizes(mesh)
            if batch_slots % bsize:
                raise ValueError(
                    f"batch_slots={batch_slots} must divide the mesh's "
                    f"data axes ({bsize}-way) so padded batches shard"
                )
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}"
            )
        self.batch_slots = batch_slots
        self.mesh = mesh
        self.donate = donate
        self.max_pending = max_pending
        self.max_retries = max_retries
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.backoff_base_s = backoff_base_s
        self._plans: dict[api.PlanConfig, api.Plan] = {}
        self._buckets: dict[api.PlanConfig, _Bucket] = {}
        self._seq = itertools.count()
        # one entry per distinct PlanConfig, at its first dispatch
        self._config_log: list[api.PlanConfig] = []
        self._config_set: set[api.PlanConfig] = set()
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._loop_error: BaseException | None = None
        self._inflight = 0
        self._dispatch_seq = 0  # executor call counter (success + failure)
        self._latencies: deque = deque(maxlen=latency_window)
        self.name = name if name is not None else f"engine-{next(_engine_names)}"
        self.span_log = span_log
        self._registry = (
            registry if registry is not None else obs_metrics.registry()
        )
        # One counter child per stat, labeled by engine instance; the
        # `stats` property is a read view over exactly these children.
        self._m = {
            k: self._registry.counter(
                f"repro_engine_{k}_total", labelnames=("engine",)
            ).labels(engine=self.name)
            for k in _STAT_KEYS
        }
        self._h_latency = self._registry.histogram(
            "repro_engine_latency_seconds",
            "submit-to-result latency of served requests",
            ("engine",),
        ).labels(engine=self.name)
        self._h_queue_wait = self._registry.histogram(
            "repro_engine_queue_wait_seconds",
            "submit-to-first-dispatch wait of dispatched requests",
            ("engine",),
        ).labels(engine=self.name)
        self._g_queue_depth = self._registry.gauge(
            "repro_engine_queue_depth", "queued, not yet dispatched",
            ("engine",),
        ).labels(engine=self.name)
        self._g_inflight = self._registry.gauge(
            "repro_engine_inflight", "popped, dispatch outcome pending",
            ("engine",),
        ).labels(engine=self.name)
        # The raw batch executor; fault injectors and tests wrap THIS
        # attribute (repro_torch.serve.faults.FaultInjector.install).  Every
        # dispatch goes through it, so a wrapper sees one call per
        # engine dispatch attempt in dispatch-index order.
        self.executor = self._execute_batch

    # -- plan cache ----------------------------------------------------
    def plan(self, n: int = 4096, t: int = 6, v: int = 30, **kw) -> api.Plan:
        """Build-or-fetch a plan, cached by its resolved
        :func:`api.plan_key` — repeated preset lookups share one Plan
        object (and, transitively, one set of device tables).  For an
        int64-width plan on a card, the kernels of its backend and of
        every backend down its :data:`FALLBACK_NEXT` chain are built and
        loaded here, so a kernel that does not build raises now (the wide
        and oracle widths launch no kernel)."""
        pl = api.plan(n=n, t=t, v=v, **kw)
        cfg = api.plan_key(pl)
        if cfg not in self._plans and pl.device.type == "cuda" and cfg.width == "int64":
            backend = cfg.backend
            while backend is not None:
                ops_mod.load_path_kernels(backend, cfg.n, cfg.t, cfg.seg_count, cfg.L)
                backend = FALLBACK_NEXT.get(backend)
        return self._plans.setdefault(cfg, pl)

    # -- request intake ------------------------------------------------
    def _validate_submit(self, pl, za, zb):
        cfg = api.plan_key(pl)
        za, zb = host_int64(za), host_int64(zb)
        want = (cfg.n, cfg.seg_count)
        for name, z in (("za", za), ("zb", zb)):
            if tuple(z.shape) != want:
                raise ValueError(
                    f"submit: expected {name} segments (n={cfg.n}, "
                    f"S={cfg.seg_count}), got shape {tuple(z.shape)}"
                )
        if self.mesh is not None:
            # Mirror the sharded dispatch's preconditions HERE: step()
            # pops requests before dispatching, so a config that could only
            # fail at dispatch would burn retries for nothing.
            if cfg.width not in ("int64", "wide"):
                raise ValueError(
                    f"mesh mode serves int64/wide-width plans only "
                    f"(got width={cfg.width!r})"
                )
            msize, _ = _mesh_sizes(self.mesh)
            if cfg.t % msize:
                raise ValueError(
                    f"mesh mode: t={cfg.t} RNS channels do not divide "
                    f"the model axis ({msize}-way); pick t a multiple "
                    f"of it or shrink the axis"
                )
            _check_mesh_device(cfg, self.mesh, "mesh mode")
        return cfg, za, zb

    def _enqueue_locked(self, cfg, pl, za, zb, deadline, priority,
                        now: float) -> PolymulFuture:
        bucket = self._buckets.get(cfg)
        if bucket is None:
            bucket = self._buckets[cfg] = _Bucket(
                key=cfg, chain=[self._plans.setdefault(cfg, pl)]
            )
        fut = PolymulFuture()
        fut._async = self._thread is not None
        req = _Request(
            za=za, zb=zb, future=fut, seq=next(self._seq), t_submit=now,
            deadline=(now + deadline) if deadline is not None else None,
            priority=priority,
        )
        if self.span_log is not None:
            req.span = self.span_log.start_span(
                "request", engine=self.name, seq=req.seq,
                bucket=_bucket_key_str(cfg), deadline=req.deadline,
                priority=priority,
            )
            fut.trace_id = req.span.trace_id
        self._m["submitted"].inc()
        if req.deadline is not None and req.deadline <= now:
            # dead on arrival: admission control resolves it, queue
            # untouched (typed error, never a silent drop)
            self._m["shed"].inc()
            if req.span is not None:
                req.span.finish("shed", reason="doa", latency_s=0.0)
            fut._fail(
                DeadlineExceededError(
                    f"deadline expired {now - req.deadline:.6f}s before "
                    f"admission (seq {req.seq})",
                    request_seq=req.seq, deadline_s=req.deadline,
                    late_s=now - req.deadline,
                ),
                latency_s=0.0,
            )
            return fut
        if req.span is not None:
            req.span.event("admit", queue_depth=self._pending_locked())
        bucket.push(req)
        self._cond.notify_all()
        return fut

    def submit(self, pl: api.Plan, za, zb, *, deadline: float | None = None,
               priority: int = 0,
               timeout: float | None = None) -> PolymulFuture:
        """Enqueue one product ``a * b`` under plan ``pl``.  ``za``,
        ``zb``: ``(n, S)`` base-2^v segments (tensors on any device, or
        arrays), kept on the host until their dispatch.  ``deadline`` is
        seconds from now; a request that cannot dispatch in time is shed
        (future fails with ``DeadlineExceededError``).  ``priority``
        orders equal-deadline requests (higher first).  When the queue
        is bounded and full, blocks up to ``timeout`` seconds for space
        (forever if ``timeout`` is None — pass a timeout or use
        :meth:`try_submit` when nothing else drives the engine), then
        raises :class:`repro_torch.errors.QueueFullError`.  Returns a
        :class:`PolymulFuture`; drive the engine (or run the background
        dispatcher) to resolve it."""
        cfg, za, zb = self._validate_submit(pl, za, zb)
        t_end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while (self.max_pending is not None
                   and self._pending_locked() >= self.max_pending):
                remaining = (
                    None if t_end is None else t_end - time.perf_counter()
                )
                if remaining is not None and remaining <= 0:
                    self._m["rejected"].inc()
                    if self.span_log is not None:
                        s = self.span_log.start_span(
                            "request", engine=self.name,
                            bucket=_bucket_key_str(cfg),
                        )
                        s.finish("rejected", reason="queue_full")
                    raise QueueFullError(
                        f"submission queue full "
                        f"({self._pending_locked()} >= "
                        f"max_pending={self.max_pending}) after "
                        f"{timeout}s",
                        queue_depth=self._pending_locked(),
                        max_pending=self.max_pending,
                    )
                # bounded wait so a missed notify cannot wedge a waiter
                self._cond.wait(0.05 if remaining is None
                                else min(remaining, 0.05))
            return self._enqueue_locked(
                cfg, pl, za, zb, deadline, priority, time.perf_counter()
            )

    def try_submit(self, pl: api.Plan, za, zb, *,
                   deadline: float | None = None,
                   priority: int = 0) -> PolymulFuture | None:
        """Non-blocking :meth:`submit`: returns ``None`` (and counts a
        rejection) instead of waiting when the bounded queue is full."""
        cfg, za, zb = self._validate_submit(pl, za, zb)
        with self._cond:
            if (self.max_pending is not None
                    and self._pending_locked() >= self.max_pending):
                self._m["rejected"].inc()
                if self.span_log is not None:
                    s = self.span_log.start_span(
                        "request", engine=self.name,
                        bucket=_bucket_key_str(cfg),
                    )
                    s.finish("rejected", reason="queue_full")
                return None
            return self._enqueue_locked(
                cfg, pl, za, zb, deadline, priority, time.perf_counter()
            )

    def _pending_locked(self) -> int:
        return sum(len(b.heap) for b in self._buckets.values())

    def pending(self) -> int:
        with self._cond:
            return self._pending_locked()

    def _has_work_locked(self) -> bool:
        return self._inflight > 0 or any(
            b.heap for b in self._buckets.values()
        )

    # -- execution -----------------------------------------------------
    def _execute_batch(self, pl: api.Plan, za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
        """The raw dispatch executor: one padded micro-batch of CPU int64
        segments ``(B, n, S)`` through the plan's datapath (through
        :func:`polymul_sharded` in mesh mode), returned as the CPU int64
        ``(B, n, L)`` limbs.  One host-to-device copy (of the one
        host buffer that ``za`` and ``zb`` are halves of, as :meth:`step`
        builds them) and one device-to-host copy, which has completed when
        this returns.  ``self.executor`` points here unless a fault
        injector (or test double) wrapped it."""
        dev = pl.device
        base = za._base
        if dev.type != "cpu" and base is not None and base is zb._base:
            both = base.to(dev)
            za, zb = both[0], both[1]
        else:
            za, zb = za.to(dev), zb.to(dev)
        if self.mesh is not None:
            return polymul_sharded(pl, za, zb, mesh=self.mesh).cpu()
        return api.execute(pl, za, zb, donate=self.donate).cpu()

    def _fallback_plan(self, pl: api.Plan) -> api.Plan | None:
        """The next plan down the degradation chain for ``pl`` — same
        n/t/v (bit-exact results), one backend simpler — or ``None``
        when the chain is exhausted / the width has no chain."""
        cfg = api.plan_key(pl)
        if cfg.width != "int64":
            return None
        nb = FALLBACK_NEXT.get(cfg.backend)
        if nb is None:
            return None
        # Prefer carrying the frozen spec (identical tiling); if that
        # combination is unservable on the fallback backend, let plan()
        # re-resolve from the schedule kind.
        for sched in (cfg.schedule, cfg.schedule.kind):
            try:
                return api.plan(
                    n=cfg.n, t=cfg.t, v=cfg.v, backend=nb, schedule=sched,
                    use_sau=cfg.use_sau, device=cfg.device,
                )
            except ValueError:
                continue
        return None

    # -- scheduling ----------------------------------------------------
    def _collect_expired(self) -> list[tuple[_Request, float]]:
        """Pop every queued request whose deadline has already passed.
        The heap orders by deadline first, so expired entries are always
        at the head."""
        out = []
        now = time.perf_counter()
        with self._cond:
            for b in self._buckets.values():
                while b.heap and b.heap[0][0] < now:
                    out.append((b.pop(), now))
            if out:
                self._m["shed"].inc(len(out))
                self._cond.notify_all()  # queue space freed
        return out

    def _resolve_shed(self, items: list[tuple[_Request, float]]) -> int:
        for req, now in items:
            if req.span is not None:
                reason = (
                    "expired" if req.deadline is not None
                    and req.deadline <= now else "unmeetable"
                )
                req.span.finish(
                    "shed", reason=reason, latency_s=now - req.t_submit
                )
            req.future._fail(
                DeadlineExceededError(
                    f"deadline missed before dispatch (seq {req.seq}, "
                    f"{max(now - req.deadline, 0.0):.6f}s late)",
                    request_seq=req.seq, deadline_s=req.deadline,
                    late_s=max(now - req.deadline, 0.0),
                ),
                latency_s=now - req.t_submit,
            )
        return len(items)

    def _select_locked(self, now: float):
        """EDF bucket choice: among buckets whose backoff gate is open,
        pick the one whose head request sorts first by
        (deadline, -priority, seq).  Returns ``None`` (idle),
        ``("defer", wake_at)`` (all live buckets backing off) or
        ``("go", bucket, plan_to_use, probing)``."""
        live = [b for b in self._buckets.values() if b.heap]
        if not live:
            return None
        ready = [b for b in live if b.not_before <= now]
        if not ready:
            return ("defer", min(b.not_before for b in live))
        bucket = min(ready, key=lambda b: b.heap[0][:3])
        probing = (
            bucket.level > 0
            and now - bucket.opened_at >= self.breaker_cooldown_s
        )
        if probing:
            self._m["probes"].inc()
            if self.span_log is not None:
                self.span_log.event(
                    "probe", engine=self.name,
                    bucket=_bucket_key_str(bucket.key),
                    backend=api.plan_key(bucket.chain[0]).backend,
                )
            use_plan = bucket.chain[0]
        else:
            use_plan = bucket.active_plan
        return ("go", bucket, use_plan, probing)

    def _admit_locked(self, bucket: _Bucket):
        """Pop up to ``batch_slots`` requests, shedding any whose
        deadline cannot be met given the bucket's EWMA service time."""
        now = time.perf_counter()
        est = bucket.ewma_service_s
        reqs, shed = [], []
        while bucket.heap and len(reqs) < self.batch_slots:
            req = bucket.pop()
            if req.deadline is not None and now + est > req.deadline:
                shed.append((req, now))
            else:
                reqs.append(req)
        if shed:
            self._m["shed"].inc(len(shed))
        if reqs or shed:
            self._cond.notify_all()  # queue space freed
        return reqs, shed

    # -- dispatch ------------------------------------------------------
    def step(self) -> int:
        """Dispatch ONE micro-batch from the EDF-chosen bucket.  Returns
        the number of requests *resolved* during the call — served,
        shed, or failed; 0 when idle.  A dispatch that raises never
        loses requests: the popped requests are requeued (bounded
        retries, per-bucket backoff + circuit breaking) or their futures
        fail with a typed error."""
        resolved = self._resolve_shed(self._collect_expired())
        while True:
            with self._cond:
                pick = self._select_locked(time.perf_counter())
            if pick is None:
                return resolved
            if pick[0] == "defer":
                if self._stop_evt.is_set():
                    return resolved
                time.sleep(
                    min(max(pick[1] - time.perf_counter(), 0.0), 0.05)
                )
                resolved += self._resolve_shed(self._collect_expired())
                continue
            _, bucket, use_plan, probing = pick
            with self._cond:
                reqs, shed = self._admit_locked(bucket)
                if reqs:
                    self._inflight += len(reqs)
            resolved += self._resolve_shed(shed)
            if not reqs:
                continue  # everything admitted this round was shed
            with self._cond:
                dispatch_idx = self._dispatch_seq
                self._dispatch_seq += 1
            cfg = api.plan_key(use_plan)
            first = cfg not in self._config_set
            if first:  # the config's first dispatch: logged, not timed
                self._config_set.add(cfg)
                self._config_log.append(cfg)
            t0 = time.perf_counter()
            for r in reqs:
                if r.attempts == 0:  # first attempt: the queue wait
                    self._h_queue_wait.observe(t0 - r.t_submit)
                if r.span is not None:
                    r.span.event(
                        "dispatch", dispatch_index=dispatch_idx,
                        backend=cfg.backend, batch=len(reqs),
                        attempt=r.attempts, probing=probing,
                    )
            try:
                # one host buffer of both operands, zero-padded to the
                # slots (oracle buckets unpadded: they run on the host)
                B = len(reqs) if cfg.width == "oracle" else self.batch_slots
                host = torch.zeros((2, B, cfg.n, cfg.seg_count), dtype=torch.int64)
                for i, r in enumerate(reqs):
                    host[0, i] = r.za
                    host[1, i] = r.zb
                out = self.executor(use_plan, host[0], host[1])
                pad = B - len(reqs)
            except Exception as e:  # noqa: BLE001 — any dispatch failure
                resolved += self._on_dispatch_failure(
                    bucket, use_plan, probing, reqs, e
                )
                return resolved
            # A config's first dispatch pays its one-time costs (the
            # caching allocator's first blocks, lazy library state);
            # folding that into the EWMA would make the deadline
            # admission shed everything behind it.
            exec_s = None if first else time.perf_counter() - t0
            resolved += self._on_dispatch_success(
                bucket, probing, reqs, out, pad, dispatch_idx, exec_s
            )
            return resolved

    def _on_dispatch_success(self, bucket, probing, reqs, out, pad,
                             dispatch_idx, exec_s) -> int:
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            if r.span is not None:
                r.span.finish(
                    "resolved", latency_s=now - r.t_submit,
                    dispatch_index=dispatch_idx,
                )
            r.future._resolve(out[i], now - r.t_submit,
                              dispatch_index=dispatch_idx)
        with self._cond:
            self._inflight -= len(reqs)
            bucket.failures = 0
            bucket.not_before = 0.0
            if probing and bucket.level > 0:
                bucket.level = 0  # probe succeeded: breaker closes
                self._m["breaker_recovered"].inc()
                if self.span_log is not None:
                    self.span_log.event(
                        "breaker_recovered", engine=self.name,
                        bucket=_bucket_key_str(bucket.key),
                    )
            if exec_s is not None:  # None: compile dispatch, not service
                bucket.ewma_service_s = (
                    exec_s if bucket.ewma_service_s == 0.0
                    else 0.75 * bucket.ewma_service_s + 0.25 * exec_s
                )
            self._m["dispatches"].inc()
            self._m["served"].inc(len(reqs))
            self._m["padded_slots"].inc(pad)
            for r in reqs:
                self._latencies.append(now - r.t_submit)
                self._h_latency.observe(now - r.t_submit)
            self._cond.notify_all()
        return len(reqs)

    def _on_dispatch_failure(self, bucket, use_plan, probing, reqs,
                             exc) -> int:
        """Fail or requeue exactly the popped requests — never lose
        them.  Non-probe failures advance the bucket's backoff and (at
        the threshold) its circuit breaker; probe failures just restart
        the cool-down without burning request retry budget."""
        now = time.perf_counter()
        failed: list[_Request] = []
        with self._cond:
            self._inflight -= len(reqs)
            self._m["dispatch_failures"].inc()
            for r in reqs:
                if not probing:
                    r.attempts += 1
                if r.attempts > self.max_retries:
                    failed.append(r)
                else:
                    bucket.push(r)
                    self._m["retried"].inc()
                    if r.span is not None:
                        r.span.event(
                            "retry", attempt=r.attempts,
                            error=type(exc).__name__, probing=probing,
                        )
            self._m["failed"].inc(len(failed))
            if probing:
                bucket.opened_at = now  # stay degraded, restart cooldown
            else:
                bucket.failures += 1
                if (bucket.failures >= self.breaker_threshold
                        and self._degrade_locked(bucket, now)):
                    pass  # breaker opened: retry immediately on fallback
                else:
                    bucket.not_before = now + min(
                        self.backoff_base_s * 2 ** (bucket.failures - 1),
                        1.0,
                    )
            self._cond.notify_all()
        backend = api.plan_key(use_plan).backend
        for r in failed:
            if r.span is not None:
                r.span.finish(
                    "failed", backend=backend, attempts=r.attempts,
                    error=type(exc).__name__, latency_s=now - r.t_submit,
                )
            err = BackendFailedError(
                f"request seq {r.seq} failed after {r.attempts} dispatch "
                f"attempts (last backend {backend!r}): {exc}",
                request_seq=r.seq, backend=backend, attempts=r.attempts,
            )
            err.__cause__ = exc
            r.future._fail(err, latency_s=now - r.t_submit)
        return len(failed)

    def _degrade_locked(self, bucket: _Bucket, now: float) -> bool:
        """Open the bucket's breaker: activate (building if needed) the
        next plan down the fallback chain.  False when exhausted."""
        if bucket.level + 1 >= len(bucket.chain):
            nxt = self._fallback_plan(bucket.chain[bucket.level])
            if nxt is None:
                return False
            bucket.chain.append(nxt)
        bucket.level += 1
        bucket.failures = 0
        bucket.opened_at = now
        bucket.not_before = 0.0
        self._m["breaker_opened"].inc()
        if self.span_log is not None:
            self.span_log.event(
                "breaker_open", engine=self.name,
                bucket=_bucket_key_str(bucket.key),
                level=bucket.level,
                backend=api.plan_key(bucket.active_plan).backend,
            )
        return True

    def run_until_idle(self) -> int:
        """Drain every bucket.  Synchronous mode: drives :meth:`step`
        and returns the number of requests resolved.  With the
        background dispatcher running: blocks until the queue and
        in-flight work drain (returns 0; see ``stats``)."""
        if self._thread is not None:
            with self._cond:
                while self._has_work_locked():
                    if self._loop_error is not None:
                        raise RuntimeError(
                            "engine dispatcher thread died"
                        ) from self._loop_error
                    self._cond.wait(0.01)
            return 0
        total = 0
        while True:
            total += self.step()
            with self._cond:
                if not self._has_work_locked():
                    return total

    def serve(self, requests) -> list[torch.Tensor]:
        """Convenience closed loop: submit ``(plan, za, zb)`` triples,
        drain, return results in submission order."""
        futs = [self.submit(pl, za, zb) for pl, za, zb in requests]
        self.run_until_idle()
        return [f.result() for f in futs]

    # -- async front end -----------------------------------------------
    def start(self) -> "PolymulEngine":
        """Launch the background dispatcher thread (idempotent).  While
        running, submissions are served without the caller driving
        ``step()``, and new futures block in ``result()``."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._loop_error = None
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="polymul-engine-dispatch",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _dispatch_loop(self) -> None:
        try:
            while not self._stop_evt.is_set():
                n = self.step()
                if n == 0:
                    with self._cond:
                        if (not self._stop_evt.is_set()
                                and not self._has_work_locked()):
                            self._cond.wait(0.02)
        except BaseException as e:  # surfaced by run_until_idle/stop
            self._loop_error = e
            with self._cond:
                self._cond.notify_all()
            raise

    def stop(self, *, drain: bool = True,
             timeout: float | None = None) -> None:
        """Stop the dispatcher thread; with ``drain`` (default) first
        wait until every queued request has resolved."""
        if self._thread is None:
            return
        if drain:
            self.run_until_idle()
        self._stop_evt.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout)
        self._thread = None
        if self._loop_error is not None:
            err, self._loop_error = self._loop_error, None
            raise RuntimeError("engine dispatcher thread died") from err

    def __enter__(self) -> "PolymulEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop(drain=exc_type is None)
        return False

    # -- probes --------------------------------------------------------
    @property
    def stats(self) -> dict:
        """Live counter view: ``{stat: int}`` read from this engine's
        children in the metrics registry (see ``_STAT_KEYS`` for the
        vocabulary).  A fresh plain dict per access — exporters and the
        registry itself hold the canonical series."""
        return {k: int(c.value) for k, c in self._m.items()}

    def snapshot(self) -> dict:
        """Point-in-time stats: the counters plus queue depth, in-flight
        count, p50/p99 submit-to-result latency (ms, over the last
        ``latency_window`` served requests) and per-bucket active
        backends — what the soak driver and CLIs gate on/report.

        The snapshot is a FROZEN wire contract: its key set is exactly
        ``SNAPSHOT_KEYS`` at ``schema_version`` =
        ``SNAPSHOT_SCHEMA_VERSION`` (each key documented there), pinned
        by a regression test so dashboards can't silently break.  It is
        an exporter view over the metrics registry — the same numbers
        are scrapeable via :func:`repro_torch.obs.to_prometheus`."""
        with self._cond:
            snap = dict(self.stats)
            snap["schema_version"] = SNAPSHOT_SCHEMA_VERSION
            snap["engine"] = self.name
            snap["queue_depth"] = self._pending_locked()
            snap["inflight"] = self._inflight
            self._g_queue_depth.set(snap["queue_depth"])
            self._g_inflight.set(snap["inflight"])
            if self._latencies:
                lat = np.asarray(self._latencies) * 1e3
                snap["latency_p50_ms"] = float(np.percentile(lat, 50))
                snap["latency_p99_ms"] = float(np.percentile(lat, 99))
            else:
                snap["latency_p50_ms"] = None
                snap["latency_p99_ms"] = None
            snap["degraded_buckets"] = sum(
                1 for b in self._buckets.values() if b.level > 0
            )
            snap["bucket_backends"] = {
                _bucket_key_str(c): api.plan_key(b.active_plan).backend
                for c, b in self._buckets.items()
            }
        return snap

    def reset_stats(self) -> None:
        """Zero every counter/histogram series of THIS engine and drop
        the latency window (benchmark warm-up hygiene)."""
        with self._cond:
            for c in self._m.values():
                c.reset()
            self._h_latency.reset()
            self._h_queue_wait.reset()
            self._latencies.clear()

    @property
    def trace_count(self) -> int:
        """Distinct PlanConfigs dispatched so far, each counted at its
        first dispatch (the reference counts its jit traces, one per
        config; breaker degradation adds one per newly-activated
        fallback)."""
        return len(self._config_log)

    @property
    def traced_configs(self) -> tuple:
        """The PlanConfigs of :attr:`trace_count`, in first-dispatch
        order."""
        return tuple(self._config_log)


def host_int64(z) -> torch.Tensor:
    """A tensor (on any device) or array as a contiguous CPU int64 tensor:
    how the engine keeps a request's segments until its dispatch."""
    if isinstance(z, torch.Tensor):
        return z.detach().to("cpu", torch.int64).contiguous()
    return torch.as_tensor(np.asarray(z, dtype=np.int64)).contiguous()
