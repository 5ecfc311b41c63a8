"""Deterministic, seedable fault injection for the serving engine (the
port of ``repro.serve.faults``).

The robustness claims of :class:`repro_torch.serve.crypto_engine.PolymulEngine`
— exactly-once resolution, bounded retries, circuit breaking onto a
bit-exact fallback backend — are only worth stating if they hold under
*actual* faults.  This module supplies them on a reproducible schedule:
a :class:`FaultInjector` wraps ``engine.executor`` (the single funnel
every dispatch attempt passes through) and can **raise** a transient
error, **delay** the dispatch, or **corrupt** the returned limbs,
according to a list of :class:`FaultRule` triggers driven by one seeded
``numpy`` generator.

Design points:

* **Deterministic.**  All randomness comes from ``seed``; the injector
  counts executor calls itself, and the engine stamps every resolved
  future with the ``dispatch_index`` of the call that produced it —
  the two counters advance in lock-step (install the injector before
  any dispatch), so the injector's ``log`` can be joined against
  resolved futures after the fact.  That join is how the soak driver
  *detects* injected corruption rather than merely surviving it.
* **Raise beats corrupt.**  When several rules match one call, the
  first matching ``raise`` rule wins; otherwise every matching
  ``delay`` sleeps and every matching ``corrupt`` XORs the output.
* **Corruption is engine-invisible.**  A corrupt rule flips the low bit
  of the result limbs *after* the wrapped executor returns — the engine
  serves it as a success.  Catching it is the oracle spot-check's job
  (:func:`spot_check`), mirroring how a real silent-data-corruption
  event would have to be caught downstream.

Usage::

    inj = FaultInjector([
        FaultRule("raise", backend="cuda_fused_e2e", max_count=3),
        FaultRule("delay", rate=0.05, delay_s=0.01),
        FaultRule("corrupt", rate=0.01),
    ], seed=7)
    inj.install(eng)          # wraps eng.executor
    ... drive traffic ...
    corrupted = {i for i, kind, _ in inj.log if kind == "corrupt"}
    # futures with fut.dispatch_index in `corrupted` carry flipped limbs
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import bigint
from repro_torch.core import polymul as core_polymul
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.crypto_engine import host_int64

__all__ = ["FaultInjector", "FaultRule", "InjectedFault", "spot_check"]


class InjectedFault(RuntimeError):
    """The transient error a ``raise`` rule throws inside the executor.

    Deliberately a plain ``RuntimeError`` subclass — the engine must
    treat it like any unexpected dispatch failure; nothing in the
    retry/breaker path is allowed to special-case it."""

    def __init__(self, message: str, *, dispatch_index: int = -1) -> None:
        super().__init__(message)
        self.dispatch_index = dispatch_index


@dataclasses.dataclass
class FaultRule:
    """One trigger in an injection schedule.

    Parameters
    ----------
    kind:
        ``"raise"`` (throw :class:`InjectedFault`), ``"delay"`` (sleep
        ``delay_s`` before executing) or ``"corrupt"`` (XOR 1 into the
        returned limbs — silent data corruption).
    rate:
        Bernoulli firing probability per *eligible* call (default 1.0:
        fire on every eligible call).
    backend:
        Only fire on dispatches whose plan uses this backend (``None``:
        any).  This is how a soak pins faults to one chain level, e.g.
        "the fused-e2e kernel is broken, its fallbacks are fine".
    after / until:
        Eligible window in executor-call indices: ``after <= idx`` and
        (when ``until`` is set) ``idx < until``.
    max_count:
        Stop firing after this many hits (``None``: unbounded).
    at:
        Explicit call indices that *force* the rule to fire (still
        subject to ``backend``) regardless of ``rate`` — pins the
        schedule's must-happen events, e.g. "call 17 is corrupted".
    delay_s:
        Sleep length for ``delay`` rules.
    """

    kind: str
    rate: float = 1.0
    backend: str | None = None
    after: int = 0
    until: int | None = None
    max_count: int | None = None
    at: tuple = ()
    delay_s: float = 0.02
    fired: int = 0  # hits so far (mutated by the injector)

    def __post_init__(self):
        if self.kind not in ("raise", "delay", "corrupt"):
            raise ValueError(
                f"FaultRule kind must be raise/delay/corrupt, "
                f"got {self.kind!r}"
            )
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


class FaultInjector:
    """Wraps an engine executor with a seeded fault schedule.

    Attributes
    ----------
    calls:
        Executor calls seen so far; the current call's index is
        ``calls - 1`` inside the wrapper and equals the engine's
        ``dispatch_index`` stamp when installed before any dispatch.
    log:
        ``(call_index, kind, backend)`` for every fault fired — the
        ground truth the soak driver joins against resolved futures.
    """

    def __init__(self, rules, *, seed: int = 0):
        self.rules = list(rules)
        self.rng = np.random.default_rng(seed)
        self.calls = 0
        self.log: list[tuple[int, str, str]] = []
        self._counter = obs_metrics.registry().counter(
            "repro_faults_injected_total",
            "faults fired by the injection schedule",
            ("kind", "backend"),
        )

    def _matches(self, rule: FaultRule, idx: int, backend: str) -> bool:
        if rule.backend is not None and backend != rule.backend:
            return False
        if rule.max_count is not None and rule.fired >= rule.max_count:
            return False
        if idx in rule.at:
            return True
        if idx < rule.after:
            return False
        if rule.until is not None and idx >= rule.until:
            return False
        # One rng draw per (rule, call) in rule order: the schedule is a
        # pure function of (rules, seed, call sequence).
        return bool(self.rng.random() < rule.rate)

    def _fire(self, rule: FaultRule, idx: int, backend: str) -> None:
        rule.fired += 1
        self.log.append((idx, rule.kind, backend))
        self._counter.labels(kind=rule.kind, backend=backend).inc()

    def wrap(self, fn):
        """The wrapped executor: ``fn`` with faults injected per the
        schedule.  Pure pass-through once every rule is exhausted."""

        def _injected(pl, za, zb):
            idx = self.calls
            self.calls += 1
            backend = api.plan_key(pl).backend
            hits = [
                r for r in self.rules if self._matches(r, idx, backend)
            ]
            for r in hits:
                if r.kind == "delay":
                    self._fire(r, idx, backend)
                    time.sleep(r.delay_s)
            for r in hits:
                if r.kind == "raise":
                    self._fire(r, idx, backend)
                    raise InjectedFault(
                        f"injected transient fault at dispatch {idx} "
                        f"(backend {backend!r})",
                        dispatch_index=idx,
                    )
            out = fn(pl, za, zb)
            for r in hits:
                if r.kind == "corrupt":
                    self._fire(r, idx, backend)
                    out = out ^ 1  # silent low-bit flip
            return out

        return _injected

    def install(self, engine) -> "FaultInjector":
        """Wrap ``engine.executor`` in place.  Install before the first
        dispatch so call indices align with the engine's
        ``dispatch_index`` stamps."""
        engine.executor = self.wrap(engine.executor)
        return self

    def indices(self, kind: str) -> set:
        """Call indices at which faults of ``kind`` fired."""
        return {i for i, k, _ in self.log if k == kind}

    def quiesce(self, kind: str | None = None) -> None:
        """Exhaust matching rules (all of them when ``kind`` is None):
        each rule's ``max_count`` is pinned to its fired count, so it
        never fires again.  The soak driver calls this before its
        recovery phase so breaker probes deterministically succeed."""
        for r in self.rules:
            if kind is None or r.kind == kind:
                r.max_count = r.fired


def spot_check(pl, za, zb, limbs, *, use_oracle: bool = False) -> bool:
    """Does a served result match ground truth?  ``za``/``zb``: the
    request's ``(n, S)`` segments; ``limbs``: the future's ``(n, L)``
    result (tensors or arrays).  Recomputes through :func:`api.polymul`
    on the request's *original* plan, on its device (bit-exact across the
    degradation chain), or — with ``use_oracle`` — through the host
    bigint oracle, independent of every device datapath.  This is the
    detection arm of the fault harness: a ``corrupt`` rule's flipped
    limbs make it return ``False``."""
    za, zb, limbs = (host_int64(x) for x in (za, zb, limbs))
    if use_oracle:
        cfg = api.plan_key(pl)
        a_ints = bigint.limbs_to_ints(za, cfg.v)
        b_ints = bigint.limbs_to_ints(zb, cfg.v)
        ref_ints = core_polymul.oracle_multiply(a_ints, b_ints, pl.params)
        return api.from_limbs(pl, limbs) == ref_ints
    ref = api.polymul(pl, za[None].to(pl.device), zb[None].to(pl.device))[0].cpu()
    return bool(torch.equal(limbs, ref))
