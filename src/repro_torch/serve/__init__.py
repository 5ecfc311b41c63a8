"""Serving engines: the LM slot-batching decode engine (``engine``), the
crypto polymul batching engine (shape-bucketed continuous batching over
the plan/execute API, with deadlines, backpressure, retries and a circuit
breaker) and the deterministic fault-injection harness that soaks its
failure semantics."""
from repro_torch.serve.crypto_engine import FALLBACK_NEXT, PolymulEngine, PolymulFuture
from repro_torch.serve.engine import Engine
from repro_torch.serve.faults import FaultInjector, FaultRule, InjectedFault, spot_check

__all__ = [
    "Engine",
    "FALLBACK_NEXT",
    "FaultInjector",
    "FaultRule",
    "InjectedFault",
    "PolymulEngine",
    "PolymulFuture",
    "spot_check",
]
