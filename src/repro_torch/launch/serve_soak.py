"""Fault-injected soak of the serving engine (the port of
``repro.launch.serve_soak``).

    PYTHONPATH=src python -m repro_torch.launch.serve_soak --ci-smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_soak --device cpu --requests 120

Drives >= 500 mixed-config requests through an async
:class:`repro_torch.serve.PolymulEngine` while a seeded
:class:`repro_torch.serve.FaultInjector` raises, delays, and corrupts
on a schedule, then checks the engine's robustness contract as hard
gates rather than vibes:

* **Exactly-once resolution.**  Every submitted future ends DONE or
  FAILED (typed ``EngineError``), none PENDING, and the counters
  conserve: ``served + shed + failed == submitted`` with empty queue
  and zero in-flight.  (Double resolution is impossible by
  construction — a second transition raises inside the engine and
  would surface as a dispatcher-loop error here.)
* **Breaker round-trip.**  A pinned burst of raises on the
  ``cuda_fused_e2e`` bucket forces its circuit breaker open
  (degrading to ``cuda_fused``); after the injector is quiesced and the
  cool-down elapses, a recovery phase observes the probe restore the
  original backend (``breaker_opened/recovered/probes >= 1``).
* **Corruption is detected, not survived.**  ``corrupt`` faults flip
  the low limb bit after execution — the engine sees a success.  The
  injector's log is joined against each future's ``dispatch_index``
  stamp: every corrupted-dispatch result must FAIL the
  :func:`repro_torch.serve.spot_check`, and sampled clean results
  must pass it (plus a small host-bigint-oracle subsample, independent
  of every device datapath).
* **Post-fault bit-exactness.**  Clean results are compared against
  ``api.polymul`` on the request's original plan — degraded dispatches
  included, since the fallback chain re-plans with the same n/t/v.
* **Span conservation** (with ``--span-log``): every admitted request
  leaves exactly ONE terminal span (resolved/shed/failed) in the JSONL
  log, and the span statuses agree with the engine counters;
  ``launch/obs_report.py --check`` re-audits the written log.

The configurations (:func:`configs`): on the card the paper's point on
the fused e2e kernel, ``(4096, 6, 30, "cuda_fused_e2e")``, the top of
the degradation chain, and the wide ``(4096, 4, 45)``; on the CPU
(``--device cpu``) the reference's ``n = 64``.  ``--ci-smoke`` (520
requests) merges a ``"serve_soak"`` record (shed rate, retries, breaker
counts, p99, seed) and an ``"obs"`` record (the metrics-registry dump)
into the JSON file ``--out`` names, and writes no file without it;
``--prom-out`` writes the registry in Prometheus text format.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import api, obs
from repro_torch.errors import EngineError
from repro_torch.serve.crypto_engine import PolymulEngine, PolymulFuture
from repro_torch.serve.faults import FaultInjector, FaultRule, spot_check

# The two operating points of the soak on the card: the paper's point on
# the fused e2e kernel (the degradation chain's top) and the wide
# digit-split datapath (plain PyTorch, no chain: mixed buckets).
CONFIGS = (
    {"n": 4096, "t": 6, "v": 30, "backend": "cuda_fused_e2e"},
    {"n": 4096, "t": 4, "v": 45},
)
# On the CPU, the reference's sizes.
CPU_CONFIGS = (
    {"n": 64, "t": 3, "v": 30, "backend": "cuda_fused_e2e"},
    {"n": 64, "t": 4, "v": 45},
)


def configs(device=None) -> tuple[dict, ...]:
    """The soak's plan kwargs on ``device`` (None: the card)."""
    if device is not None and torch.device(device).type == "cpu":
        return tuple(dict(c, device="cpu") for c in CPU_CONFIGS)
    return tuple(dict(c, device=device) for c in CONFIGS)


def default_rules(breaker_threshold: int) -> list[FaultRule]:
    """The soak schedule: a pinned raise burst that trips the e2e
    bucket's breaker, background transient raises/delays, and silent
    corruptions (one pinned so detection always has work to do)."""
    return [
        # A raise beats a corrupt on the same call, so the pinned
        # corruption window sits past the raise burst and spans several
        # calls — the gate needs >= 1 corruption deterministically.
        FaultRule("raise", backend="cuda_fused_e2e",
                  max_count=breaker_threshold),
        FaultRule("raise", rate=0.02, after=breaker_threshold + 10,
                  max_count=6),
        FaultRule("delay", rate=0.05, delay_s=0.005, max_count=20),
        FaultRule("corrupt", rate=1.0, after=breaker_threshold + 4,
                  until=breaker_threshold + 8, max_count=2),
        FaultRule("corrupt", rate=0.01, after=breaker_threshold + 8,
                  max_count=6),
    ]


def run_soak(*, requests: int = 520, seed: int = 0, batch_slots: int = 8,
             max_pending: int = 64, breaker_threshold: int = 2,
             breaker_cooldown_s: float = 0.25,
             oracle_samples: int = 3, clean_samples: int = 32,
             rules: list[FaultRule] | None = None,
             span_log_path: str | None = None, device=None) -> dict:
    """Run the fault-injected soak on ``device`` (None: the card; see
    :func:`configs`); returns the gate record (its ``failures`` list is
    empty on success).  With ``span_log_path``, every request is traced
    and the full lifecycle log is written as JSONL there, with span
    conservation audited as an extra gate."""
    rng = np.random.default_rng(seed)
    span_log = (
        obs.SpanLog(span_log_path) if span_log_path is not None else None
    )
    eng = PolymulEngine(
        batch_slots=batch_slots, max_pending=max_pending,
        max_retries=6, breaker_threshold=breaker_threshold,
        breaker_cooldown_s=breaker_cooldown_s, backoff_base_s=0.002,
        span_log=span_log,
    )
    cfgs = configs(device)
    plans = [eng.plan(**c) for c in cfgs]

    # The injector installs before ANY dispatch, so its call counter and
    # the engine's dispatch_index stamps advance in lock-step — the
    # corruption join below depends on that 1:1 alignment.  First-use costs
    # therefore happen inside the faulted run; the soak deadlines are
    # sized to absorb them.
    inj = FaultInjector(
        rules if rules is not None else default_rules(breaker_threshold),
        seed=seed,
    )
    inj.install(eng)

    t0 = time.perf_counter()
    entries = []  # (plan, za, zb, future, doa)
    with eng:
        for i in range(requests):
            pl = plans[i % len(plans)]
            shape = (pl.n, pl.config.seg_count)
            za = rng.integers(0, 1 << pl.v, size=shape)
            zb = rng.integers(0, 1 << pl.v, size=shape)
            doa = i % 97 == 13  # sprinkle guaranteed-shed requests
            fut = eng.submit(
                pl, za, zb,
                deadline=0.0 if doa else 60.0,
                priority=int(rng.integers(0, 3)),
                timeout=60.0,
            )
            entries.append((pl, za, zb, fut, doa))
        eng.run_until_idle()

        # Recovery phase: silence every raise rule, let the cool-down
        # elapse, and give each bucket traffic so probes fire.
        inj.quiesce("raise")
        time.sleep(breaker_cooldown_s + 0.05)
        for pl in plans:
            shape = (pl.n, pl.config.seg_count)
            za = rng.integers(0, 1 << pl.v, size=shape)
            zb = rng.integers(0, 1 << pl.v, size=shape)
            entries.append((pl, za, zb, eng.submit(pl, za, zb), False))
        eng.run_until_idle()
    wall = time.perf_counter() - t0
    snap = eng.snapshot()

    failures: list[str] = []

    # -- exactly-once / conservation ----------------------------------
    pending = [e for e in entries if not e[3].done()]
    if pending:
        failures.append(f"{len(pending)} futures still PENDING after drain")
    for pl, _, _, fut, _ in entries:
        if fut.done() and fut.state == PolymulFuture.FAILED:
            exc = fut.exception()
            if not isinstance(exc, EngineError):
                failures.append(
                    f"future failed with untyped {type(exc).__name__}: {exc}"
                )
                break
    conserved = (
        snap["served"] + snap["shed"] + snap["failed"] == snap["submitted"]
        and snap["queue_depth"] == 0
        and snap["inflight"] == 0
    )
    if not conserved:
        failures.append(
            f"request conservation violated: served {snap['served']} + "
            f"shed {snap['shed']} + failed {snap['failed']} != submitted "
            f"{snap['submitted']} (queue {snap['queue_depth']}, inflight "
            f"{snap['inflight']})"
        )
    doa_ok = all(
        fut.done() and isinstance(fut.exception(), EngineError)
        for _, _, _, fut, doa in entries if doa
    )
    if not doa_ok:
        failures.append("a dead-on-arrival request was not shed typed")

    # -- breaker round-trip -------------------------------------------
    for key in ("breaker_opened", "breaker_recovered", "probes"):
        if snap[key] < 1:
            failures.append(f"expected {key} >= 1, got {snap[key]}")
    still_degraded = snap["degraded_buckets"]
    if still_degraded:
        failures.append(
            f"{still_degraded} bucket(s) still degraded after recovery "
            f"phase: {snap['bucket_backends']}"
        )

    # -- corruption detection -----------------------------------------
    corrupt_idx = inj.indices("corrupt")
    done = [e for e in entries if e[3].state == PolymulFuture.DONE]
    corrupted = [e for e in done if e[3].dispatch_index in corrupt_idx]
    clean = [e for e in done if e[3].dispatch_index not in corrupt_idx]
    if not corrupt_idx:
        failures.append("no corruption was injected — schedule too light")
    if not corrupted:
        failures.append(
            f"corruptions fired at dispatches {sorted(corrupt_idx)} but "
            f"no served future maps to them — dispatch_index join broken"
        )
    for pl, za, zb, fut, _ in corrupted:
        if spot_check(pl, za, zb, fut.result()):
            failures.append(
                f"corrupted dispatch {fut.dispatch_index} passed the "
                f"spot check — detection arm is blind"
            )
            break
    # -- post-fault bit-exactness of clean results --------------------
    sample = [clean[i] for i in
              rng.choice(len(clean), size=min(clean_samples, len(clean)),
                         replace=False)] if clean else []
    for pl, za, zb, fut, _ in sample:
        if not spot_check(pl, za, zb, fut.result()):
            failures.append(
                f"clean result (dispatch {fut.dispatch_index}, backend "
                f"chain of {api.plan_key(pl).backend}) is NOT bit-exact "
                f"vs api.polymul"
            )
            break
    for pl, za, zb, fut, _ in sample[:oracle_samples]:
        if not spot_check(pl, za, zb, fut.result(), use_oracle=True):
            failures.append(
                f"clean result (dispatch {fut.dispatch_index}) fails the "
                f"host bigint oracle"
            )
            break

    # -- span conservation (tracing enabled) --------------------------
    span_summary = None
    if span_log is not None:
        cons = obs.conservation(span_log.records)
        span_summary = {
            "spans": cons["spans"],
            "admitted": cons["admitted"],
            "by_status": cons["by_status"],
            "violations": cons["violations"],
        }
        failures.extend(cons["violations"])
        # span statuses must agree with the engine's own counters —
        # a span leak would let the log and the registry drift apart
        for status, key in (("resolved", "served"), ("shed", "shed"),
                            ("failed", "failed")):
            got = cons["by_status"].get(status, 0)
            if got != snap[key]:
                failures.append(
                    f"span log has {got} {status!r} spans but the engine "
                    f"counted {key}={snap[key]}"
                )
        if cons["admitted"] != snap["submitted"]:
            failures.append(
                f"span log has {cons['admitted']} admitted spans but "
                f"submitted={snap['submitted']}"
            )
        span_log.flush()

    record = {
        "requests": len(entries),
        "seed": seed,
        "configs": len(cfgs),
        "plans": [_key(pl) for pl in plans],
        "wall_s": round(wall, 3),
        "goodput_rps": round(snap["served"] / wall, 1),
        "served": snap["served"],
        "shed": snap["shed"],
        "failed": snap["failed"],
        "shed_rate": round(snap["shed"] / max(snap["submitted"], 1), 4),
        "retried": snap["retried"],
        "dispatch_failures": snap["dispatch_failures"],
        "rejected": snap["rejected"],
        "breaker_opened": snap["breaker_opened"],
        "breaker_recovered": snap["breaker_recovered"],
        "probes": snap["probes"],
        "faults": {
            "raised": len(inj.indices("raise")),
            "delayed": len(inj.indices("delay")),
            "corrupted": len(corrupt_idx),
            "corrupted_futures": len(corrupted),
        },
        "latency_p50_ms": snap["latency_p50_ms"],
        "latency_p99_ms": snap["latency_p99_ms"],
        "span_conservation": span_summary,
        "failures": failures,
    }
    return record


def _key(pl) -> str:
    cfg = api.plan_key(pl)
    return f"n{cfg.n}_t{cfg.t}_v{cfg.v}_{cfg.backend}_{cfg.device}"


def merge_record(out_path: str, record: dict) -> None:
    """Merge the ``serve_soak`` record into the JSON file at
    ``out_path``, plus an ``obs`` record: the metrics-registry dump, so
    the file carries the same numbers an exporter would scrape."""
    doc = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            doc = json.load(f)
    doc["serve_soak"] = record
    doc["obs"] = obs.to_json()
    doc["failures"] = doc.get("failures", []) + record["failures"]
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ci-smoke", action="store_true",
                    help="520 requests; merge the record into --out (if named); "
                         "exit non-zero on any contract violation")
    ap.add_argument("--requests", type=int, default=520)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds traffic, priorities, AND the fault "
                         "schedule; stamped into the output record")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="JSON file to merge the 'serve_soak' record into "
                         "(--ci-smoke only; no file is written without it)")
    ap.add_argument("--device", default=None,
                    help="plan device (default: the card; 'cpu' runs the reference's n = 64)")
    ap.add_argument("--span-log", default=None, metavar="FILE",
                    help="trace every request into this JSONL span log "
                         "and audit span conservation as a gate")
    ap.add_argument("--prom-out", default=None, metavar="FILE",
                    help="write the metrics registry in Prometheus text "
                         "format after the run")
    args = ap.parse_args(argv)

    record = run_soak(requests=args.requests, seed=args.seed,
                      batch_slots=args.slots, span_log_path=args.span_log,
                      device=args.device)
    print(json.dumps(record, indent=1))
    if args.prom_out is not None:
        with open(args.prom_out, "w") as f:
            f.write(obs.to_prometheus())
    if args.ci_smoke and args.out is not None:
        merge_record(args.out, record)
    for msg in record["failures"]:
        print(f"[FAIL] {msg}", file=sys.stderr)
    return 1 if record["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
