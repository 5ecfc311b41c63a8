"""Crypto serving launcher: synthetic mixed-preset polymul traffic
through the batching :class:`repro_torch.serve.PolymulEngine` (the port
of ``repro.launch.serve_crypto``).

    PYTHONPATH=src python -m repro_torch.launch.serve_crypto --requests 32 --slots 8

The traffic generator interleaves heterogeneous presets and draws
Poisson arrivals at ``--rate`` requests/s (0 = closed loop: everything
arrives at t = 0).  The presets default to full width on the card
(``4096:6:30,4096:4:45,65536:6:30``: the paper's two operating points and
the ring of deep circuits, 2^20 coefficients an operand at 16 slots) and
to the reference's CPU-sized ``64:3:30,64:4:45`` with ``--device cpu``.
A preset ``n:t:v@k`` adds exactly k requests of it, spread evenly through
the round robin of the others (``1024:2:50@2``: two oracle-width
requests).  Requests are bucketed by plan config and served in padded
micro-batches; the report shows throughput, latency percentiles, and per
bucket its requests/s, products/s (its requests over the seconds its
dispatches took, copies included), p50/p99 latency, dispatches and padded
slots.

Robustness knobs: ``--deadline-ms`` sheds late requests with a typed
error, ``--max-pending`` bounds the queue (backpressure), and
``--async-dispatch`` serves from the engine's background dispatcher
thread.  ``--span-log FILE`` traces every request into a JSONL span log
(inspect with ``repro_torch.launch.obs_report``); ``--json`` emits the
summary as a machine-readable record with the ``--seed`` stamped in.
``--mesh DxM`` shards every dispatch over a (data, model) mesh of the
launched ``torch.distributed`` world (:func:`build_mesh`): ``1x1`` runs on
one card (a world of one rank, NCCL) or, with ``--device cpu``, on gloo;
any other shape needs a world of D*M ranks.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import api, obs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.serve.crypto_engine import PolymulEngine, _bucket_key_str

CARD_PRESETS = "4096:6:30,4096:4:45,65536:6:30"
CPU_PRESETS = "64:3:30,64:4:45"


def parse_preset(spec: str) -> tuple[dict, int | None]:
    """'n:t:v' or 'n:t:v@k' -> (plan kwargs, fixed request count or None)."""
    body, _, count = spec.partition("@")
    try:
        n, t, v = (int(x) for x in body.split(":"))
        k = int(count) if count else None
    except ValueError as e:
        raise SystemExit(f"bad --presets entry {spec!r}: want n:t:v or n:t:v@k") from e
    return {"n": n, "t": t, "v": v}, k


def build_mesh(spec: str, device=None) -> mesh_mod.Mesh:
    """'DxM' -> a (data, model) mesh over the launched world, which must
    have D*M ranks; a world of one rank starts itself for ``1x1``."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError as e:
        raise SystemExit(f"bad --mesh {spec!r}: want DxM, e.g. 1x1") from e
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != d * m:
        raise SystemExit(
            f"--mesh {spec} needs {d * m} devices but only {world} are visible; "
            f"launch a torch.distributed world of {d * m} ranks"
        )
    return mesh_mod.make_mesh((d, m), ("data", "model"), device)


def make_traffic(plans, requests: int, rate: float, rng, fixed=()) -> list:
    """[(arrival_s, plan, za, zb)]: ``requests`` requests round-robin over
    ``plans``, then each ``(plan, k)`` of ``fixed`` inserted k times at
    evenly spaced positions, with exponential inter-arrival gaps at
    ``rate`` req/s (0 = all at t = 0).  Operands are seeded segments
    below 2^v."""
    order = [plans[i % len(plans)] for i in range(requests)]
    for pl, k in fixed:
        for j in range(k):
            order.insert((j + 1) * len(order) // (k + 1), pl)
    out, now = [], 0.0
    for pl in order:
        if rate > 0:
            now += float(rng.exponential(1.0 / rate))
        shape = (pl.n, pl.config.seg_count)
        out.append((now, pl, rng.integers(0, 1 << pl.v, size=shape),
                    rng.integers(0, 1 << pl.v, size=shape)))
    return out


def drive(eng: PolymulEngine, traffic, *, deadline_s=None) -> list:
    """Open-loop event pump: submit each request at its arrival time,
    stepping the engine whenever work is pending (with the background
    dispatcher running, submission is all this loop does).  Returns
    futures."""
    futs = []
    i = 0
    t0 = time.perf_counter()
    while i < len(traffic) or eng.pending():
        now = time.perf_counter() - t0
        while i < len(traffic) and traffic[i][0] <= now:
            _, pl, za, zb = traffic[i]
            futs.append(eng.submit(pl, za, zb, deadline=deadline_s))
            i += 1
        if eng.running:
            time.sleep(1e-3)
        elif eng.pending():
            eng.step()
        elif i < len(traffic):
            time.sleep(min(traffic[i][0] - now, 1e-3))
    if eng.running:
        eng.run_until_idle()
    return futs


class DispatchTimer:
    """Wraps ``engine.executor``: the wall seconds and rows of every
    dispatch, per bucket (what the per-bucket report reads)."""

    def __init__(self, engine: PolymulEngine):
        self.calls: dict[str, list[tuple[float, int]]] = {}
        inner = engine.executor

        def timed(pl, za, zb):
            t0 = time.perf_counter()
            out = inner(pl, za, zb)
            self.calls.setdefault(_bucket_key_str(api.plan_key(pl)), []).append(
                (time.perf_counter() - t0, int(za.shape[0])))
            return out

        engine.executor = timed

    def take(self) -> dict[str, list[tuple[float, int]]]:
        """The calls recorded so far, which are then forgotten."""
        calls, self.calls = self.calls, {}
        return calls


def bucket_report(traffic, futs, timer: DispatchTimer, wall: float) -> dict[str, dict]:
    """Per bucket: requests served, requests/s over the run's wall,
    products/s over its dispatches' seconds, p50/p99 latency (ms),
    dispatches and padded slots."""
    lat: dict[str, list[float]] = {}
    for (_, pl, _, _), f in zip(traffic, futs):
        if f.done() and f.exception() is None:
            lat.setdefault(_bucket_key_str(api.plan_key(pl)), []).append(f.latency_s * 1e3)
    out = {}
    for key, calls in timer.calls.items():
        xs = lat.get(key, [])
        busy = sum(s for s, _ in calls)
        out[key] = {
            "requests": len(xs),
            "requests_per_s": len(xs) / wall if wall else None,
            "products_per_s": len(xs) / busy if busy else None,
            "latency_p50_ms": float(np.percentile(xs, 50)) if xs else None,
            "latency_p99_ms": float(np.percentile(xs, 99)) if xs else None,
            "dispatches": len(calls),
            "padded_slots": sum(rows for _, rows in calls) - len(xs),
        }
    return out


def run(*, presets: str | None = None, requests: int = 32, slots: int = 8, rate: float = 0.0,
        seed: int = 0, deadline_ms: float = 0.0, max_pending: int = 0,
        async_dispatch: bool = False, span_log: str | None = None, device=None,
        donate: bool = False, mesh=None) -> dict:
    """Warm every preset with one padded dispatch, then serve the seeded
    traffic; returns the engine, its plans, the traffic, the futures, the
    wall seconds, the per-bucket report and the warm-up's dispatches per
    bucket (``warm_dispatches``).  ``mesh`` serves every dispatch sharded
    (:func:`repro_torch.serve.crypto_engine.polymul_sharded`)."""
    if presets is None:
        card = device is None and torch.cuda.is_available()
        presets = CARD_PRESETS if card else CPU_PRESETS
    log = obs.SpanLog(span_log) if span_log else None
    eng = PolymulEngine(batch_slots=slots, donate=donate, max_pending=max_pending or None,
                        span_log=log, mesh=mesh)
    rr, fixed = [], []
    for spec in presets.split(","):
        kw, k = parse_preset(spec)
        pl = eng.plan(**kw, device=device)
        if k is None:
            rr.append(pl)
        else:
            fixed.append((pl, k))
    rng = np.random.default_rng(seed)

    # warm: one padded dispatch per distinct config, so the timed run
    # measures serving, not first-use costs
    timer = DispatchTimer(eng)
    for pl in rr + [pl for pl, _ in fixed]:
        shape = (pl.n, pl.config.seg_count)
        eng.submit(pl, np.zeros(shape, np.int64), np.zeros(shape, np.int64))
    eng.run_until_idle()
    eng.reset_stats()
    warm = {key: len(calls) for key, calls in timer.take().items()}

    if async_dispatch:
        eng.start()
    traffic = make_traffic(rr, requests, rate, rng, fixed)
    deadline_s = deadline_ms / 1e3 if deadline_ms > 0 else None
    t0 = time.perf_counter()
    try:
        futs = drive(eng, traffic, deadline_s=deadline_s)
        wall = time.perf_counter() - t0
    finally:
        if async_dispatch:
            eng.stop()
    if log is not None:
        log.flush()
    return {"engine": eng, "plans": rr + [pl for pl, _ in fixed], "traffic": traffic,
            "futures": futs, "wall_s": wall, "buckets": bucket_report(traffic, futs, timer, wall),
            "warm_dispatches": warm, "presets": presets}


def _num(x: float | None) -> str:
    return "-" if x is None else f"{x:.2f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8, help="fixed batch slots per dispatch")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s (0 = closed loop)")
    ap.add_argument("--presets", default=None,
                    help=f"comma-separated n:t:v[@k] presets, interleaved (default "
                         f"{CARD_PRESETS} on the card, {CPU_PRESETS} with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="plan device (default: the card; 'cpu' runs the plain datapaths)")
    ap.add_argument("--mesh", default="",
                    help="'DxM' (data x model) mesh over the launched world, e.g. 1x1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--donate", action="store_true",
                    help="accepted for the reference's command lines; changes nothing")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline; late requests are shed with "
                         "DeadlineExceededError (0 = none)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="bound the submission queue (0 = unbounded); submit then blocks")
    ap.add_argument("--async-dispatch", action="store_true",
                    help="serve from the background dispatcher thread instead of stepping inline")
    ap.add_argument("--span-log", default=None, metavar="FILE",
                    help="trace every request into this JSONL span log")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as a JSON record (seed stamped in) instead of text")
    args = ap.parse_args(argv)
    mesh = build_mesh(args.mesh, args.device) if args.mesh else None
    try:
        rec = run(presets=args.presets, requests=args.requests, slots=args.slots,
                  rate=args.rate, seed=args.seed, deadline_ms=args.deadline_ms,
                  max_pending=args.max_pending, async_dispatch=args.async_dispatch,
                  span_log=args.span_log, device=args.device, donate=args.donate, mesh=mesh)
    finally:
        if mesh is not None:
            mesh.close()
    eng, futs, wall = rec["engine"], rec["futures"], rec["wall_s"]
    snap = eng.snapshot()
    ok = [f for f in futs if f.exception() is None]
    served = snap["served"]
    lat = np.array([f.latency_s for f in ok]) * 1e3
    if args.json:
        print(json.dumps({
            "mesh": dict(mesh.shape) if mesh is not None else None,
            "seed": args.seed,
            "requests": len(futs),
            "rate_rps": args.rate,
            "presets": rec["presets"],
            "wall_s": wall,
            "served_rps": served / wall,
            "goodput_rps": len(ok) / wall,
            "latency_p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "latency_p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            "configs_dispatched": eng.trace_count,
            "buckets": rec["buckets"],
            "span_log": args.span_log,
            "snapshot": snap,
        }, indent=1))
        return 0
    print(f"served {served}/{len(futs)} requests in {wall:.3f}s "
          f"({served / wall:.1f} req/s, goodput {len(ok) / wall:.1f} req/s) [seed={args.seed}]")
    if ok:
        print(f"latency p50={np.percentile(lat, 50):.2f}ms p99={np.percentile(lat, 99):.2f}ms")
    print(f"dispatches={snap['dispatches']} padded_slots={snap['padded_slots']} "
          f"configs={eng.trace_count} buckets={len(rec['buckets'])}")
    for key, b in rec["buckets"].items():
        print(f"bucket {key}: {b['requests']} requests, {_num(b['requests_per_s'])} req/s, "
              f"{_num(b['products_per_s'])} products/s while dispatching, "
              f"p50={_num(b['latency_p50_ms'])}ms p99={_num(b['latency_p99_ms'])}ms, "
              f"dispatches={b['dispatches']} padded_slots={b['padded_slots']}")
    print(f"shed={snap['shed']} retried={snap['retried']} failed={snap['failed']} "
          f"rejected={snap['rejected']} dispatch_failures={snap['dispatch_failures']} "
          f"breaker_opened={snap['breaker_opened']} "
          f"breaker_recovered={snap['breaker_recovered']}")
    if mesh is not None:
        print(f"mesh axes={dict(mesh.shape)}")
    if args.span_log:
        print(f"span log: {args.span_log}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
