"""The PyTorch port's batching engine (``repro_torch.serve``) on CPU
plans: a mixed int64 / wide / oracle stream bit-exact against
``repro.polymul`` on the same seeded inputs, and the reference's failure
semantics — padding and slots, the plan cache, requeue and typed
failure, the circuit breaker down ``cuda_fused_e2e -> cuda_fused`` and
back, deadlines, backpressure, EDF, the async dispatcher, the fallback
chain's end at ``cuda`` and the refused mesh mode.  Every wait has a
finite timeout and every started engine is stopped, so no test can hang
a worker."""
import time

import jax
import numpy as np
import pytest
import torch

import repro
from repro.serve import crypto_engine as rengine

from repro_torch import api
from repro_torch.errors import (
    BackendFailedError,
    DeadlineExceededError,
    EngineError,
    QueueFullError,
    UnservableConfigError,
)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.serve import FALLBACK_NEXT, PolymulEngine
from repro_torch.serve import crypto_engine as tengine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_polymul_jit = jax.jit(repro.polymul)  # a Plan is a pytree argument

E2E = dict(n=64, t=3, v=30, backend="cuda_fused_e2e", device="cpu")
WIDE = dict(n=32, t=4, v=45, device="cpu")
ORACLE = dict(n=32, t=2, v=50, device="cpu")


def _mk(pl, rng):
    shape = (pl.n, pl.config.seg_count)
    return (rng.integers(0, 1 << pl.v, size=shape, dtype=np.int64),
            rng.integers(0, 1 << pl.v, size=shape, dtype=np.int64))


def _alone(pl, za, zb) -> torch.Tensor:
    """The request alone through the port's front door on its plan."""
    return api.polymul(pl, torch.as_tensor(za)[None], torch.as_tensor(zb)[None])[0]


def test_mixed_stream_matches_reference():
    """Int64 (the e2e backend's plain version), wide and oracle buckets in
    one stream at 4 slots: every result equals repro.polymul of the same
    inputs, and each bucket's active backend is its own."""
    rng = np.random.default_rng(0)
    eng = PolymulEngine(batch_slots=4)
    plans = [eng.plan(**kw) for kw in (E2E, WIDE, ORACLE)]
    reqs = [(plans[i % 3], *_mk(plans[i % 3], rng)) for i in range(11)]
    outs = eng.serve(reqs)
    for pl in plans:
        cfg = pl.config
        rpl = repro.plan(n=cfg.n, t=cfg.t, v=cfg.v)
        mine = [(za, zb, o) for (p, za, zb), o in zip(reqs, outs) if p is pl]
        za = np.stack([m[0] for m in mine])
        zb = np.stack([m[1] for m in mine])
        ref = repro.polymul if cfg.width == "oracle" else _polymul_jit  # the oracle is eager
        want = np.asarray(ref(rpl, za, zb))
        got = torch.stack([m[2] for m in mine])
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cfg))
    assert sorted(eng.snapshot()["bucket_backends"].values()) == \
        ["cuda_fused_e2e", "oracle", "torch"]
    assert eng.trace_count == 3


def test_padding_slots_and_plan_cache():
    """Partial batches pad to the slots with zero rows (oracle buckets do
    not pad), one entry per config at its first dispatch, and repeated
    plan() lookups share one Plan."""
    rng = np.random.default_rng(1)
    eng = PolymulEngine(batch_slots=4)
    pl = eng.plan(**E2E)
    assert eng.plan(**E2E) is pl
    po = eng.plan(**ORACLE)
    seen = []
    raw = eng.executor

    def spy(p, za, zb):
        seen.append((api.plan_key(p).width, tuple(za.shape), za._base is zb._base))
        return raw(p, za, zb)

    eng.executor = spy
    reqs = [_mk(pl, rng) for _ in range(6)]
    futs = [eng.submit(pl, za, zb) for za, zb in reqs]
    fo = eng.submit(po, *_mk(po, rng))
    eng.run_until_idle()
    assert seen[0] == ("int64", (4, 64, pl.config.seg_count), True)
    assert ("oracle", (1, 32, po.config.seg_count), True) in seen
    snap = eng.snapshot()
    assert (snap["dispatches"], snap["padded_slots"], snap["served"]) == (3, 2, 7)
    for f, (za, zb) in zip(futs, reqs):
        assert torch.equal(f.result(timeout=5.0), _alone(pl, za, zb))
        assert f.result().shape == (pl.n, pl.config.L)
    assert fo.exception() is None
    assert eng.traced_configs == (pl.config, po.config)
    with pytest.raises(ValueError, match="expected za"):
        eng.submit(pl, np.zeros((3, 2), np.int64), np.zeros((3, 2), np.int64))


def test_failed_dispatch_requeues_then_fails_typed():
    """A dispatch that raises requeues exactly its requests (then serves
    them); once the retries are spent a request fails with
    BackendFailedError chaining the cause."""
    rng = np.random.default_rng(2)
    eng = PolymulEngine(batch_slots=4, backoff_base_s=1e-4)
    pl = eng.plan(**E2E)
    raw = eng.executor
    boom = {"left": 1}

    def flaky(p, za, zb):
        if boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("transient device fault")
        return raw(p, za, zb)

    eng.executor = flaky
    reqs = [_mk(pl, rng) for _ in range(3)]
    futs = [eng.submit(pl, za, zb) for za, zb in reqs]
    assert eng.step() == 0 and eng.pending() == 3
    assert not any(f.done() for f in futs)
    eng.run_until_idle()
    for f, (za, zb) in zip(futs, reqs):
        assert torch.equal(f.result(timeout=5.0), _alone(pl, za, zb))
    assert (eng.stats["retried"], eng.stats["dispatch_failures"]) == (3, 1)

    dead_eng = PolymulEngine(batch_slots=2, max_retries=2, breaker_threshold=100,
                             backoff_base_s=1e-4)
    pl = dead_eng.plan(**E2E)

    def dead(p, za, zb):
        raise RuntimeError("hard fault")

    dead_eng.executor = dead
    fut = dead_eng.submit(pl, *_mk(pl, rng))
    dead_eng.run_until_idle()
    exc = fut.exception(timeout=5.0)
    assert isinstance(exc, BackendFailedError) and isinstance(exc, EngineError)
    assert exc.attempts == 3 and isinstance(exc.__cause__, RuntimeError)
    assert exc.backend == "cuda_fused_e2e"
    with pytest.raises(BackendFailedError):
        fut.result(timeout=5.0)
    assert (dead_eng.stats["failed"], dead_eng.stats["served"]) == (1, 0)


def test_breaker_degrades_bit_exact_to_cuda_fused_and_recovers():
    """Consecutive e2e failures open the bucket's breaker onto cuda_fused
    (same n/t/v and device: bit-exact, counted); after a cool-down of
    milliseconds the probe restores cuda_fused_e2e."""
    rng = np.random.default_rng(3)
    eng = PolymulEngine(batch_slots=2, max_retries=6, breaker_threshold=2,
                        breaker_cooldown_s=0.01, backoff_base_s=1e-4)
    pl = eng.plan(**E2E)
    raw = eng.executor
    used = []

    def e2e_down(p, za, zb):
        used.append(api.plan_key(p).backend)
        if used[-1] == "cuda_fused_e2e":
            raise RuntimeError("fused-e2e kernel fault")
        return raw(p, za, zb)

    eng.executor = e2e_down
    za, zb = _mk(pl, rng)
    fut = eng.submit(pl, za, zb)
    eng.run_until_idle()
    snap = eng.snapshot()
    assert (snap["breaker_opened"], snap["degraded_buckets"]) == (1, 1)
    assert list(snap["bucket_backends"].values()) == ["cuda_fused"]
    assert used == ["cuda_fused_e2e", "cuda_fused_e2e", "cuda_fused"]
    assert torch.equal(fut.result(timeout=5.0), _alone(pl, za, zb))

    eng.executor = raw  # the kernel "repaired"
    time.sleep(0.02)  # past the cool-down
    za, zb = _mk(pl, rng)
    fut2 = eng.submit(pl, za, zb)
    eng.run_until_idle()
    snap = eng.snapshot()
    assert snap["probes"] >= 1 and snap["breaker_recovered"] == 1
    assert snap["degraded_buckets"] == 0
    assert list(snap["bucket_backends"].values()) == ["cuda_fused_e2e"]
    assert torch.equal(fut2.result(timeout=5.0), _alone(pl, za, zb))


def test_deadline_shedding_and_backpressure():
    """Dead-on-arrival and expired-in-queue requests resolve with
    DeadlineExceededError; a full bounded queue rejects try_submit with
    None and submit(timeout=) with QueueFullError."""
    rng = np.random.default_rng(4)
    eng = PolymulEngine(batch_slots=2)
    pl = eng.plan(**E2E)
    doa = eng.submit(pl, *_mk(pl, rng), deadline=0.0)
    assert doa.done() and isinstance(doa.exception(), DeadlineExceededError)
    assert doa.exception().request_seq is not None
    late = eng.submit(pl, *_mk(pl, rng), deadline=0.005)
    time.sleep(0.01)
    eng.step()
    assert isinstance(late.exception(timeout=5.0), DeadlineExceededError)
    assert late.exception().late_s > 0
    assert (eng.stats["shed"], eng.stats["served"]) == (2, 0)

    eng = PolymulEngine(batch_slots=2, max_pending=2)
    pl = eng.plan(**E2E)
    f1, f2 = (eng.submit(pl, *_mk(pl, rng)) for _ in range(2))
    assert eng.try_submit(pl, *_mk(pl, rng)) is None
    with pytest.raises(QueueFullError) as ei:
        eng.submit(pl, *_mk(pl, rng), timeout=0.02)
    assert (ei.value.queue_depth, ei.value.max_pending) == (2, 2)
    assert eng.stats["rejected"] == 2
    eng.run_until_idle()
    assert f1.done() and f2.done()
    assert eng.try_submit(pl, *_mk(pl, rng)) is not None
    eng.run_until_idle()


def test_edf_order_across_buckets_and_priority():
    """The tighter-deadline bucket dispatches first though the other
    arrived earlier; among equal deadlines the higher priority wins."""
    rng = np.random.default_rng(5)
    eng = PolymulEngine(batch_slots=1)
    pl_a = eng.plan(**E2E)
    pl_b = eng.plan(**WIDE)
    slow = eng.submit(pl_a, *_mk(pl_a, rng), deadline=60.0)
    fast = eng.submit(pl_b, *_mk(pl_b, rng), deadline=5.0)
    eng.step()
    assert fast.done() and not slow.done()
    eng.run_until_idle()
    lo = eng.submit(pl_a, *_mk(pl_a, rng), priority=0)
    hi = eng.submit(pl_a, *_mk(pl_a, rng), priority=5)
    eng.step()
    assert hi.done() and not lo.done()
    eng.run_until_idle()
    assert lo.exception(timeout=5.0) is None


def test_async_dispatcher_end_to_end():
    """The background dispatcher serves a mixed stream with a bounded
    queue; futures block in result(timeout=) and equal each request
    alone; stop() drains."""
    rng = np.random.default_rng(6)
    eng = PolymulEngine(batch_slots=4, max_pending=8)
    plans = [eng.plan(**E2E), eng.plan(**WIDE)]
    reqs = [(plans[i % 2], *_mk(plans[i % 2], rng)) for i in range(10)]
    try:
        eng.start()
        thread = eng._thread
        futs = [eng.submit(p, za, zb, timeout=10.0) for p, za, zb in reqs]
        outs = [f.result(timeout=30.0) for f in futs]
    finally:
        eng.stop(timeout=30.0)
    assert not eng.running and not thread.is_alive()
    for (p, za, zb), out in zip(reqs, outs):
        assert torch.equal(out, _alone(p, za, zb))
    assert eng.stats["served"] == 10 and eng.pending() == 0


def test_concurrent_submitters_conserve_requests():
    """Eight threads submit into a bounded queue while the dispatcher
    serves, with a short switch interval: every request resolves once,
    the counters conserve and each result is its own request's."""
    import sys
    import threading

    eng = PolymulEngine(batch_slots=4, max_pending=6)
    pl = eng.plan(**E2E)
    per, threads = 6, 8
    reqs = [[_mk(pl, np.random.default_rng(100 + w)) for _ in range(per)] for w in range(threads)]
    futs = [[None] * per for _ in range(threads)]

    def submitter(w):
        for i, (za, zb) in enumerate(reqs[w]):
            futs[w][i] = eng.submit(pl, za, zb, timeout=30.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        workers = [threading.Thread(target=submitter, args=(w,)) for w in range(threads)]
        for th in workers:
            th.start()
        for th in workers:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in workers)
        outs = [[f.result(timeout=60.0) for f in row] for row in futs]
    finally:
        sys.setswitchinterval(interval)
        eng.stop(timeout=60.0)
    snap = eng.snapshot()
    assert snap["served"] == snap["submitted"] == per * threads
    assert (snap["queue_depth"], snap["inflight"], snap["shed"], snap["failed"]) == (0, 0, 0, 0)
    for w in (0, threads - 1):
        for (za, zb), out in zip(reqs[w], outs[w]):
            assert torch.equal(out, _alone(pl, za, zb))


def test_fallback_chain_ends_at_cuda_and_mesh_is_refused():
    """FALLBACK_NEXT runs cuda_fused_e2e -> cuda_fused -> cuda and stops:
    no step to the plain versions; the wide and oracle widths have no
    chain; a mesh= that is not a mesh is refused with knob mesh, and in
    mesh mode a plan whose t the model axis does not divide is refused at
    submit with the reference's message."""
    assert FALLBACK_NEXT == {"cuda_fused_e2e": "cuda_fused", "cuda_fused": "cuda"}
    eng = PolymulEngine()
    chain, pl = [], eng.plan(**E2E)
    while pl is not None:
        chain.append(api.plan_key(pl).backend)
        pl = eng._fallback_plan(pl)
    assert chain == ["cuda_fused_e2e", "cuda_fused", "cuda"]
    assert eng._fallback_plan(eng.plan(**WIDE)) is None
    assert eng._fallback_plan(eng.plan(**ORACLE)) is None
    with pytest.raises(UnservableConfigError) as err:
        PolymulEngine(mesh=object())
    assert err.value.knob == "mesh"
    # a (data=1, model=2) mesh's sizes: submit reads them before any collective
    two = mesh_mod.Mesh(None, ("data", "model"), {"data": 1, "model": 2}, torch.device("cpu"))
    eng = PolymulEngine(batch_slots=2, mesh=two)
    pl = eng.plan(**E2E)
    z = np.zeros((pl.n, pl.config.seg_count), np.int64)
    with pytest.raises(ValueError) as err:
        eng.submit(pl, z, z)

    class FakeMesh:
        axis_names, shape = ("data", "model"), {"data": 1, "model": 2}

    jpl = repro.plan(pl.n, pl.t, pl.v)
    with pytest.raises(ValueError) as want:
        rengine.PolymulEngine(batch_slots=2, mesh=FakeMesh()).submit(jpl, z, z)
    assert str(err.value) == str(want.value)
    assert eng.pending() == 0


def test_path_sources_name_each_backends_kernels():
    """What engine.plan() builds and loads on a card for a plan and its
    fallbacks: the sources of the kernels each backend's polymul launches,
    one-block or multi-block by n."""
    assert ops.path_sources("cuda_fused_e2e", 4096, 6, 6, 7) == ("fused_e2e_polymul",)
    assert ops.path_sources("cuda_fused_e2e", 65536, 6, 6, 7) == ("fused_e2e_polymul_fs",)
    assert ops.path_sources("cuda_fused", 4096, 6, 6, 7) == \
        ("decompose", "fused_polymul", "compose")
    assert ops.path_sources("cuda_fused", 65536, 6, 6, 7) == \
        ("decompose", "fused_polymul_fs", "compose")
    assert ops.path_sources("cuda", 65536, 6, 6, 7) == \
        ("decompose", "ntt_channels_fs", "intt_channels_fs", "compose")
    assert ops.path_sources("torch", 4096, 6, 6, 7) == ()


def test_snapshot_contract_matches_reference():
    """The snapshot's key set, schema version and stat vocabulary are the
    reference's; a CPU engine loads no kernel at plan time."""
    assert tengine.SNAPSHOT_KEYS == rengine.SNAPSHOT_KEYS
    assert tengine.SNAPSHOT_SCHEMA_VERSION == rengine.SNAPSHOT_SCHEMA_VERSION
    eng = PolymulEngine(name="snap")
    snap = eng.snapshot()
    assert set(snap) == set(tengine.SNAPSHOT_KEYS)
    assert snap["engine"] == "snap" and snap["latency_p50_ms"] is None
