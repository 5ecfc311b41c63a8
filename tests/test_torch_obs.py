"""The PyTorch port's observability (``repro_torch.obs``) and its
launchers: the metrics registry and the histogram quantile contract on
fixed series, the Prometheus exposition equal to the reference's for the
same observations and round-tripped through the strict parser, span
conservation of an engine run with ``obs_report --check`` on the written
log, ``serve_crypto`` on CPU plans, and ``run_soak`` at a small request
count on CPU meeting every gate."""
import json
import math

import numpy as np
import pytest

from repro import obs as robs

from repro_torch import obs
from repro_torch.launch import obs_report, serve_crypto, serve_soak
from repro_torch.serve import PolymulEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _observe(reg):
    """The same observations through either package's registry."""
    c = reg.counter("repro_engine_served_total", "served", ("engine",))
    c.labels(engine="a").inc(3)
    c.labels(engine='b"\\').inc()
    g = reg.gauge("repro_engine_queue_depth", "queued", ("engine",))
    g.labels(engine="a").set(7)
    g.labels(engine="a").dec(2)
    h = reg.histogram("repro_engine_latency_seconds", "latency", ("engine",))
    for x in (1e-7, 3e-4, 0.002, 0.002, 0.5, 100.0):
        h.labels(engine="a").observe(x)
    return c, g, h


def test_registry_families_children_and_conflicts():
    """Counters only go up, gauges move both ways, re-registration returns
    the same family, a conflicting one raises, labels are checked."""
    reg = obs.MetricsRegistry()
    c, g, h = _observe(reg)
    assert reg.counter("repro_engine_served_total", "", ("engine",)) is c
    assert c.labels(engine="a").value == 3
    assert g.labels(engine="a").value == 5
    with pytest.raises(ValueError):
        c.labels(engine="a").inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("repro_engine_served_total", "", ("engine",))
    with pytest.raises(ValueError):
        c.labels(bucket="x")
    with pytest.raises(ValueError):
        reg.counter("9bad")
    reg.reset()
    assert c.labels(engine="a").value == 0 and h.labels(engine="a").count == 0
    assert [m.name for m in reg.metrics()] == sorted(m.name for m in reg.metrics())


def test_histogram_quantile_contract_on_fixed_series():
    """exact / GROWTH - lo <= quantile(q) <= exact * GROWTH + lo against
    numpy.percentile, on fixed latency- and queue-wait-shaped series (not
    a property search), and where the exact quantile falls between two
    distant observations (the reference's estimate misses it there)."""
    rng = np.random.default_rng(7)
    series = [
        rng.lognormal(np.log(2e-3), 0.6, 2000),  # dispatch latencies
        rng.exponential(5e-4, 2000),  # queue waits
        np.full(100, 0.25),  # one bucket only
        np.array([3e-6, 3e-6, 9.0]),  # tiny sample, wide spread
    ]
    lo = obs.default_buckets()[0]
    for xs in series:
        h = obs.MetricsRegistry().histogram("repro_x_seconds")
        for x in xs:
            h.observe(float(x))
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            est = h.quantile(q)
            exact = float(np.percentile(xs, 100 * q))
            assert exact / obs.HIST_GROWTH - lo <= est <= exact * obs.HIST_GROWTH + lo, (q, est)
    assert obs.MetricsRegistry().histogram("repro_empty_seconds").quantile(0.5) is None
    assert obs.HIST_GROWTH == math.sqrt(2.0) == robs.HIST_GROWTH
    assert obs.default_buckets() == robs.default_buckets()


def test_prometheus_equals_reference_and_round_trips():
    """The same observations render the same Prometheus text in both
    packages; the strict parser reads it back (cumulative buckets, +Inf,
    _sum and _count) and refuses a broken exposition; to_json carries the
    histogram's p50/p99."""
    reg, rreg = obs.MetricsRegistry(), robs.MetricsRegistry()
    _observe(reg)
    _observe(rreg)
    text = obs.to_prometheus(reg)
    assert text == robs.to_prometheus(rreg)
    fams = obs.parse_prometheus(text)
    assert fams["repro_engine_latency_seconds"]["type"] == "histogram"
    served = {s[1]["engine"]: s[2] for s in fams["repro_engine_served_total"]["samples"]}
    assert served == {"a": 3.0, 'b\\"\\\\': 1.0}  # label values as escaped on the wire
    broken = text.replace('le="+Inf"', 'le="1e9"')
    with pytest.raises(ValueError, match="Inf"):
        obs.parse_prometheus(broken)
    doc = obs.to_json(reg)
    hist = next(f for f in doc["families"] if f["name"] == "repro_engine_latency_seconds")
    assert hist["series"][0]["count"] == 6 and hist["series"][0]["p50"] is not None
    assert json.loads(json.dumps(doc)) == doc


def test_engine_span_conservation_and_obs_report_check(tmp_path):
    """A traced engine run (served, shed, rejected) leaves one terminal
    span per admitted request, agreeing with the counters;
    obs_report --check passes on the written log and fails on a log with a
    request left open."""
    path = tmp_path / "spans.jsonl"
    log = obs.SpanLog(path)
    eng = PolymulEngine(batch_slots=2, max_pending=3, span_log=log,
                        registry=obs.MetricsRegistry())
    pl = eng.plan(64, 3, 30, device="cpu")
    rng = np.random.default_rng(0)
    z = lambda: rng.integers(0, 1 << 30, size=(64, pl.config.seg_count))  # noqa: E731
    futs = [eng.submit(pl, z(), z()) for _ in range(2)]
    futs.append(eng.submit(pl, z(), z(), deadline=0.0))  # shed on arrival
    futs.append(eng.submit(pl, z(), z()))
    assert eng.try_submit(pl, z(), z()) is None  # rejected: queue full
    eng.run_until_idle()
    assert all(f.trace_id for f in futs)
    log.flush()
    cons = obs.conservation(obs.read_jsonl(path))
    assert cons["violations"] == []
    assert cons["by_status"] == {"resolved": 3, "shed": 1, "rejected": 1}
    snap = eng.snapshot()
    assert (snap["served"], snap["shed"], snap["rejected"]) == (3, 1, 1)
    assert obs_report.main([str(path), "--check"]) == 0
    rec = json.loads(path.read_text().splitlines()[0])
    rec["status"] = "queued"  # never closed
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(rec) + "\n")
    assert obs_report.main([str(bad), "--check"]) == 1
    prom = tmp_path / "m.prom"
    prom.write_text(obs.to_prometheus(eng._registry))
    assert obs_report.main(["--prom", str(prom)]) == 0
    with pytest.raises(SystemExit):  # nothing to report
        obs_report.main([])


def test_serve_crypto_on_cpu_plans(capsys):
    """serve_crypto's closed loop on CPU plans with an oracle preset of
    fixed count: every request served, the per-bucket report's counts
    add up, and --mesh 2x2 in a world of one rank exits with the
    reference's "needs 4 devices" message."""
    rec = serve_crypto.run(presets="64:3:30,32:4:45,32:2:50@2", requests=10, slots=4,
                           device="cpu")
    futs = rec["futures"]
    assert len(futs) == 12 and all(f.exception(timeout=5.0) is None for f in futs)
    b = rec["buckets"]
    assert sum(x["requests"] for x in b.values()) == 12
    assert b["n32_t2_v50_oracle"]["requests"] == 2
    assert b["n64_t3_v30_torch"]["padded_slots"] == 3  # 5 requests in 2 dispatches of 4
    assert serve_crypto.main(["--device", "cpu", "--requests", "4", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["snapshot"]["served"] == 4
    with pytest.raises(SystemExit, match="--mesh 2x2 needs 4 devices but only 1 are visible"):
        serve_crypto.main(["--mesh", "2x2"])


def test_run_soak_on_cpu_meets_its_gates(tmp_path):
    """The fault-injected soak at n = 64 on CPU plans, 120 requests: its
    failures list is empty (exactly-once resolution, the breaker's round
    trip through cuda_fused, corruption detected, clean results bit-exact,
    span conservation), and obs_report --check passes on its log."""
    path = tmp_path / "soak.jsonl"
    rec = serve_soak.run_soak(requests=120, span_log_path=str(path), device="cpu")
    assert rec["failures"] == []
    assert rec["plans"] == ["n64_t3_v30_cuda_fused_e2e_cpu", "n64_t4_v45_torch_cpu"]
    assert rec["breaker_opened"] >= 1 and rec["breaker_recovered"] >= 1
    assert rec["faults"]["corrupted_futures"] >= 1
    assert obs_report.main([str(path), "--check"]) == 0
