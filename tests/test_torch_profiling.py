"""The port's traffic and work model (``repro_torch.kernels.cost``, re-exported
by ``kernels.ops``) and its per-stage profiler (``repro_torch.obs.profiling``,
``obs_report --stages``): the moved operation counts reproduce the
``kernels`` line's bounds at PERF.md's shapes, ``count_launches`` equals the
model's ``kernel_launches`` and ``predicted_stage_bytes`` its
``hbm_bytes`` on every backend and path (K2, K2-fs, the one-block and the
multi-block kernels), ``transform_cost_model``'s structural keys equal the
reference's at n = 64 ... 8192, and ``stage_timings`` returns the
reference's keys and gauges on a CPU plan.

    python -m pytest -q tests/test_torch_profiling.py
"""
import json

import pytest

import repro
from repro import obs as robs
from repro.core.params import make_params as ref_make_params
from repro.kernels import ops as ref_ops

import repro_torch
from repro_torch import obs
from repro_torch.core.params import make_params
from repro_torch.kernels import cost, ops
from repro_torch.kernels import ntt as kern
from repro_torch.launch import obs_report

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# PERF.md §6's bound_ms (ms, 4 decimals) at the kernels line's shapes:
# K1, K3, K4 (6, 256, 4096), K2 (256, 4096, 6), K5 and K6 2^20
# coefficients at t = 6; v = 30
MAIN_BOUNDS = {"fused_polymul": (0.0451, "bytes"), "fused_e2e_polymul": (0.0558, "operations"),
               "ntt_channels": (0.0300, "bytes"), "intt_channels": (0.0300, "bytes"),
               "decompose": (0.0300, "bytes"), "compose": (0.0326, "bytes")}


def test_moved_counts_reproduce_the_kernels_line_bounds():
    """The counts chip_smoke now imports give PERF.md §6's bounds: K1-K6 at
    the paper's point on 256 rows, and K2-fs at (16, 65536, 6), 0.0652 by
    operations and 0.0927 by bytes with its 32-bit words (n = 65536 shares
    t, S, L, t' and the reduction regime with n = 4096 at v = 30, so its
    counts come from the 4096 plan's shape and no 65536 plan is built)."""
    p = repro_torch.plan(4096, 6, 30, device="cpu").params
    for name, (nbytes, ops_) in cost.work(p, 256).items():
        ms, by = cost.bound(nbytes, ops_)
        assert (round(ms, 4), by) == MAIN_BOUNDS[name], name
    n, t, S, L, t_prime, mode, window = cost._shape(p, "test")
    rows = 16
    ops_ = cost.e2e_ops(65536, t, S, L, t_prime, mode, window, rows)
    least = (2 * S + L) * rows * 65536 * 8
    assert round(cost.bound(least, ops_)[0], 4) == 0.0652
    assert cost.bound(least, ops_)[1] == "operations"
    words = 6 * t * rows * 65536 * 4  # the model's K2-fs intermediate bytes
    assert cost.bound(least + words, ops_) == (pytest.approx(0.0927, abs=5e-5), "bytes")
    # the counts' butterflies, in every regime, as the earlier formulas gave them
    assert [cost._butterfly_ops(*m) for m in ((0, 4), (0, 2), (1, 0), (2, 0))] == [
        (11, 22), (14, 22), (23, 31), (19, 27)]
    # re-exported where the reference keeps them
    assert ops.hbm_traffic_model is cost.hbm_traffic_model
    assert ops.count_launches is cost.count_launches


# backend, n, t, the path's kernels, and the one-block predicates the
# dispatch reads switched off (the multi-block kernels at a CPU-sized n)
PATHS = [
    ("torch", 64, 3, {}, False),
    ("cuda", 64, 3, {"decompose": 2, "ntt_channels": 2, "intt_channels": 1, "compose": 1}, False),
    ("cuda", 64, 3, {"decompose": 2, "ntt_channels_fs": 2, "intt_channels_fs": 1,
                     "compose": 1}, True),
    ("cuda_fused", 64, 3, {"decompose": 2, "fused_polymul": 1, "compose": 1}, False),
    ("cuda_fused", 64, 3, {"decompose": 2, "fused_polymul_fs": 1, "compose": 1}, True),
    ("cuda_fused_e2e", 64, 3, {"fused_e2e_polymul": 1}, False),
    # the smallest n and t at v = 30 where K2's CTA does not hold the plan
    ("cuda_fused_e2e", 4096, 49, {"fused_e2e_polymul_fs": 1}, False),
]


def test_launch_counts_and_stage_bytes_match_the_model(monkeypatch):
    """On every backend and path: the wrappers one fused_polymul_e2e calls
    (counted on the CPU) are path_launches, count_launches equals
    hbm_traffic_model's kernel_launches (K2-fs's three a call), the bytes
    add up, and predicted_stage_bytes sums to the model's total (the e2e
    plans on cuda_fused's attribution, as the reference's)."""
    for backend, n, t, want, multi in PATHS:
        p = make_params(n, t, 30, "cpu")
        with monkeypatch.context() as m:
            if multi:
                m.setattr(kern, "cascade_fits", lambda n: False)
                m.setattr(kern, "stage_fits", lambda n: False)
            rp = p.plan
            model = ops.hbm_traffic_model(p, 2, backend)
            assert cost.path_launches(backend, n, t, rp.seg_count, rp.L) == want
            assert ops.wrapper_calls(p, backend) == want, (backend, n, t)
            assert ops.count_launches(p, backend) == model["kernel_launches"]
        assert model["kernel_launches"] == cost.launches_of(want)
        assert model["hbm_bytes"] == (model["segment_bytes_in"] + model["intermediate_bytes"]
                                      + model["limb_bytes_out"])
        res = t * 2 * n * 8
        between = {"torch": 12 * res, "cuda": 12 * res, "cuda_fused": 6 * res,
                   "cuda_fused_e2e": 0 if n == 64 else 3 * res}[backend]
        assert model["intermediate_bytes"] == between
        pl = repro_torch.plan(n, t, 30, backend=backend, device="cpu")
        stages = obs.predicted_stage_bytes(pl, 2)
        view = "cuda_fused" if backend == "cuda_fused_e2e" else backend
        assert sum(stages.values()) == ops.hbm_traffic_model(p, 2, view)["hbm_bytes"]
        assert tuple(stages) == obs.STAGES
    assert ops.hbm_traffic_model(make_params(64, 3, 30, "cpu"), 2)["backend"] == "torch"
    with pytest.raises(ValueError, match="int64"):
        ops.hbm_traffic_model(make_params(32, 4, 45, "cpu"), 2, "torch")


STRUCTURAL = ("schedule", "depth", "splits", "stages", "lane_strides", "sublane_stages",
              "vmem_transposes")


def test_transform_cost_model_structure_equals_reference():
    """The structural keys equal the reference's at n = 64 ... 8192 for
    every schedule and direction, in the three regimes; reduction_ops
    (the port's count from its butterflies) equals the reference's in the
    lazy regimes, and in the strict one counts the block Barrett's two
    selects where the reference's Barrett has three."""
    for v in (29, 30, 31):
        for log_n in range(6, 14):
            n = 1 << log_n
            p, rp = make_params(n, 1, v, "cpu"), ref_make_params(n=n, t=1, v=v)
            for sched in ("radix2", "four_step") + (("four_step:h",) if n >= 8192 else ()):
                for d in ("fwd", "inv"):
                    got = ops.transform_cost_model(p, schedule=sched, direction=d)
                    want = ref_ops.transform_cost_model(rp, schedule=sched, direction=d)
                    assert {k: got[k] for k in STRUCTURAL} == {k: want[k] for k in STRUCTURAL}
                    assert got["strict_reduction_ops"] == want["strict_reduction_ops"]
                    stages = log_n
                    if v < 31:
                        assert got["reduction_ops"] == want["reduction_ops"], (n, v, sched, d)
                        assert got["lazy_window"] == want["lazy_window"]
                    else:
                        assert got["reduction_ops"] == 4 * stages
                        assert want["reduction_ops"] == 5 * stages
                    assert got["operations"] == cost.transform_ops(
                        n, *kern.reduction_mode(p.tables)[:2], d == "inv")
    with pytest.raises(ValueError, match="direction"):
        ops.transform_cost_model(make_params(64, 1, 30, "cpu"), direction="both")


def test_stage_timings_on_cpu_returns_reference_keys_and_gauges():
    """stage_timings at n = 64 on a CPU plan of each backend: the
    reference's record keys (its own record at the same size), stage
    shares summing to one, the byte attribution beside them, and the four
    repro_stage_* gauge families with a child per stage and backend."""
    ref = robs.stage_timings(repro.plan(64, 3, 30), batch=2, iters=1, warmup=0,
                             registry=robs.MetricsRegistry())
    reg = obs.MetricsRegistry()
    for backend in ("torch", "cuda_fused_e2e"):
        pl = repro_torch.plan(64, 3, 30, backend=backend, device="cpu")
        rec = obs.stage_timings(pl, batch=2, iters=1, warmup=0, registry=reg)
        assert set(rec) - {"calls"} == set(ref)
        assert set(rec["stages"]) == set(ref["stages"]) == set(obs.STAGES)
        for stage in obs.STAGES:
            assert set(rec["stages"][stage]) == set(ref["stages"][stage])
        assert set(rec["transform_cost_model"]) == set(ref["transform_cost_model"])
        assert sum(s["share_measured"] for s in rec["stages"].values()) == pytest.approx(1.0)
        assert sum(s["share_predicted"] for s in rec["stages"].values()) == pytest.approx(1.0)
        assert rec["backend"] == backend and rec["calls"] == {"stage": 2, "execute": 1}
        assert json.loads(json.dumps(rec)) == rec
    for name in ("repro_stage_seconds", "repro_stage_share_measured",
                 "repro_stage_share_predicted", "repro_stage_share_drift"):
        labels = {key for key, _ in reg.get(name).children()}
        assert labels == {(s, b) for s in obs.STAGES for b in ("torch", "cuda_fused_e2e")}


def test_obs_report_stages_on_cpu(capsys):
    """obs_report --stages 64:3:30 --device cpu runs the profiler and
    prints each stage; --json prints the record."""
    assert obs_report.main(["--stages", "64:3:30", "--device", "cpu", "--iters", "1",
                            "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "stage timings n=64 t=3 v=30 backend=torch" in out
    assert all(stage in out for stage in obs.STAGES)
    assert obs_report.main(["--stages", "64:3:30", "--device", "cpu", "--iters", "1",
                            "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["n"] == 64
