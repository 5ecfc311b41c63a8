"""The port's autotuner (``repro_torch.tune``, ``launch/autotune``) against
the reference's (``repro.tune``): the table's constants, keys and
validation, tables written by one package loading in the other, atomic
saves, the batch fallback and staleness, the cost check's statistics
equal to the reference's on the same inputs, ``plan(tuning=)``'s
resolution on CPU plans (explicit knob > table > static default, the
plan's device kind, bad winners refused with their knob), a quick
micro-sweep through the CLI, and the committed table.

    python -m pytest -q tests/test_torch_tune.py
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import repro.tune as rtune
from repro.tune import costcheck as rcostcheck

import repro_torch
from repro_torch import tune
from repro_torch.launch import autotune
from repro_torch.obs import metrics as obs_metrics
from repro_torch.tune import costcheck
from repro_torch.tune import sweep as sweep_mod

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N, T, V = 64, 3, 30
WINNER = {"backend": "cuda_fused", "schedule": "radix2", "row_blk": None, "channel_grid": None}


def _table(pkg, tmp_path, winner, *, kind="cpu", name="TUNING.json", **extra):
    tab = pkg.TuningTable()
    tab.put(n=N, t=T, v=V, batch=2, winner=winner, kind=kind, measured_at=1000.0, **extra)
    path = tmp_path / name
    tab.save(path)
    return str(path), tab


def test_table_constants_and_keys_match_reference():
    """Schema, version, tunable knobs and the key grammar are the
    reference's; a bad key raises each package's TuningTableError."""
    assert (tune.TABLE_SCHEMA, tune.TABLE_VERSION, tune.TUNABLE_KNOBS) == (
        rtune.TABLE_SCHEMA, rtune.TABLE_VERSION, rtune.TUNABLE_KNOBS)
    for n, t, v, b in ((256, 6, 30, 2), (65536, 6, 30, 16), (4096, 4, 45, 16)):
        key = tune.workload_key(n, t, v, b)
        assert key == rtune.workload_key(n, t, v, b)
        assert tune.parse_workload_key(key) == rtune.parse_workload_key(key)
    for pkg in (tune, rtune):
        with pytest.raises(pkg.TuningTableError, match="bad workload key"):
            pkg.parse_workload_key("n256_t6")
    assert tune.device_kind("cpu") == "cpu" and tune.device_kind("cuda:0") == "gpu"
    assert tune.DEFAULT_TABLE_PATH != rtune.DEFAULT_TABLE_PATH
    assert tune.DEFAULT_TABLE_PATH.parent.name == "tune" and "repro_torch" in str(
        tune.DEFAULT_TABLE_PATH)


def test_tables_load_in_either_package(tmp_path):
    """A table with cpu, gpu and tpu entries (port and reference winners,
    the card's extra fields) written by one package loads in the other
    with an equal document, both ways."""
    for src, dst in ((tune, rtune), (rtune, tune)):
        _round_trip(src, dst, tmp_path)


def _round_trip(src, dst, tmp_path):
    tab = src.TuningTable()
    tab.put(n=N, t=T, v=V, batch=2, kind="cpu", measured_at=1000.0, winner=WINNER,
            winner_us=3.5, default_us=4.0, mode="cpu", rank_correlation=None)
    tab.put(n=4096, t=6, v=30, batch=256, kind="gpu", measured_at=2000.0,
            winner={"backend": "cuda_fused", "schedule": "four_step"}, winner_us=1.2,
            device_name="NVIDIA H100 80GB HBM3", power_limit="700.00 W")
    tab.put(n=256, t=6, v=30, batch=2, kind="tpu", measured_at=3000.0,
            winner={"backend": "pallas_fused_e2e", "schedule": "four_step", "row_blk": 2,
                    "channel_grid": True})
    path = tmp_path / "T.json"
    tab.save(path)
    got = dst.TuningTable.load(path)
    assert got.to_dict() == tab.to_dict()
    assert got.to_dict() == json.loads(path.read_text())


BAD_DOCS = {
    "schema": ({"schema": "nope", "version": 1}, "schema"),
    "version": ({"schema": "repro.tune.table/v1", "version": 99}, "version"),
    "kinds": ({"schema": "repro.tune.table/v1", "version": 1, "device_kinds": []}, "object"),
    "key": ({"schema": "repro.tune.table/v1", "version": 1,
             "device_kinds": {"cpu": {"n64_t3": {}}}}, "bad workload key"),
    "workload": ({"schema": "repro.tune.table/v1", "version": 1, "device_kinds": {"cpu": {
        "n64_t3_v30_b2": {"workload": {"n": 64, "t": 3, "v": 30, "batch": 4}}}}}, "disagrees"),
    "non_tunable": ({"use_sau": False}, "non-tunable"),
    "auto_backend": ({"backend": "auto"}, "resolved backend"),
    "auto_schedule": ({"schedule": "auto"}, "resolved schedule"),
    "row_blk": ({"row_blk": True}, "row_blk"),
    "channel_grid": ({"channel_grid": 1}, "channel_grid"),
}


def test_bad_documents_raise_in_both(tmp_path):
    """The reference's bad documents and winners raise TuningTableError in
    both packages, with the same message."""
    for bad in list(BAD_DOCS) + ["malformed", "missing"]:
        _check_bad(tmp_path / f"{bad}.json", bad)


def _check_bad(path, bad):
    if bad == "malformed":
        path.write_text("{not json")
        match = "malformed"
    elif bad != "missing":
        doc, match = BAD_DOCS[bad]
        if "schema" not in doc:  # a winner
            doc = {"schema": "repro.tune.table/v1", "version": 1, "device_kinds": {
                "cpu": {"n64_t3_v30_b2": {"winner": doc}}}}
        path.write_text(json.dumps(doc))
    else:
        match = "no tuning table"
    for pkg in (tune, rtune):
        with pytest.raises(pkg.TuningTableError, match=match):
            pkg.TuningTable.load(path)


def test_atomic_save_batch_fallback_and_prune_stale(tmp_path):
    """An overwrite leaves no temp file; batch=None resolves the smallest
    batch, an exact batch its own entry, another kind nothing; stale and
    stamp-less entries are pruned and emptied kinds dropped, as in the
    reference."""
    path, tab = _table(tune, tmp_path, WINNER)
    tab.save(path)
    assert sorted(os.listdir(tmp_path)) == ["TUNING.json"]
    assert tune.TuningTable.load(path).entries == tab.entries
    for pkg in (tune, rtune):
        t = pkg.TuningTable()
        t.put(n=64, t=3, v=30, batch=8, kind="cpu", winner={"backend": "cuda"}, measured_at=1000.0)
        t.put(n=64, t=3, v=30, batch=2, kind="cpu", winner={"backend": "torch"},
              measured_at=5000.0)
        assert t.lookup(n=64, t=3, v=30, batch=8, kind="cpu")["backend"] == "cuda"
        assert t.lookup(n=64, t=3, v=30, kind="cpu")["backend"] == "torch"
        assert t.lookup(n=64, t=3, v=30, kind="gpu") is None
        assert t.lookup(n=128, t=3, v=30, kind="cpu") is None
        assert t.prune_stale(max_age_s=3000.0, now=6000.0) == [("cpu", "n64_t3_v30_b8")]
        t2 = pkg.TuningTable(entries={"cpu": {"n64_t3_v30_b2": {"winner": {"backend": "torch"}}}})
        assert t2.prune_stale(max_age_s=1.0, now=10.0) == [("cpu", "n64_t3_v30_b2")]
        assert t2.entries == {}


def test_costcheck_statistics_equal_reference():
    """_ranks, spearman and cross_check equal the reference's exactly on
    seeded inputs, with ties, constant sides, unmodeled candidates and
    too few points."""
    assert costcheck.FLAG_RANK_GAP == rcostcheck.FLAG_RANK_GAP
    rng = np.random.default_rng(25)
    cases = [rng.integers(0, 6, size=k).astype(float).tolist() for k in (1, 2, 3, 7, 12)]
    cases += [rng.random(9).tolist(), [1.0, 1.0, 1.0], [10.0, 10.0, 30.0]]
    for xs in cases:
        assert costcheck._ranks(xs) == rcostcheck._ranks(xs)
        for ys in (xs[::-1], rng.random(len(xs)).tolist(), [2.0] * len(xs)):
            assert costcheck.spearman(xs, ys) == rcostcheck.spearman(xs, ys)
    for pkg in (costcheck, rcostcheck):
        with pytest.raises(ValueError, match="length"):
            pkg.spearman([1.0], [1.0, 2.0])
    for k in (1, 2, 5, 9):
        cands = [{"name": f"c{i}", "measured_us": float(rng.integers(1, 5)),
                  "model_us": None if i == 0 else float(rng.integers(1, 5))} for i in range(k)]
        assert costcheck.cross_check(cands) == rcostcheck.cross_check(cands)


def test_plan_tuning_resolution_on_cpu_plans(tmp_path):
    """explicit knob > table > static default on CPU plans: the table
    fills backend and schedule, an explicit knob wins, "off" and None
    equal the untuned plan, the plan_key drifts only in tuned knobs, a
    missing path raises TuningTableError, a wrong type UnknownKnobError,
    "auto" never raises, and a gpu entry never steers a CPU plan."""
    plan = lambda **kw: repro_torch.plan(N, T, V, device="cpu", **kw)  # noqa: E731
    path, tab = _table(tune, tmp_path, WINNER)
    untuned = plan().config
    for tuning in (path, tab):
        cfg = plan(tuning=tuning).config
        assert (cfg.backend, cfg.schedule.canonical) == ("cuda_fused", "radix2")
        drift = {f.name for f in dataclasses.fields(cfg)
                 if getattr(cfg, f.name) != getattr(untuned, f.name)}
        assert drift <= set(tune.TUNABLE_KNOBS)
    assert plan(backend="torch", tuning=path).config.backend == "torch"
    assert plan(schedule="four_step", tuning=path).config.schedule.canonical == "four_step"
    assert plan(tuning="off").config == untuned and plan(tuning=None).config == untuned
    with pytest.raises(tune.TuningTableError, match="no tuning table"):
        plan(tuning=str(tmp_path / "absent.json"))
    with pytest.raises(repro_torch.UnknownKnobError) as err:
        plan(tuning=42)
    assert err.value.knob == "tuning"
    with pytest.raises(repro_torch.UnknownKnobError):
        plan(tuning=rtune.TuningTable())  # the reference's class is not the port's
    assert plan(tuning="auto").config.n == N
    gpu_path, _ = _table(tune, tmp_path, WINNER, kind="gpu", name="G.json")
    assert plan(tuning=gpu_path).config == untuned


BAD_WINNERS = [
    ({"backend": "pallas_fused"}, "UnknownKnobError", "backend"),
    ({"backend": "cuda_fused", "row_blk": 2}, "UnservableConfigError", "row_blk"),
    ({"backend": "cuda_fused_e2e", "channel_grid": False}, "UnservableConfigError",
     "channel_grid"),
    ({"backend": "cuda_fused", "channel_grid": True}, "UnservableConfigError", "channel_grid"),
    ({"schedule": "four_step:h"}, "UnservableConfigError", "schedule"),
]


def test_bad_winners_are_refused_with_their_knob(tmp_path):
    """A table winner goes through the admission of a hand-set knob: a
    backend the port does not have, a row block, channel_grid=False or
    off the e2e backend, a schedule n does not serve, each refused with
    its own knob."""
    for i, (winner, error, knob) in enumerate(BAD_WINNERS):
        path, _ = _table(tune, tmp_path, winner, name=f"W{i}.json")
        with pytest.raises(getattr(repro_torch, error)) as err:
            repro_torch.plan(N, T, V, device="cpu", tuning=path)
        assert err.value.knob == knob, winner


def test_micro_sweep_prunes_dedupes_never_loses_and_resolves(tmp_path, capsys):
    """The quick grid at n64_t3_v30_b2 on the CPU: four_step:h pruned with
    its taxonomy, auto deduplicated with its resolution, every product
    equal to the default's, the winner never slower than the default,
    the outcomes counted in the registry; the table resolves through
    plan(), and the CLI's sweep, check, show-table and prune-stale return
    0 on it."""
    grid = sweep_mod.default_candidates(V, quick=True)
    assert grid[0] == sweep_mod.DEFAULT_CANDIDATE
    assert {c.backend for c in grid[1:]} == {"torch", "cuda_fused_e2e"}
    full = sweep_mod.default_candidates(V)
    assert {c.backend for c in full[1:]} == set(repro_torch.BACKENDS)
    assert {c.schedule for c in full if c.backend != "torch"} == {"auto"}
    assert [c.backend for c in sweep_mod.default_candidates(45)[1:]] == ["torch", "torch"]
    counter = obs_metrics.registry().counter(
        "repro_tune_candidates_total", "sweep candidate outcomes", ("status",))
    pruned_before = counter.labels(status="pruned").value
    wl = sweep_mod.Workload(n=N, t=T, v=V, batch=2)
    rep = sweep_mod.sweep_workload(wl, quick=True, iters=1, warmup=0, device="cpu")
    by_status = {}
    for c in rep["candidates"]:
        by_status.setdefault(c["status"], []).append(c)
    assert [c["knob"] for c in by_status["pruned"]] == ["schedule"]
    assert by_status["pruned"][0]["error"] == "UnservableConfigError"
    assert len(by_status["duplicate"]) == 1 and "failed" not in by_status
    assert all(c["equal_to_default"] and c["mode"] == "cpu" and c["model_us"] > 0
               for c in by_status["measured"])
    assert rep["entry"]["winner_us"] <= rep["entry"]["default_us"]
    assert counter.labels(status="pruned").value == pruned_before + 1
    out = tmp_path / "T.json"
    assert autotune.main(["sweep", "--workloads", "n64_t3_v30_b2", "--quick", "--iters", "1",
                          "--warmup", "0", "--device", "cpu", "--out", str(out),
                          "--report", str(tmp_path / "R.json")]) == 0
    winner = tune.TuningTable.load(out).lookup(n=N, t=T, v=V, kind="cpu")
    cfg = repro_torch.plan(N, T, V, device="cpu", tuning=str(out)).config
    assert (cfg.backend, cfg.schedule.canonical) == (winner["backend"], winner["schedule"])
    assert autotune.main(["check", "--table", str(out), "--device", "cpu",
                          "--report", str(tmp_path / "R.json")]) == 0
    assert autotune.main(["show-table", "--table", str(out)]) == 0
    assert "n64_t3_v30_b2" in capsys.readouterr().out
    assert autotune.main(["prune-stale", "--table", str(out), "--max-age-days", "1"]) == 0
    assert autotune.main(["check", "--table", str(out), "--device", "cpu"]) == 0


def test_committed_table_is_the_ports_and_checks_on_cpu():
    """The committed table loads in both packages, holds cpu entries at the
    reference's seed workloads and gpu entries each with the card's name
    and power limit, winners the port serves; autotune check passes on
    its cpu entries, and tuning="auto" on a CPU plan takes its entry."""
    path = str(tune.DEFAULT_TABLE_PATH)
    tab = tune.TuningTable.load(path)
    assert rtune.TuningTable.load(path).to_dict() == tab.to_dict()
    assert {"n64_t3_v30_b2", "n256_t6_v30_b2"} <= set(tab.entries["cpu"])
    for kind, entries in tab.entries.items():
        for key, e in entries.items():
            assert e["winner"]["backend"] in repro_torch.BACKENDS, key
            assert e["winner_us"] <= e["default_us"], key
            if kind == "gpu":
                assert e["device_name"] and e["power_limit"], key
    assert autotune.main(["check", "--table", path, "--device", "cpu"]) == 0
    winner = tab.lookup(n=N, t=T, v=V, kind="cpu")
    cfg = repro_torch.plan(N, T, V, device="cpu", tuning="auto").config
    assert (cfg.backend, cfg.schedule.canonical) == (winner["backend"], winner["schedule"])
