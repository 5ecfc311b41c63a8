"""CLI front door for the port's autotuner (the port of
``repro.launch.autotune``).

Subcommands, each on the card unless ``--device cpu``::

    # sweep two workloads on the card, write/merge a table + full report
    python -m repro_torch.launch.autotune sweep \
        --workloads n4096_t6_v30_b256,n65536_t6_v30_b16 \
        --out TUNING.json --report TUNE_report.json

    # print a table (default: the port's committed one)
    python -m repro_torch.launch.autotune show-table --table TUNING.json

    # verify plan(tuning=<table>) resolves every entry of the device's
    # kind to its winner, that the tuned plan_key differs from the
    # untuned one only in tuned knobs, that an explicit knob beats the
    # table and that no recorded winner is slower than the default
    python -m repro_torch.launch.autotune check --table TUNING.json
    python -m repro_torch.launch.autotune check --table TUNING.json --device cpu

    # drop entries older than N days (atomic rewrite)
    python -m repro_torch.launch.autotune prune-stale --table T.json --max-age-days 90

    # re-sweep the committed table's cpu entries (quick grid)
    python -m repro_torch.launch.autotune seed-default --device cpu

``sweep`` merges into an existing ``--out`` table by default (other
workloads and device kinds survive); ``--fresh`` starts empty.  Exit
status is nonzero on any check failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, List, Optional


def _parse_workloads(spec: str) -> list[Any]:
    from repro_torch.tune.sweep import Workload

    keys = [k.strip() for k in spec.split(",") if k.strip()]
    if not keys:
        raise SystemExit("no workloads given (want e.g. n64_t3_v30_b2,...)")
    return [Workload.from_key(k) for k in keys]


def _cmd_sweep(args: argparse.Namespace) -> int:
    from repro_torch.tune import table as table_mod
    from repro_torch.tune import sweep as sweep_mod

    workloads = _parse_workloads(args.workloads)
    base = None
    if not args.fresh:
        try:
            base = table_mod.TuningTable.load(args.out)
            print(f"merging into existing table {args.out}")
        except table_mod.TuningTableError:
            base = None
    tab, report = sweep_mod.sweep(
        workloads, quick=args.quick, iters=args.iters, warmup=args.warmup,
        table=base, device=args.device, log=print,
    )
    tab.save(args.out)
    print(f"wrote {args.out}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.report}")
    return 0


def _cmd_show_table(args: argparse.Namespace) -> int:
    from repro_torch.tune import table as table_mod

    path = args.table or str(table_mod.DEFAULT_TABLE_PATH)
    tab = table_mod.TuningTable.load(path)
    print(f"# {path}")
    for kind, entries in sorted(tab.entries.items()):
        print(f"[{kind}]")
        for key, e in sorted(entries.items()):
            w = e.get("winner", {})
            knobs = ", ".join(f"{k}={w.get(k)!r}" for k in table_mod.TUNABLE_KNOBS)
            card = (f"; {e['device_name']}, {e.get('power_limit')}"
                    if e.get("device_name") else "")
            print(
                f"  {key}: {knobs}  "
                f"({e.get('winner_us', float('nan')):.1f} us/poly vs default "
                f"{e.get('default_us', float('nan')):.1f}; "
                f"mode={e.get('mode')}, rank-corr={e.get('rank_correlation')}{card})"
            )
    return 0


def _cmd_prune_stale(args: argparse.Namespace) -> int:
    from repro_torch.tune import table as table_mod

    tab = table_mod.TuningTable.load(args.table)
    removed = tab.prune_stale(max_age_s=args.max_age_days * 86400.0)
    tab.save(args.table)
    for kind, key in removed:
        print(f"pruned [{kind}] {key}")
    print(f"{len(removed)} entries pruned; wrote {args.table}")
    return 0


def _check_entry(kind: str, key: str, entry: dict[str, Any], table_path: str,
                 device=None) -> list[str]:
    import repro_torch
    from repro_torch.tune import table as table_mod

    problems: list[str] = []
    wl = entry.get("workload") or table_mod.parse_workload_key(key)
    n, t, v = wl["n"], wl["t"], wl["v"]
    winner = entry.get("winner", {})

    tuned = repro_torch.plan(n=n, t=t, v=v, tuning=table_path, device=device)
    untuned = repro_torch.plan(n=n, t=t, v=v, device=device)
    tcfg, ucfg = repro_torch.plan_key(tuned), repro_torch.plan_key(untuned)

    # 1. the tuned plan carries the table's winner, first-class
    want_backend = winner.get("backend") or ucfg.backend
    if tcfg.backend != want_backend:
        problems.append(
            f"{key}: tuned backend {tcfg.backend!r} != winner {want_backend!r}"
        )
    want_sched = winner.get("schedule")
    if want_sched and tcfg.schedule.canonical != want_sched:
        problems.append(
            f"{key}: tuned schedule {tcfg.schedule.canonical!r} != winner "
            f"{want_sched!r}"
        )
    # the port's PlanConfig holds no row block or channel grid: plan()
    # refuses a row_blk and channel_grid=False, so a servable winner has
    # neither
    if winner.get("row_blk") is not None or winner.get("channel_grid") is False:
        problems.append(
            f"{key}: winner row_blk {winner.get('row_blk')!r} / channel_grid "
            f"{winner.get('channel_grid')!r} is not servable on the card"
        )

    # 2. plan_key differs from the untuned plan ONLY in tuned knobs
    # (+ the resolved schedule spec those knobs imply)
    allowed = set(table_mod.TUNABLE_KNOBS)
    for field in dataclasses.fields(tcfg):
        tv, uv = getattr(tcfg, field.name), getattr(ucfg, field.name)
        if tv != uv and field.name not in allowed:
            problems.append(
                f"{key}: plan_key drift outside tuned knobs: "
                f"{field.name}: tuned={tv!r} untuned={uv!r}"
            )

    # 3. explicit knobs still beat the table
    pinned = repro_torch.plan(n=n, t=t, v=v, backend=ucfg.backend, tuning=table_path,
                              device=device)
    if repro_torch.plan_key(pinned).backend != ucfg.backend:
        problems.append(f"{key}: explicit backend knob lost to the table")

    # 4. the sweep recorded a never-slower winner
    w_us, d_us = entry.get("winner_us"), entry.get("default_us")
    if w_us is not None and d_us is not None and w_us > d_us:
        problems.append(
            f"{key}: recorded winner ({w_us:.1f} us) slower than default "
            f"({d_us:.1f} us)"
        )
    return problems


def _cmd_check(args: argparse.Namespace) -> int:
    from repro_torch.tune import table as table_mod

    tab = table_mod.TuningTable.load(args.table)
    kind = table_mod.device_kind(args.device)
    entries = tab.entries.get(kind, {})
    if not entries:
        print(f"FAIL: table has no entries for device kind {kind!r}")
        return 1
    # plan() is batch-agnostic and resolves the smallest-batch entry per
    # (n, t, v); only those entries are checkable against plan(tuning=...)
    smallest: dict[tuple[int, int, int], tuple[int, str]] = {}
    for key, entry in entries.items():
        wl = entry.get("workload") or table_mod.parse_workload_key(key)
        nk = (wl["n"], wl["t"], wl["v"])
        if nk not in smallest or wl["batch"] < smallest[nk][0]:
            smallest[nk] = (wl["batch"], key)
    checkable = {key for _, key in smallest.values()}
    problems: list[str] = []
    for key, entry in sorted(entries.items()):
        if key not in checkable:
            print(f"skipped [{kind}] {key} (larger-batch twin)")
            continue
        problems.extend(_check_entry(kind, key, entry, args.table, args.device))
        print(f"checked [{kind}] {key}")
    if args.report:
        with open(args.report) as f:
            rep = json.load(f)
        for w in rep.get("workloads", []):
            if "rank_correlation" not in (w.get("entry") or {}):
                problems.append(f"report {w.get('key')}: missing rank_correlation")
    for p in problems:
        print(f"FAIL: {p}")
    print(f"{len(entries)} entries checked, {len(problems)} problems")
    return 1 if problems else 0


def _cmd_seed_default(args: argparse.Namespace) -> int:
    """Regenerate the committed table's entries of the device's kind
    (maintainer helper)."""
    from repro_torch.tune import table as table_mod

    args.out = str(table_mod.DEFAULT_TABLE_PATH)
    args.fresh = False
    return _cmd_sweep(args)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.autotune",
        description="The port's autotuner: sweep / inspect / check the "
        "persistent tuning table consulted by repro_torch.plan(tuning=...)",
    )
    device = dict(default=None, help="the plans' device: the card unless 'cpu'")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sweep", help="measure candidates, write a table")
    sp.add_argument(
        "--workloads", required=True,
        help="comma-separated workload keys, e.g. n64_t3_v30_b2,n256_t6_v30_b2",
    )
    sp.add_argument("--quick", action="store_true", help="CI micro-grid")
    sp.add_argument("--iters", type=int, default=3)
    sp.add_argument("--warmup", type=int, default=1)
    sp.add_argument("--out", default="TUNING.json", help="table path (merged)")
    sp.add_argument("--fresh", action="store_true", help="ignore existing table")
    sp.add_argument("--report", default=None, help="full sweep report path")
    sp.add_argument("--device", **device)
    sp.set_defaults(fn=_cmd_sweep)

    st = sub.add_parser("show-table", help="pretty-print a table")
    st.add_argument("--table", default=None, help="defaults to the committed table")
    st.set_defaults(fn=_cmd_show_table)

    pc = sub.add_parser(
        "check",
        help="assert plan(tuning=<table>) resolves every winner first-class",
    )
    pc.add_argument("--table", required=True)
    pc.add_argument("--report", default=None, help="sweep report to cross-check")
    pc.add_argument("--device", **device)
    pc.set_defaults(fn=_cmd_check)

    ps = sub.add_parser("prune-stale", help="drop entries past --max-age-days")
    ps.add_argument("--table", required=True)
    ps.add_argument("--max-age-days", type=float, default=180.0)
    ps.set_defaults(fn=_cmd_prune_stale)

    sd = sub.add_parser(
        "seed-default", help="re-sweep the committed TUNING_default.json"
    )
    sd.add_argument(
        "--workloads", default="n64_t3_v30_b2,n256_t6_v30_b2",
        help="comma-separated workload keys",
    )
    sd.add_argument("--quick", action="store_true", default=True)
    sd.add_argument("--iters", type=int, default=3)
    sd.add_argument("--warmup", type=int, default=1)
    sd.add_argument("--report", default=None)
    sd.add_argument("--device", **device)
    sd.set_defaults(fn=_cmd_seed_default)

    args = ap.parse_args(argv)
    return int(args.fn(args))


if __name__ == "__main__":
    sys.exit(main())
