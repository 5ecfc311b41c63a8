"""The autotuner of the port (counterpart of ``repro.tune``).

The plan knobs ``backend`` and ``schedule`` are chosen from measurement
on the card instead of the hand-written rule of ``backend="auto"``:

* :mod:`repro_torch.tune.sweep` — enumerate the servable candidates per
  workload key ``(n, t, v, batch)`` (pruning unservable ones through the
  plan-error taxonomy, deduplicating by ``plan_key``) and measure each
  with its kernels built and loaded first, then the median of
  synchronised walls on the card (the host clock on the CPU);
* :mod:`repro_torch.tune.table` — the persistent versioned JSON tuning
  table (the reference's format), keyed by device kind + workload key,
  consulted by ``repro_torch.plan(..., tuning=...)`` at plan time
  (explicit knob > tuning table > static default);
* :mod:`repro_torch.tune.costcheck` — the rank correlation of the port's
  traffic and work model (:func:`repro_torch.kernels.ops.hbm_traffic_model`)
  against the stopwatch, flagging candidates where the two disagree.

CLI front door: ``python -m repro_torch.launch.autotune`` (sweep /
show-table / check / prune-stale / seed-default).

Only the table surface is imported eagerly — the sweep harness pulls in
the full execution stack, so import :mod:`repro_torch.tune.sweep`
explicitly.
"""
from repro_torch.tune.table import (
    DEFAULT_TABLE_PATH,
    TABLE_SCHEMA,
    TABLE_VERSION,
    TUNABLE_KNOBS,
    TuningTable,
    TuningTableError,
    device_kind,
    parse_workload_key,
    workload_key,
)

__all__ = [
    "DEFAULT_TABLE_PATH",
    "TABLE_SCHEMA",
    "TABLE_VERSION",
    "TUNABLE_KNOBS",
    "TuningTable",
    "TuningTableError",
    "device_kind",
    "parse_workload_key",
    "workload_key",
]
