"""The persistent tuning table: versioned JSON, schema-validated, written
atomically, consulted by ``repro_torch.plan(..., tuning=...)`` (the port's
copy of ``repro.tune.table``; the format is the reference's, so a table
either package writes loads in the other).

Layout (``TABLE_SCHEMA`` = ``repro.tune.table/v1``)::

    {
      "version": 1,
      "schema": "repro.tune.table/v1",
      "device_kinds": {
        "cpu": {
          "n256_t6_v30_b2": {
            "workload": {"n": 256, "t": 6, "v": 30, "batch": 2},
            "winner":   {"backend": "torch", "schedule": "four_step",
                         "row_blk": null, "channel_grid": null},
            "winner_us": 123.4,          # measured, per poly
            "default_us": 150.0,         # the static-default candidate
            "mode": "cpu",               # the port: "cuda" | "cpu"
            "measured_at": 1754740000.0, # unix seconds
            "candidates_measured": 8,
            "candidates_pruned": 4,
            "rank_correlation": 0.9      # traffic model vs stopwatch
          }, ...
        },
        "gpu": {...}                     # the port's sweep on the card adds
                                         # "device_name", "power_limit"
      }
    }

Keying is **device kind + workload key**: a table seeded on a CPU dev box
never silently steers a card's run — ``lookup`` only returns entries for
the requested device kind, which :func:`repro_torch.plan` takes from the
plan's device (:func:`device_kind`).  The reference's entries (winners
``jnp`` / ``pallas*``, kinds ``cpu`` / ``tpu``) load here; a plan refuses a
winner the port does not serve with that knob's error.  ``winner`` holds exactly the
four tunable plan knobs (``TUNABLE_KNOBS``); ``backend``/``schedule``
are recorded RESOLVED (never ``"auto"``), so replaying them through
``plan()`` reproduces the measured :class:`repro_torch.PlanConfig`
bit-for-bit on any box of the same device kind.

Writes go through ``tmp + os.replace`` (atomic on POSIX): a crashed
sweep can never leave a half-written table for ``plan()`` to trip over.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Any

import torch

TABLE_VERSION = 1
TABLE_SCHEMA = "repro.tune.table/v1"

# The plan() knobs a table entry may set — nothing else (the workload key
# pins n/t/v; use_sau &c. stay caller-owned).  plan_key of a tuned plan
# differs from the untuned plan in at most these fields (+ the resolved
# `schedule` spec they imply) — asserted by `autotune check` in CI.
TUNABLE_KNOBS = ("backend", "schedule", "row_blk", "channel_grid")

# The port's committed table (``python -m repro_torch.launch.autotune
# seed-default`` for its ``cpu`` entries, ``sweep`` on the card for its
# ``gpu`` ones); never the reference's, whose winners are jnp / pallas*.
DEFAULT_TABLE_PATH = Path(__file__).resolve().parent / "TUNING_default.json"

_KEY_RE = re.compile(r"^n(\d+)_t(\d+)_v(\d+)_b(\d+)$")


class TuningTableError(ValueError):
    """A tuning table failed to load or validate (missing file for an
    explicit path, malformed JSON, wrong schema/version, bad entry)."""


def device_kind(device=None) -> str:
    """The platform bucket a measurement or a plan belongs to: ``"gpu"``
    for a CUDA device, ``"cpu"`` for the CPU.  ``device=None`` is the
    device a plan takes by default: the card where there is one."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def workload_key(n: int, t: int, v: int, batch: int) -> str:
    return f"n{n}_t{t}_v{v}_b{batch}"


def parse_workload_key(key: str) -> dict[str, int]:
    m = _KEY_RE.match(key)
    if not m:
        raise TuningTableError(
            f"bad workload key {key!r} (want 'n<n>_t<t>_v<v>_b<batch>', "
            f"e.g. 'n256_t6_v30_b2')"
        )
    n, t, v, b = map(int, m.groups())
    return {"n": n, "t": t, "v": v, "batch": b}


def _validate_winner(key: str, winner: Any) -> None:
    if not isinstance(winner, dict):
        raise TuningTableError(f"entry {key!r}: winner must be a dict")
    unknown = set(winner) - set(TUNABLE_KNOBS)
    if unknown:
        raise TuningTableError(
            f"entry {key!r}: winner sets non-tunable knobs {sorted(unknown)} "
            f"(tunable: {TUNABLE_KNOBS})"
        )
    be = winner.get("backend")
    if be is not None and (not isinstance(be, str) or be == "auto"):
        raise TuningTableError(
            f"entry {key!r}: winner backend must be a resolved backend "
            f"string, got {be!r}"
        )
    sc = winner.get("schedule")
    if sc is not None and (not isinstance(sc, str) or sc == "auto"):
        raise TuningTableError(
            f"entry {key!r}: winner schedule must be a resolved schedule "
            f"string, got {sc!r}"
        )
    rb = winner.get("row_blk")
    if rb is not None and (not isinstance(rb, int) or isinstance(rb, bool) or rb < 1):
        raise TuningTableError(
            f"entry {key!r}: winner row_blk must be a positive int or "
            f"null, got {rb!r}"
        )
    cg = winner.get("channel_grid")
    if cg is not None and not isinstance(cg, bool):
        raise TuningTableError(
            f"entry {key!r}: winner channel_grid must be true/false/null, "
            f"got {cg!r}"
        )


@dataclasses.dataclass
class TuningTable:
    """In-memory view of one tuning table file.

    ``entries`` maps device kind -> workload key -> entry dict (the JSON
    layout's ``device_kinds`` subtree, validated).
    """

    entries: dict[str, dict[str, dict[str, Any]]] = dataclasses.field(
        default_factory=dict
    )
    path: str | None = None  # where this table was loaded from, if anywhere

    # ------------------------------------------------------------ load/save
    @classmethod
    def from_dict(cls, doc: Any, *, path: str | None = None) -> "TuningTable":
        if not isinstance(doc, dict):
            raise TuningTableError(f"tuning table must be a JSON object, got {type(doc).__name__}")
        if doc.get("schema") != TABLE_SCHEMA:
            raise TuningTableError(
                f"unknown tuning-table schema {doc.get('schema')!r} "
                f"(this build reads {TABLE_SCHEMA!r})"
            )
        if doc.get("version") != TABLE_VERSION:
            raise TuningTableError(
                f"unknown tuning-table version {doc.get('version')!r} "
                f"(this build reads {TABLE_VERSION})"
            )
        kinds = doc.get("device_kinds", {})
        if not isinstance(kinds, dict):
            raise TuningTableError("device_kinds must be an object")
        entries: dict[str, dict[str, dict[str, Any]]] = {}
        for kind, table in kinds.items():
            if not isinstance(table, dict):
                raise TuningTableError(f"device kind {kind!r}: must be an object")
            entries[kind] = {}
            for key, entry in table.items():
                wl = parse_workload_key(key)
                if not isinstance(entry, dict):
                    raise TuningTableError(f"entry {key!r}: must be an object")
                got = entry.get("workload")
                if got is not None and dict(got) != wl:
                    raise TuningTableError(
                        f"entry {key!r}: workload {got!r} disagrees with its key"
                    )
                _validate_winner(key, entry.get("winner", {}))
                entries[kind][key] = dict(entry)
        return cls(entries=entries, path=path)

    @classmethod
    def load(cls, path: str | os.PathLike[str]) -> "TuningTable":
        p = Path(path)
        if not p.exists():
            raise TuningTableError(f"no tuning table at {p}")
        try:
            doc = json.loads(p.read_text())
        except json.JSONDecodeError as e:
            raise TuningTableError(f"malformed tuning table {p}: {e}") from e
        return cls.from_dict(doc, path=str(p))

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": TABLE_VERSION,
            "schema": TABLE_SCHEMA,
            "device_kinds": {
                kind: dict(sorted(table.items()))
                for kind, table in sorted(self.entries.items())
            },
        }

    def save(self, path: str | os.PathLike[str]) -> None:
        """Atomic write: serialize next to the target, fsync, then
        ``os.replace`` — readers only ever see a complete table."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=str(p.parent), prefix=p.name + ".", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=2, sort_keys=False)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------ access
    def put(
        self,
        *,
        n: int,
        t: int,
        v: int,
        batch: int,
        winner: dict[str, Any],
        kind: str | None = None,
        **extra: Any,
    ) -> dict[str, Any]:
        """Insert/overwrite one entry; returns the stored entry dict."""
        key = workload_key(n, t, v, batch)
        _validate_winner(key, winner)
        entry: dict[str, Any] = {
            "workload": {"n": n, "t": t, "v": v, "batch": batch},
            "winner": {k: winner.get(k) for k in TUNABLE_KNOBS},
            "measured_at": extra.pop("measured_at", time.time()),
        }
        entry.update(extra)
        self.entries.setdefault(kind or device_kind(), {})[key] = entry
        return entry

    def lookup(
        self,
        *,
        n: int,
        t: int,
        v: int,
        batch: int | None = None,
        kind: str | None = None,
    ) -> dict[str, Any] | None:
        """The winner-knob dict for a workload on this device kind, or
        ``None``.  ``batch=None`` (the plan-time call — plans are
        batch-agnostic) returns the smallest-batch entry for (n, t, v)."""
        table = self.entries.get(kind or device_kind())
        if not table:
            return None
        if batch is not None:
            entry = table.get(workload_key(n, t, v, batch))
            return dict(entry["winner"]) if entry else None
        best_b: int | None = None
        best: dict[str, Any] | None = None
        for key, entry in table.items():
            wl = entry.get("workload") or parse_workload_key(key)
            if (wl["n"], wl["t"], wl["v"]) != (n, t, v):
                continue
            if best_b is None or wl["batch"] < best_b:
                best_b, best = wl["batch"], entry
        return dict(best["winner"]) if best else None

    def entry(
        self, *, n: int, t: int, v: int, batch: int, kind: str | None = None
    ) -> dict[str, Any] | None:
        table = self.entries.get(kind or device_kind(), {})
        e = table.get(workload_key(n, t, v, batch))
        return dict(e) if e else None

    def prune_stale(
        self, *, max_age_s: float, now: float | None = None
    ) -> list[tuple[str, str]]:
        """Drop entries older than ``max_age_s`` (by ``measured_at``);
        entries with no timestamp count as stale.  Returns the removed
        ``(device_kind, workload_key)`` pairs."""
        cutoff = (time.time() if now is None else now) - max_age_s
        removed: list[tuple[str, str]] = []
        for kind, table in list(self.entries.items()):
            for key, entry in list(table.items()):
                at = entry.get("measured_at")
                if not isinstance(at, (int, float)) or at < cutoff:
                    removed.append((kind, key))
                    del table[key]
            if not table:
                del self.entries[kind]
        return removed


# --------------------------------------------------------------------------
# plan()-side loaders (cached so planning in a loop re-reads nothing)
# --------------------------------------------------------------------------

_CACHE: dict[tuple[str, float], TuningTable] = {}


def load_cached(path: str) -> TuningTable:
    """Load a table with an mtime-keyed cache: ``plan()`` calls in a hot
    loop hit the parsed table; an updated file is picked up on the next
    call.  Raises :class:`TuningTableError` if missing or invalid."""
    p = Path(path)
    if not p.exists():
        raise TuningTableError(f"no tuning table at {p}")
    key = (str(p.resolve()), p.stat().st_mtime)
    tab = _CACHE.get(key)
    if tab is None:
        tab = TuningTable.load(p)
        _CACHE.clear()  # one live parse per path generation is plenty
        _CACHE[key] = tab
    return tab


def load_default() -> TuningTable | None:
    """The port's committed table, or ``None`` when absent —
    ``tuning="auto"`` degrades to the static defaults silently."""
    if not DEFAULT_TABLE_PATH.exists():
        return None
    return load_cached(str(DEFAULT_TABLE_PATH))
