#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero):

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. the build of every CUDA kernel of the path (``nvcc``, one process per
   source, all started together) into the checkout's ``build/``;
3. each kernel against its plain PyTorch version on the card, exact
   int64 equality, at the paper's point (n=4096, t=6, v=30, 256 rows) and
   at n=64, t=3 in all three reduction regimes (v = 29, 30, 31);
4. the main path through the entry points a user calls:
   ``repro_torch.plan(n=4096, t=6, v=30)`` -> ``repro_torch.polymul`` on a
   seeded 256-row batch, and ``repro_torch.negacyclic_mul`` on the same
   plan, with the launch counters zeroed before and read after each;
   outputs equal to the plain versions on all rows and to the host bigint
   oracle on two sampled rows;
5. timings: the median CUDA-event time of each kernel over 20 launches
   after warm-up, its plain version's time, and its bound;
6. the end-to-end time of one ``polymul`` call at the main path's shape
   on each backend (host clock, synchronised).

It prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  It imports neither JAX nor the JAX
package.  Without a CUDA device, or outside the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks.
HBM_BYTES_PER_S = 3.35e12
# No integer-64 rate is published; the scalar (non-tensor-core) peak of
# 67 TOP/s is used, so the operation bound is optimistic.
SCALAR_OPS_PER_S = 67e12

MAIN = dict(n=4096, t=6, v=30, rows=256)
SMALL = [dict(n=64, t=3, v=v, rows=3) for v in (29, 30, 31)]
MAIN_CALLS = 3
TIMED_LAUNCHES = 20
PLAIN_RUNS = 5
E2E_RUNS = 10
ORACLE_ROWS = (0, 255)
SEED = 20260


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_inputs(torch, np, pl, rows: int, seed: int, device):
    """Segments (rows, n, S) of coefficients below q and canonical residues
    (t, rows, n), made with numpy from ``seed``."""
    cfg = pl.config
    rng = np.random.default_rng(seed)
    shape = (rows, cfg.n, cfg.seg_count)
    top = pl.q >> (cfg.v * (cfg.seg_count - 1))  # top segment bound keeps values < q

    def segments():
        z = rng.integers(0, 1 << cfg.v, size=shape, dtype=np.int64)
        z[..., -1] = rng.integers(0, top, size=shape[:-1], dtype=np.int64)
        return torch.as_tensor(z, device=device)

    qs = pl.params.qs[:, None, None]

    def residues():
        r = rng.integers(0, 1 << 62, size=(cfg.t, rows, cfg.n), dtype=np.int64) % qs
        return torch.as_tensor(r, device=device)

    return segments(), segments(), residues(), residues()


def exact(got, want, what: str) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    err = int((got - want).abs().max().item()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{what}: max |kernel - plain| = {err}, expected 0")
    return err


def time_launches(torch, fn, launches: int, warmup: int = 3) -> float:
    """Median milliseconds of one call over ``launches`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# work counts for the bound: integer operations the function needs on these
# inputs, one unit per 64-bit add, sub, mul, shift, mask, compare, select or
# remainder (a conditional subtraction is compare + sub + select = 3)
# --------------------------------------------------------------------------

COND_SUB = 3
BARRETT = 5 + 3 * COND_SUB  # two shifts, two muls, one sub, three cond subs
SHOUP = 5


def _mul_mod(mode: int) -> int:
    return 1 + (1 if mode == 2 else BARRETT)  # product + reduction


def _canon(mode: int, window: int) -> int:
    return 0 if mode != 0 else COND_SUB * (2 if window == 4 else 1)


def cascade_ops(n: int, mode: int, window: int) -> int:
    """One (channel, row) cascade: two forward transforms, the canonical
    pointwise product, one inverse transform and the exit canonicalize."""
    log_n = n.bit_length() - 1
    if mode == 0:
        ct = SHOUP + (COND_SUB + 3 if window == 4 else 1 + COND_SUB + 2 + COND_SUB)
        gs = 3 + 2 * COND_SUB + SHOUP + 2 * 4
    else:
        ct = _mul_mod(mode) + 2 * (1 + COND_SUB)
        gs = 2 * (1 + COND_SUB) + _mul_mod(mode) + 2 * 4
    butterflies = (n // 2) * log_n
    point = 2 * _canon(mode, window) + _mul_mod(mode)
    return 2 * butterflies * ct + butterflies * gs + n * (point + _canon(mode, window))


def decompose_ops(S: int, t_prime: int, n_terms: int) -> int:
    """One residue of one coefficient through the Alg-2 SAU circuit."""
    sau = 1 + 3 * n_terms
    ops = 0
    for rho in range(-(-S // t_prime)):
        base = rho * t_prime
        if t_prime > 1 and base + 1 < S:
            ops += sau + 1
        for k in range(2, t_prime):
            if base + k >= S:
                break
            ops += k * (sau + BARRETT) + 1
        ops += BARRETT + (1 if rho == 0 else 3)
    return ops + BARRETT


def e2e_ops(pl, mode: int, window: int, rows: int) -> int:
    rp = pl.params.plan
    n, t, L = rp.n, rp.t, rp.L
    n_terms = max(len(c.beta_terms) for c in rp.dec)
    per_coeff = (
        2 * t * decompose_ops(rp.seg_count, rp.t_prime, n_terms)
        + t * (_canon(mode, window) + _mul_mod(mode))
        + 2 * t * L + 3 * L + (t - 1) * 6 * L
    )
    return rows * (t * cascade_ops(n, mode, window) + n * per_coeff)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernels(dev) -> dict[str, int]:
    """Phase 3: each kernel against its plain version, exact equality."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import ntt as kern

    max_err = {"fused_polymul": 0, "fused_e2e_polymul": 0}
    for cfg in [MAIN] + SMALL:
        pl = repro_torch.plan(cfg["n"], cfg["t"], cfg["v"], device=dev)
        p = pl.params
        za, zb, ra, rb = seeded_inputs(torch, np, pl, cfg["rows"], SEED + cfg["v"], dev)
        k1 = kern.fused_polymul_cuda(ra, rb, p.tables)
        torch.cuda.synchronize()
        e1 = exact(k1, kern.fused_polymul_ref(ra, rb, p.tables), f"K1 {cfg}")
        k2 = kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan)
        torch.cuda.synchronize()
        e2 = exact(k2, kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan), f"K2 {cfg}")
        max_err["fused_polymul"] = max(max_err["fused_polymul"], e1)
        max_err["fused_e2e_polymul"] = max(max_err["fused_e2e_polymul"], e2)
        log(f"[kernels] n={cfg['n']} t={cfg['t']} v={cfg['v']} rows={cfg['rows']} "
            f"(mode, window)={kern.reduction_mode(p.tables)[:2]}: K1 {tuple(k1.shape)} and "
            f"K2 {tuple(k2.shape)} equal their plain versions bit for bit")
    return max_err


def drive_main_path(pl):
    """Phase 4: polymul, then negacyclic_mul, through the user's entry
    points, each with the launch counters zeroed just before and read just
    after.  Returns (launches per kernel, the inputs)."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import bigint, polymul as host
    from repro_torch.kernels import ntt as kern

    p, v = pl.params, pl.config.v
    za, zb, ra, rb = seeded_inputs(torch, np, pl, MAIN["rows"], SEED, pl.device)
    launches = {}

    kern.fused_polymul_cuda.launches = 0
    kern.fused_e2e_polymul_cuda.launches = 0
    outs = [repro_torch.polymul(pl, za, zb) for _ in range(MAIN_CALLS)]
    torch.cuda.synchronize()
    launches["fused_e2e_polymul"] = kern.fused_e2e_polymul_cuda.launches
    if (launches["fused_e2e_polymul"], kern.fused_polymul_cuda.launches) != (MAIN_CALLS, 0):
        raise AssertionError(f"polymul: {launches['fused_e2e_polymul']} e2e launches and "
                             f"{kern.fused_polymul_cuda.launches} cascade launches for "
                             f"{MAIN_CALLS} calls")
    plain = kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan)
    for out in outs:
        exact(out, plain, "polymul vs plain")
    for r in ORACLE_ROWS:
        a = bigint.limbs_to_ints(za[r].cpu().numpy(), v)
        b = bigint.limbs_to_ints(zb[r].cpu().numpy(), v)
        if repro_torch.from_limbs(pl, outs[0][r]) != host.oracle_multiply(a, b, p):
            raise AssertionError(f"polymul row {r} differs from the host oracle")
    log(f"[main] polymul x{MAIN_CALLS} on {tuple(za.shape)}: {launches['fused_e2e_polymul']} "
        f"e2e kernel launches; equal to the plain version on all rows and to the host "
        f"oracle on rows {ORACLE_ROWS}")

    kern.fused_polymul_cuda.launches = 0
    kern.fused_e2e_polymul_cuda.launches = 0
    prods = [repro_torch.negacyclic_mul(pl, ra, rb) for _ in range(MAIN_CALLS)]
    torch.cuda.synchronize()
    launches["fused_polymul"] = kern.fused_polymul_cuda.launches
    if (launches["fused_polymul"], kern.fused_e2e_polymul_cuda.launches) != (MAIN_CALLS, 0):
        raise AssertionError(f"negacyclic_mul: {launches['fused_polymul']} cascade launches "
                             f"for {MAIN_CALLS} calls")
    plain = kern.fused_polymul_ref(ra, rb, p.tables)
    for prod in prods:
        exact(prod, plain, "negacyclic_mul vs plain")
    for r in ORACLE_ROWS:
        for c in range(p.t):
            want = host.ntt_negacyclic_host(ra[c, r].tolist(), rb[c, r].tolist(), int(p.qs[c]))
            if prods[0][c, r].tolist() != want:
                raise AssertionError(f"negacyclic_mul channel {c} row {r} differs from the oracle")
    log(f"[main] negacyclic_mul x{MAIN_CALLS} on {tuple(ra.shape)}: {launches['fused_polymul']} "
        f"cascade kernel launches; equal to the plain version on all rows and to the host "
        f"oracle on rows {ORACLE_ROWS}")
    return launches, (za, zb, ra, rb)


def time_kernels(pl, inputs, launches, max_err) -> list[dict]:
    """Phase 5: kernel and plain-version times at the main path's shapes,
    beside the bound computed from these inputs."""
    import torch

    from repro_torch.kernels import ntt as kern

    p, cfg = pl.params, pl.config
    za, zb, ra, rb = inputs
    mode, window = kern.reduction_mode(p.tables)[:2]
    rows = za.shape[0]
    entries = []
    for name, source, replaces, fn, ref, nbytes, ops in (
        ("fused_polymul", "src/repro_torch/csrc/fused_polymul.cu",
         "src/repro/kernels/ntt.py:757",
         lambda: kern.fused_polymul_cuda(ra, rb, p.tables),
         lambda: kern.fused_polymul_ref(ra, rb, p.tables),
         3 * cfg.t * rows * cfg.n * 8, cfg.t * rows * cascade_ops(cfg.n, mode, window)),
        ("fused_e2e_polymul", "src/repro_torch/csrc/fused_e2e_polymul.cu",
         "src/repro/kernels/ntt.py:802",
         lambda: kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan),
         lambda: kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan),
         (2 * cfg.seg_count + cfg.L) * rows * cfg.n * 8, e2e_ops(pl, mode, window, rows)),
    ):
        ms = time_launches(torch, fn, TIMED_LAUNCHES)
        plain_ms = time_launches(torch, ref, PLAIN_RUNS, warmup=1)
        bound_ms, bound_by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
        log(f"[time] {name}: {ms:.4f} ms per launch (median of {TIMED_LAUNCHES}), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, "
            f"{ops} int ops); no single PyTorch call computes this function, so "
            f"library_ms is null")
    return entries


def time_backends(pl, inputs, kernel_ms: float) -> dict[str, float]:
    """Phase 6: wall milliseconds of one synchronised ``polymul`` call per
    backend at the main path's shape, median of E2E_RUNS after a warm-up."""
    import torch

    import repro_torch

    cfg = pl.config
    za, zb = inputs[:2]
    walls = {}
    for backend in reversed(repro_torch.BACKENDS):
        bpl = repro_torch.plan(cfg.n, cfg.t, cfg.v, backend=backend, device=pl.device)
        repro_torch.polymul(bpl, za, zb)
        torch.cuda.synchronize()
        times = []
        for _ in range(E2E_RUNS):
            t0 = time.perf_counter()
            repro_torch.polymul(bpl, za, zb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        walls[backend] = ms = statistics.median(times)
        log(f"[e2e] polymul backend={backend} on {tuple(za.shape)}: {ms:.4f} ms per call "
            f"(median of {E2E_RUNS}, host clock), {za.shape[0] * 1e3 / ms:.0f} products/s")
    log(f"[e2e] the e2e kernel's CUDA-event time is "
        f"{kernel_ms / walls['cuda_fused_e2e']:.3f} of the cuda_fused_e2e call's wall time")
    return walls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for name in _build.SOURCES:
        report = _build.ptxas_report(name)
        for line in report.read_text().splitlines() if report.exists() else []:
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    max_err = check_kernels(torch.device("cuda", 0))

    pl = repro_torch.plan(n=MAIN["n"], t=MAIN["t"], v=MAIN["v"])
    if pl.config.backend != "cuda_fused_e2e" or pl.device.type != "cuda":
        raise AssertionError(f"plan() resolved to {pl.config}")
    launches, inputs = drive_main_path(pl)
    entries = time_kernels(pl, inputs, launches, max_err)
    time_backends(pl, inputs, entries[1]["ms"])

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
