"""Dry run of the paper's own workload on the launched mesh (the port of
``repro.launch.dryrun_crypto``): a batched stream of 180-bit x
4096-coefficient modular polynomial products, and one long polynomial
product split over the ``model`` axis.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_crypto [--batch 4096] [--log-n 20]

RNS channels (t = 6) go over ``model`` (the paper's t parallel datapaths
are model parallelism: nothing crosses channels until the inverse CRT),
the polynomial batch over ``data``.  The reference lowers and compiles
for 256- and 512-device TPU meshes without running; the port RUNS both
records on the mesh the launch has (``--mesh``, default ``1x1``: world
size 1 on the card, or gloo with ``--device cpu``), and writes one JSON
record each into ``build/dryrun/`` of the checkout:

* ``parentt_he``: :func:`repro_torch.serve.crypto_engine.polymul_sharded`
  on ``plan(4096, 6, 30)`` (``backend="auto"``: the kernels on the card;
  the reference's dry run lowers its ``jnp`` datapath) at ``--batch``
  rows;
* ``parentt_dntt``: :func:`repro_torch.core.dntt.negacyclic_mul_fourstep`
  at n = 2^``--log-n``, q = 998244353, n1 = 2^(log_n // 2), over
  ``model``.

Each record takes the reference's field names where it has the value:
``memory`` (peak device memory, ``torch.cuda.max_memory_allocated``; not
measured on the CPU), ``wall_s`` (one synchronised call after a warm-up),
``hbm_bytes`` per device (``kernels/cost.py``'s traffic model at this
rank's rows; the four-step product, which runs no kernel, counts its
operands and result once), ``collectives`` (calls and bytes counted from
the port's own collectives, ``sharding.ctx.count_collectives``), and
``equal`` (the result checked: against ``polymul`` on two rows, or eight
coefficients against their direct negacyclic sums).  ``projected``
holds the per-device counts of the reference's production meshes, which
one card cannot build: counted from the shard shapes, not measured.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

ARTIFACTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"

DNTT_Q = 998244353  # 119 * 2^23 + 1: 2n-th roots exist up to n = 2^22
HE = dict(n=4096, t=6, v=30)
# the reference's production meshes: name -> {axis: size}
PRODUCTION = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def _memory(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"peak_bytes": None, "note": "not measured (CPU)"}
    return {"peak_bytes": torch.cuda.max_memory_allocated(device)}


def _timed(fn, device: torch.device):
    """(result, seconds, collectives) of one synchronised call after one
    warm-up call; the peak memory and the collectives are the timed
    call's."""
    from repro_torch.sharding import ctx

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with ctx.count_collectives() as coll:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return out, wall, coll.as_dict()


def negacyclic_coeffs(a: np.ndarray, b: np.ndarray, q: int, ks) -> list[int]:
    """Coefficients ``ks`` of a * b mod (x^n + 1, q) by their direct sums,
    O(n) each (products reduced before summing, so int64 holds n q)."""
    n = a.shape[-1]
    i = np.arange(n)
    out = []
    for k in ks:
        terms = a * b[(k - i) % n] % q
        out.append(int((terms[: k + 1].sum() - terms[k + 1:].sum()) % q))
    return out


class _MeshShape:
    """The axis names and sizes of a mesh that is not built."""

    def __init__(self, shape: dict):
        self.axis_names, self.shape = tuple(shape), shape


def _he_projection(pl, batch: int, shape: dict) -> dict:
    """Per-device counts of polymul_sharded's layout on a production mesh,
    from the shard shapes (``polymul_specs``): rows and channels a device,
    the traffic model's bytes at those rows, the all-gathers' bytes."""
    from repro_torch.kernels import cost
    from repro_torch.sharding import partition

    mesh = _MeshShape(shape)
    cfg = pl.config
    specs = partition.polymul_specs(mesh, pl)
    bsize = partition._axes_size(mesh, partition._fit(mesh, batch, partition.batch_axes(mesh)))
    msize = partition._axes_size(mesh, specs["residues"][0])
    rows = batch // bsize
    res_block = (cfg.t // msize) * rows * cfg.n * 8
    limb_block = rows * cfg.n * cfg.L * 8
    return {
        "basis": "counted from the shard shapes; not measured",
        "rows_per_device": rows, "channels_per_device": cfg.t // msize,
        "hbm_bytes": cost.hbm_traffic_model(pl.params, rows, cfg.backend)["hbm_bytes"],
        "all_gather_peer_bytes": (msize - 1) * res_block + (bsize - 1) * limb_block,
        "note": None if cfg.t % shape["model"] == 0 else
        f"t={cfg.t} does not divide model={shape['model']}: polymul_sharded refuses this "
        "mesh; the specs replicate the channels, counted so",
    }


def run_he(mesh, batch: int, out_dir: Path, seed: int = 0) -> dict:
    """The ``parentt_he`` record on ``mesh``'s device, written to ``out_dir``."""
    import repro_torch
    from repro_torch.kernels import cost
    from repro_torch.serve.crypto_engine import _mesh_sizes, polymul_sharded

    pl = repro_torch.plan(**HE, device=mesh.device)
    cfg = pl.config
    rec = {"arch": "parentt_he", "shape": f"polymul_b{batch}", "mesh": dict(mesh.shape),
           "n_devices": mesh.size, "tag": "crypto", "backend": cfg.backend,
           "device": str(pl.device)}
    try:
        gen = torch.Generator(pl.device).manual_seed(seed)
        za, zb = (torch.randint(0, 1 << cfg.v, (batch, cfg.n, cfg.seg_count), generator=gen,
                                device=pl.device) for _ in range(2))
        out, wall, rec["collectives"] = _timed(
            lambda: polymul_sharded(pl, za, zb, mesh=mesh), pl.device)
        rec["memory"] = _memory(pl.device)
        rec["wall_s"] = wall
        _, bsize = _mesh_sizes(mesh)
        model = cost.hbm_traffic_model(pl.params, batch // bsize, cfg.backend)
        rec["hbm_bytes"] = model["hbm_bytes"]
        rec["hbm_basis"] = "kernels/cost.py hbm_traffic_model at this rank's rows"
        rec["equal"] = bool(torch.equal(out[:2], repro_torch.polymul(pl, za[:2], zb[:2])))
        rec["projected"] = {name: _he_projection(pl, batch, shape)
                            for name, shape in PRODUCTION.items()}
        rec["status"] = "ok" if rec["equal"] else "error"
        print(f"[{'ok' if rec['equal'] else 'FAIL'}] parentt_he x b{batch} x {dict(mesh.shape)}: "
              f"wall {wall * 1e3:.3f} ms, hbm/dev {rec['hbm_bytes'] / 1e9:.3f} GB (model), "
              f"peak {rec['memory']['peak_bytes']}, collectives {rec['collectives']['calls']}")
    except Exception as e:  # noqa: BLE001 — a record of the failure, as the reference writes
        import traceback

        rec["status"] = "error"
        rec["error"] = str(e)
        rec["traceback"] = traceback.format_exc()[-3000:]
        print(f"[FAIL] parentt_he: {e}")
    _write(out_dir, f"dryrun_torch_parentt_he_b{batch}.json", rec)
    return rec


def _dntt_projection(n: int, shape: dict) -> dict:
    """Per-device counts of the four-step product over ``model`` on a
    production mesh, from the shard shapes: 3 all-to-alls of n / M words
    and one all-gather of the n / M result block."""
    M = shape["model"]
    block = n // M * 8
    return {"basis": "counted from the shard shapes; not measured", "model": M,
            "all_to_all_calls": 3, "all_to_all_bytes": 3 * block,
            "all_to_all_peer_bytes": 3 * (block * (M - 1) // M),
            "all_gather_calls": 1, "all_gather_peer_bytes": (M - 1) * block}


def run_dntt(mesh, log_n: int, out_dir: Path, seed: int = 0) -> dict:
    """The ``parentt_dntt`` record on ``mesh``'s device, written to ``out_dir``."""
    from repro_torch.core import dntt

    dev = mesh.device
    n = 1 << log_n
    n1 = 1 << (log_n // 2)
    rec = {"arch": "parentt_dntt", "shape": f"long_2^{log_n}", "mesh": dict(mesh.shape),
           "n_devices": mesh.size, "tag": "crypto", "device": str(dev), "q": DNTT_Q, "n1": n1}
    try:
        tabs = dntt.make_fourstep_tables(DNTT_Q, n, n1)
        rng = np.random.default_rng(seed)
        a_h, b_h = (rng.integers(0, DNTT_Q, size=n, dtype=np.int64) for _ in range(2))
        a, b = torch.as_tensor(a_h, device=dev), torch.as_tensor(b_h, device=dev)
        cons = dntt.make_shard_constrain(mesh)
        out, wall, rec["collectives"] = _timed(
            lambda: dntt.negacyclic_mul_fourstep(a, b, tabs, cons), dev)
        rec["memory"] = _memory(dev)
        rec["wall_s"] = wall
        rec["hbm_bytes"] = 3 * n * 8 // mesh.shape["model"]
        rec["hbm_basis"] = "operands and result once, this rank's blocks (no kernel to model)"
        ks = np.random.default_rng(seed + 1).integers(0, n, size=8)
        got = out.cpu().numpy()
        rec["equal"] = [int(got[k]) for k in ks] == negacyclic_coeffs(a_h, b_h, DNTT_Q, ks)
        rec["projected"] = {name: _dntt_projection(n, shape) for name, shape in PRODUCTION.items()}
        rec["status"] = "ok" if rec["equal"] else "error"
        print(f"[{'ok' if rec['equal'] else 'FAIL'}] parentt_dntt n=2^{log_n} x "
              f"{dict(mesh.shape)}: wall {wall * 1e3:.3f} ms, collectives "
              f"{rec['collectives']['calls']}, peak {rec['memory']['peak_bytes']}")
    except Exception as e:  # noqa: BLE001
        import traceback

        rec["status"] = "error"
        rec["error"] = str(e)
        rec["traceback"] = traceback.format_exc()[-3000:]
        print(f"[FAIL] parentt_dntt: {e}")
    _write(out_dir, f"dryrun_torch_parentt_dntt_2e{log_n}.json", rec)
    return rec


def _write(out_dir: Path, name: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(Path(out_dir) / name, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> int:
    from repro_torch.launch.serve_crypto import build_mesh

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--log-n", type=int, default=20, help="dntt polynomial size")
    ap.add_argument("--mesh", default="1x1", help="'DxM' (data x model) mesh of the launch")
    ap.add_argument("--device", default=None, help="the card (default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    mesh = build_mesh(args.mesh, args.device)
    try:
        fails = run_he(mesh, args.batch, Path(args.out), args.seed)["status"] != "ok"
        fails += run_dntt(mesh, args.log_n, Path(args.out), args.seed)["status"] != "ok"
    finally:
        mesh.close()
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
