"""Helpers of the port's distribution tests (``tests/test_torch_sharding.py``,
``tests/test_torch_dntt.py``): seeded inputs, the world-of-one checks of
the sharded products and the engine's mesh mode, and :func:`run_rank`,
one rank of the 4-rank gloo test, run in a spawned process.  It imports
torch and the port only, never JAX."""
import os

import numpy as np
import torch
import torch.distributed as dist

import repro_torch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.serve.crypto_engine import (
    PolymulEngine,
    negacyclic_mul_sharded,
    polymul_sharded,
)
from repro_torch.sharding import ctx

ROWS = 4


def seeded_inputs(pl, seed: int, rows: int = ROWS):
    """Segments za, zb (rows, n, S) below 2^v and canonical residues ra, rb
    (t, rows, n), numpy int64 from ``seed``."""
    cfg = pl.config
    rng = np.random.default_rng(seed)
    seg = (rows, cfg.n, cfg.seg_count)
    za, zb = (rng.integers(0, 1 << cfg.v, size=seg, dtype=np.int64) for _ in range(2))
    ra, rb = (rng.integers(0, 1 << 62, size=(cfg.t, rows, cfg.n), dtype=np.int64)
              % pl.params.qs[:, None, None] for _ in range(2))
    return za, zb, ra, rb


def mesh_with(mesh, **sizes):
    """A Mesh of ``mesh``'s group with other axis sizes: for the checks
    that read sizes only, before any collective."""
    return mesh_mod.Mesh(mesh.device_mesh, mesh.axis_names, {**mesh.shape, **sizes},
                         mesh.device)


def check_world_of_one(mesh, pl, inputs, want_poly, want_nega) -> None:
    """On a (1, 1) mesh: polymul_sharded (two all-gathers, no byte crossing
    a device) and negacyclic_mul_sharded equal ``want_poly`` and
    ``want_nega`` exactly, and PolymulEngine(mesh=) serves three requests
    (one padded slot) each equal to its row of ``want_poly``."""
    za, zb, ra, rb = (torch.as_tensor(x) for x in inputs)
    with ctx.count_collectives() as coll:
        got = polymul_sharded(pl, za, zb, mesh=mesh)
    assert coll.calls == {"all_gather": 2} and coll.peer_bytes == {"all_gather": 0}
    np.testing.assert_array_equal(got.numpy(), want_poly)
    np.testing.assert_array_equal(negacyclic_mul_sharded(pl, ra, rb, mesh=mesh).numpy(),
                                  want_nega)
    eng = PolymulEngine(batch_slots=ROWS, mesh=mesh)
    epl = eng.plan(pl.n, pl.t, pl.v, device="cpu")
    futs = [eng.submit(epl, za[r], zb[r]) for r in range(ROWS - 1)]
    eng.run_until_idle()
    for r, f in enumerate(futs):
        np.testing.assert_array_equal(f.result().numpy(), want_poly[r])
    snap = eng.snapshot()
    assert (snap["dispatches"], snap["padded_slots"], snap["served"]) == (1, 1, ROWS - 1)


def run_rank(rank: int, world: int, workdir: str, inputs: dict) -> None:
    """One rank of the 4-rank gloo world: it joins through a ``FileStore``
    in ``workdir``, runs the port's distributed paths on the seeded
    ``inputs`` handed over by the parent, and saves what it got as
    ``rank<r>.npz`` beside the store."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.core import dntt
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.train.aggregation import compressed_psum_draws

        out = {}
        dm = make_mesh((2, 2), ("data", "model"), device="cpu")  # the reference's host_mesh_4
        pl = repro_torch.plan(*inputs["plan"], device="cpu")
        za, zb, ra, rb = (torch.as_tensor(inputs[k]) for k in ("za", "zb", "ra", "rb"))
        out["polymul"] = polymul_sharded(pl, za, zb, mesh=dm).numpy()
        out["negacyclic"] = negacyclic_mul_sharded(pl, ra, rb, mesh=dm).numpy()
        tabs = dntt.make_fourstep_tables(*inputs["dntt"])
        a, b = torch.as_tensor(inputs["a"]), torch.as_tensor(inputs["b"])
        out["fourstep_m2"] = dntt.negacyclic_mul_fourstep(
            a, b, tabs, dntt.make_shard_constrain(dm)).numpy()
        m4 = make_mesh((4,), ("model",), device="cpu")
        cons = dntt.make_shard_constrain(m4)
        out["fourstep_m4"] = dntt.negacyclic_mul_fourstep(a, b, tabs, cons).numpy()
        out["fourstep_ntt_m4"] = dntt.fourstep_ntt(a, tabs, cons).numpy()
        pod = make_mesh((4,), ("pod",), device="cpu")
        grads = {k: torch.as_tensor(v) for k, v in inputs["grads"][rank].items()}
        draws = [torch.as_tensor(d) for d in inputs["draws"][rank]]
        got = compressed_psum_draws(grads, draws, pod)
        for k, v in got.items():
            out["psum_" + k] = v.numpy()
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
