"""The port's distribution layer held against the JAX reference: the
crypto partition rules against ``tuple(PartitionSpec)`` on the
reference's mesh shapes; at the wide width ``polymul_sharded``,
``negacyclic_mul_sharded`` and the engine's mesh mode on an in-process
gloo mesh of world size 1 against the reference's unsharded
``repro.polymul`` and ``repro.negacyclic_mul`` (equal to its sharded ones
bit for bit by the reference's own contract); the engine's refusals, the
shard-local plan, the mesh constructors and the launchers' mesh paths.
The int64 width's sharded products, int8 quantisation and the spawned
world of 4 gloo ranks are in ``tests/test_torch_dntt.py``.  Inputs are
made from a seed with numpy; the tolerance is exact equality."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro
from repro.sharding import partition as rpart

import repro_torch
from repro_torch.errors import UnservableConfigError
from repro_torch.launch import dryrun_crypto, serve_crypto
from repro_torch.launch import mesh as mesh_mod
from repro_torch.serve.crypto_engine import PolymulEngine, negacyclic_mul_sharded
from repro_torch.sharding import partition

from _torch_dist import check_world_of_one, mesh_with, seeded_inputs
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

INT64, WIDE = (64, 6, 30), (32, 4, 45)
SHAPES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "local": {"data": 1, "model": 1},
}


class FakeMesh:
    """The reference tests' stand-in: axis names and sizes only."""

    def __init__(self, shape):
        self.axis_names, self.shape = tuple(shape), dict(shape)


@pytest.fixture(scope="module")
def mesh():
    """A gloo mesh of world size 1 for this module; the process group is
    destroyed when the module ends, so the worker's next file can start
    its own."""
    m = mesh_mod.make_local_mesh(device="cpu")
    try:
        yield m
    finally:
        m.close()


@pytest.fixture(scope="module")
def wide_ref():
    """The port's wide plan, seeded inputs, and the reference's unsharded
    polymul and negacyclic_mul of them (its one wide datapath, jnp)."""
    pl = repro_torch.plan(*WIDE, device="cpu")
    ins = seeded_inputs(pl, seed=sum(WIDE))
    jpl = repro.plan(*WIDE, backend="jnp")
    za, zb, ra, rb = (jnp.asarray(x) for x in ins)
    return pl, ins, np.asarray(repro.polymul(jpl, za, zb)), \
        np.asarray(repro.negacyclic_mul(jpl, ra, rb))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_specs_match_reference(name):
    """batch_axes, batch_spec, batch_shard_spec, polymul_specs and
    plan_leaf_specs (int64 and wide plans) equal the reference's as
    tuples, on its FakeMesh shapes (16, 16), (2, 16, 16) and (1, 1)."""
    fm = FakeMesh(SHAPES[name])
    assert partition.batch_axes(fm) == rpart.batch_axes(fm)
    assert partition.batch_spec(fm, ndim=3) == tuple(rpart.batch_spec(fm, ndim=3))
    for shape in ((256, 128), (1, 128), (64, 4, 2)):
        assert partition.batch_shard_spec(fm, shape) == tuple(rpart.batch_shard_spec(fm, shape))
    for t in (6, 16, 32):
        want = rpart.polymul_specs(fm, type("T", (), {"t": t}))
        got = partition.polymul_specs(fm, type("T", (), {"t": t}))
        assert {k: tuple(v) for k, v in want.items()} == got
    for n, t, v in (INT64, WIDE):
        want = rpart.plan_leaf_specs(fm, repro.plan(n, t, v))
        got = partition.plan_leaf_specs(fm, repro_torch.plan(n, t, v, device="cpu"))
        assert got == {k: tuple(s) for k, s in want.items()}
        assert got[("rns" if v <= 31 else "wide") + "_q_limbs"] == (None,)
    assert partition.P(("data",), None) == tuple(JP(("data",), None))
    assert partition.P((), "model") == tuple(JP((), "model"))


def test_wide_sharded_products_and_engine_on_world_of_one(mesh, wide_ref):
    """At the wide width on the (1, 1) gloo mesh, polymul_sharded and
    negacyclic_mul_sharded equal the reference's unsharded products
    exactly, and PolymulEngine(mesh=) serves each request equal to its
    polymul; the batch and shape checks raise before any collective."""
    pl, ins, want_poly, want_nega = wide_ref
    check_world_of_one(mesh, pl, ins, want_poly, want_nega)
    ra, rb = torch.as_tensor(ins[2]), torch.as_tensor(ins[3])
    with pytest.raises(ValueError, match="does not divide the data axes"):
        negacyclic_mul_sharded(pl, ra, rb, mesh=mesh_with(mesh, data=3))
    with pytest.raises(ValueError, match=r"expected residues \(t="):
        negacyclic_mul_sharded(pl, ra[:1], rb[:1], mesh=mesh)


def test_engine_mesh_mode_refusals(mesh):
    """submit refuses the oracle width, and a t that the model axis does
    not divide, with the reference's messages; PolymulEngine refuses a
    batch_slots that the data axes do not divide, and a mesh= that is not
    a mesh (knob mesh)."""
    eng = PolymulEngine(batch_slots=4, mesh=mesh)
    orc = eng.plan(32, 2, 50, device="cpu")
    z = np.zeros((32, orc.config.seg_count), np.int64)
    with pytest.raises(ValueError, match="mesh mode serves int64/wide-width plans only"):
        eng.submit(orc, z, z)
    four = PolymulEngine(batch_slots=4, mesh=mesh_with(mesh, model=4))
    pl = four.plan(*INT64, device="cpu")
    z = np.zeros((64, pl.config.seg_count), np.int64)
    with pytest.raises(ValueError, match=r"t=6 RNS channels do not divide the model axis"):
        four.submit(pl, z, z)
    with pytest.raises(ValueError, match="must divide the mesh's data axes"):
        PolymulEngine(batch_slots=3, mesh=mesh_with(mesh, data=2))
    with pytest.raises(UnservableConfigError) as err:
        PolymulEngine(mesh=FakeMesh(SHAPES["local"]))
    assert err.value.knob == "mesh"


def test_shard_plan_slices_every_channel_table():
    """shard_plan(pl, 2, 4): t = 2, every per-channel table (twiddle,
    Shoup, four-step, RNS and decompose constants; a wide plan's consts)
    the slice of the whole plan's, built once per range; its decompose
    and residue product are the slices of the whole plan's."""
    for preset in (INT64, WIDE):
        pl = repro_torch.plan(*preset, device="cpu")
        loc = repro_torch.api.shard_plan(pl, 2, 4)
        assert loc is repro_torch.api.shard_plan(pl, 2, 4)
        assert repro_torch.api.shard_plan(pl, 0, pl.t) is pl
        assert loc.t == loc.params.t == loc.params.plan.t == 2 and loc.q == pl.q
        whole, part = repro_torch.api.plan_leaves(pl), repro_torch.api.plan_leaves(loc)
        assert set(whole) == set(part)
        for name, x in whole.items():
            want = x if name.endswith("q_limbs") else x[2:4]
            assert torch.equal(part[name], want), name
        za, _, ra, rb = (torch.as_tensor(x) for x in seeded_inputs(pl, seed=11, rows=2))
        assert torch.equal(repro_torch.decompose(loc, za), repro_torch.decompose(pl, za)[2:4])
        assert torch.equal(repro_torch.negacyclic_mul(loc, ra[2:4], rb[2:4]),
                           repro_torch.negacyclic_mul(pl, ra, rb)[2:4])
    assert loc.params.tables is None  # the wide width keeps its tables in consts
    ct = repro_torch.api.shard_plan(repro_torch.plan(*INT64, device="cpu"), 2, 4).params.tables
    assert ct.fs_sub_fwd_d is not None and ct.fwd_shoup_d is not None and ct.t == 2


def test_mesh_construction_and_refusals(mesh):
    """The world-of-one mesh is a (data=1, model=1) DeviceMesh on gloo and
    validate_mesh gives the reference's record; a second mesh over the
    same world leaves it up when closed; a mesh larger than the world and
    a production mesh on a world of one rank are refused with knob mesh."""
    assert mesh_mod.validate_mesh(mesh) == {"axis_names": ("data", "model"),
                                            "shape": {"data": 1, "model": 1}, "n_devices": 1}
    assert mesh.index("model") == 0 and mesh.size == 1
    assert torch.distributed.get_backend() == mesh_mod.backend_for(mesh.device) == "gloo"
    with mesh_mod.make_mesh((1,), ("pod",), device="cpu") as pod:
        assert pod.group("pod").size() == 1
    assert torch.distributed.is_initialized()
    for multi in (False, True):
        with pytest.raises(UnservableConfigError) as err:
            mesh_mod.make_production_mesh(multi_pod=multi, device="cpu")
        assert err.value.knob == "mesh"
    with pytest.raises(UnservableConfigError, match="needs 4 ranks"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        mesh_mod.make_mesh((1, 1), ("data",), device="cpu")


def test_launchers_on_mesh_1x1(mesh, tmp_path, capsys):
    """serve_crypto --mesh 1x1 serves every request on the CPU mesh, and
    the dry run's two records run, check and count their collectives
    (one all-gather each over model and data; three all-to-alls and one
    all-gather for the four-step product)."""
    assert serve_crypto.main(["--device", "cpu", "--mesh", "1x1", "--requests", "4",
                              "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["snapshot"]["served"] == 4 and out["mesh"] == {"data": 1, "model": 1}
    assert dryrun_crypto.main(["--device", "cpu", "--batch", "4", "--log-n", "8",
                               "--out", str(tmp_path)]) == 0
    he = json.loads((tmp_path / "dryrun_torch_parentt_he_b4.json").read_text())
    dn = json.loads((tmp_path / "dryrun_torch_parentt_dntt_2e8.json").read_text())
    assert he["equal"] and he["collectives"]["calls"] == {"all_gather": 2}
    assert dn["equal"] and dn["collectives"]["calls"] == {"all_to_all": 3, "all_gather": 1}
    assert dn["projected"]["single"]["basis"].startswith("counted from the shard shapes")
