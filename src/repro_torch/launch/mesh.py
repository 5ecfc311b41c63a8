"""Device meshes on ``torch.distributed`` (the port of ``repro.launch.mesh``).

Single pod : (data=16, model=16)            = 256 ranks
Multi-pod  : (pod=2, data=16, model=16)     = 512 ranks

A :class:`Mesh` is a :class:`torch.distributed.device_mesh.DeviceMesh`
with the reference's axis names over a real process group: NCCL when the
mesh's device is the card, gloo only when the caller asks for the CPU.
Neither falls back to the other.  One rank is one device: on one card the
mesh is world size 1, ``(data=1, model=1)``, as the reference's
:func:`make_local_mesh` is one device.

Defined as functions, so importing this module starts no process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
from types import MappingProxyType
from typing import Mapping

import torch
import torch.distributed as dist

from repro_torch.errors import UnservableConfigError

__all__ = [
    "Mesh",
    "backend_for",
    "make_local_mesh",
    "make_mesh",
    "make_production_mesh",
    "validate_mesh",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A device mesh: the ``DeviceMesh``, its ``axis_names``, ``shape``
    (axis -> size, in axis order, read as ``mesh.shape[axis]`` exactly as
    the reference's rules read a jax mesh), the device this rank computes
    on, and the process group of each axis (:meth:`group`).
    :meth:`close` destroys the process group when the mesh started it."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis_names: tuple[str, ...]
    shape: Mapping[str, int]
    device: torch.device
    _owned_store: str | None = None  # the store's directory, when this mesh started the group

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def close(self) -> None:
        """Destroy the process group if this mesh started it (and remove its
        store's directory); a mesh over a group its caller started leaves
        the group up."""
        if self._owned_store is None:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self._owned_store, ignore_errors=True)
        object.__setattr__(self, "_owned_store", None)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def backend_for(device: torch.device) -> str:
    """The process-group backend of a mesh on ``device``: NCCL on the card,
    gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _resolve_device(device) -> torch.device:
    """The card unless the caller asks for the CPU (as ``repro_torch.plan``
    resolves it)."""
    from repro_torch.api import _resolve_device as resolve  # deferred: api is heavy

    return resolve(device)


def _start_world_of_one(device: torch.device) -> str:
    """Start a process group of world size 1 with its store in a fresh
    temporary directory (a ``FileStore``: no socket, no network); returns
    the directory."""
    store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    kw = {"device_id": device} if device.type == "cuda" else {}
    try:
        dist.init_process_group(backend_for(device), store=store, rank=0, world_size=1, **kw)
    except BaseException:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    return store_dir


def _check_backend(device: torch.device) -> None:
    want, got = backend_for(device), dist.get_backend()
    if got != want:
        raise UnservableConfigError(
            f"a mesh on {device} needs a {want} process group, but the launched world runs "
            f"{got}; launch the world on {want} (no mesh falls back to another backend)",
            knob="mesh", value=got, alternatives=(want,),
        )


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over the launched world
    (every rank calls it, in the same order).  Its ranks must be exactly
    the world's; with no process group up, a mesh of one rank starts a
    world of one (:func:`make_local_mesh`), any larger one is refused.
    ``device``: the card (the default) or ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} do not match")
    dev = _resolve_device(device)
    size = math.prod(shape)
    owned = None
    if not dist.is_initialized():
        if size != 1:
            raise UnservableConfigError(
                f"a {shape} mesh needs a world of {size} ranks, and no process group is up; "
                f"launch {size} ranks (torch.distributed.init_process_group) first",
                knob="mesh", value=shape, alternatives=((1,) * len(shape),),
            )
        owned = _start_world_of_one(dev)
    try:
        _check_backend(dev)
        world = dist.get_world_size()
        if world != size:
            raise UnservableConfigError(
                f"a {shape} mesh needs {size} ranks, the launched world has {world}",
                knob="mesh", value=shape, alternatives=(),
            )
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    except BaseException:
        if owned is not None:
            dist.destroy_process_group()
            shutil.rmtree(owned, ignore_errors=True)
        raise
    return Mesh(device_mesh=dm, axis_names=axes, shape=MappingProxyType(dict(zip(axes, shape))),
                device=dev, _owned_store=owned)


def make_local_mesh(device=None) -> Mesh:
    """The ``(data=1, model=1)`` mesh of one device (tests, one card).  If
    no process group is up it starts one of world size 1, NCCL on the card
    or gloo on the CPU, with its store in a temporary directory, so it
    needs no network; :meth:`Mesh.close` destroys that group again.  A
    group that is already up must be of world size 1."""
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production meshes: (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``.  Refused (knob
    ``mesh``) unless the launched world has its 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise UnservableConfigError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh {shape} needs "
            f"{need} ranks, the launched world has {world}",
            knob="mesh", value=shape, alternatives=("make_local_mesh()",),
        )
    return make_mesh(shape, axes, device)


def validate_mesh(mesh) -> dict:
    """Basic sanity facts of a mesh (the reference's record)."""
    return {
        "axis_names": tuple(mesh.axis_names),
        "shape": dict(mesh.shape),
        "n_devices": math.prod(mesh.shape.values()),
    }
