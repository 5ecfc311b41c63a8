"""Activation-sharding policy context, the port's collectives and the MoE
layer's per-row scatter and gather (the port of ``repro.sharding.ctx``
without its LM mesh policy, ``make_mesh_policy``, ROADMAP Queue 1).

The reference pins layouts with ``with_sharding_constraint`` and lets
GSPMD move the data.  Eager PyTorch has no compiler to do that, so a
policy here reshards explicitly: :func:`shard` slices a whole tensor (the
same on every rank, as a jax global array is) to this rank's block of a
spec, and :func:`gather` all-gathers the blocks back into the whole
tensor.  Every collective of the port goes through the functions here,
and :func:`count_collectives` counts their calls and bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.sharding import partition

__all__ = [
    "CollectiveCount",
    "activation_policy",
    "all_gather_dim",
    "all_reduce",
    "all_to_all_leading",
    "constrain",
    "count_collectives",
    "gather",
    "make_crypto_policy",
    "moe_gather",
    "moe_scatter",
    "shard",
]

_POLICY = None


@contextlib.contextmanager
def activation_policy(policy):
    global _POLICY
    old = _POLICY
    _POLICY = policy
    try:
        yield
    finally:
        _POLICY = old


# the MoE layer's kinds: the reference's LM mesh policy pins them; no
# policy of the port reshards them, so they pass through untouched
MOE_KINDS = ("moe_tokens", "moe_w")


def constrain(x, kind: str):
    if _POLICY is None or kind in MOE_KINDS:
        return x
    return _POLICY(x, kind)


def _refuse_mesh(fn: str) -> None:
    if getattr(_POLICY, "mesh", None) is not None:
        raise NotImplementedError(f"{fn} under a mesh policy: the LM halves of sharding/ are "
                                  "not ported yet (ROADMAP Queue 1)")


def moe_scatter(slot: torch.Tensor, xk: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Dispatch scatter, per batch row b: zeros(n_rows, D) with xk[b, i]
    added at row slot[b, i] (the reference's ``.at[slot_b].add(xk_b)``).
    slot (B, SK) int64, xk (B, SK, D) -> (B, n_rows, D) in xk's dtype.  The
    slots a row's kept tokens take are distinct, so only the sentinel row,
    which gathers the dropped tokens' zeros, ever sums."""
    _refuse_mesh("moe_scatter")
    B, SK, D = xk.shape
    buf = xk.new_zeros((B, n_rows, D))
    return buf.scatter_add_(1, slot[..., None].expand(B, SK, D), xk)


def moe_gather(eout: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Combine gather, per batch row b: eout[b, slot[b]] (the reference's
    ``take_along_axis``).  eout (B, n_rows, D), slot (B, SK) -> (B, SK, D)."""
    _refuse_mesh("moe_gather")
    return torch.gather(eout, 1, slot[..., None].expand(-1, -1, eout.shape[-1]))


# --------------------------------------------------------------------------
# collectives, counted
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveCount:
    """Per collective kind (``all_gather``, ``all_to_all``, ``all_reduce``):
    ``calls``, ``bytes`` (the bytes this rank handed in) and
    ``peer_bytes`` (the bytes it received from other ranks: (k - 1) x its
    block for an all-gather over k ranks, (k - 1) / k of its tensor for an
    all-to-all, and 2 (k - 1) / k of it for an all-reduce, a ring's
    share).  At world size 1 ``peer_bytes`` is 0: nothing leaves the
    device."""

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    peer_bytes: dict = dataclasses.field(default_factory=dict)

    def add(self, kind: str, nbytes: int, peer: int) -> None:
        for d, k in ((self.calls, 1), (self.bytes, nbytes), (self.peer_bytes, peer)):
            d[kind] = d.get(kind, 0) + k

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "peer_bytes": dict(self.peer_bytes)}


_COUNTS: list[CollectiveCount] = []


@contextlib.contextmanager
def count_collectives():
    """Count every collective of the port issued inside the block."""
    c = CollectiveCount()
    _COUNTS.append(c)
    try:
        yield c
    finally:
        _COUNTS.remove(c)


def _record(kind: str, nbytes: int, peer: int) -> None:
    for c in _COUNTS:
        c.add(kind, nbytes, peer)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in the group's
    rank order (one all-gather into a tensor whose leading dim is the
    gathered one)."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((size * xm.shape[0],) + tuple(xm.shape[1:]))
    # all_gather_single where this torch has it (all_gather_into_tensor is
    # deprecated there), all_gather_into_tensor before
    gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_into(out, xm, group=group)
    _record("all_gather", _nbytes(xm), (size - 1) * _nbytes(xm))
    return out.movedim(0, dim)


def all_to_all_leading(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """One ``all_to_all_single`` over ``group``: ``x``'s leading dim,
    contiguous, is split into ``size`` equal blocks, block k going to rank
    k; the result holds the block each rank sent here, in rank order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _record("all_to_all", _nbytes(x), _nbytes(x) * (size - 1) // size)
    return out


def all_reduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum of the ``size`` ranks' ``x`` (in place, returned)."""
    dist.all_reduce(x, group=group)
    _record("all_reduce", _nbytes(x), 2 * (size - 1) * _nbytes(x) // size)
    return x


# --------------------------------------------------------------------------
# explicit reshards by spec
# --------------------------------------------------------------------------


def _block(mesh, axes) -> tuple[int, int]:
    """(this rank's block index, block count) along a spec dim's axes,
    the first axis major."""
    axes = (axes,) if isinstance(axes, str) else axes
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + mesh.index(a)
        count *= mesh.shape[a]
    return index, count


def shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view;
    every named dim must divide its axes)."""
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        k, count = _block(mesh, axes)
        size = x.shape[d]
        if size % count:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide {axes} ({count}-way)")
        x = x.narrow(d, k * (size // count), size // count)
    return x


def gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor whose block under ``spec`` this rank holds as
    ``x``: an all-gather along each named dim, over the minor axis first."""
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in reversed((axes,) if isinstance(axes, str) else axes):
            x = all_gather_dim(x, d, mesh.group(a), mesh.shape[a])
    return x


def make_crypto_policy(mesh, plan):
    """Policy of the crypto serving layer: the polymul stage boundaries in
    the :func:`repro_torch.sharding.partition.polymul_specs` layout,
    ``"segments"`` / ``"limbs"`` batch-sharded over the data axes and
    ``"residues"`` channel-sharded over ``model``.  ``policy(x, kind)``
    slices a whole 3-dim tensor to this rank's block of its kind, and
    passes it through untouched when its batch dim does not divide the
    data axes (the reference's rule); ``policy.gather(x, kind)`` gathers
    a block of a kind back into the whole tensor."""
    specs = partition.polymul_specs(mesh, plan)
    size = partition._axes_size(mesh, partition.batch_axes(mesh))

    def policy(x, kind):
        if kind not in specs or x.dim() != 3 or x.shape[1 if kind == "residues" else 0] % size:
            return x
        return shard(x, specs[kind], mesh)

    def gather_kind(x, kind):
        return gather(x, specs[kind], mesh)

    policy.gather = gather_kind
    policy.specs = specs
    return policy
