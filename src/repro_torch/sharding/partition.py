"""Partitioning rules of the crypto workload (the port of the crypto half
of ``repro.sharding.partition``).

Mesh axes:
  * ``pod``   — inter-pod data parallel (multi-pod mesh only)
  * ``data``  — intra-pod data parallel
  * ``model`` — the RNS channels: the paper's t parallel datapaths

A spec is a :class:`P`: one entry per tensor dim, each an axis name, a
tuple of axis names (the dim sharded over their product, the first axis
major) or ``None`` (the dim whole on every rank).  A one-name tuple is
stored as the name and an empty one as ``None``, as jax's
``PartitionSpec`` stores them, so
``P(...) == tuple(jax.sharding.PartitionSpec(...))``.  A dim that the
mesh axes do not divide falls back to ``None`` (:func:`_fit`), as in the
reference.  Rules read only ``mesh.axis_names`` and ``mesh.shape[axis]``.
"""
from __future__ import annotations

__all__ = [
    "P",
    "batch_axes",
    "batch_shard_spec",
    "batch_spec",
    "plan_leaf_specs",
    "polymul_specs",
]


class P(tuple):
    """An immutable partition spec: ``P("model", None)``, ``P(("pod",
    "data"), None, None)``, ``P()``."""

    def __new__(cls, *dims):
        out = []
        for d in dims:
            if isinstance(d, (tuple, list)):
                d = tuple(d)
                d = None if not d else d[0] if len(d) == 1 else d
            if not (d is None or isinstance(d, str) or
                    (isinstance(d, tuple) and all(isinstance(a, str) for a in d))):
                raise TypeError(f"a spec dim is an axis name, a tuple of them or None, got {d!r}")
            out.append(d)
        return super().__new__(cls, out)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, *, ndim: int = 2) -> P:
    """Batches: batch dim over (pod, data); rest whole."""
    return P(batch_axes(mesh), *([None] * (ndim - 1)))


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(mesh, dim: int, axes):
    """Axes if the dim divides evenly, else replicate."""
    return axes if dim % _axes_size(mesh, axes) == 0 else None


def batch_shard_spec(mesh, shape) -> P:
    first = _fit(mesh, shape[0], batch_axes(mesh))
    return P(first, *([None] * (len(shape) - 1)))


# Plan leaves that carry NO RNS-channel axis (every other leaf of an
# int64 or wide plan is (t, ...)-leading and shards its channel dim over
# `model`).  Keyed by leaf NAME, not shape, so a coincidental t == L can
# never shard the composed-modulus limb vector.
_CRYPTO_REPLICATED_LEAVES = frozenset({"rns_q_limbs", "wide_q_limbs"})


def polymul_specs(mesh, plan) -> dict[str, P]:
    """Specs of the crypto serving tensors over a (data, model) mesh, the
    stage-boundary layout of one batched polymul:

    * ``segments`` / ``limbs`` — ``(B, n, S)`` / ``(B, n, L)`` operand and
      product tiles: batch over the data axes, coefficients and limbs
      whole (the n axis feeds the NTT butterflies, which must see whole
      polynomials);
    * ``residues`` — ``(t, B, n)`` residue polynomials: the RNS channel
      axis over ``model`` and batch over the data axes.

    ``plan`` is anything with ``.t``.  A channel count that the model axis
    does not divide replicates."""
    ba = batch_axes(mesh)
    ch = _fit(mesh, plan.t, "model" if "model" in mesh.axis_names else None)
    return {
        "segments": P(ba, None, None),
        "residues": P(ch, ba, None),
        "limbs": P(ba, None, None),
    }


def plan_leaf_specs(mesh, pl) -> dict[str, P]:
    """Per-leaf specs of a plan's device tables
    (:func:`repro_torch.api.plan_leaves`: an int64 plan's
    :class:`~repro_torch.core.ntt.ChannelTables` fields as ``ntt_<field>``
    and RNS constants as ``rns_<field>``, a wide plan's ``consts``): every
    ``(t, ...)``-leading table shards its channel dim over ``model`` (the
    twiddle, Shoup and four-step row tables and the per-channel CRT
    constants), so each shard holds exactly its channels' tables; the
    channel-free leaves (the composed-modulus limbs) replicate.  The
    shard-local plan (:func:`repro_torch.api.shard_plan`) is these slices."""
    from repro_torch.api import plan_leaves  # deferred: api imports the kernels

    t = pl.t
    ch = _fit(mesh, t, "model" if "model" in mesh.axis_names else None)
    out = {}
    for name, leaf in plan_leaves(pl).items():
        if name not in _CRYPTO_REPLICATED_LEAVES and leaf.dim() >= 1 and leaf.shape[0] == t:
            out[name] = P(ch, *([None] * (leaf.dim() - 1)))
        else:
            out[name] = P(*([None] * leaf.dim()))
    return out
