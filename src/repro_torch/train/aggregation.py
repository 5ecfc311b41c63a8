"""Cross-pod gradient aggregation paths (PyTorch port of
``repro.train.aggregation``):

1. ``compressed_psum`` — int8 stochastic-rounding gradient compression for
   the inter-pod hop (4x less traffic than float32): every rank quantizes
   its gradients with its own scale and the int32 sums, the float32 scale
   sum and the rank count are all-reduced over the ``pod`` axis' group.
2. HE-secured aggregation — the paper's motivating application [1]:
   each worker quantizes its gradients, packs them into R_{n,q} plaintext
   polynomials and BFV-encrypts them; the untrusted reducer sums the
   ciphertexts (it never sees a plaintext gradient); the trusted party
   decrypts the sum.  Every homomorphic product rides the PaReNTT
   multiplier (:mod:`repro_torch.core.bfv`).

Gradients are dicts, lists or tuples of tensors, flattened in the
reference's leaf order (dict keys sorted, as ``jax.tree`` visits them).
The stochastic rounding draws its uniforms from an explicit
``torch.Generator`` where the reference takes a jax key; the ``*_draws``
forms take the draws as tensors.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import bfv


# --------------------------------------------------------------------------
# int8 stochastic-rounding compression
# --------------------------------------------------------------------------


def quantize_int8_draws(x: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale, stochastic rounding (unbiased) on the uniform
    draws ``r`` in [0, 1) (shaped like ``x``): (int8 values, float32 scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    y = xf / scale
    lo = torch.floor(y)
    q = lo + (r.to(device=xf.device, dtype=torch.float32) < y - lo).to(torch.float32)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_int8_draws` with uniforms drawn from ``generator``
    (on ``x``'s device)."""
    r = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return quantize_int8_draws(x, r)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_draws(grads: Any, draws: Sequence[torch.Tensor], mesh,
                          axis: str = "pod") -> Any:
    """All-reduce ``grads`` over the mesh axis ``axis`` with an int8
    payload, each leaf rounded on its draws (in :func:`tree_leaves`
    order).  Scales are reduced in float32; values int32-summed after
    widening (a sum of int8 over <= 2^23 ranks cannot overflow int32); the
    result, ``qsum * (ssum / k) / k`` over the k ranks, is the mean in the
    leaf's dtype, the same on every rank."""
    from repro_torch.sharding import ctx  # deferred: no collectives for the HE path

    leaves = tree_leaves(grads)
    if len(draws) != len(leaves):
        raise ValueError(f"compressed_psum: {len(draws)} draws for {len(leaves)} leaves")
    group, size = mesh.group(axis), mesh.shape[axis]
    out = []
    for leaf, r in zip(leaves, draws):
        q, s = quantize_int8_draws(leaf, r)
        ssum = ctx.all_reduce(s.reshape(1), group, size)[0]
        qsum = ctx.all_reduce(q.to(torch.int32), group, size)
        n = ctx.all_reduce(torch.ones(1, dtype=torch.float32, device=leaf.device), group, size)[0]
        out.append((qsum.to(torch.float32) * (ssum / n) / n).to(leaf.dtype))
    return tree_unflatten(grads, out)


def compressed_psum(grads: Any, generator: torch.Generator | None, mesh,
                    axis: str = "pod") -> Any:
    """:func:`compressed_psum_draws` with each leaf's uniforms drawn from
    ``generator`` in turn (the reference splits its key per leaf)."""
    draws = [torch.rand(leaf.shape, generator=generator, device=leaf.device,
                        dtype=torch.float32) for leaf in tree_leaves(grads)]
    return compressed_psum_draws(grads, draws, mesh, axis)


# --------------------------------------------------------------------------
# HE-secured aggregation (BFV, PaReNTT-powered)
# --------------------------------------------------------------------------


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nest of dicts, lists and tuples, dict keys in
    sorted order (the order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like: Any, leaves: Sequence[torch.Tensor]) -> Any:
    """A nest shaped like ``like`` holding ``leaves`` in :func:`tree_leaves`
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    return build(like)


class HeAggregator:
    """Packs flat gradients into BFV plaintexts and aggregates ciphertexts,
    on the card unless ``device="cpu"`` is passed.

    Quantization: symmetric fixed point with ``frac_bits``; the plaintext
    modulus must hold sum_i |q_i| < pt_mod / 2 across workers."""

    def __init__(self, n: int = 1024, t: int = 3, v: int = 30, pt_mod: int = 1 << 24,
                 frac_bits: int = 12, device=None):
        self.ctx = bfv.make_context(n=n, t=t, v=v, pt_mod=pt_mod, device=device)
        self.frac = frac_bits
        self.n = n

    def keygen(self, gen: torch.Generator) -> bfv.KeyPair:
        return bfv.keygen(gen, self.ctx)

    def _quantize(self, flat: torch.Tensor) -> torch.Tensor:
        """float32 values -> int64 fixed point, clipped to pt_mod / 4."""
        q = torch.round(flat.to(torch.float32) * (1 << self.frac)).to(torch.int64)
        lim = self.ctx.pt_mod // 4
        return q.clamp(-lim, lim)

    def _pack(self, qvals: torch.Tensor) -> torch.Tensor:
        """Signed ints (size,) -> (ceil(size / n), n) polynomials mod pt."""
        pad = (-qvals.numel()) % self.n
        qp = torch.nn.functional.pad(qvals, (0, pad))
        return (qp % self.ctx.pt_mod).reshape(-1, self.n)

    def encrypt_grads(self, gen: torch.Generator, flat: torch.Tensor,
                      keys: bfv.KeyPair) -> bfv.Ciphertext:
        flat = torch.as_tensor(flat, device=self.ctx.plan.device)
        return bfv.encrypt(gen, self._pack(self._quantize(flat)), keys, self.ctx)

    def aggregate(self, cts: Sequence[bfv.Ciphertext]) -> bfv.Ciphertext:
        """The untrusted reducer's step: ciphertext-only addition."""
        return bfv.add_many(list(cts), self.ctx)

    def decrypt_mean(self, ct: bfv.Ciphertext, keys: bfv.KeyPair, num_workers: int,
                     size: int) -> np.ndarray:
        """The first ``size`` decrypted values, signed and scaled back, over
        ``num_workers``: float64 on the host."""
        dec = bfv.decrypt(ct, keys, self.ctx)  # (num_ct, n) in [0, pt)
        flat = dec.reshape(-1)[:size]
        half = self.ctx.pt_mod // 2
        signed = np.where(flat > half, flat - self.ctx.pt_mod, flat)
        return signed.astype(np.float64) / (1 << self.frac) / num_workers


def he_aggregate_gradients(agg: HeAggregator, worker_grads: Sequence[Any],
                           gen: torch.Generator, keys: bfv.KeyPair) -> Any:
    """One round: each worker encrypts its flat gradient (its samples drawn
    from ``gen`` in turn), the reducer sums the ciphertexts, and the mean
    comes back decrypted in the structure of ``worker_grads[0]`` (float32,
    on each leaf's device)."""
    flats = [torch.cat([x.detach().reshape(-1).to(torch.float32) for x in tree_leaves(g)])
             for g in worker_grads]
    size = flats[0].numel()
    cts = [agg.encrypt_grads(gen, f, keys) for f in flats]
    mean = agg.decrypt_mean(agg.aggregate(cts), keys, len(flats), size)
    out, off = [], 0
    for ref in tree_leaves(worker_grads[0]):
        k = ref.numel()
        out.append(torch.as_tensor(mean[off:off + k].reshape(ref.shape), dtype=torch.float32,
                                   device=ref.device))
        off += k
    return tree_unflatten(worker_grads[0], out)
