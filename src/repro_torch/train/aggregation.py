"""HE-secured gradient aggregation, the paper's motivating application [1]
(PyTorch port of the HE half of ``repro.train.aggregation``).

Each worker quantizes its gradients, packs them into R_{n,q} plaintext
polynomials and BFV-encrypts them; the untrusted reducer sums the
ciphertexts (it never sees a plaintext gradient); the trusted party
decrypts the sum.  Every homomorphic product rides the PaReNTT
multiplier (:mod:`repro_torch.core.bfv`).

Gradients are dicts, lists or tuples of tensors, flattened in the
reference's leaf order (dict keys sorted, as ``jax.tree`` visits them).
The int8 compression (``quantize_int8``, ``compressed_psum``) is not
ported yet.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import bfv


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
