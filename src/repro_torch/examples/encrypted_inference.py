"""Encrypted inference: a linear classifier evaluated on BFV-encrypted
activations; every homomorphic product runs on the PaReNTT multiplier
(on the card: the fused cascade kernel, and the compose kernel in each
decrypt).

The server sees only ciphertexts; the client encrypts features and
decrypts logits.  ct x plaintext-weight products need no relinearization.

Weights are fixed-point quantized; features are packed one per slot into
the polynomial coefficients and each class weight vector is packed
reversed, so coefficient (n-1) of the product polynomial holds the inner
product (the coefficient-packing trick for negacyclic rings).

Run on the card, or on the CPU with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.encrypted_inference [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bfv


def pack_weights(w_row: np.ndarray, n: int) -> np.ndarray:
    """Reverse-pack so (a * w)[d-1] = sum_i a_i w_i (negacyclic ring)."""
    out = np.zeros(n, dtype=np.int64)
    d = len(w_row)
    out[:d][::-1] = w_row  # w at positions d-1-i
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(0)
    d_in, n_cls = 64, 10
    # synthetic "digit" task: class templates + noise
    templates = rng.normal(size=(n_cls, d_in))
    X = np.stack([templates[i % n_cls] + 0.3 * rng.normal(size=d_in) for i in range(20)])
    labels = np.arange(20) % n_cls
    W = templates  # the nearest-template classifier is enough for the demo

    # fixed-point quantization
    fx, fw = 6, 6
    Xq = np.round(X * (1 << fx)).astype(np.int64)
    Wq = np.round(W * (1 << fw)).astype(np.int64)

    ctx = bfv.make_context(n=256, t=3, v=30, pt_mod=1 << 26, device=args.device)
    n = ctx.params.n
    gen = torch.Generator(device=ctx.plan.device)
    keys = bfv.keygen(gen.manual_seed(0), ctx)
    wpolys = [pack_weights(Wq[c], n) for c in range(n_cls)]

    correct = 0
    for i, (x, y) in enumerate(zip(Xq, labels)):
        poly = np.zeros(n, dtype=np.int64)
        poly[:d_in] = x % ctx.pt_mod
        ct = bfv.encrypt(gen.manual_seed(100 + i), poly, keys, ctx)
        logits = []
        for wpoly in wpolys:
            prod = bfv.mul_plain(ct, wpoly, ctx)  # two PaReNTT products
            v = int(bfv.decrypt(prod, keys, ctx)[d_in - 1])
            if v > ctx.pt_mod // 2:
                v -= ctx.pt_mod
            logits.append(v / (1 << (fx + fw)))
        pred = int(np.argmax(logits))
        plain = int(np.argmax(X[i] @ W.T))
        if pred != plain:
            raise AssertionError(f"sample {i}: encrypted prediction {pred}, plaintext {plain}, "
                                 f"logits {logits}")
        correct += pred == y
    print(f"[ok] encrypted == plaintext predictions on all 20 samples "
          f"({ctx.plan.config.backend} on {ctx.plan.device})")
    print(f"     accuracy {correct}/20 (synthetic task)")
    print(f"     each class logit = 1 homomorphic ct x pt product "
          f"= 2 PaReNTT negacyclic multiplications (t={ctx.params.t} RNS channels)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
