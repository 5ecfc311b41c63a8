"""Quickstart: PaReNTT long polynomial modular multiplication through the
plan/execute API of the PyTorch port.

1. Every backend against the bigint schoolbook oracle: the kernel
   backends ``cuda``, ``cuda_fused`` and ``cuda_fused_e2e`` and the plain
   ``torch``, one entry point, ``repro_torch.polymul``.
2. Width dispatch: the SAME call serves the paper's t=6/v=30 (int64
   kernels), t=4/v=45 (the digit-split wide datapath, plain PyTorch on the
   plan's device) and a v > 46 (host bigint oracle) configuration.
3. The paper's operating point: n=4096, 180-bit q, t=6 RNS channels of
   v=30-bit special primes, batched through ``repro_torch.polymul``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--smoke] [--device cpu]

Without ``--device`` it runs on the card; ``--device cpu`` runs the
kernel backends' plain versions.  ``--smoke`` runs 1 and 2 at small n
only.
"""
import argparse
import random
import time

import numpy as np
import torch

import repro_torch
from repro_torch.core import polymul as pm


def check_backends(n: int, t: int, v: int, device) -> None:
    """Every backend, one code path, against the schoolbook."""
    rng = random.Random(0)
    pl0 = repro_torch.plan(n=n, t=t, v=v, device=device)
    a = [rng.randrange(pl0.q) for _ in range(n)]
    b = [rng.randrange(pl0.q) for _ in range(n)]
    want = pm.schoolbook_negacyclic(a, b, pl0.q)
    for backend in repro_torch.BACKENDS:
        pl = repro_torch.plan(n=n, t=t, v=v, backend=backend, device=device)
        assert repro_torch.polymul_ints(pl, a, b) == want, f"mismatch on backend={backend}"
        print(f"[ok] n={n}, q={pl0.q.bit_length()}-bit, backend={backend} on "
              f"{pl.device}: PaReNTT == schoolbook")


def check_width_dispatch(n: int, device) -> None:
    """One entry point, three datapaths: plan() resolves the width.
    Checked against the schoolbook oracle, which is independent of every
    datapath (the v > 46 width runs oracle_multiply itself)."""
    rng = random.Random(1)
    for t, v in ((3, 30), (4, 45), (2, 50)):
        pl = repro_torch.plan(n=n, t=t, v=v, device=device)
        a = [rng.randrange(pl.q) for _ in range(n)]
        b = [rng.randrange(pl.q) for _ in range(n)]
        assert repro_torch.polymul_ints(pl, a, b) == pm.schoolbook_negacyclic(a, b, pl.q)
        print(f"[ok] width={pl.config.width:<6} (t={t}, v={v}, q={pl.q.bit_length()}-bit, "
              f"backend={pl.config.backend} on {pl.device}): polymul == schoolbook oracle")


def paper_operating_point(device) -> None:
    pl = repro_torch.plan(n=4096, t=6, v=30, device=device)
    print(f"n=4096, t=6 special primes of 30 bits, q = {pl.q.bit_length()} bits, "
          f"backend={pl.config.backend}")
    for s in pl.params.primes:
        terms = " ".join(f"{'+' if sg > 0 else '-'}2^{e}" for e, sg in s.beta_terms)
        print(f"   q_i = 2^30 - ({terms} - 1) = {hex(s.q)}")
    rng_np = np.random.default_rng(0)
    batch = 4
    S = pl.config.seg_count
    za = torch.as_tensor(rng_np.integers(0, 1 << 30, size=(batch, 4096, S)), device=pl.device)
    zb = torch.as_tensor(rng_np.integers(0, 1 << 30, size=(batch, 4096, S)), device=pl.device)

    def call():
        out = repro_torch.polymul(pl, za, zb)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    out = call()  # first use
    t0 = time.perf_counter()
    for _ in range(3):
        out = call()
    dt = (time.perf_counter() - t0) / 3 / batch
    print(f"[ok] batched 180-bit x 4096-coeff modular multiplication: {dt * 1e3:.3f} ms/poly "
          f"on {pl.device} (host clock, synchronised)")
    print("     output limbs shape:", tuple(out.shape))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="small-n correctness only")
    ap.add_argument("--device", default=None,
                    help="plan device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args()
    # One switch (backend=) selects the datapath of the whole pipeline:
    #   "torch"           the plain PyTorch reference
    #   "cuda"            one kernel per stage (residues round-trip device memory)
    #   "cuda_fused"      decompose, the fused NTT -> (.) -> iNTT cascade, compose
    #   "cuda_fused_e2e"  decompose -> cascade -> compose in one kernel
    #   "auto"            cuda_fused_e2e or cuda_fused on the card, torch on the CPU
    check_backends(n=64 if args.smoke else 256, t=3, v=30, device=args.device)
    check_width_dispatch(n=32 if args.smoke else 64, device=args.device)
    if not args.smoke:
        paper_operating_point(args.device)


if __name__ == "__main__":
    main()
