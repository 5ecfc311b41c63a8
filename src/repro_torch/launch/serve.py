"""LM serving launcher: the batched decode engine (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b [--reduced] [--device cpu]

The model comes from a seeded random init (nothing is downloaded); every
arch of the registry serves, dbrx-132b and llama4-maverick through their
MoE layers.  Without ``--device`` it runs on the card, where every
attention is K7.  The prompts are ``--slots`` seeded token runs of 2 to 7 tokens, as
the reference's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    M.check_device(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(gen, cfg)
    eng = Engine(cfg, params, batch_slots=args.slots, max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab, size=rng.integers(2, 8)).astype(np.int32)
        for _ in range(args.slots)
    ]
    outs = eng.generate(prompts, max_new=args.max_new)
    for i, o in enumerate(outs):
        print(f"req {i}: {len(o)} tokens: {o[:8]}...")
    return outs


if __name__ == "__main__":
    main()
