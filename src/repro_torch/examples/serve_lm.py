"""Batched serving demo: prefill and greedy decode through the LM
``Engine`` of the port, on a reduced configuration from a seeded random
init (port of the reference's ``examples/serve_lm.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch yi-6b] [--device cpu]

Every arch of the registry serves, the MoE ones (dbrx-132b,
llama4-maverick-400b-a17b) too.

Without ``--device`` it runs on the card, where every attention is K7.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = registry.get(args.arch).reduced()
    device = torch.device(args.device)
    params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    eng = Engine(cfg, params, batch_slots=4, max_len=128, device=device)
    prompts = [
        np.array([5, 7, 11], np.int32),
        np.array([2, 4, 6, 8], np.int32),
        np.array([100, 200], np.int32),
    ]
    outs = eng.generate(prompts, max_new=args.max_new)
    for i, o in enumerate(outs):
        print(f"request {i}: prompt={prompts[i].tolist()} -> {o}")
    print(f"[ok] {len(outs)} requests decoded {args.max_new} tokens each "
          f"({cfg.name} reduced, {device})")
    return outs


if __name__ == "__main__":
    main()
