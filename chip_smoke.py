#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero):

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. the build of all eleven CUDA sources (``nvcc``, one process per
   source, all started together) into the checkout's ``build/``: K1
   fused cascade, K2 fused e2e multiplier, K3 forward NTT, K4 inverse
   NTT, K5 decompose, K6 compose, K7 flash attention, and the
   multi-block K1-fs, K3-fs, K4-fs, K2-fs; ptxas's registers, stack
   frame and spills of each K1-K6 and multi-block instance (``[ptxas]``);
3. each kernel against its plain PyTorch version on the card: K1-K6 with
   exact int64 equality, at the paper's point (n=4096, t=6, v=30, 256
   rows) and at n=64, t=3 in all three reduction regimes (v = 29, 30,
   31); K1, K3 and K4 also at the edges of their register passes in all
   three regimes (``PASS_POINTS``: n = 4, 8, 2048, 4096 and the largest n
   ``plan()`` admits for each, 16384 for K1 and 32768 for K3 and K4;
   t = 3, 2 rows), with the CTAs an SM holds; K6 also at 1, 255 and 257
   rows with r = 0 and r = q - 1 in every channel, at the paper's point
   and at one chunk of 16 limbs, 17, 32 and 45 limbs (``COMPOSE_CORNERS``);
   K2 also at n=8192, t=6 (4 rows) and at the largest t ``plan()`` serves
   on K2 in each regime (``E2E_WIDE``: n = 16384, t = 8; n = 8192, t = 24;
   n = 4096, t = 48), as clusters of min(t, 8) CTAs of which the card holds
   at least one; K5, K6, K2 and K2-fs past 16 segments, limbs and channels
   (``CHANNEL_EDGES``: t = 9, 15, 16, 20, 30 at n = 64 and 4096, and at
   4096 t = 48 for K2/K2-fs and t = 169 for K5/K6), each also against the
   other e2e kernel; K7 in float32,
   every element within 1e-5 plus, for bfloat16 I/O, one bfloat16 step
   of the plain output, at the attention layers
   of gemma2-2b (global and local prefill at 8192 tokens, decode against
   an 8192-token cache) and yi-6b (prefill at 4096 tokens), all
   bfloat16, and at a small sweep (padding, non-causal, window, softcap,
   decode, the query that sees no key, every head dim and dtype the
   kernel is built for, each of its three variants: ``wgmma`` for bf16
   prefill, ``decode`` for bf16 with at most 8 query rows per kv head,
   ``simt`` for float32); at each model shape a control that rounds the
   probabilities to bfloat16 must fall outside that tolerance; K1-fs,
   K3-fs and K4-fs (``csrc/*_fs.cu``) at ``FS_POINTS`` (n = 16 ... 65536,
   t = 3, 2 rows, all three regimes) equal to their plain versions (the
   four-step plain PyTorch) and, where K1, K3 or K4 also serve n, to
   them, with the CTAs an SM holds of each launch; K2-fs
   (``csrc/fused_e2e_polymul_fs.cu``) at ``FS_POINTS`` x t = 3, 6, 8
   (``E2E_FS_T``), 2 rows, every regime ``plan()`` admits, equal to its
   plain version (K2's over the four-step cascade) and, where K2 also
   serves n, to K2, as clusters of min(t, 8) CTAs of which the card holds
   at least one;
4. the paths through the entry points a user calls, each with every
   launch counter zeroed just before it and read just after:
   ``repro_torch.plan(n=4096, t=6, v=30)`` (auto: ``cuda_fused_e2e``) ->
   ``repro_torch.polymul`` on a seeded 256-row batch (K2 only) and
   ``repro_torch.negacyclic_mul`` (K1 only); ``polymul`` under
   ``backend="cuda"`` (K5, K3, K4, K6) and ``backend="cuda_fused"`` (K5,
   K1, K6), equal to the ``cuda_fused_e2e`` output on all rows and to the
   host bigint oracle on two sampled rows; and the stage entry points
   ``ntt``, ``intt``, ``decompose``, ``compose`` on the auto plan, one
   launch of their kernel each, with ``intt(ntt(r)) == r`` and
   ``compose(decompose(z))`` equal to z's integers; and
   ``repro_torch.kernels.attention.flash_attention`` at the four model
   shapes, one K7 launch and no other per call, of the variant
   ``ATTN_VARIANT`` names (``wgmma`` at the three prefill shapes,
   ``decode`` at gemma2 decode), its output finite and within tolerance
   of the plain version;
4b. the HE path (``[bfv]`` lines, each with the card's name and power
   limit), every call with the launch counters zeroed just before it and
   read just after: ``repro_torch.execute`` on the auto plan at the main
   path's batch (one K2 launch, equal to ``polymul``) and
   ``plan_from_params`` (the same config as ``plan()``); the BFV layer at
   the paper's point (``make_context(n=4096, t=6, v=30, pt_mod=2^24)``:
   keygen, three workers' encrypts of 64 seeded messages, ``add_many``,
   ``mul_plain`` by a seeded weight with |w| <= 8, decrypts and noise
   budgets), whose products launch K1 and whose decrypts K1 and K6 and
   nothing else (``BFV_LAUNCHES``), decrypt(encrypt(m)) == m, the sum and
   the ct x pt product right (the host product on every row), and every
   residue and decrypt equal to the same samples through a
   ``backend="torch"`` plan on the card; each call's CUDA-event median,
   the decrypt split into its device part and the host's exact rounding;
   one HE gradient-aggregation round of ``HeAggregator()`` (n=1024, t=3)
   over 3 workers x 2^20 float32 values, within 2e-3 of the plain mean,
   with its host-clock time; and the encrypted-inference example
   (``repro_torch.examples.encrypted_inference``), whose assertion must
   hold;
4c. the front door past one CTA (``[fs]`` lines): ``plan(n, 6, 30)`` at
   n = 65536 (16 rows) and 32768 (32 rows), ``FS_MAIN``, under ``auto``
   (which must resolve to ``cuda_fused_e2e`` with a multi-block schedule:
   its ``polymul`` is one K2-fs call and nothing else),
   ``backend="cuda_fused"`` and ``backend="cuda"``: ``polymul``,
   ``negacyclic_mul``, ``ntt`` and ``intt``, each call with the counters
   zeroed around it and launching what ``FS_LAUNCHES`` says, bit-exact
   against a ``backend="torch"`` plan on the card, and two polymul rows a
   size against the host bigint oracle;
4d. the slice's points past 16 channels at full width (``[wide]`` lines):
   W1 = ``plan(32768, 15, 30)`` (32 rows) and W2 = ``plan(16384, 30,
   30)`` (64 rows), ``WIDE_POINTS``, under ``auto`` (which must keep
   ``cuda_fused``) and on ``cuda_fused_e2e`` (one K2-fs call, two and four
   channels a CTA), ``cuda_fused``, ``cuda`` and ``torch``: ``polymul``
   with the counters zeroed around each call (``WIDE_LAUNCHES``), bit-exact
   against the torch plan on the card and one row against the host
   oracle; K2-fs, K5 and K6 on the points' operands against their plain
   versions;
5. timings: the median CUDA-event time of each kernel over 20 launches
   after warm-up (one call between two events, so a short kernel's time
   counts the host's issue time), K1-K6 also back to back behind a spin
   of the card (``device_ms``: device time), its plain version's time,
   and its bound (beside it, as ``bound_ms_earlier_count``, the bound from
   the earlier operation counts);
   K1, K3 and K4 with the CTAs an SM holds; K2
   also at one row (the latency case) with the clusters the card holds
   at once (``cudaOccupancyMaxActiveClusters``); K7 at each of
   its four shapes, with a PyTorch call computing the same function timed
   beside it as the yardstick (the port never calls it):
   ``scaled_dot_product_attention`` at yi-6b, the compiled
   ``flex_attention`` with a softcap ``score_mod`` at gemma2-2b; each
   K7 variant's ptxas registers, spills and shared memory, and the
   achieved TFLOP/s (prefill) or TB/s (decode); K1-fs, K3-fs and K4-fs
   at (6, 16, 65536) and K2-fs at (16, 65536, 6), one call and back to
   back, beside their plain versions and bounds (K2-fs's also with its
   32-bit scratch) and, for K2-fs, the clusters the card holds and each
   of its three launches' device time from a ``torch.profiler`` trace,
   beside cuda_fused's kernels (K5 on each operand, K1-fs's launches, K6)
   on the same inputs;
   and at W1 and W2: K2-fs, K5 and K6 one call and back to back, plain,
   bound, and K2-fs's launches beside cuda_fused's kernels;
6. the end-to-end time of one ``polymul`` call at the main path's shape
   on each backend, and of one ``negacyclic_mul`` call on the auto plan
   (host clock, synchronised), at FS_MAIN's n and rows on
   ``cuda_fused_e2e`` (auto, K2-fs), ``cuda_fused``, ``cuda`` and
   ``torch``, and at W1 and W2 on the four backends.

``python3 chip_smoke.py --time-kernels DIR NAME...`` times only the
kernels NAME (keys of ``KERNELS``: ``fused_polymul``, ``ntt_channels``,
..., and ``fused_e2e_polymul_fs``, K2-fs at (16, 65536, 6)) of the
checkout at DIR (for instance the parent commit unpacked with
``git archive``) at the main path's shape, one call between two events
and back to back (K2 also at one row), after checking each against its
plain version, and prints one ``[time-kernels]`` line per kernel; so
two commits compare on one card in one chip call.  ``--time-k2 DIR`` is
``--time-kernels DIR fused_e2e_polymul``.  ``--compose-variants`` times
K6 beside copies of its source with one of its two load orders switched
off (``COMPOSE_VARIANTS``) at ``COMPOSE_SHAPES``.

It prints a ``{"kernels": [...]}`` line (K7's entry carries the yi-6b
numbers and a ``shapes`` list with all four; K1's, K2's and K6's a
``launches_by_path`` beside ``launches``, the main path's count, with
phase 4b's paths; K1-fs's, K3-fs's, K4-fs's and K2-fs's ``launches``
sum phase 4c's and 4d's calls, each one a path of ``launches_by_path``;
the other kernels on phase 4d's paths list them in ``launches_by_path``
too; K2-fs's, K5's and K6's a ``wide`` object with their W1/W2 numbers)
and ends with
``{"ok": true, "device": {...}}``.  It imports neither JAX nor the JAX
package.  Without a CUDA device, or outside the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks.
HBM_BYTES_PER_S = 3.35e12
# No integer-64 rate is published; the scalar (non-tensor-core) peak of
# 67 TOP/s is used, so the operation bound is optimistic.
SCALAR_OPS_PER_S = 67e12
# Dense bf16 tensor-core rate: the bound of K7's two products, whatever
# units the kernel uses.
BF16_FLOPS_PER_S = 989e12

MAIN = dict(n=4096, t=6, v=30, rows=256)
SMALL = [dict(n=64, t=3, v=v, rows=3) for v in (29, 30, 31)]
# K2 at twice the paper's n, which one CTA per channel now holds, and at
# the largest t plan() serves on K2 in each regime (lazy W=4, lazy W=2,
# strict) with one channel a CTA (n = 16384) and three (n = 8192; at
# v = 31 the in-kernel decompose constants stop at t = 13 there), and at
# n = 4096, t = 48 (six channels a CTA, the staging cut to fit)
E2E_WIDE = [dict(n=8192, t=6, v=30, rows=4)] + [
    dict(n=n, t=t, v=v, rows=2)
    for n, t, v in ((16384, 8, 29), (16384, 8, 30), (16384, 8, 31),
                    (8192, 24, 29), (8192, 24, 30), (8192, 13, 31), (4096, 48, 30))
]
# K1, K3 and K4 at the edges of their register passes, t = 3, 2 rows, in
# all three regimes (lazy W=4 at v=29, lazy W=2 at v=30, strict at v=31):
# n = 4 and 8 (one stage a pass, 2 and 4 threads), 2048 and 4096 (three
# stages a pass after a first of g0 = 2 and 3), and the largest n plan()
# admits on the backend that runs each: kernel -> (backend, n values)
PASS_POINTS = {
    "fused_polymul": ("cuda_fused", (4, 8, 2048, 4096, 16384)),
    "ntt_channels": ("cuda", (4, 8, 2048, 4096, 32768)),
    "intt_channels": ("cuda", (4, 8, 2048, 4096, 32768)),
}
# K1-fs, K3-fs and K4-fs (the multi-block kernels) at t = 3, 2 rows, in all
# three regimes: n = 16 and 256 (one tile a polynomial, few passes), 1024,
# 4096 and 16384, where K1, K3 and K4 also serve and must give the same
# outputs, and past them, 32768 and 65536
FS_POINTS = (16, 256, 1024, 4096, 16384, 32768, 65536)
# K2-fs at FS_POINTS in the three regimes at these t (one channel a CTA of
# clusters of t CTAs), 2 rows, where plan() admits (n, t, v) on a kernel
# backend; against K2 where K2 also serves (n <= 16384)
E2E_FS_T = (3, 6, 8)
# the front door at full width past one CTA, t = 6, v = 30: n -> rows (2^20
# coefficients an operand, as many as the paper point's 256 rows of 4096)
FS_MAIN = {65536: 16, 32768: 32}
FS_T, FS_V = 6, 30
# the multi-block kernels' launches of each call on the auto plan
# (cuda_fused_e2e: K2-fs for polymul, K1-fs for negacyclic_mul, the cuda
# stage kernels for ntt and intt) and on backends cuda_fused and cuda, at
# n = 65536 and at 32768, where K3 and K4 hold a polynomial in one CTA
FS_LAUNCHES = {
    ("cuda_fused_e2e", "polymul"): {"fused_e2e_polymul_fs": 1},
    ("cuda_fused_e2e", "negacyclic_mul"): {"fused_polymul_fs": 1},
    ("cuda_fused", "polymul"): {"decompose": 2, "fused_polymul_fs": 1, "compose": 1},
    ("cuda_fused", "negacyclic_mul"): {"fused_polymul_fs": 1},
    ("cuda", "polymul", 65536): {"decompose": 2, "ntt_channels_fs": 2, "intt_channels_fs": 1,
                                 "compose": 1},
    ("cuda", "polymul", 32768): {"decompose": 2, "ntt_channels": 2, "intt_channels": 1,
                                 "compose": 1},
    ("cuda", "negacyclic_mul", 65536): {"ntt_channels_fs": 2, "intt_channels_fs": 1},
    ("cuda", "negacyclic_mul", 32768): {"ntt_channels": 2, "intt_channels": 1},
    ("ntt", 65536): {"ntt_channels_fs": 1}, ("ntt", 32768): {"ntt_channels": 1},
    ("intt", 65536): {"intt_channels_fs": 1}, ("intt", 32768): {"intt_channels": 1},
}
# K6 at one chunk of 16 limbs in each regime (t = 15, 14, 14 at v = 29,
# 30, 31), at 17 limbs (a second chunk of one), 32 (two chunks, three
# groups of channels) and 45, beside the paper's point; each at 1, 255
# and 257 rows (a partial last tile)
COMPOSE_CORNERS = [dict(n=64, t=15, v=29), dict(n=64, t=14, v=30), dict(n=64, t=14, v=31),
                   dict(n=64, t=15, v=30), dict(n=64, t=29, v=30), dict(n=64, t=40, v=31)]
COMPOSE_ROWS = (1, 255, 257)
# K5, K6, K2 and K2-fs past 16 segments, limbs and channels (v = 30): at
# n = 64 and 4096, t = 9 (two channels on some CTAs of a cluster), 15, 16
# (past 15 channels: the limb sums normalise between groups), 20 and 30
# (S = 30, L = 32/33, 10 Alg-2 blocks); at 4096 also t = 48, the most
# K2 and K2-fs serve there, and t = 169, the most primes the search gives
# at n = 4096, which only K5 and K6 (cuda, cuda_fused) serve: (n, t, rows)
CHANNEL_EDGES = [(64, t, 3) for t in (9, 15, 16, 20, 30)] + [
    (4096, t, 1) for t in (9, 15, 16, 20, 30, 48, 169)]
# the slice's points at full width, 2^20 coefficients an operand as at
# every earlier point: W1 = plan(32768, 15, 30), 32 rows (S = 15, L = 16,
# a 443-bit q: K2-fs past t = 8, two channels on some CTAs); W2 =
# plan(16384, 30, 30), 64 rows (S = 30, L = 32, 10 Alg-2 blocks, an
# 888-bit q: four channels a CTA): name -> (n, t, rows)
WIDE_POINTS = {"W1": (32768, 15, 32), "W2": (16384, 30, 64)}
WIDE_V = 30
# the kernels of one polymul call at each W point: backend -> launches
WIDE_LAUNCHES = {
    "cuda_fused_e2e": {"fused_e2e_polymul_fs": 1},
    ("cuda_fused", 32768): {"decompose": 2, "fused_polymul_fs": 1, "compose": 1},
    ("cuda_fused", 16384): {"decompose": 2, "fused_polymul": 1, "compose": 1},
    "cuda": {"decompose": 2, "ntt_channels": 2, "intt_channels": 1, "compose": 1},
    "torch": {},
}
LATENCY_ROWS = 1  # K2 is also timed at one row: the latency the paper is about
BACK_TO_BACK = 50  # calls queued behind one spin of the card (time_back_to_back)
SPIN_CYCLES = 50_000_000  # about 30 ms at the H100's clock: longer than issuing them
MAIN_CALLS = 3
TIMED_LAUNCHES = 20
PLAIN_RUNS = 5
E2E_RUNS = 10
ORACLE_ROWS = (0, 255)
SEED = 20260

# K7 at the full attention layer of two model configurations of the repo
# (src/repro/configs/gemma2_2b.py, yi_6b.py), bfloat16 as the LM computes:
# name -> ((B, Sq, Skv, H, Hk, D), flash_attention keywords)
ATTN_MODEL = {
    "gemma2_global_prefill": ((1, 8192, 8192, 8, 4, 256), dict(softcap=50.0)),
    "gemma2_local_prefill": ((1, 8192, 8192, 8, 4, 256), dict(window=4096, softcap=50.0)),
    "gemma2_decode": ((16, 1, 8192, 8, 4, 256), dict(softcap=50.0, q_offset=8191)),
    "yi6b_prefill": ((1, 4096, 4096, 32, 4, 128), {}),
}
ATTN_LIBRARY_SHAPE = "yi6b_prefill"  # its numbers head K7's entry (library: SDPA)
# the K7 variant (attention.attention_variant) that serves each model shape
ATTN_VARIANT = {
    "gemma2_global_prefill": "wgmma",
    "gemma2_local_prefill": "wgmma",
    "gemma2_decode": "decode",
    "yi6b_prefill": "wgmma",
}
# the sweep of tests/test_kernels_attention.py, the query that sees no key,
# and every (dtype, head dim) the kernel is built for:
# (name, (B, Sq, Skv, H, Hk, D), dtype, flash_attention keywords)
ATTN_SMALL = [
    ("mha", (1, 128, 128, 4, 4, 32), "float32", dict(blk_k=64)),
    ("gqa", (2, 256, 256, 4, 2, 32), "float32", dict(blk_k=64)),
    ("sq_lt_skv", (1, 128, 384, 8, 2, 64), "float32", dict(blk_k=64)),
    ("ragged", (1, 96, 160, 4, 4, 32), "float32", dict(blk_k=64)),
    ("non_causal", (1, 128, 128, 4, 4, 32), "float32", dict(causal=False, blk_k=64)),
    ("window", (1, 256, 256, 4, 4, 32), "float32", dict(window=64, blk_k=64)),
    ("softcap", (1, 128, 128, 4, 2, 32), "float32", dict(softcap=50.0, blk_k=64)),
    ("softcap_bends", (1, 128, 200, 4, 2, 64), "float32", dict(softcap=1.0, q_offset=72)),
    ("decode", (2, 1, 256, 4, 4, 32), "float32", dict(q_offset=200, blk_k=64)),
    ("no_key_blk64", (1, 4, 100, 2, 1, 32), "float32", dict(window=8, q_offset=500, blk_k=64)),
    ("no_key_blk128", (1, 4, 100, 2, 1, 32), "float32", dict(window=8, q_offset=500, blk_k=128)),
    ("f32_d128", (1, 100, 200, 4, 2, 128), "float32", dict(window=50, softcap=30.0)),
    ("f32_d256", (1, 70, 130, 2, 1, 256), "float32", dict(causal=False, window=40, q_offset=20)),
    ("bf16_d32", (1, 128, 128, 4, 4, 32), "bfloat16", dict(blk_k=64)),
    ("bf16_d64", (1, 90, 190, 4, 1, 64), "bfloat16", dict(q_offset=7)),
    ("bf16_d128_softcap_bends", (1, 256, 256, 8, 4, 128), "bfloat16", dict(softcap=1.0)),
    ("bf16_d256_window", (1, 200, 300, 8, 4, 256), "bfloat16", dict(window=100, softcap=50.0)),
    ("bf16_non_causal", (1, 130, 200, 2, 2, 128), "bfloat16", dict(causal=False)),
    ("bf16_no_key_wgmma", (1, 70, 130, 2, 1, 64), "bfloat16", dict(window=8, q_offset=500)),
    ("bf16_no_key_decode", (1, 4, 100, 2, 1, 32), "bfloat16", dict(window=8, q_offset=500,
                                                                     blk_k=64)),
    ("bf16_decode_ragged", (16, 1, 1000, 8, 4, 128), "bfloat16", dict(q_offset=999)),
    ("bf16_decode_window", (4, 1, 3000, 8, 2, 64), "bfloat16", dict(q_offset=2999, window=700)),
    ("bf16_decode_rows8", (2, 2, 517, 16, 4, 32), "bfloat16", dict(q_offset=515, softcap=50.0)),
]
# K7 against its plain version, per output element in float32:
# |kernel - plain| <= ATTN_ATOL, plus one bf16 step of the plain output
# for bf16 I/O.  Both compute in float32 and round once to the output
# type, so a value near a rounding boundary may land one step apart;
# ATTN_ATOL covers the float32 summation order (under 1e-6 at the model
# shapes).  A control that rounds P to bf16 before P @ V, as a bf16
# tensor-core kernel would, must fall outside it at every model shape.
ATTN_ATOL = 1e-5
# the library calls' check that they compute the same function, per
# element: they round P to bf16 before P @ V, which moves an output by up
# to 2^-9 of its largest p * |v| terms, so they get 2^-8 past one step
LIBRARY_ATOL = 2.0 ** -8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_inputs(torch, np, pl, rows: int, seed: int, device):
    """Segments (rows, n, S) of coefficients below q and canonical residues
    (t, rows, n), made with numpy from ``seed``."""
    cfg = pl.config
    rng = np.random.default_rng(seed)
    shape = (rows, cfg.n, cfg.seg_count)
    top = pl.q >> (cfg.v * (cfg.seg_count - 1))  # top segment bound keeps values < q

    def segments():
        z = rng.integers(0, 1 << cfg.v, size=shape, dtype=np.int64)
        z[..., -1] = rng.integers(0, top, size=shape[:-1], dtype=np.int64)
        return torch.as_tensor(z, device=device)

    qs = pl.params.qs[:, None, None]

    def residues():
        r = rng.integers(0, 1 << 62, size=(cfg.t, rows, cfg.n), dtype=np.int64) % qs
        return torch.as_tensor(r, device=device)

    return segments(), segments(), residues(), residues()


def exact(got, want, what: str) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    err = int((got - want).abs().max().item()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{what}: max |kernel - plain| = {err}, expected 0")
    return err


def time_back_to_back(torch, fn, launches: int, warmup: int = 3) -> float:
    """Milliseconds of device time per call over ``launches`` calls queued
    back to back behind a spin of the card, so the host's time to issue
    each call is hidden: what a launch costs the card, where
    ``time_launches`` (one call between two events) also counts the
    host's issue time for a short kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def launch_split(torch, fn, calls: int = TIMED_LAUNCHES) -> dict[str, float]:
    """Device milliseconds per call of each CUDA kernel that ``fn``
    launches, from a ``torch.profiler`` trace of ``calls`` calls after a
    warm-up: kernel name -> ms (the trace's self device time over the
    calls)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        name = re.search(r"(\w+_kernel)<", e.key)
        if us and name:
            split[name.group(1)] = split.get(name.group(1), 0.0) + us / 1e3 / calls
    if not split:
        raise AssertionError("torch.profiler's trace holds no device time of a kernel")
    return split


def time_launches(torch, fn, launches: int, warmup: int = 3) -> float:
    """Median milliseconds of one call over ``launches`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# work counts for the bound: integer operations the function needs on these
# inputs, one unit per add, sub, mul, shift, mask, compare, select or
# remainder, 32- or 64-bit (a conditional subtraction is compare + sub +
# select = 3)
# --------------------------------------------------------------------------

COND_SUB = 3
BARRETT = 5 + 3 * COND_SUB  # two shifts, two muls, one sub, three cond subs
BLOCK_BARRETT = 4 + 2 * COND_SUB  # shift, high product, product, sub, two cond subs
SHOUP = 5


def _mul_mod(mode: int) -> int:
    return 1 + (BLOCK_BARRETT if mode == 2 else BARRETT)  # product + reduction


def _canon(mode: int, window: int) -> int:
    return 0 if mode != 0 else COND_SUB * (2 if window == 4 else 1)


def _butterfly_ops(mode: int, window: int) -> tuple[int, int]:
    """(CT, GS) butterfly operation counts in a regime."""
    if mode == 0:
        ct = SHOUP + (COND_SUB + 3 if window == 4 else 1 + COND_SUB + 2 + COND_SUB)
        gs = 3 + 2 * COND_SUB + SHOUP + 2 * 4
    else:
        ct = _mul_mod(mode) + 2 * (1 + COND_SUB)
        gs = 2 * (1 + COND_SUB) + _mul_mod(mode) + 2 * 4
    return ct, gs


def transform_ops(n: int, mode: int, window: int, inverse: bool) -> int:
    """One (channel, row) forward or inverse transform with its exit
    canonicalize (K3, K4)."""
    ct, gs = _butterfly_ops(mode, window)
    return (n // 2) * (n.bit_length() - 1) * (gs if inverse else ct) + n * _canon(mode, window)


def cascade_ops(n: int, mode: int, window: int) -> int:
    """One (channel, row) cascade: two forward transforms, the canonical
    pointwise product, one inverse transform and the exit canonicalize."""
    ct, gs = _butterfly_ops(mode, window)
    butterflies = (n // 2) * (n.bit_length() - 1)
    point = 2 * _canon(mode, window) + _mul_mod(mode)
    return 2 * butterflies * ct + butterflies * gs + n * (point + _canon(mode, window))


def decompose_ops(S: int, t_prime: int, sau: int = 1) -> int:
    """One residue of one coefficient through the Alg-2 SAU circuit, its
    SAU network (Eq 5) ``sau`` operations: one product by beta."""
    ops = 0
    for rho in range(-(-S // t_prime)):
        base = rho * t_prime
        if t_prime > 1 and base + 1 < S:
            ops += sau + 1
        for k in range(2, t_prime):
            if base + k >= S:
                break
            ops += k * (sau + BARRETT) + 1
        ops += BARRETT + (1 if rho == 0 else 3)
    return ops + BARRETT


def compose_tail_ops(t: int, L: int, quotient: bool = True) -> int:
    """The Eq-10 limb sums and tail of one coefficient: the quotient
    floor(value / q) from t multiply-adds, a carry ripple that subtracts
    it times q, and one conditional correction (``quotient``); else a
    plain carry ripple and t - 1 conditional subtractions."""
    if quotient:
        return 2 * t * L + (t + 1) + 5 * L + 2 * COND_SUB * L
    return 2 * t * L + 3 * L + (t - 1) * 2 * COND_SUB * L


def compose_ops(t: int, L: int, earlier: bool = False) -> int:
    """One coefficient through K6: y_c = r_c q~_c mod q_c as a product and
    a block Barrett per channel, then the Eq-10 limb sums and quotient
    tail.  ``earlier``: PR 11-14's count (a product and a remainder per
    channel, the tail's t - 1 subtractions)."""
    if earlier:
        return 2 * t + compose_tail_ops(t, L, quotient=False)
    return t * (1 + BLOCK_BARRETT) + compose_tail_ops(t, L)


def channel_decompose_ops(pl, earlier: bool = False) -> int:
    """One coefficient's residues in all t channels (K5).  ``earlier``:
    PR 11-14's count, the SAU network as 1 + 3 n_terms shifts and adds
    (with the compose tail's t - 1 subtractions, more than the function
    needs; printed beside the bound only so earlier bounds compare)."""
    rp = pl.params.plan
    sau = 1 + 3 * max(len(c.beta_terms) for c in rp.dec) if earlier else 1
    return rp.t * decompose_ops(rp.seg_count, rp.t_prime, sau)


def e2e_ops(pl, mode: int, window: int, rows: int, earlier: bool = False) -> int:
    rp = pl.params.plan
    n, t, L = rp.n, rp.t, rp.L
    per_coeff = (
        2 * channel_decompose_ops(pl, earlier)
        + t * (_canon(mode, window) + _mul_mod(mode))
        + compose_tail_ops(t, L, quotient=not earlier)
    )
    return rows * (t * cascade_ops(n, mode, window) + n * per_coeff)


def bound(bytes_moved: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_calls(pl, inputs):
    """Each kernel's (wrapper call, plain-version call) on the main path's
    shapes of ``inputs``: the stage kernels take the operands flattened to
    the layouts the ops layer hands them."""
    from repro_torch.kernels import crt
    from repro_torch.kernels import ntt as kern

    p = pl.params
    za, zb, ra, rb = inputs
    z2 = za.reshape(-1, pl.config.seg_count)
    r2 = ra.reshape(pl.config.t, -1)
    return {
        "fused_polymul": (lambda: kern.fused_polymul_cuda(ra, rb, p.tables),
                          lambda: kern.fused_polymul_ref(ra, rb, p.tables)),
        "fused_e2e_polymul": (lambda: kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan),
                              lambda: kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan)),
        "ntt_channels": (lambda: kern.ntt_channels_cuda(ra, p.tables),
                         lambda: kern.ntt_channels_ref(ra, p.tables)),
        "intt_channels": (lambda: kern.intt_channels_cuda(ra, p.tables),
                          lambda: kern.intt_channels_ref(ra, p.tables)),
        "decompose": (lambda: crt.decompose_cuda(z2, p.plan),
                      lambda: crt.decompose_ref(z2, p.plan)),
        "compose": (lambda: crt.compose_cuda(r2, p.plan),
                    lambda: crt.compose_ref(r2, p.plan)),
    }


def wrappers():
    """Kernel name -> its wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels import attention, crt
    from repro_torch.kernels import ntt as kern

    return {
        "fused_polymul": kern.fused_polymul_cuda,
        "fused_e2e_polymul": kern.fused_e2e_polymul_cuda,
        "ntt_channels": kern.ntt_channels_cuda,
        "intt_channels": kern.intt_channels_cuda,
        "decompose": crt.decompose_cuda,
        "compose": crt.compose_cuda,
        "attention": attention.flash_attention_cuda,
        "fused_polymul_fs": kern.fused_polymul_fs_cuda,
        "ntt_channels_fs": kern.ntt_channels_fs_cuda,
        "intt_channels_fs": kern.intt_channels_fs_cuda,
        "fused_e2e_polymul_fs": kern.fused_e2e_polymul_fs_cuda,
    }


def counted(torch, fn):
    """Run ``fn`` with every launch counter zeroed just before and read
    just after: (its result, launches per kernel)."""
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in ws.items()}


def expect_launches(got: dict, want: dict, what: str) -> None:
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def check_kernels(dev) -> dict[str, int]:
    """Phase 3: K1-K6 against their plain versions, exact equality."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import ntt as kern

    max_err = {name: 0 for name in KERNELS}
    for cfg in [MAIN] + SMALL:
        pl = repro_torch.plan(cfg["n"], cfg["t"], cfg["v"], device=dev)
        inputs = seeded_inputs(torch, np, pl, cfg["rows"], SEED + cfg["v"], dev)
        shapes = []
        for name, (fn, ref) in kernel_calls(pl, inputs).items():
            got = fn()
            torch.cuda.synchronize()
            err = exact(got, ref(), f"{name} {cfg}")
            max_err[name] = max(max_err[name], err)
            shapes.append(f"{name} {tuple(got.shape)}")
        log(f"[kernels] n={cfg['n']} t={cfg['t']} v={cfg['v']} rows={cfg['rows']} "
            f"(mode, window)={kern.reduction_mode(pl.params.tables)[:2]}: "
            + ", ".join(shapes) + " equal their plain versions bit for bit")
    for cfg in E2E_WIDE:
        pl = repro_torch.plan(cfg["n"], cfg["t"], cfg["v"], backend="cuda_fused_e2e", device=dev)
        p = pl.params
        za, zb, _, _ = seeded_inputs(torch, np, pl, cfg["rows"], SEED + 1, dev)
        got = kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan)
        torch.cuda.synchronize()
        err = exact(got, kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan), f"fused_e2e {cfg}")
        max_err["fused_e2e_polymul"] = max(max_err["fused_e2e_polymul"], err)
        expect_cluster(pl, f"fused_e2e {cfg}")
        clusters = kern.e2e_max_active_clusters(p.tables, p.plan)
        if clusters < 1:
            raise AssertionError(f"fused_e2e {cfg}: the card holds no cluster")
        smem = kern.e2e_smem_bytes(cfg["n"], cfg["t"], pl.config.seg_count, pl.config.L)
        log(f"[kernels] n={cfg['n']} t={cfg['t']} v={cfg['v']} rows={cfg['rows']} "
            f"(mode, window)={kern.reduction_mode(p.tables)[:2]}: fused_e2e_polymul "
            f"{tuple(got.shape)}, clusters of {kern.fused_e2e_polymul_cuda.cluster} CTAs "
            f"({smem} B of shared memory at most), {clusters} clusters resident, equals its "
            "plain version bit for bit")
    return max_err


def check_pass_kernels(dev, max_err: dict[str, int]) -> None:
    """Phase 3 for K1, K3 and K4 at PASS_POINTS: exact equality with their
    plain versions, and the CTAs an SM holds at each n and regime."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import ntt as kern

    for name, (backend, ns) in PASS_POINTS.items():
        for n in ns:
            for v in (29, 30, 31):
                pl = repro_torch.plan(n, 3, v, backend=backend, device=dev)
                tables = pl.params.tables
                _, _, ra, rb = seeded_inputs(torch, np, pl, 2, SEED + n + v, dev)
                cuda, ref, blocks_per_sm, _ = pass_kernel(name)
                operands = (ra, rb) if name == "fused_polymul" else (ra,)
                want = ref(*operands, tables)
                got = cuda(*operands, tables)
                blocks = blocks_per_sm(tables)
                torch.cuda.synchronize()
                err = exact(got, want, f"{name} n={n} t=3 v={v}")
                max_err[name] = max(max_err[name], err)
                log(f"[kernels] {name} n={n} t=3 v={v} rows=2 (mode, window)="
                    f"{kern.reduction_mode(tables)[:2]}: {tuple(want.shape)} equal to the plain "
                    f"version bit for bit; {kern.pass_threads(n)} threads, K="
                    f"{kern.pass_group(n)}; CTAs an SM holds: {blocks}")


def pass_kernel(name: str) -> tuple:
    """K1's, K3's or K4's (``name``) wrapper, plain version, CTAs-an-SM
    reader and shared memory of a CTA at n."""
    from repro_torch.kernels import ntt as kern

    return {
        "fused_polymul": (kern.fused_polymul_cuda, kern.fused_polymul_ref,
                          kern.cascade_blocks_per_sm, kern.cascade_smem_bytes),
        "ntt_channels": (kern.ntt_channels_cuda, kern.ntt_channels_ref, kern.ntt_blocks_per_sm,
                         kern.stage_smem_bytes),
        "intt_channels": (kern.intt_channels_cuda, kern.intt_channels_ref,
                          kern.intt_blocks_per_sm, kern.stage_smem_bytes),
    }[name]


def fs_kernel(name: str) -> tuple:
    """K1-fs's, K3-fs's or K4-fs's (``name``) wrapper, plain version, the
    one-block kernel of the same function with its fit test, and the CTAs
    an SM holds of each launch."""
    from repro_torch.kernels import ntt as kern

    return {
        "fused_polymul_fs": (kern.fused_polymul_fs_cuda, kern.fused_polymul_fs_ref,
                             kern.fused_polymul_cuda, kern.cascade_fits,
                             kern.cascade_fs_blocks_per_sm),
        "ntt_channels_fs": (kern.ntt_channels_fs_cuda, kern.ntt_channels_fs_ref,
                            kern.ntt_channels_cuda, kern.stage_fits, kern.ntt_fs_blocks_per_sm),
        "intt_channels_fs": (kern.intt_channels_fs_cuda, kern.intt_channels_fs_ref,
                             kern.intt_channels_cuda, kern.stage_fits,
                             kern.intt_fs_blocks_per_sm),
    }[name]


def check_fs_kernels(dev, max_err: dict[str, int]) -> None:
    """Phase 3 for K1-fs, K3-fs and K4-fs at FS_POINTS in every regime:
    exact equality with their plain versions (the four-step plain PyTorch
    on the card) and, where the one-block kernel also serves n, with it;
    the CTAs an SM holds of each launch."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import ntt as kern

    t0 = time.perf_counter()
    for n in FS_POINTS:
        for v in (29, 30, 31):
            pl = repro_torch.plan(n, 3, v, backend="cuda", device=dev)
            tables = pl.params.tables
            _, _, ra, rb = seeded_inputs(torch, np, pl, 2, SEED + 3 * n + v, dev)
            ra[:, 0, :2] = pl.params.plan.qs_d[:, None] - 1  # the largest canonical residue
            seen = []
            for name in FS_TRANSFORMS:
                cuda, ref, one_block, fits, blocks_per_sm = fs_kernel(name)
                operands = (ra, rb) if name == "fused_polymul_fs" else (ra,)
                got = cuda(*operands, tables)
                torch.cuda.synchronize()
                err = exact(got, ref(*operands, tables), f"{name} n={n} t=3 v={v}")
                if fits(n):
                    exact(got, one_block(*operands, tables), f"{name} vs one block n={n} v={v}")
                max_err[name] = max(max_err.get(name, 0), err)
                seen.append(f"{name} {blocks_per_sm(tables)}" + (" = one block" if fits(n) else ""))
            log(f"[kernels] multi-block n={n} t=3 v={v} rows=2 (mode, window)="
                f"{kern.reduction_mode(tables)[:2]} split {kern.fs_split(n)}, "
                f"{kern.fs_threads(n)} threads, {kern.fs_tile(n)}-element tiles: equal to the "
                "plain versions bit for bit (and to K1/K3/K4 where marked); CTAs an SM holds "
                "per launch: " + ", ".join(seen))
    log(f"[kernels] multi-block checks took {time.perf_counter() - t0:.1f} s (host clock)")


def check_e2e_fs(dev, max_err: dict[str, int]) -> None:
    """Phase 3 for K2-fs at FS_POINTS x E2E_FS_T in every regime, where
    plan() admits (n, t, v) on cuda_fused_e2e: exact equality with its
    plain version (K2's over the four-step cascade, on the card) and,
    where K2 also serves n, with K2; its clusters of min(t, 8) CTAs, and
    the card holds at least one cluster of each cluster launch (the row
    launch is K1-fs's).  One coefficient of row 0 is 0, one of row 1 is
    q - 1 in both operands."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import ntt as kern

    t0 = time.perf_counter()
    refused = []
    for t in E2E_FS_T:
        for n in FS_POINTS:
            seen = []
            for v in (29, 30, 31):
                try:
                    pl = repro_torch.plan(n, t, v, backend="cuda_fused_e2e", device=dev)
                except repro_torch.UnservableConfigError as err:
                    refused.append(f"(n={n}, t={t}, v={v}) knob {err.knob}")
                    continue
                p = pl.params
                za, zb, _, _ = seeded_inputs(torch, np, pl, 2, SEED + 5 * n + t + v, dev)
                za[0, 0] = zb[0, 1] = 0
                za[1, 0] = zb[1, 0] = repro_torch.to_segments(pl, [pl.q - 1])[0]
                kern.fused_e2e_polymul_fs_cuda.cluster = 0
                got = kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan)
                torch.cuda.synchronize()
                what = f"fused_e2e_polymul_fs n={n} t={t} v={v}"
                if kern.fused_e2e_polymul_fs_cuda.cluster != min(t, kern.MAX_CLUSTER):
                    raise AssertionError(f"{what}: clusters of "
                                         f"{kern.fused_e2e_polymul_fs_cuda.cluster} CTAs")
                err = exact(got, kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan), what)
                k2 = kern.e2e_fits(n, t, pl.config.seg_count, pl.config.L)
                if k2:
                    exact(got, kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan),
                          f"{what} vs K2")
                clusters = kern.e2e_fs_max_active_clusters(p.tables, p.plan)
                if min(clusters) < 1:
                    raise AssertionError(f"{what}: the card holds no cluster of a launch: "
                                         f"{clusters}")
                max_err["fused_e2e_polymul_fs"] = max(max_err.get("fused_e2e_polymul_fs", 0), err)
                seen.append(f"v={v} {kern.reduction_mode(p.tables)[:2]} {clusters}"
                            + (" = K2" if k2 else ""))
            log(f"[kernels] fused_e2e_polymul_fs n={n} t={t} rows=2, clusters of "
                f"{min(t, kern.MAX_CLUSTER)} CTAs, {kern.fs_threads(n)} threads, "
                f"{kern.fs_tile(n)}-element tiles: equal to its plain version bit for bit (and "
                "to K2 where marked); (mode, window) (clusters resident of the forward and of "
                "the inverse column launch): " + ", ".join(seen))
    log(f"[kernels] fused_e2e_polymul_fs checks took {time.perf_counter() - t0:.1f} s (host "
        f"clock); plan() refuses, so no kernel backend serves: " + ("; ".join(refused) or "none"))


def check_compose_edges(dev, max_err: dict[str, int]) -> None:
    """Phase 3 for K6 at COMPOSE_ROWS rows, with r = 0 and r = q - 1 in
    every channel, at the paper's point and at COMPOSE_CORNERS: exact
    equality with its plain version."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import crt

    for cfg in [dict(n=MAIN["n"], t=MAIN["t"], v=MAIN["v"])] + COMPOSE_CORNERS:
        pl = repro_torch.plan(cfg["n"], cfg["t"], cfg["v"], backend="cuda", device=dev)
        rp = pl.params.plan
        rows = max(COMPOSE_ROWS)
        _, _, ra, _ = seeded_inputs(torch, np, pl, -(-rows // cfg["n"]), SEED + cfg["t"], dev)
        r2 = ra.reshape(cfg["t"], -1)[:, :rows].contiguous()
        r2[:, 0] = 0
        r2[:, 1] = rp.qs_d - 1
        for m in COMPOSE_ROWS:
            part = r2[:, :m].contiguous()
            got = crt.compose_cuda(part, rp)
            torch.cuda.synchronize()
            err = exact(got, crt.compose_ref(part, rp), f"compose {cfg} rows={m}")
            max_err["compose"] = max(max_err["compose"], err)
        log(f"[kernels] compose n={cfg['n']} t={cfg['t']} v={cfg['v']} L={rp.L}: rows "
            f"{COMPOSE_ROWS} with r = 0 and r = q - 1 in every channel equal the plain version "
            "bit for bit")


def check_channel_edges(dev, max_err: dict[str, int]) -> None:
    """Phase 3 past 16 segments, limbs and channels (CHANNEL_EDGES, v =
    30): K5 and K6 on the plan's segments and residues, and K2 and K2-fs
    wherever plan() serves cuda_fused_e2e (each also against the other),
    exact against their plain versions, with the clusters the card holds;
    one coefficient of row 0 is 0, one of row 1 (or the second
    coefficient) q - 1 in both operands, and one residue 0 and one q - 1
    in every channel."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import crt
    from repro_torch.kernels import ntt as kern

    t0 = time.perf_counter()
    for n, t, rows in CHANNEL_EDGES:
        pl = repro_torch.plan(n, t, WIDE_V, backend="cuda", device=dev)
        p, cfg = pl.params, pl.config
        za, zb, ra, _ = seeded_inputs(torch, np, pl, rows, SEED + 7 * n + t, dev)
        za[0, 0] = zb[0, 1] = 0
        za[-1, -1] = zb[-1, -1] = repro_torch.to_segments(pl, [pl.q - 1])[0]
        z2 = za.reshape(-1, cfg.seg_count)
        r2 = ra.reshape(t, -1).contiguous()
        r2[:, 0] = 0
        r2[:, 1] = p.plan.qs_d - 1
        what = f"n={n} t={t} v={WIDE_V} S={cfg.seg_count} L={cfg.L}"
        seen = [f"decompose ({crt.decompose_rows(t, cfg.seg_count)} rows a block)",
                f"compose ({crt.compose_rows(t, cfg.L)} rows a CTA)"]
        for name, fn, ref in (("decompose", crt.decompose_cuda, crt.decompose_ref),
                              ("compose", crt.compose_cuda, crt.compose_ref)):
            arg = z2 if name == "decompose" else r2
            got = fn(arg, p.plan)
            torch.cuda.synchronize()
            max_err[name] = max(max_err[name], exact(got, ref(arg, p.plan), f"{name} {what}"))
        S, L = cfg.seg_count, cfg.L
        outs = []
        if kern.e2e_fits(n, t, S, L):
            got = kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan)
            torch.cuda.synchronize()
            expect_cluster(pl, f"fused_e2e_polymul {what}")
            err = exact(got, kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan),
                        f"fused_e2e_polymul {what}")
            max_err["fused_e2e_polymul"] = max(max_err["fused_e2e_polymul"], err)
            clusters = kern.e2e_max_active_clusters(p.tables, p.plan)
            if clusters < 1:
                raise AssertionError(f"fused_e2e_polymul {what}: the card holds no cluster")
            outs.append(got)
            seen.append(f"fused_e2e_polymul ({kern.e2e_cluster(t)[1]} slots, "
                        f"{kern.e2e_smem_bytes(n, t, S, L)} B, {clusters} clusters resident)")
        if kern.e2e_fs_fits(n, t, S, L):
            got = kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan)
            torch.cuda.synchronize()
            expect_e2e_fs_cluster(pl, f"fused_e2e_polymul_fs {what}")
            err = exact(got, kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan),
                        f"fused_e2e_polymul_fs {what}")
            max_err["fused_e2e_polymul_fs"] = max(max_err.get("fused_e2e_polymul_fs", 0), err)
            clusters = kern.e2e_fs_max_active_clusters(p.tables, p.plan)
            if min(clusters) < 1:
                raise AssertionError(f"fused_e2e_polymul_fs {what}: no cluster resident "
                                     f"{clusters}")
            for other in outs:
                exact(got, other, f"fused_e2e_polymul_fs {what} vs K2")
            seen.append(f"fused_e2e_polymul_fs ({kern.e2e_fs_smem_bytes(n, t, S, L)} B, "
                        f"clusters resident {clusters})" + (" = K2" if outs else ""))
        log(f"[kernels] {what}, {rows} rows: " + ", ".join(seen) + " equal their plain "
            "versions bit for bit")
    log(f"[kernels] channel-edge checks took {time.perf_counter() - t0:.1f} s (host clock)")


def expect_cluster(pl, what: str) -> None:
    """K2's last launch ran as clusters of min(t, 8) CTAs a row."""
    from repro_torch.kernels import ntt as kern

    want = min(pl.config.t, kern.MAX_CLUSTER)
    if kern.fused_e2e_polymul_cuda.cluster != want:
        raise AssertionError(f"{what}: cluster of {kern.fused_e2e_polymul_cuda.cluster} CTAs, "
                             f"expected {want}")


def expect_e2e_fs_cluster(pl, what: str) -> None:
    """K2-fs's last call ran its cluster launches as clusters of min(t, 8)
    CTAs."""
    from repro_torch.kernels import ntt as kern

    want = min(pl.config.t, kern.MAX_CLUSTER)
    if kern.fused_e2e_polymul_fs_cuda.cluster != want:
        raise AssertionError(f"{what}: clusters of {kern.fused_e2e_polymul_fs_cuda.cluster} "
                             f"CTAs, expected {want}")


def check_oracle(pl, za, zb, out, what: str, rows=ORACLE_ROWS) -> None:
    """``out`` rows ``rows`` equal the host bigint oracle."""
    from repro_torch.core import bigint, polymul as host

    import repro_torch

    for r in rows:
        a = bigint.limbs_to_ints(za[r].cpu().numpy(), pl.config.v)
        b = bigint.limbs_to_ints(zb[r].cpu().numpy(), pl.config.v)
        if repro_torch.from_limbs(pl, out[r]) != host.oracle_multiply(a, b, pl.params):
            raise AssertionError(f"{what}: row {r} differs from the host oracle")


def drive_main_path(pl):
    """Phase 4: the paths through the user's entry points, each with every
    launch counter zeroed just before it and read just after.  Returns
    (launches per kernel on the path it serves, the inputs)."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import bigint, polymul as host
    from repro_torch.kernels import ntt as kern

    p, cfg = pl.params, pl.config
    za, zb, ra, rb = seeded_inputs(torch, np, pl, MAIN["rows"], SEED, pl.device)
    launches = {}

    # the auto plan (cuda_fused_e2e): polymul launches K2 alone
    outs, got = counted(torch, lambda: [repro_torch.polymul(pl, za, zb)
                                        for _ in range(MAIN_CALLS)])
    expect_launches(got, {"fused_e2e_polymul": MAIN_CALLS}, "polymul (auto)")
    expect_cluster(pl, "polymul (auto)")
    launches["fused_e2e_polymul"] = got["fused_e2e_polymul"]
    plain = kern.fused_e2e_polymul_ref(za, zb, p.tables, p.plan)
    for out in outs:
        exact(out, plain, "polymul vs plain")
    check_oracle(pl, za, zb, outs[0], "polymul (auto)")
    e2e = outs[0]
    log(f"[main] polymul x{MAIN_CALLS} on {tuple(za.shape)}: {got}, clusters of "
        f"{kern.fused_e2e_polymul_cuda.cluster} CTAs; equal to the plain version on all rows "
        f"and to the host oracle on rows {ORACLE_ROWS}")

    # the residue-domain product on the auto plan: K1 alone
    prods, got = counted(torch, lambda: [repro_torch.negacyclic_mul(pl, ra, rb)
                                         for _ in range(MAIN_CALLS)])
    expect_launches(got, {"fused_polymul": MAIN_CALLS}, "negacyclic_mul (auto)")
    launches["fused_polymul"] = got["fused_polymul"]
    plain = kern.fused_polymul_ref(ra, rb, p.tables)
    for prod in prods:
        exact(prod, plain, "negacyclic_mul vs plain")
    for r in ORACLE_ROWS:
        for c in range(p.t):
            want = host.ntt_negacyclic_host(ra[c, r].tolist(), rb[c, r].tolist(), int(p.qs[c]))
            if prods[0][c, r].tolist() != want:
                raise AssertionError(f"negacyclic_mul channel {c} row {r} differs from the oracle")
    log(f"[main] negacyclic_mul x{MAIN_CALLS} on {tuple(ra.shape)}: {got}; equal to the plain "
        f"version on all rows and to the host oracle on rows {ORACLE_ROWS}")

    # the staged backends: cuda (K5 x2, K3 x2, K4, K6) and cuda_fused (K5 x2, K1, K6)
    for backend, want in (
        ("cuda", {"decompose": 2, "ntt_channels": 2, "intt_channels": 1, "compose": 1}),
        ("cuda_fused", {"decompose": 2, "fused_polymul": 1, "compose": 1}),
    ):
        bpl = repro_torch.plan(cfg.n, cfg.t, cfg.v, backend=backend)
        outs, got = counted(torch, lambda: [repro_torch.polymul(bpl, za, zb)
                                            for _ in range(MAIN_CALLS)])
        expect_launches(got, {k: MAIN_CALLS * v for k, v in want.items()},
                        f"polymul ({backend})")
        if backend == "cuda":
            launches.update({k: got[k] for k in want})
        for out in outs:
            exact(out, e2e, f"polymul ({backend}) vs cuda_fused_e2e")
        check_oracle(pl, za, zb, outs[0], f"polymul ({backend})")
        log(f"[main] polymul backend={backend} x{MAIN_CALLS}: {got}; equal to the "
            f"cuda_fused_e2e output on all rows and to the host oracle on rows {ORACLE_ROWS}")

    # the stage entry points on the auto plan: one launch of their kernel each
    for name, fn, arg in (
        ("ntt_channels", repro_torch.ntt, ra),
        ("intt_channels", repro_torch.intt, ra),
        ("decompose", repro_torch.decompose, za),
        ("compose", repro_torch.compose, ra),
    ):
        _, got = counted(torch, lambda: fn(pl, arg))
        expect_launches(got, {name: 1}, f"{fn.__name__} (auto)")
    spectra = repro_torch.ntt(pl, ra)
    exact(repro_torch.intt(pl, spectra), ra, "intt(ntt(r)) vs r")
    limbs = repro_torch.compose(pl, repro_torch.decompose(pl, za))
    if repro_torch.from_limbs(pl, limbs) != bigint.limbs_to_ints(za.cpu().numpy(), cfg.v):
        raise AssertionError("compose(decompose(z)) differs from z's integers")
    log(f"[main] ntt, intt, decompose, compose (auto plan): one launch each; "
        f"intt(ntt(r)) == r on {tuple(ra.shape)}, compose(decompose(z)) == z on "
        f"{tuple(za.shape)}")
    return launches, (za, zb, ra, rb)


def drive_fs_front_door(card: str) -> tuple[dict[str, int], dict]:
    """Phase 4c: ``plan(n, 6, 30)`` at FS_MAIN's n, past one CTA, under
    ``auto`` (which must resolve to cuda_fused_e2e on multi-block kernels),
    ``backend="cuda_fused"`` and ``backend="cuda"``: ``polymul`` on
    FS_MAIN rows, ``negacyclic_mul``,
    ``ntt`` and ``intt`` on (6, rows, n) residues, each call with the
    launch counters zeroed just before it and read just after
    (FS_LAUNCHES), bit-exact against a ``backend="torch"`` plan on the card
    and two polymul rows against the host bigint oracle.  Returns (the
    multi-block kernels' launches: kernel -> path -> count, n -> inputs)."""
    import numpy as np
    import torch

    import repro_torch

    t0 = time.perf_counter()
    launches, inputs = {}, {}
    for n, rows in FS_MAIN.items():
        auto = repro_torch.plan(n, FS_T, FS_V)
        spec = auto.config.schedule
        if auto.config.backend != "cuda_fused_e2e" or not spec.multi_block:
            raise AssertionError(f"plan(n={n}, t={FS_T}, v={FS_V}) resolved to {auto.config}")
        plain = repro_torch.plan(n, FS_T, FS_V, backend="torch", device=auto.device)
        za, zb, ra, rb = seeded_inputs(torch, np, auto, rows, SEED + n, auto.device)
        inputs[n] = (za, zb, ra, rb)
        want = {
            "polymul": repro_torch.polymul(plain, za, zb),
            "negacyclic_mul": repro_torch.negacyclic_mul(plain, ra, rb),
            "ntt": repro_torch.ntt(plain, ra),
            "intt": repro_torch.intt(plain, ra),
        }
        for backend, pl in (("cuda_fused_e2e", auto),
                            ("cuda_fused", repro_torch.plan(n, FS_T, FS_V, backend="cuda_fused")),
                            ("cuda", repro_torch.plan(n, FS_T, FS_V, backend="cuda"))):
            for fn in ("polymul", "negacyclic_mul", "ntt", "intt"):
                args = (za, zb) if fn == "polymul" else (ra, rb) if fn == "negacyclic_mul" else (ra,)
                out, got = counted(torch, lambda: getattr(repro_torch, fn)(pl, *args))
                key = ((backend, fn) if (backend, fn) in FS_LAUNCHES else (backend, fn, n)
                       if fn in ("polymul", "negacyclic_mul") else (fn, n))
                expect_launches(got, FS_LAUNCHES[key], f"{fn} n={n} ({backend})")
                for name, k in launched(got).items():
                    if name in FS_KERNELS:
                        launches.setdefault(name, {})[f"{fn} n={n} {backend}"] = k
                exact(out, want[fn], f"{fn} n={n} ({backend}) vs backend='torch'")
                if (backend, fn) == ("cuda_fused_e2e", "polymul"):
                    expect_e2e_fs_cluster(auto, f"polymul n={n} (auto)")
            log(f"[fs] plan(n={n}, t={FS_T}, v={FS_V}, backend={backend!r}) {pl.config.schedule}: "
                f"polymul on {tuple(za.shape)}, negacyclic_mul, ntt, intt on {tuple(ra.shape)} "
                f"launched as FS_LAUNCHES; equal to the backend='torch' plan on the card; {card}")
        oracle_rows = (0, rows - 1)
        check_oracle(auto, za, zb, want["polymul"], f"polymul n={n}", oracle_rows)
        log(f"[fs] n={n}: polymul rows {oracle_rows} equal the host bigint oracle (every "
            f"backend's polymul equals them bit for bit); auto plan {auto.config.schedule!s}, "
            f"card split {spec.card_split}, {spec.smem_bytes} B of shared memory a CTA")
    log(f"[fs] phase 4c took {time.perf_counter() - t0:.1f} s (host clock)")
    return launches, inputs


def time_fs_kernels(inputs, launches: dict[str, dict[str, int]], max_err: dict[str, int],
                    card: str) -> list[dict]:
    """Phase 5 for K1-fs, K3-fs, K4-fs and K2-fs at the largest FS_MAIN
    shape: one call between two events, back to back, the plain version,
    and the bound for the least traffic (one int64 read of each operand
    and one write a coefficient; K2-fs: 2S segments in and L limbs out,
    with the bound of its traffic with the 32-bit scratch beside it)
    against the same operation counts as K1/K3/K4/K2."""
    import torch

    import repro_torch
    from repro_torch.kernels import ntt as kern

    n = max(FS_MAIN)
    _, _, ra, rb = inputs[n]
    tables = repro_torch.plan(n, FS_T, FS_V).params.tables
    mode, window = kern.reduction_mode(tables)[:2]
    polys = FS_T * FS_MAIN[n]
    work_of = {
        "fused_polymul_fs": (3 * polys * n * 8, polys * cascade_ops(n, mode, window)),
        "ntt_channels_fs": (2 * polys * n * 8, polys * transform_ops(n, mode, window, False)),
        "intt_channels_fs": (2 * polys * n * 8, polys * transform_ops(n, mode, window, True)),
    }
    entries = []
    for name in FS_TRANSFORMS:
        source, replaces = FS_KERNELS[name]
        cuda, ref, _, _, blocks_per_sm = fs_kernel(name)
        operands = (ra, rb) if name == "fused_polymul_fs" else (ra,)
        fn = lambda: cuda(*operands, tables)
        ms = time_launches(torch, fn, TIMED_LAUNCHES)
        device_ms = time_back_to_back(torch, fn, TIMED_LAUNCHES)
        plain_ms = time_launches(torch, lambda: ref(*operands, tables), PLAIN_RUNS, warmup=1)
        nbytes, ops = work_of[name]
        bound_ms, bound_by = bound(nbytes, ops)
        blocks = blocks_per_sm(tables)
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.get(name, {}).values()),
            "launches_by_path": launches.get(name, {}), "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "device_ms": device_ms, "shape": [FS_T, FS_MAIN[n], n],
            "blocks_per_sm": list(blocks),
        })
        log(f"[time] {name} at (t, rows, n) = ({FS_T}, {FS_MAIN[n]}, {n}): {ms:.4f} ms per call "
            f"(median of {TIMED_LAUNCHES}, one call between two events, "
            f"{'three' if name == 'fused_polymul_fs' else 'two'} launches), {device_ms:.4f} ms "
            f"back to back (device time), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({nbytes} bytes, {ops} int ops); CTAs an SM holds per launch {blocks}; "
            f"no single PyTorch call computes this function, so library_ms is null; {card}")
    entries.append(time_e2e_fs(inputs, launches, max_err, card))
    return entries


def time_e2e_fs(inputs, launches: dict[str, dict[str, int]], max_err: dict[str, int],
                card: str) -> dict:
    """Phase 5 for K2-fs at (FS_T, FS_MAIN rows, largest FS_MAIN n): one
    call between two events and back to back, the plain version, the bound
    for the least traffic (2S int64 segments in and L limbs out a
    coefficient) against e2e_ops, the bound of its traffic with the 32-bit
    scratch (six words a channel-coefficient: two written and read between
    launches 1 and 2, one between 2 and 3), and the clusters the card holds."""
    import torch

    import repro_torch
    from repro_torch.kernels import ntt as kern

    n = max(FS_MAIN)
    rows = FS_MAIN[n]
    za, zb, _, _ = inputs[n]
    pl = repro_torch.plan(n, FS_T, FS_V)
    p, cfg = pl.params, pl.config
    mode, window = kern.reduction_mode(p.tables)[:2]
    coeffs = rows * n
    least = (2 * cfg.seg_count + cfg.L) * 8
    with_scratch = least + 6 * cfg.t * 4
    ops = e2e_ops(pl, mode, window, rows)
    fn = lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan)
    ms = time_launches(torch, fn, TIMED_LAUNCHES)
    device_ms = time_back_to_back(torch, fn, TIMED_LAUNCHES)
    plain_ms = time_launches(torch, lambda: kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan),
                             PLAIN_RUNS, warmup=1)
    bound_ms, bound_by = bound(least * coeffs, ops)
    scratch_ms, scratch_by = bound(with_scratch * coeffs, ops)
    clusters = kern.e2e_fs_max_active_clusters(p.tables, p.plan)
    # device time of each launch, beside cuda_fused's kernels on the same
    # inputs (K5 on each operand, K1-fs's three launches, K6)
    from repro_torch.kernels import crt

    _, _, ra, rb = inputs[n]
    split = launch_split(torch, fn)
    staged = {
        "decompose x2": 2 * sum(launch_split(torch, lambda: crt.decompose_cuda(
            za.reshape(-1, cfg.seg_count), p.plan)).values()),
        **launch_split(torch, lambda: kern.fused_polymul_fs_cuda(ra, rb, p.tables)),
        "compose": sum(launch_split(torch, lambda: crt.compose_cuda(ra.reshape(cfg.t, -1),
                                                                     p.plan)).values()),
    }
    log(f"[time] fused_e2e_polymul_fs launches at ({cfg.t}, {rows}, {n}), device ms a call "
        f"(torch.profiler, {TIMED_LAUNCHES} calls): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f" (sum {sum(split.values()):.4f}); cuda_fused's kernels on the same inputs: "
        + ", ".join(f"{k} {v:.4f}" for k, v in staged.items())
        + f" (sum {sum(staged.values()):.4f}); {card}")
    name = "fused_e2e_polymul_fs"
    source, replaces = FS_KERNELS[name]
    log(f"[time] {name} at (t, rows, n) = ({cfg.t}, {rows}, {n}): {ms:.4f} ms per call (median "
        f"of {TIMED_LAUNCHES}, one call between two events, three launches), {device_ms:.4f} ms "
        f"back to back (device time), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({least} B a coefficient, {least * coeffs} bytes, {ops} int ops); with the "
        f"32-bit scratch {with_scratch} B a coefficient, bound {scratch_ms:.4f} ms by "
        f"{scratch_by}; clusters of {kern.e2e_cluster(cfg.t)[0]} CTAs, clusters resident of "
        f"the forward and of the inverse column launch {clusters}; no single PyTorch call "
        f"computes this function, so library_ms is null; {card}")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.get(name, {}).values()),
        "launches_by_path": launches.get(name, {}), "max_abs_err": max_err[name], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "device_ms": device_ms, "bound_ms_with_scratch": scratch_ms, "shape": [rows, n, cfg.t],
        "cluster": kern.e2e_cluster(cfg.t)[0], "max_active_clusters": list(clusters),
        "launch_ms": split, "cuda_fused_launch_ms": staged,
    }


def time_fs_walls() -> None:
    """Phase 6 at FS_MAIN: the wall of one synchronised ``polymul`` and
    ``negacyclic_mul`` call per backend that serves n (host clock)."""
    import numpy as np
    import torch

    import repro_torch

    for n, rows in FS_MAIN.items():
        for backend in ("cuda_fused_e2e", "cuda_fused", "cuda", "torch"):
            pl = repro_torch.plan(n, FS_T, FS_V, backend=backend, device="cuda")
            za, zb, ra, rb = seeded_inputs(torch, np, pl, rows, SEED + n, pl.device)
            ms = wall_ms(torch, lambda: repro_torch.polymul(pl, za, zb))
            nms = wall_ms(torch, lambda: repro_torch.negacyclic_mul(pl, ra, rb))
            log(f"[e2e] n={n} polymul backend={backend} on {tuple(za.shape)}: {ms:.4f} ms per "
                f"call, {rows * 1e3 / ms:.0f} products/s; negacyclic_mul on {tuple(ra.shape)}: "
                f"{nms:.4f} ms per call (median of {E2E_RUNS}, host clock)")


def drive_wide(card: str) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 4d at WIDE_POINTS: ``plan(n, t, 30)`` under ``auto`` (which
    keeps cuda_fused there) and on each backend, cuda_fused_e2e (K2-fs),
    cuda_fused, cuda and torch: ``polymul`` on the point's rows, each call
    with the launch counters zeroed just before it and read just after
    (WIDE_LAUNCHES), bit-exact against the torch plan on the card, and one
    row against the host bigint oracle; then K2-fs, K5 and K6 on the
    point's operands against their plain versions.  Returns (kernel ->
    path -> launches, name -> inputs)."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import crt
    from repro_torch.kernels import ntt as kern

    t0 = time.perf_counter()
    launches, inputs = {}, {}
    for point, (n, t, rows) in WIDE_POINTS.items():
        auto = repro_torch.plan(n, t, WIDE_V)
        plans = {b: repro_torch.plan(n, t, WIDE_V, backend=b)
                 for b in ("cuda_fused_e2e", "cuda_fused", "cuda", "torch")}
        if auto.config.backend != "cuda_fused":
            raise AssertionError(f"{point}: auto resolved to {auto.config}")
        cfg = plans["cuda_fused_e2e"].config
        if not cfg.schedule.multi_block:
            raise AssertionError(f"{point}: cuda_fused_e2e resolved to {cfg}")
        za, zb, ra, _ = seeded_inputs(torch, np, auto, rows, SEED + n + t, auto.device)
        inputs[point] = (za, zb, ra)
        want, _ = counted(torch, lambda: repro_torch.polymul(plans["torch"], za, zb))
        for backend, pl in plans.items():
            if backend == "torch":
                continue
            out, got = counted(torch, lambda: repro_torch.polymul(pl, za, zb))
            key = backend if backend in WIDE_LAUNCHES else (backend, n)
            expect_launches(got, WIDE_LAUNCHES[key], f"polymul {point} ({backend})")
            for name, k in launched(got).items():
                launches.setdefault(name, {})[f"polymul {point} {backend}"] = k
            exact(out, want, f"polymul {point} ({backend}) vs backend='torch'")
            if backend == "cuda_fused_e2e":
                expect_e2e_fs_cluster(pl, f"polymul {point}")
            log(f"[wide] {point} plan(n={n}, t={t}, v={WIDE_V}, backend={backend!r}) "
                f"{pl.config.schedule}: polymul on {tuple(za.shape)} launched {launched(got)}; "
                f"equal to the backend='torch' plan on the card; {card}")
        check_oracle(auto, za, zb, want, f"polymul {point}", (rows - 1,))
        p = plans["cuda_fused_e2e"].params
        z2 = za.reshape(-1, cfg.seg_count)
        r2 = ra.reshape(t, -1)
        for name, fn, ref in (
            ("fused_e2e_polymul_fs", lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan),
             lambda: kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan)),
            ("decompose", lambda: crt.decompose_cuda(z2, p.plan),
             lambda: crt.decompose_ref(z2, p.plan)),
            ("compose", lambda: crt.compose_cuda(r2, p.plan), lambda: crt.compose_ref(r2, p.plan)),
        ):
            got = fn()
            torch.cuda.synchronize()
            exact(got, ref(), f"{name} {point}")
        log(f"[wide] {point}: S={cfg.seg_count}, L={cfg.L}, q of {auto.q.bit_length()} bits, "
            f"{kern.e2e_cluster(t)[1]} channels a CTA of clusters of {kern.e2e_cluster(t)[0]}; "
            f"polymul row {rows - 1} equals the host bigint oracle; K2-fs, K5 and K6 on the "
            f"point's operands equal their plain versions bit for bit; auto -> cuda_fused")
    log(f"[wide] phase 4d took {time.perf_counter() - t0:.1f} s (host clock)")
    return launches, inputs


def time_wide(inputs, card: str) -> dict[str, dict]:
    """Phase 5/6 at WIDE_POINTS: each backend's polymul wall (host clock,
    median of E2E_RUNS synchronised calls; torch of 3), K2-fs one call and
    back to back with its launches' device time (torch.profiler) beside
    cuda_fused's kernels, K5 and K6 back to back, each plain version once,
    and each kernel's bound at the point's shapes.  Returns kernel ->
    point -> numbers for the kernels line."""
    import torch

    import repro_torch
    from repro_torch.kernels import crt
    from repro_torch.kernels import ntt as kern

    out = {"fused_e2e_polymul_fs": {}, "decompose": {}, "compose": {}}
    for point, (n, t, rows) in WIDE_POINTS.items():
        za, zb, ra = inputs[point]
        walls = {}
        for backend in ("cuda_fused_e2e", "cuda_fused", "cuda", "torch"):
            pl = repro_torch.plan(n, t, WIDE_V, backend=backend)
            walls[backend] = wall_ms(torch, lambda: repro_torch.polymul(pl, za, zb),
                                     3 if backend == "torch" else E2E_RUNS)
        log(f"[wide] {point} polymul walls on {tuple(za.shape)}, ms (median of {E2E_RUNS}, "
            f"torch of 3, host clock): " + ", ".join(f"{b} {ms:.4f}" for b, ms in walls.items())
            + f"; cuda_fused_e2e / cuda_fused = {walls['cuda_fused_e2e'] / walls['cuda_fused']:.3f}"
            f"; auto takes cuda_fused; {card}")
        pl = repro_torch.plan(n, t, WIDE_V, backend="cuda_fused_e2e")
        p, cfg = pl.params, pl.config
        mode, window = kern.reduction_mode(p.tables)[:2]
        coeffs = rows * n
        z2 = za.reshape(-1, cfg.seg_count)
        r2 = ra.reshape(t, -1)
        calls = {
            "fused_e2e_polymul_fs": (
                lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan),
                lambda: kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan),
                (2 * cfg.seg_count + cfg.L) * coeffs * 8, e2e_ops(pl, mode, window, rows)),
            "decompose": (lambda: crt.decompose_cuda(z2, p.plan),
                          lambda: crt.decompose_ref(z2, p.plan),
                          (cfg.seg_count + t) * coeffs * 8, coeffs * channel_decompose_ops(pl)),
            "compose": (lambda: crt.compose_cuda(r2, p.plan), lambda: crt.compose_ref(r2, p.plan),
                        (t + cfg.L) * coeffs * 8, coeffs * compose_ops(t, cfg.L)),
        }
        for name, (fn, ref, nbytes, ops) in calls.items():
            ms = time_launches(torch, fn, TIMED_LAUNCHES)
            device_ms = time_back_to_back(torch, fn, TIMED_LAUNCHES)
            plain_ms = time_launches(torch, ref, 1, warmup=0)
            bound_ms, bound_by = bound(nbytes, ops)
            out[name][point] = {"shape": [rows, n, t], "ms": ms, "device_ms": device_ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                                "wall_ms": walls}
            log(f"[time] {name} at {point} (rows, n, t) = ({rows}, {n}, {t}): {ms:.4f} ms per "
                f"call (median of {TIMED_LAUNCHES}), {device_ms:.4f} ms back to back (device "
                f"time), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes} bytes, {ops} int ops); {card}")
        fs = calls["fused_e2e_polymul_fs"][0]
        split = launch_split(torch, fs)
        cascade = kern.fused_polymul_fs_cuda if n > 16384 else kern.fused_polymul_cuda
        rb = ra.flip(1).contiguous()
        staged = {
            "decompose x2": 2 * sum(launch_split(torch, calls["decompose"][0]).values()),
            **launch_split(torch, lambda: cascade(ra, rb, p.tables)),
            "compose": sum(launch_split(torch, calls["compose"][0]).values()),
        }
        out["fused_e2e_polymul_fs"][point].update(launch_ms=split, cuda_fused_launch_ms=staged,
                                                  max_active_clusters=list(
                                                      kern.e2e_fs_max_active_clusters(p.tables,
                                                                                      p.plan)))
        log(f"[time] fused_e2e_polymul_fs launches at {point}, device ms a call "
            f"(torch.profiler, {TIMED_LAUNCHES} calls): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f" (sum {sum(split.values()):.4f}); cuda_fused's kernels on the same inputs: "
            + ", ".join(f"{k} {v:.4f}" for k, v in staged.items())
            + f" (sum {sum(staged.values()):.4f}); clusters resident "
            f"{out['fused_e2e_polymul_fs'][point]['max_active_clusters']}; {card}")
    return out


# K1-K6: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_polymul": ("src/repro_torch/csrc/fused_polymul.cu", "src/repro/kernels/ntt.py:757"),
    "fused_e2e_polymul": ("src/repro_torch/csrc/fused_e2e_polymul.cu",
                          "src/repro/kernels/ntt.py:802"),
    "ntt_channels": ("src/repro_torch/csrc/ntt_channels.cu", "src/repro/kernels/ntt.py:680"),
    "intt_channels": ("src/repro_torch/csrc/intt_channels.cu", "src/repro/kernels/ntt.py:721"),
    "decompose": ("src/repro_torch/csrc/decompose.cu", "src/repro/kernels/crt.py:180"),
    "compose": ("src/repro_torch/csrc/compose.cu", "src/repro/kernels/crt.py:266"),
}
# K1-fs, K3-fs, K4-fs, K2-fs: the multi-block forms of K1, K3, K4, K2 (the
# four-step bodies of the same TPU kernels)
FS_KERNELS = {
    "fused_polymul_fs": ("src/repro_torch/csrc/fused_polymul_fs.cu",
                         "src/repro/kernels/ntt.py:757"),
    "ntt_channels_fs": ("src/repro_torch/csrc/ntt_channels_fs.cu", "src/repro/kernels/ntt.py:680"),
    "intt_channels_fs": ("src/repro_torch/csrc/intt_channels_fs.cu",
                         "src/repro/kernels/ntt.py:721"),
    "fused_e2e_polymul_fs": ("src/repro_torch/csrc/fused_e2e_polymul_fs.cu",
                             "src/repro/kernels/ntt.py:802"),
}
# the multi-block transforms (K1-fs, K3-fs, K4-fs), checked and timed alike
FS_TRANSFORMS = ("fused_polymul_fs", "ntt_channels_fs", "intt_channels_fs")
ATTN_SOURCE = "src/repro_torch/csrc/attention.cu"
ATTN_REPLACES = "src/repro/kernels/attention.py:82"


def work(pl, rows: int, earlier: bool = False) -> dict[str, tuple[int, int]]:
    """Kernel -> (bytes it must move, integer operations it needs) at the
    main path's shapes with ``rows`` rows: each input read once, each
    output written once, as int64 words (``earlier``: PR 11-14's operation
    counts)."""
    from repro_torch.kernels import ntt as kern

    cfg = pl.config
    mode, window = kern.reduction_mode(pl.params.tables)[:2]
    polys = cfg.t * rows  # (channel, row) polynomials
    coeffs = rows * cfg.n
    return {
        "fused_polymul": (3 * polys * cfg.n * 8, polys * cascade_ops(cfg.n, mode, window)),
        "fused_e2e_polymul": ((2 * cfg.seg_count + cfg.L) * coeffs * 8,
                              e2e_ops(pl, mode, window, rows, earlier)),
        "ntt_channels": (2 * polys * cfg.n * 8,
                         polys * transform_ops(cfg.n, mode, window, inverse=False)),
        "intt_channels": (2 * polys * cfg.n * 8,
                          polys * transform_ops(cfg.n, mode, window, inverse=True)),
        "decompose": ((cfg.seg_count + cfg.t) * coeffs * 8,
                      coeffs * channel_decompose_ops(pl, earlier)),
        "compose": ((cfg.t + cfg.L) * coeffs * 8, coeffs * compose_ops(cfg.t, cfg.L, earlier)),
    }


def time_kernels(pl, inputs, launches, max_err) -> list[dict]:
    """Phase 5: kernel and plain-version times at the main path's shapes,
    beside the bound computed from these inputs."""
    import torch

    calls = kernel_calls(pl, inputs)
    counts = work(pl, inputs[0].shape[0])
    earlier = work(pl, inputs[0].shape[0], earlier=True)
    entries = []
    for name, (source, replaces) in KERNELS.items():
        fn, ref = calls[name]
        nbytes, ops = counts[name]
        ms = time_launches(torch, fn, TIMED_LAUNCHES)
        plain_ms = time_launches(torch, ref, PLAIN_RUNS, warmup=1)
        bound_ms, bound_by = bound(nbytes, ops)
        earlier_ms, earlier_by = bound(*earlier[name])
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bound_ms_earlier_count": earlier_ms,
        })
        device = ""
        if name != "fused_e2e_polymul":  # K2's comes with its one-row times below
            entries[-1]["device_ms"] = time_back_to_back(torch, fn, TIMED_LAUNCHES)
            device = f", {entries[-1]['device_ms']:.4f} ms back to back (device time)"
        log(f"[time] {name}: {ms:.4f} ms per launch (median of {TIMED_LAUNCHES}){device}, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, "
            f"{ops} int ops; PR 11-14's count: {earlier_ms:.4f} ms by {earlier_by}, "
            f"{earlier[name][1]} int ops); no single PyTorch call computes this function, so "
            f"library_ms is null")
    by_name = {e["name"]: e for e in entries}
    by_name["fused_e2e_polymul"].update(time_e2e_latency(pl, inputs))
    by_name["fused_polymul"].update(pass_occupancy(pl, "fused_polymul"))
    by_name["ntt_channels"].update(pass_occupancy(pl, "ntt_channels"))
    by_name["intt_channels"].update(pass_occupancy(pl, "intt_channels"))
    return entries


def pass_occupancy(pl, name: str) -> dict:
    """K1's, K3's or K4's (``name``) CTAs an SM holds at the main path's shape."""
    from repro_torch.kernels import ntt as kern

    n, tables = pl.config.n, pl.params.tables
    _, _, blocks_per_sm, smem_bytes = pass_kernel(name)
    smem, blocks = smem_bytes(n), blocks_per_sm(tables)
    log(f"[time] {name}: {kern.pass_threads(n)} threads a CTA, {smem} B of shared memory, "
        f"{blocks} CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    return {"blocks_per_sm": blocks}


def time_e2e_latency(pl, inputs) -> dict:
    """K2 at LATENCY_ROWS rows of the main path's inputs, beside its bound
    there, and how many of its clusters the card holds at once."""
    import torch

    from repro_torch.kernels import ntt as kern

    p = pl.params
    times = k2_times(torch, kern, pl, *inputs[:2])
    nbytes, ops = work(pl, LATENCY_ROWS)["fused_e2e_polymul"]
    bound_ms, bound_by = bound(nbytes, ops)
    clusters = kern.e2e_max_active_clusters(p.tables, p.plan)
    cluster = kern.e2e_cluster(pl.config.t)[0]
    log(f"[time] fused_e2e_polymul at {LATENCY_ROWS} row: {times['latency_ms']:.4f} ms per "
        f"launch (median of {TIMED_LAUNCHES}, one call between two events), "
        f"{times['latency_device_ms']:.4f} ms back to back (device time, {BACK_TO_BACK} calls); "
        f"at {inputs[0].shape[0]} rows {times['device_ms']:.4f} ms back to back; bound at "
        f"{LATENCY_ROWS} row {bound_ms:.4f} ms by {bound_by}; clusters of {cluster} CTAs "
        f"({kern.pass_threads(pl.config.n)} threads, "
        f"{kern.e2e_smem_bytes(pl.config.n, pl.config.t, pl.config.seg_count, pl.config.L)} B "
        f"of shared memory at most), {clusters} clusters resident on the card at once "
        "(cudaOccupancyMaxActiveClusters)")
    return {"rows": inputs[0].shape[0], "latency_rows": LATENCY_ROWS, **times,
            "latency_bound_ms": bound_ms, "cluster": cluster, "max_active_clusters": clusters}


def k2_times(torch, kern, pl, za, zb) -> dict[str, float]:
    """K2 at LATENCY_ROWS rows (one call between two events, and back to
    back) and at all of ``za``'s rows back to back."""
    p = pl.params
    za1, zb1 = za[:LATENCY_ROWS], zb[:LATENCY_ROWS]
    one = lambda: kern.fused_e2e_polymul_cuda(za1, zb1, p.tables, p.plan)
    full = lambda: kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan)
    return {"latency_ms": time_launches(torch, one, TIMED_LAUNCHES),
            "latency_device_ms": time_back_to_back(torch, one, BACK_TO_BACK),
            "device_ms": time_back_to_back(torch, full, TIMED_LAUNCHES)}


def time_checkout(checkout: Path, names: list[str]) -> int:
    """``--time-kernels DIR NAME...``: the kernels NAME of the checkout at
    DIR (its ``src/`` imported, its kernels built into its ``build/``) at
    the main path's shape, each first checked against its plain version:
    one call between two events (``ms``) and back to back (``device_ms``),
    K2 also at one row (``k2_times``), K2-fs (``fused_e2e_polymul_fs``)
    at the largest FS_MAIN shape, so two commits compare in one call."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    known = [*KERNELS, "fused_e2e_polymul_fs"]
    unknown = [name for name in names if name not in known]
    if unknown or not names:
        print(f"chip_smoke: --time-kernels takes names of {known}, got {names}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(checkout.resolve() / "src"))
    import repro_torch
    from repro_torch.kernels import ntt as kern

    pl = repro_torch.plan(n=MAIN["n"], t=MAIN["t"], v=MAIN["v"])
    inputs = seeded_inputs(torch, np, pl, MAIN["rows"], SEED, pl.device)
    calls = kernel_calls(pl, inputs)
    if "fused_e2e_polymul_fs" in names:  # K2-fs at the largest FS_MAIN shape
        n = max(FS_MAIN)
        fs = repro_torch.plan(n, FS_T, FS_V, backend="cuda_fused_e2e").params
        za, zb, _, _ = seeded_inputs(torch, np, repro_torch.plan(n, FS_T, FS_V), FS_MAIN[n],
                                     SEED + n, pl.device)
        calls["fused_e2e_polymul_fs"] = (
            lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, fs.tables, fs.plan),
            lambda: kern.fused_e2e_polymul_fs_ref(za, zb, fs.tables, fs.plan))
    log(card_line())
    for name in names:
        fn, ref = calls[name]
        exact(fn(), ref(), f"{name} of {checkout}")
        times = {"ms": time_launches(torch, fn, TIMED_LAUNCHES)}
        if name == "fused_e2e_polymul":
            times.update(k2_times(torch, kern, pl, *inputs[:2]))
        else:
            times["device_ms"] = time_back_to_back(torch, fn, TIMED_LAUNCHES)
        log(f"[time-kernels] {name} {checkout} ({repro_torch.__file__}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()))
    return 0


# K6's two load orders (csrc/compose.cu), each switched off in a copy of
# the source that --compose-variants builds beside it
COMPOSE_VARIANTS = {
    "no_preload": ("crt_compose<MAXL, !kSingle, kSingle>(", "crt_compose<MAXL, false, kSingle>("),
    "no_hoist": ("[&](int c) { return kSingle ? first[c] : (res_t)__ldg(r + (size_t)c * args.rows); }",
                 "[&](int c) { return (res_t)__ldg(r + (size_t)c * args.rows); }"),
}
# (n, t, rows) of its timings: L = 4, 7, 8 (the 8-limb instance), 9, 13,
# 16 (16 limbs, three CTAs an SM; W1) and 32 (two CTAs; W2)
COMPOSE_SHAPES = ((4096, 3, 256), (4096, 6, 256), (4096, 7, 256), (4096, 8, 256),
                  (4096, 12, 256), (32768, 15, 32), (16384, 30, 64))


def time_compose_variants() -> int:
    """``--compose-variants``: K6 built from csrc/compose.cu beside copies
    with one load order switched off (COMPOSE_VARIANTS: the 16-limb
    instances' PRELOAD, the 8-limb instance's reads before the table
    fills), each build's ptxas lines, and each checked against the plain
    version and timed back to back at COMPOSE_SHAPES, in the order as
    built, variants, variants reversed, as built."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels import _build, crt

    src = (_build.CSRC / "compose.cu").read_text()
    sources = {"as_built": src}
    for name, (old, new) in COMPOSE_VARIANTS.items():
        if old not in src:
            print(f"chip_smoke: csrc/compose.cu no longer holds {old!r}", file=sys.stderr)
            return 1
        sources[name] = src.replace(old, new)
    out = _build.BUILD_DIR / "compose_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            print(f"chip_smoke: nvcc failed on {name}:\n{text}", file=sys.stderr)
            return 1
        _build.ptxas_report(f"compose_variants/{name}").write_text(text)
        for line in ptxas_entries(f"compose_variants/{name}"):
            log(f"[ptxas compose {name}] {line}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).parentt_compose
        fn.argtypes = [P] * 7 + [LL] + [I] * 5 + [P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    log(card_line())
    order = [*sources, *reversed(sources)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for n, t, rows in COMPOSE_SHAPES:
        plan = repro_torch.plan(n, t, 30, backend="cuda").params.plan
        qs = plan.qs_d.reshape(t, 1)
        res = (torch.rand((t, rows * n), generator=gen, device="cuda", dtype=torch.float64)
               * qs).long().clamp_(max=qs - 1)
        res[:, :4] = qs - 1
        want = crt.compose_ref(res, plan)
        pointers, ints = crt._compose_constants(plan, "--compose-variants")
        times = []
        for name in order:
            got = torch.empty((rows * n, plan.L), dtype=torch.int64, device="cuda")
            call = lambda fn=fns[name], got=got: fn(
                _build.ptr(res), _build.ptr(got), *pointers, rows * n, *ints,
                _build.stream_of(res))
            if call() != 0:
                raise RuntimeError(f"K6 {name} failed to launch at {(n, t, rows)}")
            torch.cuda.synchronize()
            exact(got, want, f"K6 {name} at {(n, t, rows)}")
            times.append(f"{name} {time_back_to_back(torch, call, TIMED_LAUNCHES):.4f}")
        log(f"[compose-variants] n={n} t={t} L={plan.L} rows={rows}, ms back to back: "
            + ", ".join(times))
    return 0


def ptxas_entries(name: str) -> list[str]:
    """One line per kernel instance that ``-Xptxas -v`` reported for
    ``csrc/<name>.cu``: its kernel, template arguments, registers, stack
    frame and spills."""
    import re

    from repro_torch.kernels import _build

    lines, entry = [], None
    for line in _build.ptxas_report(name).read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            # the kernel's <length><name> in the mangled name
            kernel = next((mangled[m.end(1):m.end(1) + int(m.group(1))]
                           for m in re.finditer(r"(?=(\d+))", mangled)
                           if mangled[m.end(1):m.end(1) + int(m.group(1))].endswith("_kernel")),
                          mangled)
            entry = {"args": ",".join(re.findall(r"L[ib](\d+)E", mangled)) or "-",
                     "kernel": kernel}
        elif entry is not None and "stack frame" in line:
            entry["frame"] = line.strip()
        elif entry is not None and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{entry['kernel']}<{entry['args']}>: {regs} registers, "
                         f"{entry.get('frame', '')}")
            entry = None
    return lines


# --------------------------------------------------------------------------
# phase 4b: the front door's execute / plan_from_params and the HE path
# (the BFV layer on K1 and K6, HE gradient aggregation, encrypted inference)
# --------------------------------------------------------------------------

# BFV at the paper's point: a batch of 64 messages a worker, three workers
BFV = dict(n=4096, t=6, v=30, pt_mod=1 << 24, batch=64, workers=3, weight=8)
BFV_TIMED = 10  # CUDA-event timed calls of each BFV operation
HOST_RUNS = 3  # host-clock timed decrypt roundings and aggregation rounds
# HeAggregator()'s defaults, over 3 workers x 2^20 float32 gradient values
AGG = dict(n=1024, t=3, v=30, workers=3, rows=1023, cols=1024)
AGG_ATOL = 2e-3
# K1, K6 launches of one BFV call on the auto plan
BFV_LAUNCHES = {
    "keygen": {"fused_polymul": 1},
    "encrypt": {"fused_polymul": 2},
    "add_many": {},
    "mul_plain": {"fused_polymul": 2},
    "decrypt": {"fused_polymul": 1, "compose": 1},
    "noise_budget_bits": {"fused_polymul": 1, "compose": 1},
}
# the encrypted-inference example: 20 samples x 10 classes, one keygen, an
# encrypt a sample, a mul_plain and a decrypt a (sample, class)
INFER_SAMPLES, INFER_CLASSES = 20, 10
INFER_LAUNCHES = {
    "fused_polymul": 1 + INFER_SAMPLES * (2 + INFER_CLASSES * 3),
    "compose": INFER_SAMPLES * INFER_CLASSES,
}


def add_launches(total: dict, got: dict) -> None:
    for name, k in got.items():
        if k:
            total[name] = total.get(name, 0) + k


def launched(got: dict) -> dict:
    """The kernels of ``got`` that launched."""
    return {name: k for name, k in got.items() if k}


def drive_front_door(pl, inputs) -> dict[str, int]:
    """Phase 4b: ``execute`` on the auto plan at the main path's batch is
    one K2 launch and equals ``polymul``; ``plan_from_params`` of the same
    params resolves to ``plan()``'s config."""
    import torch

    import repro_torch
    from repro_torch.core.params import make_params

    za, zb = inputs[:2]
    out, got = counted(torch, lambda: repro_torch.execute(pl, za, zb))
    expect_launches(got, {"fused_e2e_polymul": 1}, "execute (auto)")
    exact(out, repro_torch.polymul(pl, za, zb), "execute vs polymul")
    params = make_params(MAIN["n"], MAIN["t"], MAIN["v"], device="cuda")
    cfg = repro_torch.plan_from_params(params).config
    if cfg != pl.config:
        raise AssertionError(f"plan_from_params: {cfg}, plan(): {pl.config}")
    log(f"[bfv] execute on {tuple(za.shape)}: {launched(got)}; equal to polymul; plan_from_params("
        f"make_params({MAIN['n']}, {MAIN['t']}, {MAIN['v']}, device='cuda')).config == "
        f"plan().config: {cfg}")
    return got


def negacyclic_mod(m, w, pt: int):
    """Rows of ``m`` times ``w`` mod (x^n + 1, pt), the host schoolbook as
    exact int64 convolutions (|m| < 2^24, |w| <= 8: every sum < 2^40)."""
    import numpy as np

    n = m.shape[-1]
    out = []
    for row in m.reshape(-1, n):
        c = np.convolve(row, w)
        p = c[:n].copy()
        p[:n - 1] -= c[n:]
        out.append(p % pt)
    return np.stack(out).reshape(m.shape)


def bfv_calls(ctx, seed: int, ms, w, prod) -> tuple[dict, dict]:
    """keygen, one encrypt a worker, add_many, mul_plain of the sum by
    ``w``, decrypt of each ciphertext and noise_budget_bits before and
    after the product (whose plaintext is ``prod``), each with every
    launch counter zeroed just before and read just after.  Returns
    (name -> result, name -> launches)."""
    import torch

    from repro_torch.core import bfv

    gen = torch.Generator(device=ctx.plan.device).manual_seed(seed)
    out, launches = {}, {}

    def step(name, kind, fn):
        out[name], got = counted(torch, fn)
        expect_launches(got, BFV_LAUNCHES[kind] if ctx.plan.config.backend != "torch" else {},
                        f"bfv {name} ({ctx.plan.config.backend})")
        add_launches(launches, got)

    step("keys", "keygen", lambda: bfv.keygen(gen, ctx))
    kp = out["keys"]
    for i, m in enumerate(ms):
        step(f"ct{i}", "encrypt", lambda: bfv.encrypt(gen, m, kp, ctx))
    cts = [out[f"ct{i}"] for i in range(len(ms))]
    step("sum", "add_many", lambda: bfv.add_many(cts, ctx))
    step("prod", "mul_plain", lambda: bfv.mul_plain(out["sum"], w, ctx))
    for name in [f"ct{i}" for i in range(len(ms))] + ["sum", "prod"]:
        step(f"dec_{name}", "decrypt", lambda: bfv.decrypt(out[name], kp, ctx))
    step("budget_fresh", "noise_budget_bits", lambda: bfv.noise_budget_bits(cts[0], kp, ctx, ms[0]))
    step("budget_prod", "noise_budget_bits",
         lambda: bfv.noise_budget_bits(out["prod"], kp, ctx, prod))
    return out, launches


def drive_bfv(card: str) -> dict[str, int]:
    """Phase 4b: the BFV layer at the paper's point on the auto plan (every
    product K1, every compose K6), checked against the plaintexts and held
    residue for residue against the same samples through a backend="torch"
    plan on the card; then each call's CUDA-event time.  Returns the
    launches per kernel."""
    import numpy as np
    import torch

    from repro_torch.core import bfv

    n, pt = BFV["n"], BFV["pt_mod"]
    ctx = bfv.make_context(n=n, t=BFV["t"], v=BFV["v"], pt_mod=pt)
    plain = bfv.make_context(n=n, t=BFV["t"], v=BFV["v"], pt_mod=pt, backend="torch")
    if ctx.plan.config.backend != "cuda_fused_e2e" or plain.plan.device.type != "cuda":
        raise AssertionError(f"make_context resolved to {ctx.plan.config}, {plain.plan.config}")
    rng = np.random.default_rng(SEED)
    ms = [rng.integers(0, pt, size=(BFV["batch"], n), dtype=np.int64)
          for _ in range(BFV["workers"])]
    w = rng.integers(-BFV["weight"], BFV["weight"] + 1, size=(n,), dtype=np.int64)
    total = sum(ms) % pt
    prod = negacyclic_mod(total, w, pt)
    got, launches = bfv_calls(ctx, SEED, ms, w, prod)
    want, _ = bfv_calls(plain, SEED, ms, w, prod)

    for i, m in enumerate(ms):
        if not np.array_equal(got[f"dec_ct{i}"], m):
            raise AssertionError(f"bfv: decrypt(encrypt(m)) != m for worker {i}")
    if not np.array_equal(got["dec_sum"], total):
        raise AssertionError("bfv: decrypt(add_many) != sum of m mod pt")
    if not np.array_equal(got["dec_prod"], prod):
        raise AssertionError("bfv: decrypt(mul_plain) differs from the host product")
    fresh, after = got["budget_fresh"], got["budget_prod"]
    if not 0 < after < fresh:
        raise AssertionError(f"bfv: noise budget {fresh} fresh, {after} after mul_plain")
    for name, value in got.items():
        other = want[name]
        if name == "keys":
            exact(value.sk, other.sk, "bfv sk vs torch plan")
            exact(value.pk, other.pk, "bfv pk vs torch plan")
        elif isinstance(value, bfv.Ciphertext):
            exact(value.c, other.c, f"bfv {name} vs torch plan")
        elif not np.array_equal(value, other):
            raise AssertionError(f"bfv {name}: {value} on the kernels, {other} on the torch plan")
    log(f"[bfv] make_context(n={n}, t={BFV['t']}, v={BFV['v']}, pt_mod=2^24) on "
        f"{ctx.plan.config.backend}: keygen, {BFV['workers']} encrypts of {BFV['batch']} "
        f"messages, add_many, mul_plain by |w| <= {BFV['weight']}, 5 decrypts, 2 noise budgets "
        f"launched {launches} (per call as BFV_LAUNCHES, counters zeroed around each); "
        f"decrypt(encrypt(m)) == m, decrypt(add_many) == sum mod pt, decrypt(mul_plain) == "
        f"the host product on all {BFV['batch']} rows; noise budget {fresh:.2f} -> "
        f"{after:.2f} bits; "
        f"every residue and decrypt equal to the backend='torch' plan's on the card")
    time_bfv(ctx, got, ms, w, card)
    return launches


def time_bfv(ctx, got, ms, w, card: str) -> None:
    """The CUDA-event median of each BFV call at the paper's point, and a
    decrypt split into its device part (phase and compose) and the host's
    exact rounding (limbs copied off the card, Python-int arithmetic)."""
    import torch

    from repro_torch.core import bfv

    gen = torch.Generator(device=ctx.plan.device).manual_seed(SEED + 1)
    kp, cts = got["keys"], [got[f"ct{i}"] for i in range(len(ms))]
    calls = {
        "keygen": lambda: bfv.keygen(gen, ctx),
        "encrypt": lambda: bfv.encrypt(gen, ms[0], kp, ctx),
        "add_many": lambda: bfv.add_many(cts, ctx),
        "mul_plain": lambda: bfv.mul_plain(got["sum"], w, ctx),
        "decrypt_device": lambda: bfv._phase_limbs(got["sum"], kp, ctx),
    }
    times = {name: time_launches(torch, fn, BFV_TIMED) for name, fn in calls.items()}
    limbs = bfv._phase_limbs(got["sum"], kp, ctx)
    times["decrypt_host"] = host_ms(torch, lambda: bfv._round(bfv._phase_ints(limbs, ctx), ctx))
    times["decrypt"] = host_ms(torch, lambda: bfv.decrypt(got["sum"], kp, ctx))
    shape = (BFV["t"], BFV["batch"], BFV["n"])
    log(f"[bfv] times at (t, batch, n) = {shape}, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items())
        + f" (CUDA-event median of {BFV_TIMED} one-call windows; decrypt_host: limbs off the "
        f"card and the exact rounding, decrypt: the whole call, host clock, median of "
        f"{HOST_RUNS}); {card}")


def host_ms(torch, fn) -> float:
    """Median host-clock milliseconds of HOST_RUNS synchronised calls."""
    times = []
    for _ in range(HOST_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def drive_aggregation(card: str) -> dict[str, int]:
    """Phase 4b: one HE aggregation round of HeAggregator() (n=1024, t=3,
    v=30) over AGG workers x 2^20 float32 gradient values (1024 ciphertexts
    a worker), within AGG_ATOL of the plain mean, with its launches; then
    the round's host-clock time and its host rounding alone."""
    import torch

    from repro_torch.core import bfv
    from repro_torch.train import aggregation

    agg = aggregation.HeAggregator(n=AGG["n"], t=AGG["t"], v=AGG["v"])
    dev = agg.ctx.plan.device
    data = torch.Generator(device=dev).manual_seed(SEED)
    workers = [
        {"w": 0.1 * torch.randn((AGG["rows"], AGG["cols"]), generator=data, device=dev),
         "b": 0.1 * torch.randn((AGG["cols"],), generator=data, device=dev)}
        for _ in range(AGG["workers"])
    ]
    values = sum(x.numel() for x in workers[0].values())
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    keys = agg.keygen(gen)
    mean, launches = counted(torch, lambda: aggregation.he_aggregate_gradients(
        agg, workers, gen, keys))
    expect_launches(launches, {"fused_polymul": 2 * AGG["workers"] + 1, "compose": 1},
                    "he_aggregate_gradients")
    err = max((mean[k] - sum(x[k] for x in workers) / AGG["workers"]).abs().max().item()
              for k in ("w", "b"))
    if not err <= AGG_ATOL:
        raise AssertionError(f"he_aggregate_gradients: max |HE mean - plain mean| = {err}")
    round_ms = host_ms(torch, lambda: aggregation.he_aggregate_gradients(agg, workers, gen, keys))
    cts = [agg.encrypt_grads(gen, torch.cat([x["b"], x["w"].reshape(-1)]), keys)
           for x in workers]
    limbs = bfv._phase_limbs(agg.aggregate(cts), keys, agg.ctx)
    rounding_ms = host_ms(torch, lambda: bfv._round(bfv._phase_ints(limbs, agg.ctx), agg.ctx))
    log(f"[bfv] he_aggregate_gradients, {AGG['workers']} workers x {values} float32 values "
        f"({cts[0].c.shape[2]} ciphertexts a worker, n={AGG['n']}, t={AGG['t']}): "
        f"{launched(launches)}; "
        f"max |HE mean - plain mean| = {err:.3e} (<= {AGG_ATOL:g}); round {round_ms:.1f} ms, "
        f"of which the host rounding {rounding_ms:.1f} ms (host clock, median of {HOST_RUNS}); "
        f"{card}")
    return launches


def drive_inference(card: str) -> dict[str, int]:
    """Phase 4b: the encrypted-inference example's main on the card, its
    assertion (encrypted == plaintext predictions on all 20 samples) and
    its launches."""
    import torch

    from repro_torch.examples import encrypted_inference

    t0 = time.perf_counter()
    rc, launches = counted(torch, lambda: encrypted_inference.main([]))
    ms = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        raise AssertionError(f"encrypted_inference.main returned {rc}")
    expect_launches(launches, INFER_LAUNCHES, "encrypted_inference")
    log(f"[bfv] encrypted_inference (n=256, t=3, v=30): {launched(launches)}; "
        f"encrypted == plaintext "
        f"predictions on all {INFER_SAMPLES} samples; {ms:.1f} ms (host clock, one run); {card}")
    return launches


def drive_he(pl, inputs, card: str) -> dict[str, dict[str, int]]:
    """Phase 4b, each path with the launch counters zeroed around each of
    its calls: kernel -> path -> launches."""
    paths = {
        "execute": drive_front_door(pl, inputs),
        "bfv": drive_bfv(card),
        "he_aggregation": drive_aggregation(card),
        "encrypted_inference": drive_inference(card),
    }
    by_kernel = {}
    for path, got in paths.items():
        for name, k in launched(got).items():
            by_kernel.setdefault(name, {})[path] = k
    return by_kernel


# --------------------------------------------------------------------------
# K7: flash attention
# --------------------------------------------------------------------------


def attention_inputs(torch, shape, dtype: str, seed: int, device):
    """Standard-normal q, k, v for ``shape`` = (B, Sq, Skv, H, Hk, D), made
    on the card from ``seed`` and cast to ``dtype``."""
    B, Sq, Skv, H, Hk, D = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.randn(size, generator=gen, device=device).to(getattr(torch, dtype))
        for size in ((B, Sq, H, D), (B, Skv, Hk, D), (B, Skv, Hk, D))
    )


def bf16_step(torch, x):
    """The spacing of bfloat16 values at each element of float32 ``x``:
    2^(e-8) for |x| in [2^(e-1), 2^e), 0 at 0."""
    mant, exp = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(mant), exp - 8))


def attention_excess(torch, got, want, atol: float, what: str) -> tuple[float, int]:
    """(max |got - want|, how many elements lie past atol plus, for bf16,
    one bf16 step of ``want``), compared in float32; raises on a misshapen
    or non-finite ``got``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    if not got.numel():
        return 0.0, 0
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs()
    allowed = atol + bf16_step(torch, want) if bf16 else atol
    return err.max().item(), int((err > allowed).sum().item())


def attention_error(torch, got, want, what: str) -> float:
    """max |got - want| in float32; raises unless every element is within
    the K7 tolerance (ATTN_ATOL, plus one bf16 step for bf16 outputs)."""
    err, past = attention_excess(torch, got, want, ATTN_ATOL, what)
    if past:
        raise AssertionError(f"{what}: {past} elements past the tolerance, "
                             f"max |kernel - plain| = {err}")
    return err


def bf16_p_control(torch, q, k, v, causal=True, window=None, softcap=0.0, q_offset=0, **_):
    """Plain attention that rounds P to bf16 before P @ V, as a bf16
    tensor-core kernel would, and is otherwise exact in float32: what the
    K7 tolerance must reject.  One kv head at a time, all scores at once."""
    import math

    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = k_pos <= q_pos if causal else torch.ones_like(k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    out = torch.empty_like(q)
    for hk in range(Hk):
        qh = q[:, :, hk * g:(hk + 1) * g].transpose(1, 2).float() / math.sqrt(D)
        s = qh @ k[:, None, :, hk].float().transpose(-1, -2)  # (B, g, Sq, Skv)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(mask, s, -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = (p.bfloat16().float() @ v[:, None, :, hk].float()) / p.sum(-1, keepdim=True)
        out[:, :, hk * g:(hk + 1) * g] = o.transpose(1, 2).to(q.dtype)
    return out


def check_attention(dev):
    """Phase 3 for K7: the kernel against its plain version at the small
    sweep and the four model shapes, and at each model shape a bf16-P
    control that the tolerance must reject.  Returns (max error, model
    shape -> (its inputs, the plain output))."""
    import torch

    from repro_torch.kernels import attention

    cases = ATTN_SMALL + [(name, shape, "bfloat16", kw) for name, (shape, kw) in ATTN_MODEL.items()]
    max_err, model = 0.0, {}
    for i, (name, shape, dtype, kw) in enumerate(cases):
        q, k, v = attention_inputs(torch, shape, dtype, SEED + i, dev)
        variant = attention.attention_variant(q.dtype, shape[5], shape[1], shape[3] // shape[4])
        got = attention.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention.flash_attention_ref(q, k, v, **kw)
        err = attention_error(torch, got, want, f"attention {name}")
        max_err = max(max_err, err)
        log(f"[kernels] attention {name} (B, Sq, Skv, H, Hk, D)={shape} {dtype} {kw} "
            f"[{variant}]: max |kernel - plain| = {err:.3e}; every element within {ATTN_ATOL:g}"
            + (" + one bf16 step" if dtype == "bfloat16" else ""))
        if name in ATTN_MODEL:
            model[name] = ((q, k, v), want)
            c_err, c_past = attention_excess(torch, bf16_p_control(torch, q, k, v, **kw), want,
                                             ATTN_ATOL, f"bf16-P control {name}")
            if not c_past:
                raise AssertionError(f"attention {name}: the tolerance passes a control that "
                                     "rounds P to bf16")
            log(f"[kernels] attention {name}: the bf16-P control is past the tolerance at "
                f"{c_past} of {want.numel()} elements (max |control - plain| = {c_err:.3e})")
    return max_err, model


def drive_attention(model) -> dict[str, int]:
    """Phase 4 for K7: the entry point ``flash_attention`` at the four model
    shapes, each call with every launch counter zeroed just before it and
    read just after: one K7 launch and no other.  Returns K7's launches
    per shape."""
    import torch

    from repro_torch.kernels import attention

    launches = {}
    counts = attention.flash_attention_cuda.variants
    for name, ((q, k, v), want) in model.items():
        kw = ATTN_MODEL[name][1]
        counts.update(dict.fromkeys(counts, 0))
        out, got = counted(torch, lambda: attention.flash_attention(q, k, v, **kw))
        expect_launches(got, {"attention": 1}, f"flash_attention ({name})")
        want_variants = {n: int(n == ATTN_VARIANT[name]) for n in attention.VARIANTS}
        if counts != want_variants:
            raise AssertionError(f"flash_attention ({name}): variants {counts}, expected "
                                 f"{want_variants}")
        err = attention_error(torch, out, want, f"flash_attention {name}")
        launches[name] = got["attention"]
        log(f"[main] flash_attention {name} q {tuple(q.shape)} k/v {tuple(k.shape)} {kw}: "
            f"{got}, variants {counts}; finite, max |out - plain| = {err:.3e}")
    return launches


def attention_work(shape, kw, itemsize: int) -> tuple[int, int]:
    """(bytes K7 must move, FLOPs of its two products) for one call: the
    port's traffic model at one query block (q, k, v read once, the output
    written once); 4 * D FLOPs per (query, key) pair the masks leave
    visible, per query head."""
    import numpy as np

    from repro_torch.kernels import attention

    B, Sq, Skv, H, Hk, D = shape
    q_pos = kw.get("q_offset", 0) + np.arange(Sq, dtype=np.int64)
    window = kw.get("window")
    lo = np.maximum(0, q_pos - window + 1) if window else np.zeros_like(q_pos)
    hi = np.minimum(Skv, q_pos + 1) if kw.get("causal", True) else np.full_like(q_pos, Skv)
    pairs = int(np.maximum(hi - lo, 0).sum())
    nbytes = attention.hbm_bytes_per_call(B, Sq, Skv, H, Hk, D, blk_q=Sq, itemsize=itemsize)
    return nbytes, 4 * D * pairs * B * H


def library_call(torch, name, q, k, v):
    """(one PyTorch call computing K7's function on these inputs, what it
    is), set up before any timed window; the yardstick, never called by
    the port.  yi-6b: ``scaled_dot_product_attention`` (causal, no
    softcap), K and V expanded to H heads here.  gemma2: the compiled
    ``flex_attention`` with a tanh-softcap ``score_mod`` and a causal or
    sliding-window block mask, where this torch has it."""
    import importlib.util

    import torch.nn.functional as F

    shape, kw = ATTN_MODEL[name]
    qh = q.transpose(1, 2).contiguous()
    if name == ATTN_LIBRARY_SHAPE:
        g = q.shape[2] // k.shape[2]
        kh, vh = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous() for x in (k, v))
        return (lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True).transpose(1, 2),
                "scaled_dot_product_attention(is_causal=True), K/V expanded to H heads")
    if importlib.util.find_spec("torch.nn.attention.flex_attention") is None:
        return None, f"torch {torch.__version__} has no flex_attention"
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    cap, window, offset = kw["softcap"], kw.get("window"), kw.get("q_offset", 0)

    def softcap(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap

    def visible(b, h, q_idx, kv_idx):
        seen = kv_idx <= q_idx + offset
        return seen & (kv_idx > q_idx + offset - window) if window else seen

    B, Sq, Skv = shape[:3]
    mask = create_block_mask(visible, None, None, Sq, Skv, device=q.device)
    kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
    flex = torch.compile(flex_attention, dynamic=False)
    return (lambda: flex(qh, kh, vh, score_mod=softcap, block_mask=mask,
                         enable_gqa=True).transpose(1, 2),
            "flex_attention (torch.compile) with a tanh softcap score_mod and a "
            + ("sliding-window" if window else "causal") + " block mask, enable_gqa")


def attention_build_report() -> dict[str, list[str]]:
    """K7 variant -> one line per compiled instance: head dim (and decode's
    row bound), ptxas's registers and spill bytes, and the dynamic shared
    memory of a block (decode's at its largest row bound)."""
    import re

    from repro_torch.kernels import _build

    smem = _build.load("attention", "parentt_attention_smem", [ctypes.c_int, ctypes.c_int])
    kinds = {"prefill_kernel": "wgmma", "decode_kernel": "decode", "attention_kernel": "simt"}
    report, entry, entry_name = {v: [] for v in kinds.values()}, None, ""
    for line in _build.ptxas_report("attention").read_text().splitlines():
        if "Compiling entry function" in line:
            entry_name = name = line.split("'")[1]
            kind = next((v for k, v in kinds.items() if k in name), None)
            entry = (kind, [int(x) for x in re.findall(r"Li(\d+)E", name)], "")
        elif entry and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            entry = (*entry[:2], f"spills {stores} B stored, {loads} B loaded")
        elif entry and entry[0] and "Used" in line and "registers" in line:
            kind, args, spills = entry
            regs = re.search(r"Used (\d+) registers", line).group(1)
            nbytes = smem(list(kinds.values()).index(kind), args[-1 if kind == "simt" else 0])
            report[kind].append(f"D={args[0] if kind != 'simt' else args[-1]}"
                                + (f" rows<={args[1]}" if kind == "decode" else "")
                                + (" softcap" if kind == "wgmma" and "Lb1E" in entry_name else "")
                                + f": {regs} registers, {spills}, {nbytes} B shared memory")
            entry = None
    return report


def time_attention(model, launches: dict[str, int], max_err: float) -> dict:
    """Phase 5 for K7: kernel, plain-version and library times at the four
    model shapes, beside the bound from these inputs; each library call is
    first held against the plain version.  Returns the ``kernels`` entry:
    the yi-6b numbers, and all four under ``shapes``."""
    import torch

    from repro_torch.kernels import attention

    for kind, lines in attention_build_report().items():
        for line in lines:
            log(f"[ptxas attention {kind}] {line}")
    shapes = []
    for name, ((q, k, v), want) in model.items():
        shape, kw = ATTN_MODEL[name]
        nbytes, flops = attention_work(shape, kw, q.element_size())
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        ms = time_launches(torch, lambda: attention.flash_attention_cuda(q, k, v, **kw),
                           TIMED_LAUNCHES)
        plain_ms = time_launches(torch, lambda: attention.flash_attention_ref(q, k, v, **kw),
                                 PLAIN_RUNS, warmup=1)
        library, note = library_call(torch, name, q, k, v)
        library_ms = None
        if library is not None:
            err, past = attention_excess(torch, library(), want, LIBRARY_ATOL, f"library {name}")
            if past:
                raise AssertionError(f"library call at {name}: {past} elements past "
                                     f"{LIBRARY_ATOL:g} + one bf16 step of the plain version, "
                                     f"max |library - plain| = {err}: not the same function")
            k7_past = attention_excess(torch, library(), want, ATTN_ATOL, f"library {name}")[1]
            library_ms = time_launches(torch, library, TIMED_LAUNCHES)
            note += (f"; max |library - plain| = {err:.3e}, {k7_past} elements past K7's "
                     f"tolerance")
        variant = ATTN_VARIANT[name]
        shapes.append({
            "shape": name, "variant": variant, "launches": launches[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
        if variant == "decode":
            rate = f"{nbytes / ms / 1e9:.3f} TB/s of the {HBM_BYTES_PER_S / 1e12:g} peak"
        else:  # the split P makes the tensor cores do 6 D FLOPs a pair, the bound counts 4 D
            rate = (f"{flops / ms / 1e9:.1f} TFLOP/s counted (4 D a pair), "
                    f"{1.5 * flops / ms / 1e9:.1f} TFLOP/s issued to the tensor cores (6 D)")
        log(f"[time] attention {name} [{variant}]: {ms:.4f} ms per launch (median of "
            f"{TIMED_LAUNCHES}), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes} bytes, {flops} FLOPs), library "
            + (f"{library_ms:.4f} ms" if library_ms is not None else "null")
            + f" ({note}); {ms / bound_ms:.1f}x the bound; {rate}")
    main = next(e for e in shapes if e["shape"] == ATTN_LIBRARY_SHAPE)
    return {
        "name": "attention", "route": "cuda", "source": ATTN_SOURCE, "replaces": ATTN_REPLACES,
        "launches": sum(launches.values()), "max_abs_err": max_err,
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": ATTN_LIBRARY_SHAPE, "shapes": shapes,
    }


def wall_ms(torch, fn, runs: int = E2E_RUNS) -> float:
    """Median wall milliseconds of one synchronised call over ``runs``
    after a warm-up (host clock)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_backends(pl, inputs, kernel_ms: float) -> dict[str, float]:
    """Phase 6: wall milliseconds of one synchronised ``polymul`` call per
    backend at the main path's shape, and of one ``negacyclic_mul`` call
    on the auto plan (K1), median of E2E_RUNS after a warm-up."""
    import torch

    import repro_torch

    cfg = pl.config
    za, zb, ra, rb = inputs
    walls = {}
    for backend in reversed(repro_torch.BACKENDS):
        bpl = repro_torch.plan(cfg.n, cfg.t, cfg.v, backend=backend, device=pl.device)
        walls[backend] = ms = wall_ms(torch, lambda: repro_torch.polymul(bpl, za, zb))
        log(f"[e2e] polymul backend={backend} on {tuple(za.shape)}: {ms:.4f} ms per call "
            f"(median of {E2E_RUNS}, host clock), {za.shape[0] * 1e3 / ms:.0f} products/s")
    ms = wall_ms(torch, lambda: repro_torch.negacyclic_mul(pl, ra, rb))
    log(f"[e2e] negacyclic_mul (auto plan) on {tuple(ra.shape)}: {ms:.4f} ms per call "
        f"(median of {E2E_RUNS}, host clock)")
    log(f"[e2e] the e2e kernel's CUDA-event time is "
        f"{kernel_ms / walls['cuda_fused_e2e']:.3f} of the cuda_fused_e2e call's wall time")
    return walls


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k2":
        return time_checkout(Path(sys.argv[2]), ["fused_e2e_polymul"])
    if len(sys.argv) >= 3 and sys.argv[1] == "--time-kernels":
        return time_checkout(Path(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:] == ["--compose-variants"]:
        return time_compose_variants()
    # the yardstick's torch.compile caches stay inside the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for name in _build.SOURCES:
        # per instance, with its template arguments
        if name != "attention":
            for line in ptxas_entries(name):
                log(f"[ptxas {name}] {line}")
            continue
        report = _build.ptxas_report(name)
        for line in report.read_text().splitlines() if report.exists() else []:
            if ("Used" in line and "registers" in line) or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # the plain versions' float32 products run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    max_err = check_kernels(dev)
    check_pass_kernels(dev, max_err)
    check_compose_edges(dev, max_err)
    check_fs_kernels(dev, max_err)
    check_e2e_fs(dev, max_err)
    check_channel_edges(dev, max_err)
    attn_err, attn_model = check_attention(dev)

    pl = repro_torch.plan(n=MAIN["n"], t=MAIN["t"], v=MAIN["v"])
    if pl.config.backend != "cuda_fused_e2e" or pl.device.type != "cuda":
        raise AssertionError(f"plan() resolved to {pl.config}")
    launches, inputs = drive_main_path(pl)
    attn_launches = drive_attention(attn_model)
    he_launches = drive_he(pl, inputs, card)
    fs_launches, fs_inputs = drive_fs_front_door(card)
    wide_launches, wide_inputs = drive_wide(card)
    entries = time_kernels(pl, inputs, launches, max_err)
    for entry in entries:
        if entry["name"] in he_launches:
            entry["launches_by_path"] = {"main": entry["launches"], **he_launches[entry["name"]]}
    entries.append(time_attention(attn_model, attn_launches, attn_err))
    entries += time_fs_kernels(fs_inputs, fs_launches, max_err, card)
    wide = time_wide(wide_inputs, card)
    for entry in entries:  # phase 4d's paths and times beside each kernel's
        name = entry["name"]
        if name in wide:
            entry["wide"] = wide[name]
        paths = wide_launches.get(name, {})
        if paths:
            entry.setdefault("launches_by_path", {"main": entry["launches"]}).update(paths)
            if name in FS_KERNELS:  # the multi-block kernels count their paths' calls
                entry["launches"] += sum(paths.values())
    time_backends(pl, inputs, next(e["ms"] for e in entries if e["name"] == "fused_e2e_polymul"))
    time_fs_walls()

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
