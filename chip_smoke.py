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
   4096 t = 48 for K2/K2-fs and t = 169 for K5/K6; K2-fs and each of its
   launches wherever it serves past K2, and up to t = 48 where K2 serves
   too), each also against the other e2e kernel; K7 in float32,
   every element within 1e-5 plus, for bfloat16 I/O, one bfloat16 step
   of the plain output, at the attention layers
   of gemma2-2b (global and local prefill at 8192 tokens, decode against
   an 8192-token cache), yi-6b (prefill at 4096 tokens) and zamba2-2.7b
   (head dim 80: prefill at 4096 tokens, decode at 4 slots against 4096
   keys), all bfloat16, and at a small sweep (padding, non-causal, window, softcap,
   decode, the query that sees no key, every head dim and dtype the
   kernel is built for, each of its three variants: ``wgmma`` for bf16
   prefill, ``decode`` for bf16 with at most 8 query rows per kv head,
   ``simt`` for float32); at each model shape a control that rounds the
   probabilities to bfloat16 must fall outside that tolerance; K1-fs,
   K3-fs and K4-fs (``csrc/*_fs.cu``) at ``FS_POINTS`` (n = 16 ... 65536,
   t = 3, 2 rows, all three regimes; K3-fs and K4-fs also at n = 4 and 8,
   ``FS_SMALL_POINTS``) equal to their plain versions (the four-step
   plain PyTorch) and, where K1, K3 or K4 also serve n, to them, with the
   CTAs an SM holds of K3-fs's and K4-fs's tile streams and
   K1-fs's clusters resident by size (the card holds at least one of
   the size ``fs_cluster`` names, which its launch takes); K2-fs
   (``csrc/fused_e2e_polymul_fs.cu``) at ``FS_POINTS`` x t = 3, 6, 8
   (``E2E_FS_T``), 2 rows, every regime ``plan()`` admits, equal to its
   plain version (K2's over the four-step cascade), each of its three
   launches alone equal to its plain counterpart, and, where K2 also
   serves n, equal to K2; the card holds at least one cluster of its
   cascade (of ``e2e_fs_cluster`` CTAs);
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
   ``repro_torch.kernels.attention.flash_attention`` at the ten model
   shapes, one K7 launch and no other per call, of the variant
   ``ATTN_VARIANT`` names (``wgmma`` at the six prefill shapes,
   ``decode`` at the four decode shapes), its output finite and within tolerance
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
   (which must resolve to ``FS_AUTO`` with a multi-block schedule),
   ``backend="cuda_fused_e2e"`` (its ``polymul`` one K2-fs call and
   nothing else), ``backend="cuda_fused"`` and ``backend="cuda"``: ``polymul``,
   ``negacyclic_mul``, ``ntt`` and ``intt``, each call with the counters
   zeroed around it and launching what ``FS_LAUNCHES`` says, bit-exact
   against a ``backend="torch"`` plan on the card, and two polymul rows a
   size against the host bigint oracle;
4d. the slice's points past 16 channels at full width (``[wide]`` lines):
   W1 = ``plan(32768, 15, 30)`` (32 rows) and W2 = ``plan(16384, 30,
   30)`` (64 rows), ``WIDE_POINTS``, under ``auto`` (which must resolve
   to ``WIDE_AUTO``) and on ``cuda_fused_e2e`` (one K2-fs call),
   ``cuda_fused``, ``cuda`` and ``torch``: ``polymul`` with the counters
   zeroed around each call (``WIDE_LAUNCHES``), bit-exact against the
   torch plan on the card and one row against the host oracle; K2-fs (and
   each of its launches), K5 and K6 on the points' operands against their
   plain versions;
5. timings: the median CUDA-event time of each kernel over 20 launches
   after warm-up (one call between two events, so a short kernel's time
   counts the host's issue time), K1-K6 also back to back behind a spin
   of the card (``device_ms``: device time), its plain version's time,
   and its bound (the bytes, operation counts and card peaks of
   ``repro_torch.kernels.cost``; beside it, as ``bound_ms_earlier_count``,
   the bound from the earlier operation counts);
   K1, K3 and K4 with the CTAs an SM holds; K2
   also at one row (the latency case) with the clusters the card holds
   at once (``cudaOccupancyMaxActiveClusters``); K7 at each of
   its ten shapes, with a PyTorch call computing the same function timed
   beside it as the yardstick (the port never calls it):
   ``scaled_dot_product_attention`` at yi-6b, zamba2-2.7b, dbrx-132b and
   llama4-maverick, the compiled
   ``flex_attention`` with a softcap ``score_mod`` at gemma2-2b; each
   K7 variant's ptxas registers, spills and shared memory, and the
   achieved TFLOP/s (prefill) or TB/s (decode); K1-fs, K3-fs and K4-fs
   at (6, 16, 65536) and K2-fs at (16, 65536, 6), one call and back to
   back, beside their plain versions and bounds (K2-fs's also with the
   32-bit words between its launches; K3-fs and K4-fs with their CTAs
   an SM and persistent grid), K1-fs's and K2-fs's cascade's
   clusters resident and waves at each FS_MAIN n and W point, and each of
   K2-fs's three launches'
   device time from a ``torch.profiler`` trace, beside cuda_fused's
   kernels (K5 on each operand, K1-fs, K6) on the same inputs;
   and at W1 and W2: K2-fs, K5 and K6 one call and back to back, plain,
   bound, and K2-fs's launches beside cuda_fused's kernels, with its
   cascade's clusters resident and waves;
6. the end-to-end time of one ``polymul`` call at the main path's shape
   on each backend, and of one ``negacyclic_mul`` call on the auto plan
   (host clock, synchronised), at FS_MAIN's n and rows on
   ``cuda_fused_e2e`` (K2-fs), ``cuda_fused`` (auto), ``cuda`` and
   ``torch``, and at W1 and W2 on the four backends; the walls of
   ``cuda_fused_e2e`` (K2-fs) and ``cuda_fused`` at ``AUTO_EDGES``, points
   on each side of auto's K2-fs rule, each pair of outputs equal bit for
   bit, beside what auto takes there (``[auto]`` lines); and the host
   time of one ``polymul`` call at the largest FS_MAIN n on both, with
   the card kept busy so the host never waits, split into the front door,
   each wrapper, K2-fs's C call and its allocations, on ``cuda`` K3-fs's
   C call (its counters' memset, its TMA maps' encoding and its launch)
   and its allocations, with ``torch.profiler``'s host-side events beside
   (``[host]`` lines);
7. the wide and oracle widths (``[widths]`` lines): ``polymul`` on
   ``plan(4096, 4, 45)`` (the wide width, plain PyTorch on the card: no
   kernel of the port launches) at 16 rows equal bit for bit to the same
   call on CPU tensors and on two rows to the host oracle, and
   ``plan(1024, 2, 50)`` (the oracle width: operands and result on the
   card, arithmetic on the host) equal to the host schoolbook on its 2
   rows; each call's median wall of 10 synchronised calls and the CUDA
   launches of one wide call (``torch.profiler``);
8. the batching engine at full width, the slice's main path (``[serve]``
   lines): ``repro_torch.launch.serve_crypto`` at ``SERVE_PRESETS``
   (4096:6:30, 4096:4:45 and 65536:6:30 in turn, plus two requests at
   1024:2:50) with 16 slots, a closed-loop run stepped inline and one on
   the background dispatcher with a deadline that sheds nothing, 101
   requests each, every launch counter zeroed just before each run and
   read just after: every result equal to ``polymul`` of its request
   alone on its plan, three (the inline run's first of each full-width
   preset) equal to the host oracle; served == submitted and no dispatch
   failure, breaker opening, shed or failure; K2's launches exactly the
   (4096, 6, 30) bucket's dispatches, K5's, K1-fs's and K6's exactly what
   the (65536, 6, 30) bucket's dispatches make (two, one and one a
   dispatch; warm-up included), nothing else launched; no int64-width
   plan of the engine on ``torch``; per bucket its requests/s, products/s
   over its dispatches' time, p50/p99 latency, dispatches and padded
   slots;
9. the fault-injected soak (``[soak]`` line): ``serve_soak.run_soak`` on
   the card at its ``CONFIGS`` ((4096, 6, 30) on ``cuda_fused_e2e`` and
   the wide (4096, 4, 45)), 520 requests, a span log in a temporary
   directory, the launch counters zeroed around it: its ``failures`` list
   empty (exactly-once resolution, the breaker's round trip
   ``cuda_fused_e2e -> cuda_fused -> cuda_fused_e2e``, injected corruption
   detected, clean results bit-exact, span conservation) and
   ``obs_report --check`` passing on the log; K2, K5, K1 and K6 launched;
10. the autotuner and the stage profiler (``[tune]``, ``[stages]`` lines):
   ``repro_torch.tune.sweep`` on the card at ``TUNE_WORKLOADS``
   (n4096_t6_v30_b256, the paper's point at phase 6's batch, and
   n65536_t6_v30_b16) over every backend (``schedule`` varied on
   ``torch``), the median of 20 synchronised calls each after the path's
   kernels are built and loaded, the counters zeroed around each
   workload: no candidate failed, every measured candidate's product
   equal to the default candidate's bit for bit, the launches exactly
   the traffic model's (``kernels.cost.path_launches`` times each
   candidate's calls); each candidate's us/poly beside the model's time,
   the winner, the rank correlation; the two entries into a table in a
   temporary directory on which ``autotune check`` must return 0; then
   ``obs.stage_timings`` at (4096, 6, 30) on ``cuda``, ``cuda_fused`` and
   ``cuda_fused_e2e`` (256 rows) and at (65536, 6, 30) on ``cuda_fused``
   (16 rows): each stage's median wall, its share beside the byte
   model's and the drift, ``execute``'s wall, launches exactly the
   model's;
11. the sharded paths on an NCCL world of one rank (``[shard]`` lines):
   ``repro_torch.launch.mesh.make_local_mesh()`` (a (data=1, model=1)
   ``DeviceMesh``, its store in a temporary directory, the group destroyed
   at the end); ``polymul_sharded`` and ``negacyclic_mul_sharded`` at
   ``SHARD_POINTS`` (``plan(4096, 6, 30)`` at 256 rows, ``plan(65536, 6,
   30)`` at 16 rows, which runs K1-fs, and the wide ``plan(4096, 4, 45)``
   at 16 rows), each equal bit for bit to ``polymul`` and
   ``negacyclic_mul`` (the wide one also to its CPU run), their launches
   exactly ``SHARD_LAUNCHES`` (K5, K1 or K1-fs, K6) and their collectives
   counted; a shard-local plan of channels [2, 4) one K1 (K1-fs) launch
   over two channels, equal to their slice; the walls, in two turns, of
   ``polymul_sharded``, ``polymul`` and ``polymul`` on ``cuda_fused`` (the
   shard path's kernels), median of 10 synchronised calls each;
   ``PolymulEngine(mesh=)`` with 16 slots on 33 requests at (4096, 6, 30),
   each equal to ``polymul``, none shed or failed, its launches K5, K1 and
   K6 a dispatch; ``negacyclic_mul_fourstep`` at n = 2^20 (q = 998244353,
   n1 = 2^10) over the mesh's model axis, equal to the same code on the
   CPU and on 8 seeded coefficients to their direct negacyclic sums, with
   3 all-to-alls and 1 all-gather, its wall beside the unsharded one's;
   and ``launch.dryrun_crypto``'s two records at 4096 rows and 2^20 (peak
   device memory, wall, modelled bytes a device, collectives).
12. LM serving on the card (``[lm]`` lines): each arch of ``LM_FULL`` at
   full width from a seeded generator, weights stored bf16, through
   ``repro_torch.serve.Engine``: gemma2-2b
   (``src/repro_torch/configs/gemma2_2b.py``: 26 layers, d_model 2304, 8
   heads over 4 kv heads of 256, vocab 256000, a 4096-token window on
   alternate layers, softcaps 50 and 30; 4 slots, an 8192-entry cache,
   4 seeded prompts of 4608-5120 tokens and 32 new tokens each) and
   zamba2-2.7b (``configs/zamba2_2p7b.py``: 54 mamba2 layers and a shared
   attention block of 32 heads of 80 after each 6; 4 slots, a 4096-entry
   cache, prompts of 1536-2048 tokens, 16 new), each after a warm-up,
   with every launch counter zeroed just before and read just after:
   exactly (attention calls a step) x (1 + new) K7 launches (26 x 33 and
   9 x 17; the first step's ``wgmma``, the rest ``decode``) and no other
   kernel's, finite logits at every step, the new tokens a request; the
   prefill's and the steps' CUDA-event times, tokens/s (host-bound,
   measured after the earlier phases), the peak memory and K7's share of
   one decode step's device time (``torch.profiler``); the serve's
   ``decode_step`` calls replayed with the plain attention on a fresh
   cache, fed the same tokens, every call's logits within the arch's
   bound of the serve's (the left-padded B = 4 prefill and the decode
   steps at the serve's own key splits); then one prompt at B = 1,
   ``forward``'s logits at every position with K7 against the same model
   with the plain attention (the reference's arithmetic, bf16 P) on the
   card, and one ``decode_step`` after a K7 prefill likewise, within the
   bound, with the share of positions whose greedy token agrees, and a
   control that must fall outside it (gemma2: the attention softcap
   corrupted; zamba2: K7 over the first 64 of the 80 head-dim columns,
   what a kernel that dropped its second panel computes); then every
   other arch without experts reduced (``LM_REDUCED``) through ``Engine``
   (2 prompts, 4 new tokens): K7's launches exactly one per attention call
   (none for mamba2), every step's logits within ``LM_REDUCED_BOUND`` of the
   plain attention fed the same tokens, and qwen2-vl and seamless also
   ``forward`` over frontend embeddings;
13. the MoE archs at full width on the card (``[moe]`` lines): dbrx-132b
   (16 experts top-4, d_model 6144, d_ff 10752, vocab 100352) at 8 of its
   40 layers and llama4-maverick-400b-a17b (128 experts top-1 and a shared
   expert, dense layers at 2 d_ff) at one super-block, 2 of its 48 layers,
   at their published widths from a seeded generator, one after the
   other, through ``Engine`` (4 slots, a 4096-entry cache, seeded prompts
   of 1536-2048 tokens, 16 new each), the counters around the measured
   run: exactly n_layers x 17 K7 launches (n_layers ``wgmma``) and no
   other kernel's, finite logits, 16 tokens a request; the prefill's and
   the steps' times, tokens/s, peak memory, one decode step's device
   time with K7's and the expert products' shares; the share of the
   prefill's assignments dropped; the serve replayed with the plain
   attention: the routing decisions that differ counted per MoE layer,
   their share of the prefill's within the arch's ``flip_bound``
   (``MOE_FULL``), the prefill with a faulty attention (K7 over 64 of the
   128 head-dim columns) outside it; the MoE layer alone on the card
   against the same call on the CPU, its input in ``forward`` over the
   serve's longest prompt (about 2000 tokens) and the same weights, its
   slots equal and its output within ``MOE_LAYER_TOL``.  K7 itself is
   held at both archs' prefill and decode shapes in phase 3.

``python3 chip_smoke.py --time-kernels DIR NAME...`` times only the
kernels NAME (keys of ``KERNELS``: ``fused_polymul``, ``ntt_channels``,
..., and ``fused_polymul_fs``, ``ntt_channels_fs``,
``intt_channels_fs`` and ``fused_e2e_polymul_fs``, K1-fs, K3-fs and
K4-fs at (6, 16, 65536) and K2-fs at (16, 65536, 6), and
``attention``, K7 at the ten ``ATTN_MODEL`` shapes) of the
checkout at DIR (for instance the parent commit unpacked with
``git archive``) at the main path's shape, one call between two events
and back to back (K2 also at one row), after checking each against its
plain version, and prints one ``[time-kernels]`` line per kernel; so
two commits compare on one card in one chip call.  ``--time-k2 DIR`` is
``--time-kernels DIR fused_e2e_polymul``.  ``--compose-variants`` times
K6 beside copies of its source with one of its two load orders switched
off (``COMPOSE_VARIANTS``) at ``COMPOSE_SHAPES``.  ``--cascade-variants``
times K1-fs at each FS_MAIN shape in clusters of 8 and of 16 CTAs, in
turns 8, 16, 16, 8, each whole and cut after its first and its second
DSMEM transpose (``csrc/fused_polymul_fs.cu``
``parentt_fused_polymul_fs_phases``), back to back, with the clusters
resident and waves of each size: the phase split and the measurement
behind ``fs_cluster``.  ``--transform-variants`` times K3-fs and K4-fs
at ``TRANSFORM_SHAPES`` in turns: the earlier design's two launches of
one CTA a tile (``csrc/fs_variants.cu``, a measurement-only source)
whole, as copies
and as their passes alone, against the shipped tile stream as one
launch, as two launches of one phase each, each alone, as a copy and as
its passes, and the one-block K3/K4 at 32768: whether whole time is the
sum of the memory and the integer time or their maximum.

It prints a ``{"kernels": [...]}`` line (K7's entry carries the yi-6b
numbers and a ``shapes`` list with all ten; K1's, K2's and K6's a
``launches_by_path`` beside ``launches``, the main path's count, with
phase 4b's paths; K1-fs's, K3-fs's, K4-fs's and K2-fs's ``launches``
sum phase 4c's and 4d's calls, each one a path of ``launches_by_path``;
the other kernels on phase 4d's paths list them in ``launches_by_path``
too, and K2, K1, K1-fs, K5 and K6 their launches in phases 8 and 9
(paths ``serve inline``, ``serve async``, ``soak``), and every kernel
phase 10 launched its launches there (paths ``tune <workload>``,
``stages n=<n> <backend>``), and phase 11's as paths ``shard`` (the
sharded calls, the shard-local plan and the engine) and ``dryrun``, and
K7 phase 12's as paths ``lm gemma2-2b``, ``lm zamba2-2.7b`` and ``lm
reduced <arch>`` and phase 13's as ``lm moe <arch>``;
K2-fs's, K5's and K6's a ``wide`` object with their W1/W2 numbers)
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
# and K3-fs and K4-fs below it, where a column tile's 32-bit words are
# narrower than TMA's 16-byte box: a polynomial of them is one contiguous
# tile, moved by a 1-D bulk copy like every row tile
FS_SMALL_POINTS = (4, 8)
# K2-fs at FS_POINTS in the three regimes at these t (one channel a CTA of
# clusters of t CTAs), 2 rows, where plan() admits (n, t, v) on a kernel
# backend; against K2 where K2 also serves (n <= 16384)
E2E_FS_T = (3, 6, 8)
# the front door at full width past one CTA, t = 6, v = 30: n -> rows (2^20
# coefficients an operand, as many as the paper point's 256 rows of 4096)
FS_MAIN = {65536: 16, 32768: 32}
FS_T, FS_V = 6, 30
# the backend auto resolves to at each FS_MAIN n (ops.auto_backend)
FS_AUTO = {65536: "cuda_fused", 32768: "cuda_fused"}
# the multi-block kernels' calls of each call on the auto plan (each K1-fs
# call one cluster launch, each K2-fs call three launches;
# cuda_fused_e2e: K2-fs for polymul, K1-fs for negacyclic_mul, the cuda
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
# K2-fs's and cuda_fused's walls on each side of auto's K2-fs rule
# (ops.auto_backend): past K2 at n = 2048 ... 16384, where K2-fs's cascade
# is K1's one-CTA body (the first t past K2, t around AUTO_E2E_FS_T, and
# the largest t), and on K1-fs's cluster at 32768 and 65536 past t = 6 and
# 15 (around AUTO_E2E_FS_T, and the largest t): (n, t); 2^20
# coefficients an operand up to t = 48, 2^16 past it
AUTO_EDGES = [(16384, 9), (16384, 16), (16384, 29), (16384, 48), (16384, 110),
              (8192, 25), (8192, 30), (8192, 139), (4096, 49), (4096, 169), (2048, 109),
              (2048, 208), (32768, 30), (32768, 85), (65536, 30), (65536, 63)]
# the slice's points at full width, 2^20 coefficients an operand as at
# every earlier point: W1 = plan(32768, 15, 30), 32 rows (S = 15, L = 16,
# a 443-bit q: K2-fs past t = 8, two channels on some CTAs); W2 =
# plan(16384, 30, 30), 64 rows (S = 30, L = 32, 10 Alg-2 blocks, an
# 888-bit q: four channels a CTA): name -> (n, t, rows)
WIDE_POINTS = {"W1": (32768, 15, 32), "W2": (16384, 30, 64)}
WIDE_V = 30
# the backend auto resolves to at each point (ops.auto_backend)
WIDE_AUTO = {"W1": "cuda_fused", "W2": "cuda_fused_e2e"}
# the kernels of one polymul call at each W point (a K2-fs call is three
# launches, its cascade K1-fs's cluster at W1 and K1's one-CTA body at W2):
# backend -> launches
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
# synchronised calls of each kernel backend's wall at FS_MAIN and WIDE_POINTS,
# the walls auto past one CTA follows (ops.auto_backend)
AUTO_WALL_RUNS = 30
ORACLE_ROWS = (0, 255)
SEED = 20260

# K7 at the full attention layer of five model configurations of the repo
# (src/repro/configs/gemma2_2b.py, yi_6b.py, zamba2_2p7b.py: head dim 80,
# which K7 pads to 128 columns inside the kernel; dbrx_132b.py and
# llama4_maverick_400b_a17b.py at the shapes phase 13's serve gives K7: 4
# slots prefilled left-padded to the longest prompt, 1995 and 1971 tokens,
# into a 4096-entry cache, and a decode step halfway through its 16, the
# decode template's 8-row tile holding 6 and 5 query heads), bfloat16 as
# the LM computes: name -> ((B, Sq, Skv, H, Hk, D), flash_attention keywords)
ATTN_MODEL = {
    "gemma2_global_prefill": ((1, 8192, 8192, 8, 4, 256), dict(softcap=50.0)),
    "gemma2_local_prefill": ((1, 8192, 8192, 8, 4, 256), dict(window=4096, softcap=50.0)),
    "gemma2_decode": ((16, 1, 8192, 8, 4, 256), dict(softcap=50.0, q_offset=8191)),
    "yi6b_prefill": ((1, 4096, 4096, 32, 4, 128), {}),
    "zamba2_prefill": ((1, 4096, 4096, 32, 32, 80), {}),
    "zamba2_decode": ((4, 1, 4096, 32, 32, 80), dict(q_offset=4095)),
    "dbrx_prefill": ((4, 1995, 4096, 48, 8, 128), {}),
    "dbrx_decode": ((4, 1, 4096, 48, 8, 128), dict(q_offset=2003)),
    "llama4_prefill": ((4, 1971, 4096, 40, 8, 128), {}),
    "llama4_decode": ((4, 1, 4096, 40, 8, 128), dict(q_offset=1979)),
}
ATTN_LIBRARY_SHAPE = "yi6b_prefill"  # its numbers head K7's entry (library: SDPA)
# the K7 variant (attention.attention_variant) that serves each model shape
ATTN_VARIANT = {
    "gemma2_global_prefill": "wgmma",
    "gemma2_local_prefill": "wgmma",
    "gemma2_decode": "decode",
    "yi6b_prefill": "wgmma",
    "zamba2_prefill": "wgmma",
    "zamba2_decode": "decode",
    "dbrx_prefill": "wgmma",
    "dbrx_decode": "decode",
    "llama4_prefill": "wgmma",
    "llama4_decode": "decode",
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
    # head dim 80 in each variant, padded inside the kernel
    ("f32_d80", (1, 100, 200, 4, 2, 80), "float32", dict(window=50, softcap=30.0)),
    ("bf16_d80_window", (1, 200, 300, 8, 4, 80), "bfloat16", dict(window=100, softcap=50.0)),
    ("bf16_d80_non_causal", (1, 130, 200, 2, 2, 80), "bfloat16", dict(causal=False)),
    ("bf16_no_key_wgmma_d80", (1, 70, 130, 2, 1, 80), "bfloat16", dict(window=8, q_offset=500)),
    ("bf16_decode_d80", (4, 1, 1000, 32, 32, 80), "bfloat16", dict(q_offset=999)),
    ("bf16_decode_d80_rows8", (2, 2, 517, 16, 4, 80), "bfloat16", dict(q_offset=515,
                                                                         softcap=50.0)),
    ("bf16_no_key_decode_d80", (1, 4, 100, 2, 1, 80), "bfloat16", dict(window=8, q_offset=500,
                                                                         blk_k=64)),
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
    """Kernel name -> its wrapper, whose ``launches`` counts its launches:
    the multiplier's (``kernels.cost.WRAPPERS``) and K7's."""
    from repro_torch.kernels import attention, cost

    return {**{name: getattr(mod, attr) for name, (mod, attr) in cost.WRAPPERS.items()},
            "attention": attention.flash_attention_cuda}


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


def cascade_sizes(n: int) -> tuple[int, ...]:
    """K1-fs's cluster sizes worth reading the residency of at n: the one
    its launch takes (``fs_cluster``), and the other of 8 and 16 where n1
    holds 16."""
    from repro_torch.kernels import ntt as kern

    n1 = kern.fs_split(n)[0]
    return tuple(sorted({kern.fs_cluster(n), *((8, 16) if n1 >= 16 else ())}))


def k1fs_clusters(tables) -> dict[int, int]:
    """K1-fs's clusters the card holds at once, by cluster size
    (``cascade_sizes``)."""
    from repro_torch.kernels import ntt as kern

    return {c: kern.cascade_fs_clusters_resident(tables, c) for c in cascade_sizes(tables.n)}


def fs_kernel(name: str) -> tuple:
    """K1-fs's, K3-fs's or K4-fs's (``name``) wrapper, plain version, the
    one-block kernel of the same function with its fit test, and its
    occupancy: the CTAs an SM holds of each launch (K3-fs, K4-fs), the
    clusters the card holds by cluster size (K1-fs)."""
    from repro_torch.kernels import ntt as kern

    return {
        "fused_polymul_fs": (kern.fused_polymul_fs_cuda, kern.fused_polymul_fs_ref,
                             kern.fused_polymul_cuda, kern.cascade_fits, k1fs_clusters),
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
    the CTAs an SM holds of each launch (K3-fs, K4-fs), and K1-fs's
    clusters, of which the card holds at least one at the size it
    launched."""
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
                occupancy = blocks_per_sm(tables)
                if name == "fused_polymul_fs":
                    expect_cascade_cluster(occupancy, n, f"{name} n={n} v={v}")
                    occupancy = (f"clusters of {kern.fs_cluster(n)} CTAs, "
                                 f"{kern.cascade_fs_threads(n)} threads; clusters resident by "
                                 f"size {occupancy}")
                seen.append(f"{name} {occupancy}" + (" = one block" if fits(n) else ""))
            log(f"[kernels] multi-block n={n} t=3 v={v} rows=2 (mode, window)="
                f"{kern.reduction_mode(tables)[:2]} split {kern.fs_split(n)}, K3-fs/K4-fs "
                f"{kern.fs_threads(n)} threads, {kern.fs_tile(n)}-element tiles: equal to the "
                "plain versions bit for bit (and to K1/K3/K4 where marked); CTAs an SM holds "
                "per launch: " + ", ".join(seen))
    for n in FS_SMALL_POINTS:
        for v in (29, 30, 31):
            pl = repro_torch.plan(n, 3, v, backend="cuda", device=dev)
            tables = pl.params.tables
            _, _, ra, _ = seeded_inputs(torch, np, pl, 3, SEED + 3 * n + v, dev)
            for name in FS_TRANSFORMS[1:]:
                cuda, ref, one_block, _, _ = fs_kernel(name)
                got = cuda(ra, tables)
                torch.cuda.synchronize()
                exact(got, ref(ra, tables), f"{name} n={n} t=3 v={v}")
                exact(got, one_block(ra, tables), f"{name} vs one block n={n} v={v}")
        log(f"[kernels] K3-fs and K4-fs at n={n}, t=3, 3 rows, v = 29, 30, 31: one tile a "
            f"polynomial ({kern.fs_col_box(n, 4)}), equal to the plain versions and K3/K4 bit "
            "for bit")
    log(f"[kernels] multi-block checks took {time.perf_counter() - t0:.1f} s (host clock)")


def expect_cascade_cluster(clusters: dict[int, int], n: int, what: str) -> None:
    """The card holds at least one K1-fs cluster of the size its launch
    takes at n (``fs_cluster``: 16 past n = 32768)."""
    from repro_torch.kernels import ntt as kern

    if clusters[kern.fs_cluster(n)] < 1:
        raise AssertionError(f"{what}: clusters of {kern.fs_cluster(n)} CTAs, clusters resident "
                             f"by size {clusters}")


def check_e2e_fs_call(za, zb, p, what: str, max_err: dict[str, int]):
    """K2-fs on (za, zb) under the params ``p``, bit for bit against its
    plain version, and each of its three launches alone on the kernel's
    inputs against its plain counterpart (decompose_ref, the four-step
    cascade with the q~ product, the Eq-10 limb sums and tail); the card
    holds at least one cluster of its cascade.  Returns (K2-fs's output,
    its cascade's clusters resident by size)."""
    import torch

    from repro_torch.kernels import ntt as kern

    got = kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan)
    torch.cuda.synchronize()
    err = exact(got, kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan), what)
    ra, rb = kern.e2e_fs_decompose_cuda(za, zb, p.tables, p.plan)
    torch.cuda.synchronize()
    for x, want in zip((ra, rb), kern.e2e_fs_decompose_ref(za, zb, p.plan)):
        exact(x, want, f"{what} decompose launch")
    y = kern.e2e_fs_cascade_cuda(ra, rb, p.tables, p.plan)
    torch.cuda.synchronize()
    exact(y, kern.e2e_fs_cascade_ref(ra, rb, p.tables, p.plan), f"{what} cascade launch")
    limbs = kern.e2e_fs_compose_cuda(y, p.plan)
    torch.cuda.synchronize()
    exact(limbs, kern.e2e_fs_compose_ref(y, p.plan), f"{what} compose launch")
    exact(limbs, got, f"{what} launches one at a time vs one call")
    clusters = e2e_fs_clusters(p)
    if min(clusters.values()) < 1:
        raise AssertionError(f"{what}: cascade clusters resident by size {clusters}")
    max_err["fused_e2e_polymul_fs"] = max(max_err.get("fused_e2e_polymul_fs", 0), err)
    return got, clusters


def e2e_fs_clusters(p) -> dict[int, int]:
    """{C: clusters of C CTAs of K2-fs's cascade the card holds at once}
    at the size its launch takes (C = 1: K1's one-CTA body, CTAs
    resident)."""
    from repro_torch.kernels import ntt as kern

    return {kern.e2e_fs_cluster(p.plan.n): kern.e2e_fs_clusters_resident(p.tables, p.plan)}


def check_e2e_fs(dev, max_err: dict[str, int]) -> None:
    """Phase 3 for K2-fs at FS_POINTS x E2E_FS_T in every regime, where
    plan() admits (n, t, v) on cuda_fused_e2e: K2-fs and each of its
    launches exactly equal to their plain versions (check_e2e_fs_call)
    and, where K2 also serves n, to K2; the card holds at least one
    cluster of its cascade.  One coefficient of row 0 is 0, one of row 1
    is q - 1 in both operands."""
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
                what = f"fused_e2e_polymul_fs n={n} t={t} v={v}"
                got, clusters = check_e2e_fs_call(za, zb, p, what, max_err)
                k2 = kern.e2e_fits(n, t, pl.config.seg_count, pl.config.L)
                if k2:
                    exact(got, kern.fused_e2e_polymul_cuda(za, zb, p.tables, p.plan),
                          f"{what} vs K2")
                seen.append(f"v={v} {kern.reduction_mode(p.tables)[:2]} cascade clusters of "
                            f"{kern.e2e_fs_cluster(n)}, resident by size {clusters}"
                            + (" = K2" if k2 else ""))
            log(f"[kernels] fused_e2e_polymul_fs n={n} t={t} rows=2, three launches: equal to "
                "its plain version bit for bit, each launch to its plain counterpart (and to K2 "
                "where marked); (mode, window), the cascade's cluster (1: K1's one-CTA body): "
                + ", ".join(seen))
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
    30): K5 and K6 on the plan's segments and residues, K2 wherever it
    holds the plan and K2-fs (each launch too) wherever it serves past K2,
    and up to t = 48 where K2 serves too (each also against the other),
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
        if kern.e2e_fs_fits(n, t, S, L) and (t <= 48 or not outs):
            got, clusters = check_e2e_fs_call(za, zb, p, f"fused_e2e_polymul_fs {what}",
                                              max_err)
            for other in outs:
                exact(got, other, f"fused_e2e_polymul_fs {what} vs K2")
            seen.append(f"fused_e2e_polymul_fs and its launches "
                        f"({kern.e2e_fs_smem_bytes(n, t, S, L)} B, cascade clusters resident "
                        f"by size {clusters})" + (" = K2" if outs else ""))
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
    """Phase 4c: ``plan(n, 6, 30)`` at FS_MAIN's n, past one CTA (``auto``
    must resolve to FS_AUTO on multi-block kernels), on
    ``backend="cuda_fused_e2e"``, ``"cuda_fused"`` and ``"cuda"``: ``polymul`` on
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
        if auto.config.backend != FS_AUTO[n] or not spec.multi_block:
            raise AssertionError(f"plan(n={n}, t={FS_T}, v={FS_V}) resolved to {auto.config}")
        e2e = repro_torch.plan(n, FS_T, FS_V, backend="cuda_fused_e2e")
        plain = repro_torch.plan(n, FS_T, FS_V, backend="torch", device=auto.device)
        za, zb, ra, rb = seeded_inputs(torch, np, auto, rows, SEED + n, auto.device)
        inputs[n] = (za, zb, ra, rb)
        want = {
            "polymul": repro_torch.polymul(plain, za, zb),
            "negacyclic_mul": repro_torch.negacyclic_mul(plain, ra, rb),
            "ntt": repro_torch.ntt(plain, ra),
            "intt": repro_torch.intt(plain, ra),
        }
        for backend, pl in (("cuda_fused_e2e", e2e),
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
    with the bound of its traffic with the 32-bit words beside it)
    against the same operation counts as K1/K3/K4/K2."""
    import torch

    import repro_torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import ntt as kern

    n = max(FS_MAIN)
    _, _, ra, rb = inputs[n]
    params = repro_torch.plan(n, FS_T, FS_V).params
    tables = params.tables
    polys = FS_T * FS_MAIN[n]
    # the multi-block forms move and compute what the one-block ones do
    work_of = {f"{name}_fs": w for name, w in cost.work(params, FS_MAIN[n]).items()}
    entries = []
    for name in FS_TRANSFORMS:
        source, replaces = FS_KERNELS[name]
        cuda, ref, _, _, occupancy = fs_kernel(name)
        operands = (ra, rb) if name == "fused_polymul_fs" else (ra,)
        fn = lambda: cuda(*operands, tables)
        ms = time_launches(torch, fn, TIMED_LAUNCHES)
        device_ms = time_back_to_back(torch, fn, TIMED_LAUNCHES)
        plain_ms = time_launches(torch, lambda: ref(*operands, tables), PLAIN_RUNS, warmup=1)
        nbytes, ops = work_of[name]
        bound_ms, bound_by = cost.bound(nbytes, ops)
        blocks = occupancy(tables)
        if name == "fused_polymul_fs":
            fill = cascade_residency(polys, blocks, kern.fs_cluster(n))
            resident = fill["str"]
            extra = {"cluster": kern.fs_cluster(n),
                     "clusters_resident": {str(c): k for c, k in blocks.items()},
                     "waves": fill["waves"]}
        else:
            grid = kern.fs_stream_grid(tables, name)
            resident = (f"{blocks} CTAs an SM ({kern.fs_threads(n)} consumer threads and a "
                        f"producer warp, {kern.fs_stream_smem_bytes(n)} B of shared memory), "
                        f"{grid} persistent CTAs over {2 * kern.fs_blocks(FS_T, FS_MAIN[n], n)} "
                        "tiles")
            extra = {"blocks_per_sm": blocks, "grid": grid}
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.get(name, {}).values()),
            "launches_by_path": launches.get(name, {}), "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "device_ms": device_ms, "shape": [FS_T, FS_MAIN[n], n],
            **extra,
        })
        log(f"[time] {name} at (t, rows, n) = ({FS_T}, {FS_MAIN[n]}, {n}): {ms:.4f} ms per call "
            f"(median of {TIMED_LAUNCHES}, one call between two events, "
            f"{'one cluster launch' if name == 'fused_polymul_fs' else 'one persistent launch'}), "
            f"{device_ms:.4f} ms back to back (device time), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, {ops} int ops); {resident}; "
            f"no single PyTorch call computes this function, so library_ms is null; {card}")
    entries.append(time_e2e_fs(inputs, launches, max_err, card))
    fill = log_cluster_fill(card)
    for entry in entries:
        key = {"fused_polymul_fs": "K1-fs", "fused_e2e_polymul_fs": "K2-fs"}.get(entry["name"])
        if key:
            entry["waves_by_point"] = {pt: f[key] for pt, f in fill.items() if key in f}
    return entries


def cascade_residency(pairs: int, clusters: dict[int, int], cluster: int) -> dict:
    """How a cascade launch of ``pairs`` (channel, row) clusters of
    ``cluster`` CTAs fills the card, from the clusters resident by size
    (``clusters``: cudaOccupancyMaxActiveClusters; size 1 counts K1's
    one-CTA body's CTAs resident): its ``waves`` (pairs over the clusters
    resident at its size) and a printable ``str``."""
    waves = pairs / clusters[cluster]
    return {"waves": waves, "str": f"clusters of {cluster} CTAs, {clusters[cluster]} resident "
            f"({clusters} by size), {pairs} pairs: {waves:.2f} waves"}


def log_cluster_fill(card: str) -> dict[str, dict]:
    """Phase 5 at each FS_MAIN n (t = 6) and WIDE_POINTS point: the
    clusters resident and waves of K1-fs's launch (where it runs, n >
    16384, on cuda_fused and negacyclic_mul) and of K2-fs's cascade on the
    point's rows.  Returns point -> numbers."""
    import repro_torch
    from repro_torch.kernels import ntt as kern

    points = {f"n={n}": (n, FS_T, rows) for n, rows in FS_MAIN.items()}
    points.update(WIDE_POINTS)
    out = {}
    for point, (n, t, rows) in points.items():
        p = repro_torch.plan(n, t, WIDE_V, backend="cuda_fused_e2e").params
        fill = {"K2-fs": cascade_residency(t * rows, e2e_fs_clusters(p),
                                           kern.e2e_fs_cluster(n))}
        if not kern.cascade_fits(n):
            fill["K1-fs"] = cascade_residency(t * rows, k1fs_clusters(p.tables),
                                              kern.fs_cluster(n))
        out[point] = {k: v["waves"] for k, v in fill.items()}
        log(f"[time] clusters at {point} (t, rows, n) = ({t}, {rows}, {n}): "
            + "; ".join(f"{k} {v['str']}" for k, v in fill.items()) + f"; {card}")
    return out


def time_e2e_fs(inputs, launches: dict[str, dict[str, int]], max_err: dict[str, int],
                card: str) -> dict:
    """Phase 5 for K2-fs at (FS_T, FS_MAIN rows, largest FS_MAIN n): one
    call between two events and back to back, the plain version, the bound
    for the least traffic (2S int64 segments in and L limbs out a
    coefficient) against e2e_ops, the bound of its traffic with the 32-bit
    words between its launches (six a channel-coefficient: two residues
    written and read between launches 1 and 2, one y between 2 and 3), and
    its cascade's and K1-fs's clusters resident and waves."""
    import torch

    import repro_torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import ntt as kern

    n = max(FS_MAIN)
    rows = FS_MAIN[n]
    za, zb, _, _ = inputs[n]
    pl = repro_torch.plan(n, FS_T, FS_V)
    p, cfg = pl.params, pl.config
    coeffs = rows * n
    least, ops = cost.work(p, rows)["fused_e2e_polymul"]
    least //= coeffs
    # the model's K2-fs traffic: the 32-bit words between its launches too
    with_scratch = cost.hbm_traffic_model(p, rows, "cuda_fused_e2e")["hbm_bytes"] // coeffs
    fn = lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan)
    ms = time_launches(torch, fn, TIMED_LAUNCHES)
    device_ms = time_back_to_back(torch, fn, TIMED_LAUNCHES)
    plain_ms = time_launches(torch, lambda: kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan),
                             PLAIN_RUNS, warmup=1)
    bound_ms, bound_by = cost.bound(least * coeffs, ops)
    scratch_ms, scratch_by = cost.bound(with_scratch * coeffs, ops)
    clusters = e2e_fs_clusters(p)
    fill = cascade_residency(cfg.t * rows, clusters, kern.e2e_fs_cluster(n))
    # device time of each launch, beside cuda_fused's kernels on the same
    # inputs (K5 on each operand, K1-fs, K6)
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
        f"{scratch_by}; its cascade {fill['str']}; no single PyTorch call computes this "
        f"function, so library_ms is null; {card}")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.get(name, {}).values()),
        "launches_by_path": launches.get(name, {}), "max_abs_err": max_err[name], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "device_ms": device_ms, "bound_ms_with_scratch": scratch_ms, "shape": [rows, n, cfg.t],
        "cluster": kern.e2e_fs_cluster(n),
        "clusters_resident": {str(c): k for c, k in clusters.items()}, "waves": fill["waves"],
        "launch_ms": split, "cuda_fused_launch_ms": staged,
    }


def time_fs_walls() -> None:
    """Phase 6 at FS_MAIN: the wall of one synchronised ``polymul`` and
    ``negacyclic_mul`` call per backend that serves n (host clock)."""
    import numpy as np
    import torch

    import repro_torch

    for n, rows in FS_MAIN.items():
        walls = {}
        for backend in ("cuda_fused_e2e", "cuda_fused", "cuda", "torch"):
            pl = repro_torch.plan(n, FS_T, FS_V, backend=backend, device="cuda")
            za, zb, ra, rb = seeded_inputs(torch, np, pl, rows, SEED + n, pl.device)
            runs = E2E_RUNS if backend == "torch" else AUTO_WALL_RUNS
            ms = walls[backend] = wall_ms(torch, lambda: repro_torch.polymul(pl, za, zb), runs)
            nms = wall_ms(torch, lambda: repro_torch.negacyclic_mul(pl, ra, rb), runs)
            log(f"[e2e] n={n} polymul backend={backend} on {tuple(za.shape)}: {ms:.4f} ms per "
                f"call, {rows * 1e3 / ms:.0f} products/s; negacyclic_mul on {tuple(ra.shape)}: "
                f"{nms:.4f} ms per call (median of {runs}, host clock)")
        log(f"[e2e] n={n}: cuda_fused_e2e / cuda_fused = "
            f"{walls['cuda_fused_e2e'] / walls['cuda_fused']:.3f}; auto takes {FS_AUTO[n]}")


def wall_turns(torch, fns: dict, runs: int = AUTO_WALL_RUNS) -> dict[str, float]:
    """Median wall milliseconds of one synchronised call of each of
    ``fns`` (name -> call), ``runs`` samples each taken in two turns, the
    names in order and then reversed, so a drift of the card's clock
    falls on both alike (host clock, after a warm-up of each)."""
    samples = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        fns[name]()
        torch.cuda.synchronize()
        for _ in range(runs // 2):
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in samples.items()}


def time_auto_edges(card: str) -> None:
    """Phase 6 at AUTO_EDGES: the walls of one synchronised ``polymul`` on
    cuda_fused_e2e (K2-fs) and cuda_fused (``wall_turns``), whose outputs
    must be equal bit for bit, beside what auto takes there (``[auto]``
    lines)."""
    import numpy as np
    import torch

    import repro_torch

    t0 = time.perf_counter()
    for n, t in AUTO_EDGES:
        rows = max(1, (1 << (20 if t <= 48 else 16)) // n)
        auto = repro_torch.plan(n, t, WIDE_V)
        plans = {b: repro_torch.plan(n, t, WIDE_V, backend=b)
                 for b in ("cuda_fused_e2e", "cuda_fused")}
        za, zb, _, _ = seeded_inputs(torch, np, auto, rows, SEED + 11 * n + t, auto.device)
        got = {b: repro_torch.polymul(pl, za, zb) for b, pl in plans.items()}
        torch.cuda.synchronize()
        exact(got["cuda_fused_e2e"], got["cuda_fused"], f"polymul n={n} t={t} e2e vs fused")
        del got
        walls = wall_turns(torch, {b: (lambda pl=pl: repro_torch.polymul(pl, za, zb))
                                   for b, pl in plans.items()})
        ratio = walls["cuda_fused_e2e"] / walls["cuda_fused"]
        cfg = plans["cuda_fused_e2e"].config
        log(f"[auto] n={n} t={t} v={WIDE_V} (S={cfg.seg_count}, L={cfg.L}) polymul on "
            f"{tuple(za.shape)}, walls ms (median of {AUTO_WALL_RUNS}, two turns, host clock): "
            f"cuda_fused_e2e {walls['cuda_fused_e2e']:.4f}, cuda_fused "
            f"{walls['cuda_fused']:.4f}, e2e / fused {ratio:.3f} (outputs equal bit for bit); "
            f"auto takes {auto.config.backend}; {card}")
        del za, zb
    log(f"[auto] edge walls took {time.perf_counter() - t0:.1f} s (host clock)")


def issue_ms(torch, fn, calls: int = TIMED_LAUNCHES) -> float:
    """Host milliseconds a call of ``fn`` takes to return with the card busy
    behind a spin, so no call waits for it: median of three rounds of
    ``calls`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(rounds)


def time_host_split(card: str) -> None:
    """Phase 6 at the largest FS_MAIN shape: the host time of one
    ``polymul`` call on cuda_fused_e2e (K2-fs), on cuda_fused and on cuda
    (``issue_ms``): the whole call, each kernel wrapper it runs alone, and
    K2-fs's and K3-fs's C calls alone on buffers allocated beforehand
    (K3-fs's: the counters' memset, the TMA maps' encoding, the launch)
    and their allocations alone; then ``torch.profiler``'s host-side
    events over TIMED_LAUNCHES calls of each, self time a call by name
    (``[host]`` lines)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.kernels import _build, crt
    from repro_torch.kernels import ntt as kern

    n = max(FS_MAIN)
    rows = FS_MAIN[n]
    e2e = repro_torch.plan(n, FS_T, FS_V, backend="cuda_fused_e2e")
    fused = repro_torch.plan(n, FS_T, FS_V, backend="cuda_fused")
    staged = repro_torch.plan(n, FS_T, FS_V, backend="cuda")
    p, fp, cfg = e2e.params, fused.params, e2e.config
    za, zb, ra, rb = seeded_inputs(torch, np, e2e, rows, SEED + n, e2e.device)
    pointers, ints = kern._e2e_constants(p.tables, p.plan, "fused_e2e_polymul_fs_cuda",
                                         kern.e2e_fs_fits)
    launch = _build.load("fused_e2e_polymul_fs", "parentt_fused_e2e_polymul_fs",
                         kern._E2E_FS_ARGTYPES)
    out = torch.empty((rows, n, cfg.L), dtype=torch.int64, device=za.device)
    res = [torch.empty((cfg.t, rows, n), dtype=torch.int32, device=za.device) for _ in range(2)]
    extra = (int(kern.narrow_moduli(p.plan)), kern.e2e_fs_cluster(n).bit_length() - 1)
    ptr = _build.ptr

    def alloc():
        return (torch.empty((rows, n, cfg.L), dtype=torch.int64, device=za.device),
                *(torch.empty((cfg.t, rows, n), dtype=torch.int32, device=za.device)
                  for _ in range(2)))

    z2a, z2b = za.reshape(-1, cfg.seg_count), zb.reshape(-1, cfg.seg_count)
    tables = staged.params.tables
    ntt_pointers, ntt_ints = kern._table_constants(tables, "ntt_channels_fs", "[host]")
    ntt_launch = _build.load("ntt_channels_fs", "parentt_ntt_channels_fs", kern._FS_STAGE_ARGTYPES)
    grid = kern.fs_stream_grid(tables, "ntt_channels_fs")

    def fs_alloc():
        return (torch.empty_like(ra),
                torch.empty(cfg.t * rows * (n + 1) + 1, dtype=torch.int32, device=ra.device))

    fs_out, fs_scratch = fs_alloc()
    parts = {
        "cuda_fused_e2e": {
            "polymul": lambda: repro_torch.polymul(e2e, za, zb),
            "K2-fs wrapper": lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan),
            "its C call": lambda: launch(ptr(za), ptr(zb), ptr(res[0]), ptr(res[1]), ptr(out),
                                         *pointers, rows, *ints, *extra, _build.stream_of(za)),
            "its allocations": alloc,
        },
        "cuda_fused": {
            "polymul": lambda: repro_torch.polymul(fused, za, zb),
            "K5 wrapper x2": lambda: (crt.decompose_cuda(z2a, fp.plan),
                                      crt.decompose_cuda(z2b, fp.plan)),
            "K1-fs wrapper": lambda: kern.fused_polymul_fs_cuda(ra, rb, fp.tables),
            "K6 wrapper": lambda: crt.compose_cuda(ra.reshape(cfg.t, -1), fp.plan),
        },
        "cuda": {
            "polymul": lambda: repro_torch.polymul(staged, za, zb),
            "K5 wrapper x2": lambda: (crt.decompose_cuda(z2a, fp.plan),
                                      crt.decompose_cuda(z2b, fp.plan)),
            "K3-fs wrapper x2": lambda: (kern.ntt_channels_fs_cuda(ra, tables),
                                         kern.ntt_channels_fs_cuda(rb, tables)),
            "K4-fs wrapper": lambda: kern.intt_channels_fs_cuda(ra, tables),
            "K6 wrapper": lambda: crt.compose_cuda(ra.reshape(cfg.t, -1), fp.plan),
            "K3-fs C call": lambda: ntt_launch(ptr(ra), ptr(fs_scratch), ptr(fs_out),
                                               *ntt_pointers, cfg.t, rows, *ntt_ints, grid,
                                               _build.stream_of(ra)),
            "its allocations": fs_alloc,
        },
    }
    for backend, fns in parts.items():
        ms = {name: issue_ms(torch, fn) for name, fn in fns.items()}
        wrappers = sum(v for k, v in ms.items() if "wrapper" in k)
        log(f"[host] n={n} polymul on {tuple(za.shape)} backend={backend}: host ms a call with "
            f"the card busy (median of 3 rounds of {TIMED_LAUNCHES}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + f"; outside the wrappers {ms['polymul'] - wrappers:.4f}; {card}")
    for backend, fns in parts.items():
        fn = fns["polymul"]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMED_LAUNCHES):
                fn()
            torch.cuda.synchronize()
        events = sorted(((e.key, e.self_cpu_time_total / TIMED_LAUNCHES / 1e3)
                         for e in prof.key_averages()
                         if e.self_cpu_time_total > 0 and "Synchronize" not in e.key),
                        key=lambda kv: -kv[1])
        log(f"[host] n={n} polymul backend={backend}: torch.profiler host self ms a call "
            f"({TIMED_LAUNCHES} calls, profiled): "
            + ", ".join(f"{k} {v:.4f}" for k, v in events[:10])
            + f"; all {sum(v for _, v in events):.4f}")


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
        if auto.config.backend != WIDE_AUTO[point]:
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
        check_e2e_fs_call(za, zb, p, f"fused_e2e_polymul_fs {point}", {})
        log(f"[wide] {point}: S={cfg.seg_count}, L={cfg.L}, q of {auto.q.bit_length()} bits; "
            f"polymul row {rows - 1} equals the host bigint oracle; K2-fs, K5 and K6 on the "
            f"point's operands equal their plain versions bit for bit; auto -> "
            f"{auto.config.backend}")
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
    from repro_torch.kernels import cost, crt
    from repro_torch.kernels import ntt as kern

    out = {"fused_e2e_polymul_fs": {}, "decompose": {}, "compose": {}}
    for point, (n, t, rows) in WIDE_POINTS.items():
        za, zb, ra = inputs[point]
        walls = {}
        for backend in ("cuda_fused_e2e", "cuda_fused", "cuda", "torch"):
            pl = repro_torch.plan(n, t, WIDE_V, backend=backend)
            walls[backend] = wall_ms(torch, lambda: repro_torch.polymul(pl, za, zb),
                                     3 if backend == "torch" else AUTO_WALL_RUNS)
        log(f"[wide] {point} polymul walls on {tuple(za.shape)}, ms (median of {AUTO_WALL_RUNS}, "
            f"torch of 3, host clock): " + ", ".join(f"{b} {ms:.4f}" for b, ms in walls.items())
            + f"; cuda_fused_e2e / cuda_fused = {walls['cuda_fused_e2e'] / walls['cuda_fused']:.3f}"
            f"; auto takes {WIDE_AUTO[point]}; {card}")
        pl = repro_torch.plan(n, t, WIDE_V, backend="cuda_fused_e2e")
        p, cfg = pl.params, pl.config
        z2 = za.reshape(-1, cfg.seg_count)
        r2 = ra.reshape(t, -1)
        counts = cost.work(p, rows)
        calls = {
            "fused_e2e_polymul_fs": (
                lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, p.tables, p.plan),
                lambda: kern.fused_e2e_polymul_fs_ref(za, zb, p.tables, p.plan),
                *counts["fused_e2e_polymul"]),
            "decompose": (lambda: crt.decompose_cuda(z2, p.plan),
                          lambda: crt.decompose_ref(z2, p.plan), *counts["decompose"]),
            "compose": (lambda: crt.compose_cuda(r2, p.plan), lambda: crt.compose_ref(r2, p.plan),
                        *counts["compose"]),
        }
        for name, (fn, ref, nbytes, ops) in calls.items():
            ms = time_launches(torch, fn, TIMED_LAUNCHES)
            device_ms = time_back_to_back(torch, fn, TIMED_LAUNCHES)
            plain_ms = time_launches(torch, ref, 1, warmup=0)
            bound_ms, bound_by = cost.bound(nbytes, ops)
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
        clusters = e2e_fs_clusters(p)
        fill = cascade_residency(t * rows, clusters, kern.e2e_fs_cluster(n))
        out["fused_e2e_polymul_fs"][point].update(
            launch_ms=split, cuda_fused_launch_ms=staged,
            clusters_resident={str(c): k for c, k in clusters.items()}, waves=fill["waves"])
        log(f"[time] fused_e2e_polymul_fs launches at {point}, device ms a call "
            f"(torch.profiler, {TIMED_LAUNCHES} calls): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f" (sum {sum(split.values()):.4f}); cuda_fused's kernels on the same inputs: "
            + ", ".join(f"{k} {v:.4f}" for k, v in staged.items())
            + f" (sum {sum(staged.values()):.4f}); its cascade {fill['str']}; {card}")
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


def time_kernels(pl, inputs, launches, max_err) -> list[dict]:
    """Phase 5: kernel and plain-version times at the main path's shapes,
    beside the bound computed from these inputs."""
    import torch

    from repro_torch.kernels import cost

    calls = kernel_calls(pl, inputs)
    counts = cost.work(pl.params, inputs[0].shape[0])
    earlier = cost.work(pl.params, inputs[0].shape[0], earlier=True)
    entries = []
    for name, (source, replaces) in KERNELS.items():
        fn, ref = calls[name]
        nbytes, ops = counts[name]
        ms = time_launches(torch, fn, TIMED_LAUNCHES)
        plain_ms = time_launches(torch, ref, PLAIN_RUNS, warmup=1)
        bound_ms, bound_by = cost.bound(nbytes, ops)
        earlier_ms, earlier_by = cost.bound(*earlier[name])
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

    from repro_torch.kernels import cost
    from repro_torch.kernels import ntt as kern

    p = pl.params
    times = k2_times(torch, kern, pl, *inputs[:2])
    nbytes, ops = cost.work(p, LATENCY_ROWS)["fused_e2e_polymul"]
    bound_ms, bound_by = cost.bound(nbytes, ops)
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
    K2 also at one row (``k2_times``), K1-fs, K3-fs, K4-fs and K2-fs
    (``fused_polymul_fs``, ``ntt_channels_fs``, ``intt_channels_fs``,
    ``fused_e2e_polymul_fs``) at the largest FS_MAIN shape, and K7
    (``attention``) at the ten ATTN_MODEL shapes, first held within its
    tolerance, so two commits compare in one call."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    multi_block = ["fused_polymul_fs", "ntt_channels_fs", "intt_channels_fs",
                   "fused_e2e_polymul_fs"]
    known = [*KERNELS, *multi_block, "attention"]
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
    if set(multi_block) & set(names):
        # K1-fs, K3-fs, K4-fs and K2-fs at the largest FS_MAIN shape
        n = max(FS_MAIN)
        fs = repro_torch.plan(n, FS_T, FS_V, backend="cuda_fused_e2e").params
        za, zb, ra, rb = seeded_inputs(torch, np, repro_torch.plan(n, FS_T, FS_V), FS_MAIN[n],
                                       SEED + n, pl.device)
        calls["fused_polymul_fs"] = (lambda: kern.fused_polymul_fs_cuda(ra, rb, fs.tables),
                                     lambda: kern.fused_polymul_fs_ref(ra, rb, fs.tables))
        calls["ntt_channels_fs"] = (lambda: kern.ntt_channels_fs_cuda(ra, fs.tables),
                                    lambda: kern.ntt_channels_fs_ref(ra, fs.tables))
        calls["intt_channels_fs"] = (lambda: kern.intt_channels_fs_cuda(ra, fs.tables),
                                     lambda: kern.intt_channels_fs_ref(ra, fs.tables))
        calls["fused_e2e_polymul_fs"] = (
            lambda: kern.fused_e2e_polymul_fs_cuda(za, zb, fs.tables, fs.plan),
            lambda: kern.fused_e2e_polymul_fs_ref(za, zb, fs.tables, fs.plan))
    log(card_line())
    if "attention" in names:  # K7 at the ten model shapes, within its tolerance
        from repro_torch.kernels import attention

        names = [name for name in names if name != "attention"]
        for shape_name, (shape, kw) in ATTN_MODEL.items():
            if shape[5] not in attention.HEAD_DIMS:  # a checkout whose K7 lacks the head dim
                log(f"[time-kernels] attention {shape_name} {checkout}: head dim {shape[5]} "
                    "not built")
                continue
            q, k, v = attention_inputs(torch, shape, "bfloat16", SEED, pl.device)
            fn = lambda q=q, k=k, v=v, kw=kw: attention.flash_attention_cuda(q, k, v, **kw)
            attention_error(torch, fn(), attention.flash_attention_ref(q, k, v, **kw),
                            f"attention {shape_name} of {checkout}")
            log(f"[time-kernels] attention {shape_name} {checkout} ({repro_torch.__file__}): "
                f"ms {time_launches(torch, fn, TIMED_LAUNCHES):.4f}, device_ms "
                f"{time_back_to_back(torch, fn, TIMED_LAUNCHES):.4f}")
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


# K6's two load orders (its kernel, csrc/parentt.cuh compose_kernel), each
# switched off in a copy of the header that --compose-variants builds
# csrc/compose.cu against
COMPOSE_VARIANTS = {
    "no_preload": ("crt_compose<MAXL, !kSingle, kSingle>(", "crt_compose<MAXL, false, kSingle>("),
    "no_hoist": ("[&](int c) { return kSingle ? first[c] : word(c); }",
                 "[&](int c) { return word(c); }"),
}
# (n, t, rows) of its timings: L = 4, 7, 8 (the 8-limb instance), 9, 13,
# 16 (16 limbs, three CTAs an SM; W1) and 32 (two CTAs; W2)
COMPOSE_SHAPES = ((4096, 3, 256), (4096, 6, 256), (4096, 7, 256), (4096, 8, 256),
                  (4096, 12, 256), (32768, 15, 32), (16384, 30, 64))


def time_compose_variants() -> int:
    """``--compose-variants``: K6 built from csrc/compose.cu beside builds
    against copies of csrc/parentt.cuh with one load order of its compose
    kernel switched off (COMPOSE_VARIANTS: the 16-limb
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

    header = (_build.CSRC / "parentt.cuh").read_text()
    sources = {"as_built": header}
    for name, (old, new) in COMPOSE_VARIANTS.items():
        if old not in header:
            print(f"chip_smoke: csrc/parentt.cuh no longer holds {old!r}", file=sys.stderr)
            return 1
        sources[name] = header.replace(old, new)
    out = _build.BUILD_DIR / "compose_variants"
    procs = {}
    for name, text in sources.items():
        # compose.cu beside its own copy of the header, which its #include finds first
        (out / name).mkdir(parents=True, exist_ok=True)
        (out / name / "parentt.cuh").write_text(text)
        (out / name / "compose.cu").write_text((_build.CSRC / "compose.cu").read_text())
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
               str(out / name / "compose.cu")]
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


def time_cascade_variants() -> int:
    """``--cascade-variants``: K1-fs at each FS_MAIN shape (t = 6, v = 30)
    launched in clusters of 8 and of 16 CTAs through
    ``parentt_fused_polymul_fs_phases``, each whole output checked against
    the plain version, then timed back to back whole and cut after its
    first and its second DSMEM transpose, in turns 8, 16, 16, 8: the
    phases' split (the columns with the first transpose, the rows with the
    product and the second transpose, the inverse columns) and the
    clusters resident and waves of each size."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ntt as kern

    # the cut instances live only in a build with PARENTT_CASCADE_PHASES
    # defined, beside the kernels' own build
    out_dir = _build.BUILD_DIR / "cascade_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libfused_polymul_fs_phases.so"
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DPARENTT_CASCADE_PHASES",
                             "-o", str(lib), str(_build.CSRC / "fused_polymul_fs.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(["fused_polymul_fs"])
    text, _ = proc.communicate()
    if proc.returncode:
        print(f"chip_smoke: nvcc failed on the phase build:\n{text}", file=sys.stderr)
        return 1
    _build.ptxas_report("cascade_variants/fused_polymul_fs_phases").write_text(text)
    for line in ptxas_entries("cascade_variants/fused_polymul_fs_phases"):
        log(f"[ptxas fused_polymul_fs phases] {line}")
    log(card_line())
    P, I = ctypes.c_void_p, ctypes.c_int
    launch = ctypes.CDLL(str(lib)).parentt_fused_polymul_fs_phases
    launch.argtypes = [P] * 10 + [I] * 10 + [P]
    launch.restype = ctypes.c_int
    sizes, turns = (8, 16), (8, 16, 16, 8)
    for n, rows in FS_MAIN.items():
        pl = repro_torch.plan(n, FS_T, FS_V, backend="cuda_fused")
        tables = pl.params.tables
        _, _, ra, rb = seeded_inputs(torch, np, pl, rows, SEED + n, pl.device)
        want = kern.fused_polymul_fs_ref(ra, rb, tables)
        pointers, ints = kern._table_constants(tables, "fused_polymul_fs", "--cascade-variants")
        out = torch.empty_like(ra)

        def call(c, phases):
            return lambda: _build.check("fused_polymul_fs", launch(
                _build.ptr(ra), _build.ptr(rb), _build.ptr(out), *pointers, FS_T, rows, *ints,
                c.bit_length() - 1, phases, _build.stream_of(ra)))

        resident = {c: kern.cascade_fs_clusters_resident(tables, c) for c in sizes}
        for c in sizes:
            out.zero_()
            call(c, 3)()
            torch.cuda.synchronize()
            exact(out, want, f"K1-fs n={n} in clusters of {c}")
        times = {(c, ph): [] for c in sizes for ph in (1, 2, 3)}
        for c in turns:
            for ph in (1, 2, 3):
                times[(c, ph)].append(time_back_to_back(torch, call(c, ph), TIMED_LAUNCHES))
        for c in sizes:
            t1, t2, t3 = (statistics.mean(times[(c, ph)]) for ph in (1, 2, 3))
            log(f"[cascade-variants] K1-fs at (t, rows, n) = ({FS_T}, {rows}, {n}) in clusters "
                f"of {c} CTAs{' (the launch size, fs_cluster)' if c == kern.fs_cluster(n) else ''}"
                f", equal to the plain version bit for bit; ms back to back in turns {turns}: "
                f"whole {' / '.join(f'{x:.4f}' for x in times[(c, 3)])}; the phases (mean of "
                f"the turns): columns + first transpose {t1:.4f}, rows + product + second "
                f"transpose {t2 - t1:.4f}, inverse columns {t3 - t2:.4f}; {resident[c]} "
                f"clusters resident, {FS_T * rows / resident[c]:.2f} waves")
    return 0


# --transform-variants: the shapes (t, rows, n), and the launches of the
# earlier design (one CTA a tile, two launches a call) in
# csrc/fs_variants.cu: transform -> (index, its launches in order)
TRANSFORM_SHAPES = ((6, 16, 65536), (6, 32, 32768))
OLD_LAUNCHES = {"ntt_channels_fs": (0, ("columns", "rows")),
                "intt_channels_fs": (1, ("rows", "columns"))}
# the shipped kernel's builds beside its own (PARENTT_FS_STREAM_FORM): as
# built, copying its tiles with no butterfly, its passes with no TMA traffic
STREAM_FORMS = {"stream": 0, "stream_copy": 1, "stream_passes": 2}


def build_variant_libs(specs: dict[str, tuple[str, tuple[str, ...]]]) -> dict:
    """Each ``name: (source, flags)`` of ``specs``: ``csrc/<source>.cu``
    built with ``flags`` into ``build/transform_variants/lib<name>.so``,
    one nvcc process each, all started together; their ptxas lines
    printed; name -> the library, loaded with ctypes."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "transform_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(out_dir / f"lib{name}.so"),
         str(_build.CSRC / f"{source}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (source, flags) in specs.items()}
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {specs[name]}:\n{text}")
        _build.ptxas_report(f"transform_variants/{name}").write_text(text)
        for line in ptxas_entries(f"transform_variants/{name}"):
            log(f"[ptxas {name}] {line}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def old_transform_forms(torch, lib, name: str, a, tables) -> dict[str, object]:
    """The earlier design's launches of K3-fs or K4-fs (``name``) on ``a`` from
    csrc/fs_variants.cu, each whole, as a copy and as its passes, and both
    whole launches in turn, after checking the two whole launches' output
    against the plain version: form -> a call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ntt as kern

    P, I = ctypes.c_void_p, ctypes.c_int
    launch = lib.parentt_fs_variant
    launch.argtypes = [I] * 3 + [P] * 8 + [I] * 8 + [P]
    launch.restype = ctypes.c_int
    index, order = OLD_LAUNCHES[name]
    t, rows, _ = a.shape
    pointers, ints = kern._table_constants(tables, name, "--transform-variants")
    scratch = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    out = torch.empty_like(a)

    def call(step, variant):
        return lambda: _build.check("fs_variants", launch(
            index, step, variant, _build.ptr(a), _build.ptr(scratch), _build.ptr(out), *pointers,
            t, rows, *ints, _build.stream_of(a)))

    both = lambda: (call(0, 0)(), call(1, 0)())
    both()
    torch.cuda.synchronize()
    ref = kern.ntt_channels_fs_ref if index == 0 else kern.intt_channels_fs_ref
    exact(out, ref(a, tables), f"per-CTA {name} at {tuple(a.shape)}")
    forms = {"per-CTA both launches": both}
    for step, part in enumerate(order):
        for variant, form in enumerate(("whole", "copy", "passes")):
            forms[f"per-CTA {part} {form}"] = call(step, variant)
    return forms


def time_transform_variants() -> int:
    """``--transform-variants``: K3-fs and K4-fs at TRANSFORM_SHAPES (v =
    30), back to back, each form in turns (the list, then reversed): the
    earlier design's column and row launches of one CTA a tile
    (csrc/fs_variants.cu, the forms labelled "per-CTA") each whole, as a
    copy with their tile maps and word types and no butterfly (memory
    time) and as their passes on a tile in shared memory (integer time);
    the shipped kernel as one persistent launch against the same tile loop
    as two launches, each a queue of one phase, each of those alone, and
    its one launch as a copy and as its passes (PARENTT_FS_STREAM_FORM),
    and the one-block K3 or K4 where it serves n (32768), every output of
    a whole form checked against the plain version; then, for both
    designs, whole / (copy + passes) and whole / max(copy, passes), the
    mean of the turns."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ntt as kern

    _build.build(["ntt_channels_fs", "intt_channels_fs", "ntt_channels", "intt_channels"])
    specs = {"fs_variants": ("fs_variants", ())}
    for name in OLD_LAUNCHES:
        for form, flag in STREAM_FORMS.items():
            specs[f"{name}_{form}"] = (name, ("-DPARENTT_FS_PHASES",
                                              f"-DPARENTT_FS_STREAM_FORM={flag}"))
    libs = build_variant_libs(specs)
    log(card_line())
    for t, rows, n in TRANSFORM_SHAPES:
        pl = repro_torch.plan(n, t, FS_V, backend="cuda")
        tables = pl.params.tables
        _, _, ra, _ = seeded_inputs(torch, np, pl, rows, SEED + n, pl.device)
        for name in OLD_LAUNCHES:
            forms = old_transform_forms(torch, libs["fs_variants"], name, ra, tables)
            forms.update(stream_transform_forms(torch, libs, name, ra, tables))
            if kern.stage_fits(n):  # the one-block kernel (K3 or K4) serves n too
                one_block = fs_kernel(name)[2]
                exact(one_block(ra, tables), kern.ntt_channels_fs_ref(ra, tables)
                      if name == "ntt_channels_fs" else kern.intt_channels_fs_ref(ra, tables),
                      f"one-block {name} at {(t, rows, n)}")
                forms["one-block kernel"] = lambda f=one_block: f(ra, tables)
            times = {form: [] for form in forms}
            for form in [*forms, *reversed(forms)]:
                times[form].append(time_back_to_back(torch, forms[form], TIMED_LAUNCHES))
            log(f"[transform-variants] {name} at (t, rows, n) = ({t}, {rows}, {n}), ms back to "
                "back in turns (the list, then reversed): " + "; ".join(
                    f"{form} {' / '.join(f'{x:.4f}' for x in ts)}" for form, ts in times.items()))
            mean = {form: statistics.mean(ts) for form, ts in times.items()}
            first, second = OLD_LAUNCHES[name][1]
            old_copy = mean[f"per-CTA {first} copy"] + mean[f"per-CTA {second} copy"]
            old_passes = mean[f"per-CTA {first} passes"] + mean[f"per-CTA {second} passes"]
            for design, whole, copy, passes in (
                    ("per-CTA (two launches)", mean["per-CTA both launches"], old_copy, old_passes),
                    ("stream (one launch)", mean["one launch"], mean["one launch copy"],
                     mean["one launch passes"])):
                log(f"[transform-variants] {name} at ({t}, {rows}, {n}), {design}: whole "
                    f"{whole:.4f}, copy {copy:.4f}, passes {passes:.4f}; whole / (copy + passes) "
                    f"{whole / (copy + passes):.3f}, whole / max(copy, passes) "
                    f"{whole / max(copy, passes):.3f}; {card_line()}")
    return 0


def stream_transform_forms(torch, libs: dict, name: str, a, tables) -> dict[str, object]:
    """The shipped K3-fs or K4-fs (``name``) on ``a``: its one launch
    through the wrapper; the same kernel (``libs[name + " stream"]``,
    built with PARENTT_FS_PHASES) as two launches of a queue of one phase
    each (``parentt_<name>_phases``) and each of those alone, after
    checking the two-launch form against the plain version; and its one
    launch built as a copy with no butterfly and as its passes with no
    TMA traffic (STREAM_FORMS): form -> a call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ntt as kern

    P, I = ctypes.c_void_p, ctypes.c_int
    t, rows, n = a.shape
    pointers, ints = kern._table_constants(tables, name, "--transform-variants")
    grid = kern.fs_stream_grid(tables, name)
    scratch = torch.empty(t * rows * (n + 1) + 1, dtype=torch.int32, device=a.device)
    out = torch.empty_like(a)

    def call(form, phases):
        launch = getattr(libs[f"{name}_{form}"], f"parentt_{name}_phases")
        launch.argtypes = [P] * 8 + [I] * 10 + [P]
        launch.restype = ctypes.c_int
        return lambda: _build.check(name, launch(
            _build.ptr(a), _build.ptr(scratch), _build.ptr(out), *pointers, t, rows, *ints,
            phases, grid, _build.stream_of(a)))

    two = lambda: (call("stream", 1)(), call("stream", 2)())
    two()
    torch.cuda.synchronize()
    fwd = name == "ntt_channels_fs"
    ref = kern.ntt_channels_fs_ref if fwd else kern.intt_channels_fs_ref
    exact(out, ref(a, tables), f"{name} as two launches at {tuple(a.shape)}")
    cuda = kern.ntt_channels_fs_cuda if fwd else kern.intt_channels_fs_cuda
    first, second = ("columns", "rows") if fwd else ("rows", "columns")
    return {"one launch": lambda: cuda(a, tables), "two launches": two,
            f"{first} launch alone": call("stream", 1),
            f"{second} launch alone": call("stream", 2),
            "one launch copy": call("stream_copy", 3),
            "one launch passes": call("stream_passes", 3)}


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
    sweep and the ten model shapes, and at each model shape a bf16-P
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
    """Phase 4 for K7: the entry point ``flash_attention`` at the ten model
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
    port's traffic model at one query block (q, the keys and values some
    query sees read once, the output written once); 4 * D FLOPs per
    (query, key) pair the masks leave visible, per query head."""
    import numpy as np

    from repro_torch.kernels import attention

    B, Sq, Skv, H, Hk, D = shape
    q_pos = kw.get("q_offset", 0) + np.arange(Sq, dtype=np.int64)
    window = kw.get("window")
    lo = np.maximum(0, q_pos - window + 1) if window else np.zeros_like(q_pos)
    hi = np.minimum(Skv, q_pos + 1) if kw.get("causal", True) else np.full_like(q_pos, Skv)
    pairs = int(np.maximum(hi - lo, 0).sum())
    seen = int(hi.max() - lo.min())  # the keys some query sees: a cache's tail is never read
    nbytes = attention.hbm_bytes_per_call(B, Sq, seen, H, Hk, D, blk_q=Sq, itemsize=itemsize)
    return nbytes, 4 * D * pairs * B * H


def library_call(torch, name, q, k, v):
    """(one PyTorch call computing K7's function on these inputs, what it
    is), set up before any timed window; the yardstick, never called by
    the port.  yi-6b, zamba2, dbrx and llama4 (no softcap):
    ``scaled_dot_product_attention`` over the keys some query sees (the
    masked tail of a cache left out), K and V expanded to H heads here
    where H > Hk; causal at a prefill from position 0, every seen key at a
    decode query.  gemma2: the
    compiled
    ``flex_attention`` with a tanh-softcap ``score_mod`` and a causal or
    sliding-window block mask, where this torch has it."""
    import importlib.util

    import torch.nn.functional as F

    shape, kw = ATTN_MODEL[name]
    qh = q.transpose(1, 2).contiguous()
    if not kw.get("softcap"):
        B, Sq, Skv, H, Hk = shape[:5]
        causal, offset = Sq > 1, kw.get("q_offset", 0)
        if kw.get("window") or not kw.get("causal", True) or (causal and offset):
            raise AssertionError(f"{name}: no scaled_dot_product_attention call computes it")
        seen = min(Skv, offset + Sq)
        kh, vh = (x[:, :seen].repeat_interleave(H // Hk, dim=2).transpose(1, 2).contiguous()
                  for x in (k, v))
        return (lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal).transpose(
            1, 2), f"scaled_dot_product_attention(is_causal={causal})"
                + (", K/V expanded to H heads" if H > Hk else ""))
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
    """Phase 5 for K7: kernel, plain-version and library times at the ten
    model shapes, beside the bound from these inputs; each library call is
    first held against the plain version.  Returns the ``kernels`` entry:
    the yi-6b numbers, and all ten under ``shapes``."""
    import torch

    from repro_torch.kernels import attention, cost

    for kind, lines in attention_build_report().items():
        for line in lines:
            log(f"[ptxas attention {kind}] {line}")
    shapes = []
    for name, ((q, k, v), want) in model.items():
        shape, kw = ATTN_MODEL[name]
        nbytes, flops = attention_work(shape, kw, q.element_size())
        bound_ms, bound_by = cost.bound(nbytes, flops, cost.BF16_FLOPS_PER_S)
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
            rate = f"{nbytes / ms / 1e9:.3f} TB/s of the {cost.HBM_BYTES_PER_S / 1e12:g} peak"
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


# phases 7-9: the wide and oracle widths, the batching engine at full
# width (the slice's main path) and the fault-injected soak
WIDTH_WIDE = dict(n=4096, t=4, v=45, rows=16)  # the paper's wide-word point
WIDTH_ORACLE = dict(n=1024, t=2, v=50, rows=2)  # past the wide fold window
WIDTH_ORACLE_ROWS = (0, 15)  # wide rows also held against the host oracle
SERVE_PRESETS = "4096:6:30,4096:4:45,65536:6:30,1024:2:50@2"
SERVE_REQUESTS = 99  # a run: 33 of each full-width preset, plus the two oracle requests
SERVE_SLOTS = 16  # 16 rows of 65536: 2^20 coefficients an operand, as phase 4c's
SERVE_DEADLINE_MS = 120_000.0  # the async run's deadline: loose enough to shed nothing
SERVE_ORACLE_SAMPLES = 3
SOAK_REQUESTS = 520


def drive_widths(card: str) -> None:
    """Phase 7 (``[widths]``): ``polymul`` on ``plan(4096, 4, 45)`` at 16
    rows on the card equal bit for bit to the same call on CPU tensors,
    and on two rows to the host oracle; ``plan(1024, 2, 50)`` (oracle
    width) exact against the host schoolbook on its 2 rows; each call's
    median wall of 10 synchronised calls and the CUDA launches of one
    wide call (``torch.profiler``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.core import bigint
    from repro_torch.core import polymul as host

    t0 = time.perf_counter()
    w, o = WIDTH_WIDE, WIDTH_ORACLE
    wide = repro_torch.plan(w["n"], w["t"], w["v"])
    cpu = repro_torch.plan(w["n"], w["t"], w["v"], device="cpu")
    if (wide.config.width, wide.config.backend, wide.device.type) != ("wide", "torch", "cuda"):
        raise AssertionError(f"plan(4096, 4, 45) resolved to {wide.config}")
    za, zb, _, _ = seeded_inputs(torch, np, wide, w["rows"], SEED + 45, wide.device)
    out, got = counted(torch, lambda: repro_torch.polymul(wide, za, zb))
    expect_launches(got, {}, "polymul plan(4096, 4, 45)")  # no kernel of the port's
    exact(out.cpu(), repro_torch.polymul(cpu, za.cpu(), zb.cpu()), "wide polymul card vs CPU")
    check_oracle(wide, za, zb, out, "wide polymul", WIDTH_ORACLE_ROWS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        repro_torch.polymul(wide, za, zb)
        torch.cuda.synchronize()
    cuda_launches = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    if not cuda_launches:
        raise AssertionError("torch.profiler saw no CUDA kernel of a wide polymul call")
    wide_ms = wall_ms(torch, lambda: repro_torch.polymul(wide, za, zb))
    log(f"[widths] plan(n=4096, t=4, v=45): width={wide.config.width}, "
        f"backend={wide.config.backend!r} (plain PyTorch on the card), q of "
        f"{wide.q.bit_length()} bits, S={wide.config.seg_count}, L={wide.config.L}; polymul on "
        f"{tuple(za.shape)} equal to the CPU run bit for bit, rows {WIDTH_ORACLE_ROWS} to the "
        f"host oracle; {wide_ms:.4f} ms per call (median of {E2E_RUNS}, host clock), "
        f"{w['rows'] * 1e3 / wide_ms:.0f} products/s; {cuda_launches} CUDA kernel launches a "
        f"call (torch.profiler); {card}")

    orc = repro_torch.plan(o["n"], o["t"], o["v"])
    if (orc.config.width, orc.config.backend) != ("oracle", "oracle"):
        raise AssertionError(f"plan(1024, 2, 50) resolved to {orc.config}")
    ya, yb, _, _ = seeded_inputs(torch, np, orc, o["rows"], SEED + 50, orc.device)
    out = repro_torch.polymul(orc, ya, yb)
    if out.device != orc.device:
        raise AssertionError(f"oracle polymul returned on {out.device}, plan on {orc.device}")
    for r in range(o["rows"]):
        a = bigint.limbs_to_ints(ya[r].cpu().numpy(), o["v"])
        b = bigint.limbs_to_ints(yb[r].cpu().numpy(), o["v"])
        if repro_torch.from_limbs(orc, out[r]) != host.schoolbook_negacyclic(a, b, orc.q):
            raise AssertionError(f"oracle polymul row {r} differs from the host schoolbook")
    orc_ms = wall_ms(torch, lambda: repro_torch.polymul(orc, ya, yb))
    log(f"[widths] plan(n=1024, t=2, v=50): width={orc.config.width}, q of "
        f"{orc.q.bit_length()} bits; polymul on {tuple(ya.shape)} (operands and result on "
        f"{orc.device}, arithmetic on the host) equal to the host schoolbook on every row; "
        f"{orc_ms:.4f} ms per call (median of {E2E_RUNS}, host clock); {card}")
    log(f"[widths] phase 7 took {time.perf_counter() - t0:.1f} s (host clock)")


def serve_launches(rec: dict) -> dict[str, int]:
    """The launches a serve_crypto run must make: per dispatch (warm-up
    included) of the (4096, 6, 30) bucket one K2, of the (65536, 6, 30)
    bucket two K5 (one an operand), one K1-fs and one K6; the wide and
    oracle buckets launch no kernel."""
    from repro_torch.serve.crypto_engine import _bucket_key_str

    want: dict[str, int] = {}
    for pl in rec["plans"]:
        cfg = pl.config
        key = _bucket_key_str(cfg)
        d = rec["buckets"].get(key, {}).get("dispatches", 0) + rec["warm_dispatches"].get(key, 0)
        per = {("cuda_fused_e2e", 4096): {"fused_e2e_polymul": 1},
               ("cuda_fused", 65536): {"decompose": 2, "fused_polymul_fs": 1, "compose": 1},
               }.get((cfg.backend, cfg.n), {})
        if cfg.width == "int64" and not per:
            raise AssertionError(f"serve: unexpected int64 bucket {cfg}")
        for name, k in per.items():
            want[name] = want.get(name, 0) + k * d
    return want


def serve_split(pl, slots: int, runs: int = 5) -> dict[str, float]:
    """Where one full dispatch of ``pl``'s bucket spends its time, each
    step as ``PolymulEngine.step`` and ``_execute_batch`` take it: filling
    the zero-padded host buffer from the requests' rows, its one
    host-to-device copy, ``execute``, and the device-to-host copy of the
    limbs; host-clock milliseconds, synchronised, median of ``runs``."""
    import numpy as np
    import torch

    import repro_torch

    cfg = pl.config
    rng = np.random.default_rng(SEED)
    rows = [torch.as_tensor(rng.integers(0, 1 << cfg.v, size=(cfg.n, cfg.seg_count)))
            for _ in range(2 * slots)]
    steps: dict[str, list[float]] = {"fill": [], "to device": [], "execute": [], "to host": []}

    def clock(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name].append((time.perf_counter() - t0) * 1e3)
        return out

    def fill():
        host = torch.zeros((2, slots, cfg.n, cfg.seg_count), dtype=torch.int64)
        for i in range(slots):
            host[0, i], host[1, i] = rows[2 * i], rows[2 * i + 1]
        return host

    for _ in range(runs + 1):  # the first run warms up
        host = clock("fill", fill)
        both = clock("to device", lambda: host.to(pl.device))
        out = clock("execute", lambda: repro_torch.execute(pl, both[0], both[1]))
        clock("to host", lambda: out.cpu())
    return {k: statistics.median(v[1:]) for k, v in steps.items()}


def drive_serve(card: str) -> dict[str, dict[str, int]]:
    """Phase 8 (``[serve]``, the slice's main path): ``serve_crypto`` on
    the card at SERVE_PRESETS with SERVE_SLOTS slots, a closed-loop run
    stepped inline and one on the background dispatcher with a loose
    deadline, each with every launch counter zeroed just before it and read
    just after.  Gates: every result equals ``polymul`` of its request
    alone on its plan, SERVE_ORACLE_SAMPLES sampled results equal the host
    oracle; served == submitted, no dispatch failure, breaker opening,
    shed or failure; K2's launches are the (4096, 6, 30) bucket's
    dispatches, K5's, K1-fs's and K6's what the (65536, 6, 30) bucket's
    dispatches make, nothing else launched; no int64 plan of the engine's
    cache on ``torch``.  Returns kernel -> path -> launches."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import bigint
    from repro_torch.core import polymul as host
    from repro_torch.launch import serve_crypto

    t0 = time.perf_counter()
    launches: dict[str, dict[str, int]] = {}
    rng = np.random.default_rng(SEED + 8)
    for path, kw in (("serve inline", {}),
                     ("serve async", {"async_dispatch": True, "deadline_ms": SERVE_DEADLINE_MS})):
        rec, got = counted(torch, lambda: serve_crypto.run(
            presets=SERVE_PRESETS, requests=SERVE_REQUESTS, slots=SERVE_SLOTS, seed=SEED, **kw))
        expect_launches(got, serve_launches(rec), path)
        for name, k in launched(got).items():
            launches.setdefault(name, {})[path] = k
        eng, futs = rec["engine"], rec["futures"]
        snap = eng.snapshot()
        bad = {k: snap[k] for k in ("dispatch_failures", "breaker_opened", "shed", "failed")
               if snap[k]}
        if snap["served"] != snap["submitted"] or snap["served"] != len(futs) or bad:
            raise AssertionError(f"{path}: served {snap['served']} of {snap['submitted']} "
                                 f"submitted ({len(futs)} requests), {bad}")
        torch_plans = [c for c in eng._plans if c.width == "int64" and c.backend == "torch"]
        if torch_plans:
            raise AssertionError(f"{path}: int64 plans on the plain datapath: {torch_plans}")
        for (_, pl, za, zb), f in zip(rec["traffic"], futs):
            alone = repro_torch.polymul(pl, torch.as_tensor(za, device=pl.device)[None],
                                        torch.as_tensor(zb, device=pl.device)[None])[0]
            exact(f.result(timeout=60.0), alone.cpu(), f"{path}: {pl.config} request")
        # the inline run's first request of each full-width preset
        sampled = [] if kw else [
            next(i for i, (_, pl, _, _) in enumerate(rec["traffic"]) if pl is want)
            for want in rec["plans"][:SERVE_ORACLE_SAMPLES]]
        for i in sampled:
            _, pl, za, zb = rec["traffic"][i]
            a, b = (bigint.limbs_to_ints(z, pl.config.v) for z in (za, zb))
            if repro_torch.from_limbs(pl, futs[i].result()) != host.oracle_multiply(a, b,
                                                                                    pl.params):
                raise AssertionError(f"{path}: request {i} ({pl.config}) differs from the "
                                     "host oracle")
        log(f"[serve] {path}: {len(futs)} requests at {SERVE_PRESETS}, {SERVE_SLOTS} slots, "
            f"served {snap['served']} in {rec['wall_s'] * 1e3:.1f} ms "
            f"({snap['served'] / rec['wall_s']:.1f} requests/s), p50 "
            f"{snap['latency_p50_ms']:.3f} ms, p99 {snap['latency_p99_ms']:.3f} ms; every result "
            f"equal to polymul alone, requests {sampled or 'none'} to the host oracle; launched "
            f"{launched(got)}; {card}")
        for key, b in rec["buckets"].items():
            log(f"[serve] {path} bucket {key}: {b['requests']} requests, "
                f"{b['requests_per_s']:.1f} requests/s, {b['products_per_s']:.1f} products/s "
                f"over its dispatches' {b['requests'] / b['products_per_s'] * 1e3:.1f} ms, p50 "
                f"{b['latency_p50_ms']:.3f} ms, p99 {b['latency_p99_ms']:.3f} ms, "
                f"{b['dispatches']} dispatches, {b['padded_slots']} padded slots; {card}")
    for pl in rec["plans"][:SERVE_ORACLE_SAMPLES]:
        split = serve_split(pl, SERVE_SLOTS)
        log(f"[serve] split of one dispatch of {pl.config.n}:{pl.config.t}:{pl.config.v} "
            f"({pl.config.backend}, {SERVE_SLOTS} rows): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            + f" (host clock, synchronised, median of 5); {card}")
    log(f"[serve] phase 8 took {time.perf_counter() - t0:.1f} s (host clock)")
    return launches


def drive_soak(card: str) -> dict[str, dict[str, int]]:
    """Phase 9 (``[soak]``): ``serve_soak.run_soak`` on the card at its
    CONFIGS, SOAK_REQUESTS requests, with a span log in a temporary
    directory and the launch counters zeroed just before and read just
    after; its ``failures`` must be empty (exactly-once resolution, the
    breaker's round trip through cuda_fused, injected corruption
    detected, clean results bit-exact, span conservation) and
    ``obs_report --check`` must pass on the log.  Returns kernel -> path
    -> launches."""
    import tempfile

    import torch

    from repro_torch.launch import obs_report, serve_soak

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log_path = str(Path(tmp) / "soak.jsonl")
        rec, got = counted(torch, lambda: serve_soak.run_soak(
            requests=SOAK_REQUESTS, seed=SEED, span_log_path=log_path))
        if rec["failures"]:
            raise AssertionError(f"soak failures: {rec['failures']}")
        if obs_report.main([log_path, "--check"]) != 0:
            raise AssertionError("obs_report --check failed on the soak's span log")
    # the e2e bucket's dispatches and spot checks (K2), its degraded
    # dispatches (K5, K1, K6); the wide bucket launches no kernel
    missing = [n for n in ("fused_e2e_polymul", "decompose", "fused_polymul", "compose")
               if not got[n]]
    stray = [n for n in ("attention", "fused_e2e_polymul_fs", "fused_polymul_fs",
                         "ntt_channels_fs", "intt_channels_fs") if got[n]]
    if missing or stray:
        raise AssertionError(f"soak launched {launched(got)}: none of {missing}, some of {stray}")
    log(f"[soak] {rec['requests']} requests at {rec['plans']}: served {rec['served']}, shed "
        f"{rec['shed']}, failed {rec['failed']}, retried {rec['retried']}, breaker opened "
        f"{rec['breaker_opened']} / recovered {rec['breaker_recovered']} (probes "
        f"{rec['probes']}), faults {rec['faults']}, p50 {rec['latency_p50_ms']:.3f} ms, p99 "
        f"{rec['latency_p99_ms']:.3f} ms, {rec['goodput_rps']} requests/s over "
        f"{rec['wall_s']} s; spans {rec['span_conservation']['by_status']}, obs_report --check "
        f"passed; launched {launched(got)}; {card}")
    log(f"[soak] phase 9 took {time.perf_counter() - t0:.1f} s (host clock)")
    return {name: {"soak": k} for name, k in launched(got).items()}


# phase 10: the tuner's sweep at the paper's point (its phase 6 batch) and
# past one CTA (the 2^20 coefficients of phase 4c), on the full grid, into a
# temporary table (never the committed one); then the stage profiler at
# (4096, 6, 30) on each kernel backend and at (65536, 6, 30) on cuda_fused
TUNE_WORKLOADS = ("n4096_t6_v30_b256", "n65536_t6_v30_b16")
TUNE_ITERS, TUNE_WARMUP = 20, 3
STAGE_POINTS = [(4096, backend) for backend in ("cuda", "cuda_fused", "cuda_fused_e2e")] + [
    (65536, "cuda_fused")]
STAGE_ROWS = {4096: 256, 65536: 16}
STAGE_ITERS, STAGE_WARMUP = 20, 3


def drive_tune(card: str) -> dict[str, dict[str, int]]:
    """Phase 10 (``[tune]``, ``[stages]``): ``repro_torch.tune.sweep`` on the
    card at TUNE_WORKLOADS (every backend; ``schedule`` on ``torch``) with
    the launch counters zeroed around each workload, into a table in a
    temporary directory: no candidate failed, every measured candidate's
    product equal to the default candidate's bit for bit, the kernels'
    launches exactly the model's (``kernels.cost.path_launches`` of each
    measured candidate's backend times its calls), then ``autotune check``
    on that table returns 0; and ``obs.stage_timings`` at STAGE_POINTS,
    its launches exactly its stage calls times the stage view's path plus
    its ``execute`` calls times the plan's path.  Returns kernel -> path ->
    launches."""
    import tempfile

    import torch

    import repro_torch
    from repro_torch import obs
    from repro_torch.kernels import cost
    from repro_torch.launch import autotune
    from repro_torch.tune import TuningTable
    from repro_torch.tune import sweep as sweep_mod

    t0 = time.perf_counter()
    paths: dict[str, dict[str, int]] = {}
    tab = TuningTable()
    for key in TUNE_WORKLOADS:
        wl = sweep_mod.Workload.from_key(key)
        rep, got = counted(torch, lambda: sweep_mod.sweep_workload(
            wl, iters=TUNE_ITERS, warmup=TUNE_WARMUP))
        cfg = repro_torch.plan(wl.n, wl.t, wl.v, device="cpu").config
        want: dict[str, int] = {}
        for rec in rep["candidates"]:
            if rec["status"] == "failed":
                raise AssertionError(f"[tune] {key}: {rec['name']} failed: {rec['reason']}")
            if rec["status"] == "measured":
                if not rec["equal_to_default"]:
                    raise AssertionError(f"[tune] {key}: {rec['name']} differs from the default")
                for name, k in cost.path_launches(rec["config"]["backend"], wl.n, wl.t,
                                                  cfg.seg_count, cfg.L).items():
                    want[name] = want.get(name, 0) + k * rec["calls"]
            log(f"[tune] {key} {rec['name']}: {rec['status']}"
                + (f", {rec['us_per_poly']:.3f} us/poly (median of {TUNE_ITERS} synchronised "
                   f"calls), model {rec['model_us']:.3f} us ({rec['hbm_bytes']} bytes, "
                   f"{rec['operations']} int ops, {rec['kernel_launches']} launches), build and "
                   f"load {rec['compile_s']:.3f} s, equal to the default"
                   if rec["status"] == "measured" else
                   f" ({rec.get('error', '')}, knob {rec.get('knob')})"
                   if rec["status"] == "pruned" else f" (same as {rec['same_as']})"))
        expect_launches(got, want, f"[tune] {key}")
        entry = rep["entry"]
        log(f"[tune] {key}: winner {rep['winner']} ({entry['winner']}) "
            f"{entry['winner_us']:.3f} us/poly, default {entry['default_us']:.3f}, "
            f"winner / default {entry['winner_us'] / entry['default_us']:.3f}; rank correlation "
            f"model vs stopwatch {entry['rank_correlation']}, flagged "
            f"{[f['name'] for f in rep['costcheck']['flagged']]}; launched {launched(got)} "
            f"(the model's, exactly); {entry['device_name']}, {entry['power_limit']}")
        for name, k in launched(got).items():
            paths.setdefault(name, {})[f"tune {key}"] = k
        tab.put(kind="gpu", **entry)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "TUNING.json")
        tab.save(path)
        if autotune.main(["check", "--table", path]) != 0:
            raise AssertionError("[tune] autotune check failed on the swept table")
    log(f"[tune] autotune check passed on the swept table; took "
        f"{time.perf_counter() - t0:.1f} s (host clock)")

    t1 = time.perf_counter()
    for n, backend in STAGE_POINTS:
        pl = repro_torch.plan(n, FS_T, FS_V, backend=backend)
        cfg = pl.config
        rec, got = counted(torch, lambda: obs.stage_timings(
            pl, batch=STAGE_ROWS[n], iters=STAGE_ITERS, warmup=STAGE_WARMUP,
            registry=obs.MetricsRegistry()))
        view = "cuda_fused" if backend == "cuda_fused_e2e" else backend
        shape = (n, FS_T, cfg.seg_count, cfg.L)
        want = {}
        for calls, path_of in ((rec["calls"]["stage"], cost.path_launches(view, *shape)),
                               (rec["calls"]["execute"], cost.path_launches(backend, *shape))):
            for name, k in path_of.items():
                want[name] = want.get(name, 0) + k * calls
        expect_launches(got, want, f"[stages] n={n} {backend}")
        for name, k in launched(got).items():
            paths.setdefault(name, {})[f"stages n={n} {backend}"] = k
        st = rec["stages"]
        log(f"[stages] n={n} t={FS_T} v={FS_V} backend={backend} batch={rec['batch']}: "
            + ", ".join(f"{s} {st[s]['seconds'] * 1e3:.4f} ms (share {st[s]['share_measured']:.3f},"
                        f" model {st[s]['share_predicted']:.3f}, drift {st[s]['drift']:.3f})"
                        for s in obs.STAGES)
            + f"; sum {rec['stage_sum_s'] * 1e3:.4f} ms, execute {rec['e2e_s'] * 1e3:.4f} ms "
            f"(fusion speedup {rec['fusion_speedup']:.3f}); median of {STAGE_ITERS} synchronised "
            f"calls; launched {launched(got)} (the model's, exactly); {card}")
    log(f"[stages] took {time.perf_counter() - t1:.1f} s; phase 10 "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    return paths


# phase 11: the sharded paths on an NCCL world of one rank, at full width:
# name -> (n, t, v, rows); the paper's point at phase 6's batch, K1-fs's
# ring at 2^20 coefficients an operand, the wide width
SHARD_POINTS = {"paper": (4096, 6, 30, 256), "fs": (65536, 6, 30, 16),
                "wide": (4096, 4, 45, 16)}
# each point's kernels in one polymul_sharded and one negacyclic_mul_sharded
# call on a world of one (the shard-local plan is the plan itself): K5 on
# each operand, the cascade once a call, K6 once
SHARD_LAUNCHES = {"paper": {"decompose": 2, "fused_polymul": 2, "compose": 1},
                  "fs": {"decompose": 2, "fused_polymul_fs": 2, "compose": 1}, "wide": {}}
SHARD_SLOTS, SHARD_REQUESTS = 16, 33
SHARD_WALL_RUNS = 10
DNTT_Q, DNTT_LOG_N, DNTT_SAMPLES = 998244353, 20, 8
DRYRUN_BATCH = 4096


def drive_shard(card: str) -> dict[str, dict[str, int]]:
    """Phase 11 (``[shard]``): ``make_local_mesh()``, an NCCL process group
    of world size 1 with its store in a temporary directory, destroyed at
    the end.  At SHARD_POINTS ``polymul_sharded`` and
    ``negacyclic_mul_sharded`` equal ``polymul`` and ``negacyclic_mul`` bit
    for bit (the wide point also its CPU run), their launches exactly
    SHARD_LAUNCHES, their collectives counted; the shard-local plan of
    channels [2, 4) launches K1 over two channels and equals their slice;
    ``PolymulEngine(mesh=)`` with SHARD_SLOTS slots serves SHARD_REQUESTS
    requests at (4096, 6, 30), each equal to ``polymul``, with no shed and
    no failure; ``negacyclic_mul_fourstep`` at 2^20 over the mesh's model
    axis equals the same code on the CPU, and DNTT_SAMPLES seeded
    coefficients equal their direct negacyclic sums, with one all-to-all a
    transform; then the dry run's two records at DRYRUN_BATCH rows and
    2^20.  The walls (median of SHARD_WALL_RUNS synchronised calls):
    sharded beside unsharded at each point, and the four-step product.
    Returns kernel -> path (``shard``, ``dryrun``) -> launches."""
    import tempfile

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import dntt
    from repro_torch.kernels import ntt as kern
    from repro_torch.launch import dryrun_crypto
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.serve.crypto_engine import (
        PolymulEngine,
        negacyclic_mul_sharded,
        polymul_sharded,
    )
    from repro_torch.sharding import ctx

    t0 = time.perf_counter()
    shard: dict[str, int] = {}
    with mesh_mod.make_local_mesh() as mesh:
        if torch.distributed.get_backend() != "nccl" or mesh.device.type != "cuda":
            raise AssertionError(f"[shard] the mesh runs {torch.distributed.get_backend()} on "
                                 f"{mesh.device}")
        log(f"[shard] mesh {mesh_mod.validate_mesh(mesh)} on {mesh.device}, NCCL, world size "
            f"{torch.distributed.get_world_size()}")
        for name, (n, t, v, rows) in SHARD_POINTS.items():
            pl = repro_torch.plan(n, t, v)
            za, zb, ra, rb = seeded_inputs(torch, np, pl, rows, SEED + 11, pl.device)
            with ctx.count_collectives() as coll:
                (got_p, got_n), got = counted(torch, lambda: (
                    polymul_sharded(pl, za, zb, mesh=mesh),
                    negacyclic_mul_sharded(pl, ra, rb, mesh=mesh)))
            expect_launches(got, SHARD_LAUNCHES[name], f"[shard] {name}")
            add_launches(shard, got)
            want_p = repro_torch.polymul(pl, za, zb)
            exact(got_p, want_p, f"[shard] {name} polymul_sharded vs polymul")
            exact(got_n, repro_torch.negacyclic_mul(pl, ra, rb),
                  f"[shard] {name} negacyclic_mul_sharded vs negacyclic_mul")
            if pl.config.width == "wide":
                cpu = repro_torch.plan(n, t, v, device="cpu")
                exact(got_p.cpu(), repro_torch.polymul(cpu, za.cpu(), zb.cpu()),
                      f"[shard] {name} polymul_sharded vs its CPU run")
            else:
                loc = repro_torch.api.shard_plan(pl, 2, 4)
                part, k = counted(torch, lambda: repro_torch.negacyclic_mul(loc, ra[2:4], rb[2:4]))
                exact(part, got_n[2:4], f"[shard] {name} shard-local plan of channels [2, 4)")
                cascade = "fused_polymul" if name == "paper" else "fused_polymul_fs"
                expect_launches(k, {cascade: 1}, f"[shard] {name} shard-local plan")
                add_launches(shard, k)
            # the unsharded walls: the plan's own polymul, and where it is K2
            # polymul on cuda_fused, the shard path's kernels (K5, K1, K6)
            same = pl if pl.config.backend != "cuda_fused_e2e" else \
                repro_torch.plan(n, t, v, backend="cuda_fused")
            walls = {}
            for _ in range(2):  # in turns: sharded, plain, same kernels; twice
                for key, fn in (("sharded", lambda: polymul_sharded(pl, za, zb, mesh=mesh)),
                                ("plain", lambda: repro_torch.polymul(pl, za, zb)),
                                ("same", lambda: repro_torch.polymul(same, za, zb))):
                    walls.setdefault(key, []).append(wall_ms(torch, fn, SHARD_WALL_RUNS))
            sh, pw, sw = (walls[k] for k in ("sharded", "plain", "same"))
            log(f"[shard] {name} plan({n}, {t}, {v}) {pl.config.backend}, {rows} rows, two "
                f"turns: polymul_sharded {sh[0]:.4f} / {sh[1]:.4f} ms, polymul {pw[0]:.4f} / "
                f"{pw[1]:.4f} ms, polymul on {same.config.backend} (the shard path's kernels) "
                f"{sw[0]:.4f} / {sw[1]:.4f} ms; sharded / unsharded {sh[0] / pw[0]:.4f} / "
                f"{sh[1] / pw[1]:.4f}, sharded / same kernels {sh[0] / sw[0]:.4f} / "
                f"{sh[1] / sw[1]:.4f} (median of {SHARD_WALL_RUNS} synchronised calls each); "
                f"both products equal to the unsharded ones bit for bit; launched "
                f"{launched(got)}; collectives of the two calls {coll.as_dict()}; {card}")

        eng = PolymulEngine(batch_slots=SHARD_SLOTS, mesh=mesh)
        pl = eng.plan(4096, 6, 30)
        za, zb, _, _ = seeded_inputs(torch, np, pl, SHARD_REQUESTS, SEED + 12, "cpu")

        def serve():
            futs = [eng.submit(pl, za[i], zb[i]) for i in range(SHARD_REQUESTS)]
            eng.run_until_idle()
            return futs

        futs, got = counted(torch, serve)
        add_launches(shard, got)
        snap = eng.snapshot()
        bad = {k: snap[k] for k in ("dispatch_failures", "shed", "failed", "rejected") if snap[k]}
        if snap["served"] != SHARD_REQUESTS or bad:
            raise AssertionError(f"[shard] engine served {snap['served']} of {SHARD_REQUESTS}: "
                                 f"{bad}")
        want = repro_torch.polymul(pl, za.to(pl.device), zb.to(pl.device)).cpu()
        for i, f in enumerate(futs):
            exact(f.result(timeout=60.0), want[i], f"[shard] engine request {i}")
        dispatches = -(-SHARD_REQUESTS // SHARD_SLOTS)
        expect_launches(got, {"decompose": 2 * dispatches, "fused_polymul": dispatches,
                              "compose": dispatches}, "[shard] engine")
        log(f"[shard] PolymulEngine(mesh=, batch_slots={SHARD_SLOTS}) at {pl.config.n}:"
            f"{pl.config.t}:{pl.config.v} ({pl.config.backend}): {snap['served']} of "
            f"{SHARD_REQUESTS} requests served in {snap['dispatches']} dispatches, each equal to "
            f"polymul, shed {snap['shed']}, failed {snap['failed']}; launched {launched(got)}")

        n = 1 << DNTT_LOG_N
        t1 = time.perf_counter()
        tabs = dntt.make_fourstep_tables(DNTT_Q, n, 1 << (DNTT_LOG_N // 2))
        tables_s = time.perf_counter() - t1
        rng = np.random.default_rng(SEED + 13)
        a_h, b_h = (rng.integers(0, DNTT_Q, size=n, dtype=np.int64) for _ in range(2))
        a, b = torch.as_tensor(a_h, device=mesh.device), torch.as_tensor(b_h, device=mesh.device)
        cons = dntt.make_shard_constrain(mesh)
        with ctx.count_collectives() as coll:
            out, got = counted(torch, lambda: dntt.negacyclic_mul_fourstep(a, b, tabs, cons))
        expect_launches(got, {}, "[shard] four-step product")  # plain PyTorch, no kernel
        if coll.calls != {"all_to_all": 3, "all_gather": 1}:
            raise AssertionError(f"[shard] four-step collectives {coll.calls}")
        host = dntt.negacyclic_mul_fourstep(torch.as_tensor(a_h), torch.as_tensor(b_h), tabs)
        exact(out.cpu(), host, "[shard] four-step product card vs CPU")
        ks = np.random.default_rng(SEED + 14).integers(0, n, size=DNTT_SAMPLES)
        got_k = out.cpu().numpy()[ks].tolist()
        if got_k != dryrun_crypto.negacyclic_coeffs(a_h, b_h, DNTT_Q, ks):
            raise AssertionError("[shard] four-step coefficients differ from their direct sums")
        sharded = wall_ms(torch, lambda: dntt.negacyclic_mul_fourstep(a, b, tabs, cons),
                          SHARD_WALL_RUNS)
        whole = wall_ms(torch, lambda: dntt.negacyclic_mul_fourstep(a, b, tabs),
                        SHARD_WALL_RUNS)
        log(f"[shard] negacyclic_mul_fourstep n=2^{DNTT_LOG_N} q={DNTT_Q} n1=2^"
            f"{DNTT_LOG_N // 2}: {sharded:.4f} ms over the mesh's model axis, {whole:.4f} ms "
            f"without a mesh (median of {SHARD_WALL_RUNS} synchronised calls); equal to its CPU "
            f"run, {DNTT_SAMPLES} coefficients equal to their direct sums; collectives "
            f"{coll.as_dict()} (one all-to-all a transform); tables built in {tables_s:.2f} s "
            f"(host clock); {card}")

        with tempfile.TemporaryDirectory() as tmp:
            recs, dry = counted(torch, lambda: (
                dryrun_crypto.run_he(mesh, DRYRUN_BATCH, Path(tmp)),
                dryrun_crypto.run_dntt(mesh, DNTT_LOG_N, Path(tmp))))
        for rec in recs:
            if rec["status"] != "ok":
                raise AssertionError(f"[shard] dry run {rec['arch']}: {rec.get('error')}")
            log(f"[shard] dryrun {rec['arch']} {rec['shape']}: wall {rec['wall_s'] * 1e3:.4f} ms "
                f"(one synchronised call after a warm-up), peak {rec['memory']['peak_bytes']} B, "
                f"hbm/device {rec['hbm_bytes']} B ({rec['hbm_basis']}), collectives "
                f"{rec['collectives']}; {card}")
    if torch.distributed.is_initialized():
        raise AssertionError("[shard] the process group outlived its mesh")
    for name in ("decompose", "fused_polymul", "fused_polymul_fs", "compose"):
        if not shard.get(name):
            raise AssertionError(f"[shard] {name} never launched on the shard path")
    log(f"[shard] phase 11 took {time.perf_counter() - t0:.1f} s (host clock); launched "
        f"{shard} on the shard path")
    out = {name: {"shard": k} for name, k in shard.items()}
    for name, k in launched(dry).items():
        out.setdefault(name, {})["dryrun"] = k
    return out


# --------------------------------------------------------------------------
# phase 12: LM serving on the card
# --------------------------------------------------------------------------

# the archs served at full width through the Engine, with their traffic:
# gemma2-2b (src/repro_torch/configs/gemma2_2b.py): 4 slots of seeded prompts
# of 4608-5120 tokens, past its 4096-token window, so that its local layers
# mask, 32 greedy tokens each, an 8192-entry cache; zamba2-2.7b
# (configs/zamba2_2p7b.py: 54 mamba2 layers and K7 at head dim 80 in the
# shared block after each 6): 4 slots of 1536-2048 tokens, 16 new, a
# 4096-entry cache.  check_len: the one prompt (B = 1) K7 and the plain
# attention both serve; bound: K7 against the plain attention (below)
LM_FULL = {
    "gemma2-2b": dict(slots=4, max_len=8192, new=32, lens=(4608, 5120), check_len=4608,
                      seed=SEED + 12, bound=0.25),
    "zamba2-2.7b": dict(slots=4, max_len=4096, new=16, lens=(1536, 2048), check_len=2048,
                        seed=SEED + 14, bound=1.5),
}
# every other arch without experts, reduced, through the Engine: 2 prompts
# of LM_REDUCED_LENS tokens, 4 new tokens
LM_REDUCED = ("yi-6b", "deepseek-7b", "mistral-large-123b", "qwen2-vl-7b", "mamba2-130m",
              "zamba2-2.7b", "seamless-m4t-medium")
LM_REDUCED_LENS, LM_REDUCED_NEW, LM_REDUCED_MAX_LEN = (20, 13), 4, 64
# K7 against the plain attention (the reference's arithmetic, bf16 P) on the
# card, same weights and inputs: max |logit difference| over the compared
# logits.  K7 keeps P in float32, which moves an attention output by up to
# 2^-9 of its terms; the bf16 roundings downstream (every product and sum
# of the layers after it, and the logits' own bf16 grid, 2^-6 at |logit| in
# [2, 4)) carry that on as whole steps.  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W: up to 0.139 over gemma2-2b's 26 layers (0.521 with the
# softcap corrupted), up to 0.055 on the reduced models (2-4 layers): the
# bounds leave about 2x.  The full-width archs' bounds are LM_FULL's:
# zamba2-2.7b's logits (largest |logit| 5.4) moved by up to 0.726 at B = 1
# and 0.477 over the serve (its dropped-columns control 4.195), its 54
# mamba2 layers carrying a bf16 step on further than gemma2's 26 layers:
# K7 against its own arithmetic in plain PyTorch (flash_attention_ref, P in
# float32) through the model moves them as far, 0.729.  So zamba2's bound
# catches only a gross fault, as its control is; the kernel check at
# D = 80 is phase 3's, every element within 1e-5 + one bf16 step.
LM_REDUCED_BOUND = 0.1
# controls each full-width bound must reject: gemma2's attention softcap
# corrupted; for zamba2 (no softcap) the attention over the first 64 of its
# 80 head-dim columns alone, what a K7 that dropped its second panel computes
# (phase 13's routing bounds take the same control at 64 of 128 columns)
LM_CONTROL_SOFTCAP = 5.0
LM_CONTROL_COLUMNS = 64


class DecodeRecorder:
    """While a run lasts, wraps ``models.model.decode_step`` (which the
    Engine calls): each call's CUDA events around it and a device flag of
    its logits' finiteness; with ``keep``, its tokens, keywords and logits
    (for a replay); ``last``, the last call's cache and batch."""

    def __init__(self, keep: bool = False):
        self.keep, self.events, self.finite, self.calls, self.last = keep, [], [], [], None

    def __enter__(self):
        from repro_torch.models import model

        self.model, self.orig = model, model.decode_step
        model.decode_step = self.call
        return self

    def __exit__(self, *exc):
        self.model.decode_step = self.orig

    def call(self, params, cfg, cache, batch, **kw):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits, new = self.orig(params, cfg, cache, batch, **kw)
        end.record()
        self.events.append((start, end))
        self.finite.append(torch.isfinite(logits).all())
        if self.keep:
            self.calls.append((batch["tokens"].clone(), kw, logits.clone()))
        self.last = (cache, batch)
        return logits, new


class AttentionRoute:
    """Routes the models' attention through ``route`` ("plain": the
    reference's arithmetic, on the card too) while it lasts: the seam
    ``models.layers.attention_route``.  ``by_row`` runs the plain attention
    one batch row at a time (the same arithmetic; its (Sq, Skv) scores of
    a full-width prefill would not fit beside the weights otherwise)."""

    def __init__(self, route: str, by_row: bool = False):
        self.route, self.by_row = route, by_row

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.orig, self.plain = layers, layers.attention_route, layers._attend_plain
        layers.attention_route = lambda device, head_dim, positions: self.route
        if self.by_row:
            def rows(q, k, v, *args):
                import torch

                return torch.cat([self.plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], *args)
                                  for i in range(q.shape[0])])

            layers._attend_plain = rows
        return self

    def __exit__(self, *exc):
        self.layers.attention_route = self.orig
        self.layers._attend_plain = self.plain


class DroppedColumns:
    """A faulty attention while it lasts (zamba2's and the MoE archs'
    control): K7 over the first LM_CONTROL_COLUMNS head-dim columns of q,
    k and v alone (q scaled so that the scores keep 1 / sqrt(D)), the
    other output columns zero."""

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.orig = layers, layers._attend
        layers._attend = self.attend
        return self

    def __exit__(self, *exc):
        self.layers._attend = self.orig

    @staticmethod
    def attend(q, k, v, cfg, positions, window, causal):
        import math

        import torch.nn.functional as F

        from repro_torch.kernels import attention

        c, D = LM_CONTROL_COLUMNS, q.shape[-1]
        qs = (q[..., :c].float() * math.sqrt(c / D)).to(q.dtype)
        out = attention.flash_attention(qs, k[..., :c], v[..., :c], causal=causal,
                                        window=window or 0, softcap=cfg.attn_softcap,
                                        q_offset=positions)
        return F.pad(out, (0, D - c))


class K7Arithmetic:
    """While it lasts, the models' attention on the card runs
    ``flash_attention_ref`` (K7's plain version: P in float32) where it
    would launch K7."""

    def __enter__(self):
        from repro_torch.kernels import attention

        self.attention, self.orig = attention, attention.flash_attention
        attention.flash_attention = attention.flash_attention_ref
        return self

    def __exit__(self, *exc):
        self.attention.flash_attention = self.orig


class MoeSlots:
    """While it lasts, records the slot tensor of every ``moe_apply`` call
    (``sharding.ctx.moe_scatter``'s first argument), on the device, in
    order: one a MoE layer of each ``decode_step``."""

    def __enter__(self):
        from repro_torch.sharding import ctx

        self.ctx, self.orig, self.slots = ctx, ctx.moe_scatter, []

        def rec(slot, xk, n_rows):
            self.slots.append(slot)
            return self.orig(slot, xk, n_rows)

        ctx.moe_scatter = rec
        return self

    def __exit__(self, *exc):
        self.ctx.moe_scatter = self.orig


def k7_launches_a_step(cfg) -> int:
    """K7 launches of one decode_step of ``cfg``: one per attention layer
    call (self and cross), none for mamba2."""
    if cfg.family == "hybrid":  # the shared block after each group of mamba layers
        return cfg.n_layers // cfg.shared_attn_every
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "encdec": 2 * cfg.n_layers}[cfg.family]


def expect_k7(got: dict, variants: dict, want: int, want_variants: dict | None, what: str):
    expect_launches(got, {"attention": want}, what)
    if want_variants is not None and variants != {n: want_variants.get(n, 0) for n in variants}:
        raise AssertionError(f"{what}: K7 variants {variants}, expected {want_variants}")


def logit_gap(torch, got, want, what: str) -> tuple[float, float]:
    """(max |got - want|, share of positions whose greedy token agrees);
    raises on a misshapen or non-finite ``got``."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {tuple(got.shape)} against {tuple(want.shape)}, or "
                             "non-finite")
    gap = (got - want).abs().max().item() if got.numel() else 0.0
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item() if got.numel() else 1.0
    return gap, agree


EXPERT_RANGE = "moe expert products"


def profile_step(card: str, tag: str, cfg, params, cache, batch) -> None:
    """One decode step (the serve's last, again on its cache) under
    ``torch.profiler``: its device time over its kernels (their self time)
    and K7's share; for a MoE config also the expert products' share (the
    einsums of ``moe_apply``, each inside a ``record_function`` range
    while the profile lasts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import model as M

    M.decode_step(params, cfg, cache, batch)  # the last step again: same inputs, same writes
    torch.cuda.synchronize()
    einsum = torch.einsum

    def named(*args, **kw):
        with record_function(EXPERT_RANGE):
            return einsum(*args, **kw)

    if cfg.n_experts:
        torch.einsum = named
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            M.decode_step(params, cfg, cache, batch)
            torch.cuda.synchronize()
    finally:
        torch.einsum = einsum
    total = k7 = experts = 0.0
    kernels = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if e.key == EXPERT_RANGE:  # the range's span on the device, or its kernels' time
            experts = max(experts, us or 0, getattr(e, "device_time_total", 0) or 0)
            continue
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or not us:
            continue
        total += us
        kernels += e.count
        if "decode_kernel<" in e.key or "prefill_kernel<" in e.key:
            k7 += us
    if not total:
        raise AssertionError("[lm] torch.profiler's trace holds no device time")
    note = (f", expert products {experts / 1e3:.3f} ms, share {experts / total:.3f}"
            if cfg.n_experts else "")
    log(f"[{tag}] {cfg.name} one decode step ({batch['tokens'].shape[0]} slots at position "
        f"{cache['pos']}): device time {total / 1e3:.3f} ms over {kernels} kernels "
        f"(torch.profiler, their self time), K7 {k7 / 1e3:.3f} ms, share {k7 / total:.3f}"
        f"{note}; {card}")


def seeded_prompts(cfg, spec: dict):
    """(lengths, prompts): spec's slots of prompts of seeded lengths in
    spec's range, seeded tokens of ``cfg``'s vocabulary."""
    import numpy as np

    rng = np.random.default_rng(spec["seed"])
    lens = rng.integers(spec["lens"][0], spec["lens"][1] + 1, size=spec["slots"])
    return lens, [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]


def serve_full(card: str, tag: str, cfg, params, spec: dict, slots=None):
    """``cfg`` at full width through ``Engine`` (spec's slots, cache, seeded
    prompts and new tokens): a warm-up run, then the measured run with
    every launch counter zeroed just before and read just after: exactly
    k7_launches_a_step x (1 + new) K7 launches (the first step's
    ``wgmma``, the rest ``decode``) and no other kernel's, ``new``
    finite-logit tokens a request.  Prints the prefill's and the steps'
    CUDA-event times, tokens/s, the peak memory and one decode step's
    device split (``profile_step``).  ``slots`` (a list) receives the
    measured run's MoE slot tensors.  Returns (launches, the run's
    ``decode_step`` calls as ``DecodeRecorder(keep=True)`` keeps them)."""
    import torch

    from repro_torch.kernels import attention
    from repro_torch.models import model as M
    from repro_torch.serve import Engine

    lens, prompts = seeded_prompts(cfg, spec)
    eng = Engine(cfg, params, batch_slots=spec["slots"], max_len=spec["max_len"])
    eng.generate(prompts, max_new=2)  # warm-up: cuBLAS's and K7's first calls at these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = attention.flash_attention_cuda.variants
    counts.update(dict.fromkeys(counts, 0))
    new, steps = spec["new"], 1 + spec["new"]
    t0 = time.perf_counter()
    with DecodeRecorder(keep=True) as rec, MoeSlots() as moe:
        outs, got = counted(torch, lambda: eng.generate(prompts, max_new=new))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if slots is not None:
        slots.extend(moe.slots)
    per_step = k7_launches_a_step(cfg)
    expect_k7(got, dict(counts), per_step * steps, {"wgmma": per_step, "decode": per_step * new},
              f"[{tag}] {cfg.name} serve")
    if [len(o) for o in outs] != [new] * spec["slots"] or not all(bool(f) for f in rec.finite):
        raise AssertionError(f"[{tag}] {cfg.name}: tokens {[len(o) for o in outs]}, finite "
                             f"logits {[bool(f) for f in rec.finite]}")
    if len(rec.events) != steps:
        raise AssertionError(f"[{tag}] {cfg.name}: {len(rec.events)} decode_step calls, not "
                             f"{steps}")
    prefill_ms = rec.events[0][0].elapsed_time(rec.events[0][1])
    step_ms = [s.elapsed_time(e) for s, e in rec.events[1:]]
    span_ms = rec.events[1][0].elapsed_time(rec.events[-1][1])
    log(f"[{tag}] {cfg.name} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, vocab {cfg.vocab}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts else "")
        + f"): Engine({spec['slots']} slots, max_len {spec['max_len']}), prompts of "
        f"{lens.tolist()} tokens, {new} new each: launches {launched(got)}, K7 variants "
        f"{dict(counts)}; every logit finite, {new} tokens a request; {card}")
    log(f"[{tag}] {cfg.name} times: prefill {prefill_ms:.3f} ms (CUDA events, {spec['slots']} x "
        f"{max(lens)} tokens left-padded), decode {statistics.median(step_ms):.3f} ms a step "
        f"(median of {new}; min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
        f"{spec['slots'] * new / span_ms * 1e3:.1f} tokens/s over the {new} steps "
        f"({span_ms:.3f} ms, CUDA events), generate wall {wall_s * 1e3:.1f} ms (host clock), "
        f"measured after the earlier phases in this process; peak memory {peak} B "
        f"(torch.cuda.max_memory_allocated; params {M.param_count(params)} values); {card}")
    cache, batch = rec.last
    profile_step(card, tag, cfg, params, cache, batch)
    del cache, batch, eng
    rec.last = None
    return got, rec.calls


def replay(cfg, params, spec: dict, calls, attention) -> tuple[list, int]:
    """The serve's ``decode_step`` calls (``calls``, from
    ``DecodeRecorder(keep=True)``) again on a fresh cache while
    ``attention`` (a context that reroutes the models' attention) lasts,
    fed the same tokens: the left-padded prefill over the whole cache and
    every decode step at the key splits the serve's K7 launches took.
    Raises on a non-finite logit.  Returns ([(logits, MoE slot tensors)
    of each call], the peak memory since the serve began)."""
    import torch

    from repro_torch.models import model as M

    torch.cuda.empty_cache()
    cache = M.init_cache(cfg, spec["slots"], spec["max_len"], device="cuda")
    run = []
    with attention:
        for step, (tokens, kw, _) in enumerate(calls):
            with MoeSlots() as moe:
                logits, cache = M.decode_step(params, cfg, cache, {"tokens": tokens}, **kw)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{cfg.name} replay, call {step}: non-finite logits")
            run.append((logits, moe.slots))
    peak = torch.cuda.max_memory_allocated()
    del cache
    torch.cuda.empty_cache()
    return run, peak


def replay_logits(card: str, tag: str, cfg, spec: dict, calls, run, peak: int) -> None:
    """The serve's calls replayed with the plain attention (``run``, from
    ``replay``): every call's logits within spec's bound of the serve's."""
    import torch

    gaps, agree, scale = [], [], 0.0
    for step, ((_, _, k7_logits), (plain, _)) in enumerate(zip(calls, run)):
        gap, share = logit_gap(torch, k7_logits, plain, f"[{tag}] serve replay, call {step}")
        scale = max(scale, plain.abs().max().item())
        gaps.append(gap)
        agree.append(share)
    log(f"[{tag}] {cfg.name} serve replayed with the plain attention on the card, the serve's "
        f"{len(calls)} decode_step calls fed the same tokens ({spec['slots']} slots "
        f"left-padded, cache {spec['max_len']}): max |logit difference| prefill {gaps[0]:.5f}, "
        f"decode steps {max(gaps[1:]):.5f} (median {statistics.median(gaps[1:]):.5f}); greedy "
        f"tokens agree at {sum(agree) / len(agree):.5f} of the slot-steps; largest |logit| "
        f"{scale:.3f}; bound {spec['bound']}; peak memory {peak} B since the serve began; {card}")
    if len(calls) != 1 + spec["new"] or max(gaps) > spec["bound"]:
        raise AssertionError(f"[{tag}] {cfg.name} serve: {len(calls)} calls, K7 and the plain "
                             f"attention differ by {max(gaps)}, past {spec['bound']}")


def lm_full_check(card: str, cfg, params, spec: dict) -> None:
    """One ``check_len``-token prompt (B = 1): ``forward``'s logits at
    every position with K7 against the same model with the plain
    attention on the card, and one ``decode_step`` after a K7 prefill
    through the cache likewise; max |difference| within spec's bound, with
    the share of positions whose greedy token agrees; a control (gemma2:
    the softcap corrupted; zamba2: ``DroppedColumns``) must fall outside
    the bound."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import model as M

    rng = np.random.default_rng(SEED + 13)
    n, bound = spec["check_len"], spec["bound"]
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, n)), device="cuda")
    batch = {"tokens": tokens}
    k7 = M.forward(params, cfg, batch)[..., :cfg.vocab]
    with AttentionRoute("plain"):
        plain = M.forward(params, cfg, batch)[..., :cfg.vocab]
    gap, agree = logit_gap(torch, k7, plain, f"[lm] {cfg.name} forward")
    scale = plain.abs().max().item()
    with K7Arithmetic():
        own, _ = logit_gap(torch, M.forward(params, cfg, batch)[..., :cfg.vocab], k7,
                           f"[lm] {cfg.name} K7's arithmetic")
    del k7
    if cfg.attn_softcap:
        bad, what = dataclasses.replace(cfg, attn_softcap=LM_CONTROL_SOFTCAP), (
            f"attention softcap {LM_CONTROL_SOFTCAP} for {cfg.attn_softcap}")
        ctl = contextlib.nullcontext()
    else:
        bad, what = cfg, f"K7 over the first {LM_CONTROL_COLUMNS} of {cfg.head_dim_} columns"
        ctl = DroppedColumns()
    with ctl:
        control, _ = logit_gap(torch, M.forward(params, bad, batch)[..., :cfg.vocab], plain,
                               f"[lm] {cfg.name} control")
    del plain
    cache = M.init_cache(cfg, 1, spec["max_len"], device="cuda")
    last, cache = M.decode_step(params, cfg, cache, batch, last_only=True)
    nxt = {"tokens": last[:, -1].argmax(-1)[:, None]}
    d_k7, _ = M.decode_step(params, cfg, cache, nxt)
    with AttentionRoute("plain"):
        d_plain, _ = M.decode_step(params, cfg, cache, nxt)
    d_gap, d_agree = logit_gap(torch, d_k7, d_plain, f"[lm] {cfg.name} decode_step")
    log(f"[lm] {cfg.name} K7 against the plain attention on the card, one prompt of {n} "
        f"tokens: forward max |logit difference| {gap:.5f} over {n} x {cfg.vocab} logits "
        f"(largest |logit| {scale:.3f}; K7 against its own arithmetic in plain PyTorch, "
        f"flash_attention_ref with P in float32, {own:.5f}), "
        f"greedy tokens agree at {agree:.5f} of positions; decode_step after a K7 prefill "
        f"{d_gap:.5f} (token {'agrees' if d_agree == 1 else 'differs'}); bound {bound}; "
        f"control ({what}) {control:.5f}; {card}")
    if max(gap, d_gap) > bound:
        raise AssertionError(f"[lm] {cfg.name}: K7 and the plain attention differ by "
                             f"{max(gap, d_gap)}, past {bound}")
    if control <= bound:
        raise AssertionError(f"[lm] {cfg.name}: the control ({control}) lies inside {bound}")


def lm_reduced(card: str, arch: str) -> dict[str, int]:
    """One reduced arch through ``Engine`` on the card (2 prompts,
    LM_REDUCED_NEW new tokens): K7's launches exactly one per attention
    call and no other kernel's; then the plain attention fed the same
    tokens step by step, every step's logits within LM_REDUCED_BOUND.
    qwen2-vl also runs ``forward`` over frontend embeddings, K7 against
    the plain attention."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import attention
    from repro_torch.models import model as M
    from repro_torch.serve import Engine

    cfg = registry.get(arch).reduced()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(gen, cfg)
    rng = np.random.default_rng(SEED + len(arch))
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in LM_REDUCED_LENS]
    eng = Engine(cfg, params, batch_slots=len(prompts), max_len=LM_REDUCED_MAX_LEN)
    with DecodeRecorder(keep=True) as rec:
        outs, got = counted(torch, lambda: eng.generate(prompts, max_new=LM_REDUCED_NEW))
    want = k7_launches_a_step(cfg) * (1 + LM_REDUCED_NEW)
    expect_k7(got, {}, want, None, f"[lm] reduced {arch}")
    if [len(o) for o in outs] != [LM_REDUCED_NEW] * len(prompts):
        raise AssertionError(f"[lm] reduced {arch}: tokens {outs}")
    cache = M.init_cache(cfg, len(prompts), LM_REDUCED_MAX_LEN, device="cuda")
    gap = 0.0
    with AttentionRoute("plain"):
        for tokens, kw, k7_logits in rec.calls:
            plain, cache = M.decode_step(params, cfg, cache, {"tokens": tokens}, **kw)
            gap = max(gap, logit_gap(torch, k7_logits, plain, f"[lm] reduced {arch}")[0])
    note = ""
    if cfg.frontend:  # forward over the frontend stub's embeddings: K7 against plain
        emb = torch.randn((2, 24, cfg.d_model), generator=gen, device="cuda")
        if cfg.family == "encdec":  # the encoder (non-causal K7) over them, then the decoder
            batch, calls = {"enc_embeddings": emb, "tokens": torch.as_tensor(
                rng.integers(0, cfg.vocab, (2, 9)), device="cuda")}, 3 * cfg.n_layers
        else:
            batch, calls = {"embeddings": emb}, cfg.n_layers
        fwd, f_got = counted(torch, lambda: M.forward(params, cfg, batch))
        expect_k7(f_got, {}, calls, None, f"[lm] reduced {arch} forward over embeddings")
        got["attention"] += f_got["attention"]
        with AttentionRoute("plain"):
            f_gap = logit_gap(torch, fwd, M.forward(params, cfg, batch), f"[lm] {arch} forward")[0]
        gap = max(gap, f_gap)
        note = (f"; forward over (2, 24, {cfg.d_model}) frontend embeddings ({f_got['attention']} "
                f"K7 launches) {f_gap:.5f}")
    log(f"[lm] reduced {arch} ({cfg.family}, {cfg.n_layers} layers, head dim {cfg.head_dim_}): "
        f"Engine({len(prompts)} slots), prompts of {list(LM_REDUCED_LENS)} tokens, "
        f"{LM_REDUCED_NEW} new: launches {launched(got)}; K7 against the plain attention fed the "
        f"same tokens, max |logit difference| {gap:.5f}{note} (bound {LM_REDUCED_BOUND}); {card}")
    if gap > LM_REDUCED_BOUND:
        raise AssertionError(f"[lm] reduced {arch}: {gap} past {LM_REDUCED_BOUND}")
    return got


def drive_lm(card: str) -> dict[str, dict[str, int]]:
    """Phase 12 (``[lm]``): the LM serving path on the card.  Each arch of
    LM_FULL at full width from a seeded generator through ``Engine``
    (``serve_full``), its serve replayed with the plain attention
    (``replay``, ``replay_logits``) and one prompt held against it with a
    control (``lm_full_check``); every other arch without experts reduced
    (``lm_reduced``).  Returns K7's launches per path."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    paths = {}
    for arch, spec in LM_FULL.items():
        t1 = time.perf_counter()
        cfg = registry.get(arch)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = M.init_params(gen, cfg)
        torch.cuda.synchronize()
        log(f"[lm] {arch}: {M.param_count(params)} parameters from a seeded generator on the "
            f"card in {time.perf_counter() - t1:.1f} s (host clock), weights stored bf16; {card}")
        got, calls = serve_full(card, "lm", cfg, params, spec)
        paths[f"lm {arch}"] = got["attention"]
        run, peak = replay(cfg, params, spec, calls, AttentionRoute("plain", by_row=True))
        replay_logits(card, "lm", cfg, spec, calls, run, peak)
        del calls, run
        lm_full_check(card, cfg, params, spec)
        del params
        torch.cuda.empty_cache()
    for arch in LM_REDUCED:
        paths[f"lm reduced {arch}"] = lm_reduced(card, arch)["attention"]
    log(f"[lm] phase 12 took {time.perf_counter() - t0:.1f} s (host clock); K7 launches {paths}; "
        f"{card}")
    return {"attention": paths}


# --------------------------------------------------------------------------
# phase 13: the MoE archs at full width on the card
# --------------------------------------------------------------------------

# dbrx-132b (src/repro_torch/configs/dbrx_132b.py) and llama4-maverick-400b-a17b
# (configs/llama4_maverick_400b_a17b.py) at their published widths, depth cut
# to what one 80 GB card holds beside the serve: dbrx 8 of 40 layers (6.34 GB
# of experts a layer), llama4 one super-block, 2 of 48 layers (32.2 GB of 128
# experts); each through Engine with 4 slots of seeded prompts of 1536-2048
# tokens, 16 new each, a 4096-entry cache; one model's weights freed before
# the other's are made.  K7 itself is held at these shapes in phase 3
# (ATTN_MODEL's dbrx_* and llama4_*); what follows is the model around it.
# K7 against the plain attention fed the same tokens: routing is
# discontinuous, so near-tied tokens can pick other experts when K7's
# float32 P moves their inputs by a bf16 step; a token that picks another
# expert moves by a whole expert's output, which moves the later layers'
# routing of it and, through their attention, of the tokens after it, and
# a capacity-bound expert then keeps other tokens.  flip_bound bounds the
# share of the prefill's routing decisions (each assignment's expert, or
# dropped) that differ.  Its control is a faulty attention, DroppedColumns:
# K7 over the first LM_CONTROL_COLUMNS of the 128 head-dim columns, what a
# K7 that dropped its second 64-column panel computes; it must exceed the
# bound.  The bound catches an attention that is grossly wrong, not one
# that is a little off: at dbrx a bf16 step already flips a tenth of the
# decisions.  Measured on an NVIDIA H100 80GB HBM3 at 700 W: dbrx 0.1056,
# llama4 0.0072; the bounds leave about 2x
MOE_FULL = {"dbrx-132b": dict(n_layers=8, seed=SEED + 15, flip_bound=0.2),
            "llama4-maverick-400b-a17b": dict(n_layers=2, seed=SEED + 16, flip_bound=0.015)}
MOE_SPEC = dict(slots=4, max_len=4096, new=16, lens=(1536, 2048))
# the MoE layer alone, card against CPU: its input in forward over the
# serve's longest prompt (the whole row, S = 1995 and 1971: C = 624 and 20
# slots an expert), the same weights: the slots equal, the output within
# MOE_LAYER_TOL of the CPU's largest |value| (the CPU tests' layer bound,
# 2e-2, taken of the output's scale)
MOE_LAYER_TOL = 2e-2


def moe_decisions(cfg, slot):
    """(B, S, K) expert of each assignment of one ``moe_apply`` call (its
    slot tensor, (B, S * K)), -1 where it was dropped."""
    import torch

    from repro_torch.models import layers as L

    S = slot.shape[1] // cfg.top_k
    E, C = cfg.n_experts, L.moe_capacity(S, cfg)
    return torch.where(slot < E * C, slot // C, -1).view(slot.shape[0], S, cfg.top_k)


def routing_flips(cfg, k7_slots, run) -> tuple[list[int], int, int, int]:
    """The routing decisions of a replay (``run``, from ``replay``) that
    differ from the serve's (``k7_slots``: one slot tensor a MoE layer and
    call, in order): (per MoE layer of the prefill, over the decode steps,
    the decode steps' decisions, the slots whose routing parted)."""
    n_moe = len(run[0][1])
    layers, flips, total, parted = [], 0, 0, 0
    for step, (_, slots) in enumerate(run):
        for a, b in zip(k7_slots[n_moe * step:n_moe * (step + 1)], slots):
            differ = moe_decisions(cfg, a) != moe_decisions(cfg, b)
            parted = parted | differ.flatten(1).any(1)
            if step:
                flips += int(differ.sum())
                total += differ.numel()
            else:
                layers.append(int(differ.sum()))
    return layers, flips, total, int(parted.sum())


def moe_block(params, cfg):
    """The first MoE block's ffn of a transformer's params."""
    first = params["layers"][0]
    return (first["moe"] if "moe" in first else first)["ffn"]


class _MoeInput(Exception):
    """Carries the input of the first ``moe_apply`` call out of ``forward``."""


def first_moe_input(params, cfg, tokens):
    """The input of the first MoE layer of ``forward`` over ``tokens`` on
    the card (K7 its attention); the forward stops there."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    def stop(p, x, c):
        raise _MoeInput(x)

    orig, L.moe_apply = L.moe_apply, stop
    try:
        M.forward(params, cfg, {"tokens": tokens})
    except _MoeInput as got:
        return got.args[0]
    finally:
        L.moe_apply = orig
    raise AssertionError(f"{cfg.name}: forward ran no MoE layer")


def moe_layer_check(card: str, cfg, params, tokens) -> None:
    """The MoE layer alone: ``moe_apply`` on its input in ``forward`` over
    ``tokens`` (one row) on the card, and on the CPU with the same input
    and weights copied there: the slot tensors equal and the outputs
    within MOE_LAYER_TOL."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    x = first_moe_input(params, cfg, tokens)
    ffn = moe_block(params, cfg)
    with MoeSlots() as card_slots:
        got = L.moe_apply(ffn, x, cfg).float().cpu()
    t0 = time.perf_counter()
    cpu_ffn = M.tree_map(lambda t: t.cpu(), ffn)
    t1 = time.perf_counter()
    with MoeSlots() as cpu_slots:
        want = L.moe_apply(cpu_ffn, x.cpu(), cfg).float()
    t2 = time.perf_counter()
    del cpu_ffn
    slot = cpu_slots.slots[0]
    same = torch.equal(card_slots.slots[0].cpu(), slot)
    S, E = x.shape[1], cfg.n_experts
    C = L.moe_capacity(S, cfg)
    dropped = int((slot == E * C).sum())
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    log(f"[moe] {cfg.name} the MoE layer alone, card against CPU, its input in forward over the "
        f"serve's longest prompt ({S} tokens, {x.dtype}; C = {C}, {dropped} of {slot.numel()} "
        f"assignments dropped) and the same weights: slots {'equal' if same else 'DIFFER'}, max "
        f"|output difference| {err:.5f} of a largest |output| {scale:.3f} ({err / scale:.6f}, "
        f"bound {MOE_LAYER_TOL}); the CPU's copy {t1 - t0:.1f} s and call {t2 - t1:.1f} s "
        f"(host clock, {torch.get_num_threads()} threads); {card}")
    if not same or not torch.isfinite(got).all() or err > MOE_LAYER_TOL * scale:
        raise AssertionError(f"[moe] {cfg.name}: the MoE layer on the card differs from the CPU's")


def drive_moe(card: str) -> dict[str, dict[str, int]]:
    """Phase 13 (``[moe]``): each arch of MOE_FULL at its published widths,
    depth cut, weights from a seeded generator on the card, through
    ``Engine`` (``serve_full``: exactly n_layers x (1 + 16) K7 launches,
    n_layers ``wgmma`` and the rest ``decode``, and no other kernel's;
    prefill and decode times, tokens/s, peak memory, a step's device time
    with K7's and the expert products' shares); the share of the prefill's
    assignments dropped; the serve replayed with the plain attention
    (``replay``, ``routing_flips``: the routing decisions that differ,
    within the arch's flip_bound) and its prefill with ``DroppedColumns``
    (outside it); the MoE layer alone, card against CPU
    (``moe_layer_check``).  Returns K7's launches per path."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    paths = {}
    for arch, cut in MOE_FULL.items():
        t1 = time.perf_counter()
        full = registry.get(arch)
        cfg = dataclasses.replace(full, n_layers=cut["n_layers"])
        spec = dict(MOE_SPEC, seed=cut["seed"])
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = M.init_params(gen, cfg)
        torch.cuda.synchronize()
        log(f"[moe] {arch}: published widths, depth cut from {full.n_layers} to {cfg.n_layers} "
            f"layers (one card's memory); {M.param_count(params)} parameters from a seeded "
            f"generator on the card in {time.perf_counter() - t1:.1f} s (host clock), experts "
            f"stored bf16, {torch.cuda.memory_allocated()} B allocated; {card}")
        slots = []
        got, calls = serve_full(card, "moe", cfg, params, spec, slots=slots)
        paths[f"lm moe {arch}"] = got["attention"]
        n_moe = len(slots) // (1 + spec["new"])
        S = calls[0][0].shape[1]
        C = L.moe_capacity(S, cfg)
        dropped = sum(int((s == cfg.n_experts * C).sum()) for s in slots[:n_moe])
        total = sum(s.numel() for s in slots[:n_moe])
        log(f"[moe] {arch} prefill ({spec['slots']} x {S} tokens, left-padded, C = {C} slots an "
            f"expert and row): {dropped} of {total} assignments dropped ({dropped / total:.5f}) "
            f"over its {n_moe} MoE layers; {card}")
        run, peak = replay(cfg, params, spec, calls, AttentionRoute("plain", by_row=True))
        layers, d_flips, d_total, parted = routing_flips(cfg, slots, run)
        del run
        share = sum(layers) / total
        log(f"[moe] {arch} serve replayed with the plain attention on the card, the serve's "
            f"{len(calls)} decode_step calls fed the same tokens ({spec['slots']} slots "
            f"left-padded, cache {spec['max_len']}): routing decisions (each assignment's expert, "
            f"or dropped) that differ from K7's run, prefill per MoE layer {layers} of "
            f"{total // n_moe} each ({share:.6f} over the prefill), decode steps {d_flips} of "
            f"{d_total}; slots whose routing parted {parted} of {spec['slots']}; every logit "
            f"finite; peak memory {peak} B since the serve began; {card}")
        run, _ = replay(cfg, params, spec, calls[:1], DroppedColumns())
        control = sum(routing_flips(cfg, slots, run)[0]) / total
        del run
        bound = cut["flip_bound"]
        log(f"[moe] {arch} routing, K7 against the plain attention: {share:.6f} of the "
            f"prefill's decisions differ (bound {bound}); control (the prefill with K7 over the "
            f"first {LM_CONTROL_COLUMNS} of {cfg.head_dim_} head-dim columns) {control:.6f}; "
            f"{card}")
        if share > bound or control <= bound:
            raise AssertionError(f"[moe] {arch}: routing flips {share}, control {control}, "
                                 f"bound {bound}")
        del calls, slots
        lens, prompts = seeded_prompts(cfg, spec)
        longest = torch.as_tensor(prompts[int(np.argmax(lens))][None], device="cuda")
        moe_layer_check(card, cfg, params, longest)
        del params
        torch.cuda.empty_cache()
    log(f"[moe] phase 13 took {time.perf_counter() - t0:.1f} s (host clock); K7 launches "
        f"{paths}; {card}")
    return {"attention": paths}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k2":
        return time_checkout(Path(sys.argv[2]), ["fused_e2e_polymul"])
    if len(sys.argv) >= 3 and sys.argv[1] == "--time-kernels":
        return time_checkout(Path(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:] == ["--compose-variants"]:
        return time_compose_variants()
    if sys.argv[1:] == ["--cascade-variants"]:
        return time_cascade_variants()
    if sys.argv[1:] == ["--transform-variants"]:
        return time_transform_variants()
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
    time_auto_edges(card)
    time_host_split(card)
    drive_widths(card)
    serve_paths = drive_serve(card)
    for name, paths in drive_soak(card).items():
        serve_paths.setdefault(name, {}).update(paths)
    for name, paths in drive_tune(card).items():
        serve_paths.setdefault(name, {}).update(paths)
    for name, paths in drive_shard(card).items():
        serve_paths.setdefault(name, {}).update(paths)
    for name, paths in drive_lm(card).items():
        serve_paths.setdefault(name, {}).update(paths)
    for name, paths in drive_moe(card).items():
        serve_paths.setdefault(name, {}).update(paths)
    for entry in entries:  # phases 8-13's paths beside each kernel's
        paths = serve_paths.get(entry["name"], {})
        if paths:
            entry.setdefault("launches_by_path", {"main": entry["launches"]}).update(paths)

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
