"""The tile streams of the port's multi-block transforms (K3-fs,
``csrc/ntt_channels_fs.cu``, and K4-fs, ``csrc/intt_channels_fs.cu``;
``csrc/parentt.cuh`` fs_stream): one persistent launch a call whose CTAs
take the column and row tiles of every polynomial from one ordered queue,
a second-phase tile loaded once its polynomial's first-phase tiles are
stored, every tile moved by TMA.

The kernels run only on the card (``tests/test_torch_cuda.py``), and
their arithmetic is emulated pass by pass in
``tests/test_torch_kernel_arith.py``.  Here, on the Python mirrors of
``kernels/ntt.py`` (``fs_ticket``, ``fs_queue``, ``fs_lag``,
``fs_col_box``, ``fs_stream_smem_bytes``): the queue hands out every tile
once at every n and several grids, each second-phase tile behind all its
polynomial's first-phase tiles by the lag; a simulation of the CTAs'
producers and consumers in random order finishes every queue without a
deadlock; and every tile the kernels move obeys TMA's limits.

    python -m pytest -q tests/test_torch_fs_stream.py
"""
import numpy as np
import pytest

from repro_torch.kernels import ntt as tkern

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEED = 23
# chip_smoke.py's FS_SMALL_POINTS and FS_POINTS: every n the card checks
NS = (4, 8, 16, 256, 1024, 4096, 16384, 32768, 65536)
# CTAs a launch may have: one, a few, fewer than a polynomial's tiles, the
# H100's 2 x 132, and more than any queue here has tickets
GRIDS = (1, 2, 5, 264, 10_000)
# (t, rows): one polynomial, an odd count, the measured shape's 96
SHAPES = ((1, 1), (3, 3), (6, 16))


def test_queue_hands_out_every_tile_once():
    """At every n, grid and shape the queue of both phases holds each
    (phase, polynomial, tile) exactly once, each polynomial's tiles of a
    phase in order; a queue of one phase holds that phase's tiles in
    order."""
    for n in NS:
        per = n // tkern.fs_tile(n)
        for t, rows in SHAPES:
            polys = t * rows
            want = [(ph, p, b) for ph in (0, 1) for p in range(polys) for b in range(per)]
            for grid in GRIDS:
                queue = tkern.fs_queue(t, rows, n, grid)
                assert sorted(queue) == want, (n, t, rows, grid)
                for ph in (0, 1):
                    mine = [(p, b) for q, p, b in queue if q == ph]
                    assert mine == sorted(mine), (n, grid, ph)
            for phases in (1, 2):
                one = tkern.fs_queue(t, rows, n, 264, phases)
                assert one == [x for x in want if x[0] == phases - 1], (n, phases)


def test_second_phase_tiles_wait_behind_the_lag():
    """Every second-phase tile comes after all first-phase tiles of its
    polynomial, and between the last of those and the polynomial's first
    second-phase tile the queue hands out lag - (tiles a polynomial) + 1
    first-phase tiles (or all that are left): a polynomial's row tiles
    (K3-fs) wait about two tiles' time behind its column tiles, so a CTA
    seldom waits on one; the lag keeps every dependency on an earlier
    ticket, which is what makes the queue free of deadlock."""
    for n in NS:
        per = n // tkern.fs_tile(n)
        for t, rows in SHAPES:
            polys = t * rows
            for grid in GRIDS:
                lag = tkern.fs_lag(n, grid)
                assert lag == per + grid and lag >= per - 1
                queue = tkern.fs_queue(t, rows, n, grid)
                ticket = {x: k for k, x in enumerate(queue)}
                firsts = np.cumsum([ph == 0 for ph, _, _ in queue])
                for p in range(polys):
                    last_a = max(ticket[(0, p, b)] for b in range(per))
                    first_b = min(ticket[(1, p, b)] for b in range(per))
                    assert first_b > last_a, (n, grid, p)
                    between = firsts[first_b] - firsts[last_a]
                    left = polys * per - firsts[last_a]
                    assert between == min(lag - per + 1, left), (n, grid, p, between)


def simulate(t, rows, n, grid, phases, rng):
    """The CTAs of one launch, each a producer with a ring of two slots and
    consumers that finish the tiles in the order loaded, stepped in random
    order; a CTA's step is one of what it can do, chosen at random, as
    fs_stream's producer and consumers do it: drain its oldest tile once
    finished (store; a first-phase tile adds one to its polynomial's
    count), finish its oldest tile, or load its next ticket where a slot
    is free and, for a second-phase tile, its polynomial's count is full.
    Returns the tiles in the order stored; raises if no CTA can do anything
    before every tile is stored."""
    queue = tkern.fs_queue(t, rows, n, grid, phases)
    per = n // tkern.fs_tile(n)
    grid = min(grid, len(queue))
    counts = [0] * (t * rows)
    nxt = 0
    ring = [[] for _ in range(grid)]  # per CTA: [ticket, finished] in load order
    pending = [None] * grid
    stored = []
    while len(stored) < len(queue):
        moved = False
        for c in rng.permutation(grid):
            steps = []
            if ring[c]:
                steps.append("drain" if ring[c][0][1] else "finish")
            if len(ring[c]) < 2:
                if pending[c] is None and nxt < len(queue):
                    pending[c], nxt = nxt, nxt + 1
                k = pending[c]
                if k is not None:
                    phase, p, _ = queue[k]
                    if not (phases == 3 and phase == 1 and counts[p] < per):
                        steps.append("load")
            if not steps:
                continue
            moved = True
            step = steps[rng.integers(len(steps))]
            if step == "drain":
                k = ring[c].pop(0)[0]
                if queue[k][0] == 0:
                    counts[queue[k][1]] += 1
                stored.append(k)
            elif step == "finish":
                ring[c][0][1] = True
            else:
                ring[c].append([pending[c], False])
                pending[c] = None
        if not moved:
            raise AssertionError(f"no CTA can move: n={n} grid={grid} stored {len(stored)}")
    return [queue[k] for k in stored]


@pytest.mark.parametrize("n", (16, 4096, 65536))
def test_stream_finishes_every_queue(n):
    """The producers' protocol, simulated over every grid of GRIDS (one
    CTA, a few, and more than the tickets) and at t = 3, 3 rows, finishes
    the queue in many random orders: a CTA whose next ticket waits on its
    own unfinished tile keeps draining it, so nothing deadlocks; each tile
    is stored once, and no second-phase tile before its polynomial's
    first-phase tiles; a queue of one phase finishes too."""
    rng = np.random.default_rng(SEED + n)
    per = n // tkern.fs_tile(n)
    for grid in GRIDS:
        for _ in range(3):
            order = simulate(3, 3, n, grid, 3, rng)
            assert sorted(order) == sorted(tkern.fs_queue(3, 3, n, grid)), grid
            done = {}
            for phase, p, _ in order:
                if phase == 0:
                    done[p] = done.get(p, 0) + 1
                else:
                    assert done.get(p, 0) == per, (grid, p)
        for phases in (1, 2):
            assert len(simulate(3, 3, n, grid, phases, rng)) == 9 * per


def test_tiles_obey_tma_limits():
    """Every tile the kernels move at n = 4 ... 65536, in 4-byte words (the
    scratch) and 8-byte words (input and output): a column tile past n =
    4096 is a TMA box of C columns x n1 rows of the (n2, polys n1) view,
    each box dimension at most 256 elements, its inner extent and the
    row stride multiples of 16 bytes, its E words one tile; every other
    tile (a row tile, and a column tile at n <= 4096, which is the whole
    polynomial) is a contiguous span of a multiple of 16 bytes starting on
    a 16-byte boundary, down to n = 4 (16 bytes of 32-bit words)."""
    for log_n in range(2, 17):
        n = 1 << log_n
        n1, n2 = tkern.fs_split(n)
        E = tkern.fs_tile(n)
        for word in (4, 8):
            box = tkern.fs_col_box(n, word)
            assert box["bytes"] == E * word
            if n <= tkern.FS_TILE:
                assert box == {"kind": "bulk", "bytes": n * word}
            else:
                cols, box_rows = box["box"]
                assert box["kind"] == "tensor" and cols * box_rows == E
                assert box_rows == n1 <= 256 and cols <= 256 and cols <= box["dims"][0] == n2
                assert (cols * word) % 16 == 0 and box["stride"] == n2 * word
                assert box["stride"] % 16 == 0
            # a span: a polynomial's tile at offset (poly n + blk E) words
            assert (E * word) % 16 == 0 and (n * word) % 16 == 0


def test_stream_shared_memory_holds_two_ctas_an_sm():
    """A CTA's shared memory (two staging slots of E int64 words, 128-byte
    aligned, the padded tile, the mbarriers and tickets) fits one block at
    every n, two CTAs an SM at n >= 4096 (228 KB an SM, 1 KB of it
    reserved a CTA), and each slot starts 128-byte aligned, as a TMA box
    needs; the consumer threads run the passes of any tile, and the
    scratch row tiles K3-fs drops from L2 are whole 128-byte lines of
    their own at every n that drops them (E >= 32)."""
    for log_n in range(2, 17):
        n = 1 << log_n
        E = tkern.fs_tile(n)
        smem = tkern.fs_stream_smem_bytes(n)
        assert smem <= tkern.MAX_SMEM_BYTES
        assert (8 * E) % 128 == 0 or n < 16  # the second slot's start
        assert tkern.fs_threads(n) >= tkern.pass_threads(E)
        if E >= 32:
            assert (4 * E) % 128 == 0
    assert tkern.fs_stream_smem_bytes(65536) == 83112
    assert 2 * (tkern.fs_stream_smem_bytes(65536) + 1024) <= 228 * 1024
