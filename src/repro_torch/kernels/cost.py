"""The port's traffic and work model: what one end-to-end multiply moves
through device memory, which hand-written kernels it launches, and the
integer operations each kernel needs (counterpart of the reference's
``hbm_traffic_model``, ``count_pallas_launches`` and
``transform_cost_model`` in ``repro.kernels.ops``, recounted for the
port's dispatch; :mod:`repro_torch.kernels.ops` re-exports them).

Three readers share it: ``chip_smoke.py``'s per-kernel bounds (the card's
peaks, :func:`work`, :func:`bound`), the tuner's cost check
(:mod:`repro_torch.tune.costcheck`: :func:`hbm_traffic_model`'s bytes and
operations as a roofline time a candidate) and the stage profiler
(:mod:`repro_torch.obs.profiling`: the byte attribution per stage).

Operation counts are integer operations the function needs on its inputs,
one unit per add, sub, mul, shift, mask, compare, select or remainder,
32- or 64-bit (a conditional subtraction is compare + sub + select = 3).
Bytes count each input read once and each output written once, as int64
words, plus the 32-bit words that cross between K2-fs's launches.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import ntt as ntt_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.params import ParenttParams
from repro_torch.kernels import crt as crt_kernels
from repro_torch.kernels import ntt as ntt_kernels

# NVIDIA H100 SXM published peaks.
HBM_BYTES_PER_S = 3.35e12
# No integer-64 rate is published; the scalar (non-tensor-core) peak of
# 67 TOP/s is used, so the operation bound is optimistic.
SCALAR_OPS_PER_S = 67e12
# Dense bf16 tensor-core rate: the bound of K7's two products, whatever
# units the kernel uses.
BF16_FLOPS_PER_S = 989e12

COND_SUB = 3
BARRETT = 5 + 3 * COND_SUB  # two shifts, two muls, one sub, three cond subs
BLOCK_BARRETT = 4 + 2 * COND_SUB  # shift, high product, product, sub, two cond subs
SHOUP = 5


def _mul_mod(mode: int) -> int:
    return 1 + (BLOCK_BARRETT if mode == ntt_kernels.MODE_REM else BARRETT)  # product + reduction


def _canon(mode: int, window: int) -> int:
    return 0 if mode != ntt_kernels.MODE_LAZY else COND_SUB * (2 if window == 4 else 1)


def _butterfly_selects(mode: int, window: int) -> tuple[int, int]:
    """(CT, GS) conditional subtractions of one butterfly in a regime: the
    lazy butterflies' range folds (one at W = 4, two at W = 2 for CT, two
    for GS); strict, the product's reduction (three for a Barrett, two
    for the block Barrett) and the add's and sub's corrections."""
    if mode == ntt_kernels.MODE_LAZY:
        return (1 if window == 4 else 2), 2
    red = 2 if mode == ntt_kernels.MODE_REM else 3
    return red + 2, red + 2


def _butterfly_ops(mode: int, window: int) -> tuple[int, int]:
    """(CT, GS) butterfly operation counts in a regime: the Shoup product
    (lazy) or the product and its reduction (strict), the add and the
    sub, GS's two subtractions of the offset, and the selects of
    :func:`_butterfly_selects`."""
    ct_sel, gs_sel = _butterfly_selects(mode, window)
    if mode == ntt_kernels.MODE_LAZY:
        return SHOUP + 3 + COND_SUB * ct_sel, SHOUP + 11 + COND_SUB * gs_sel
    plain = 1 + (4 if mode == ntt_kernels.MODE_REM else 5)  # the product and its reduction
    return plain + 2 + COND_SUB * ct_sel, plain + 10 + COND_SUB * gs_sel


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
    tail.  ``earlier``: the first kernels' count (a product and a
    remainder per channel, the tail's t - 1 subtractions)."""
    if earlier:
        return 2 * t + compose_tail_ops(t, L, quotient=False)
    return t * (1 + BLOCK_BARRETT) + compose_tail_ops(t, L)


def sau_ops(plan, earlier: bool = False) -> int:
    """Operations of the SAU network (Eq 5) of one residue: one product by
    beta; ``earlier``: the first kernels' count, 1 + 3 n_terms shifts and
    adds (more than the function needs; kept only so earlier bounds
    compare)."""
    return 1 + 3 * max(len(c.beta_terms) for c in plan.dec) if earlier else 1


def channel_decompose_ops(t: int, S: int, t_prime: int, sau: int = 1) -> int:
    """One coefficient's residues in all t channels (K5)."""
    return t * decompose_ops(S, t_prime, sau)


def e2e_ops(n: int, t: int, S: int, L: int, t_prime: int, mode: int, window: int, rows: int,
            sau: int = 1, quotient: bool = True) -> int:
    """One multiply of ``rows`` polynomials in one kernel (K2, K2-fs): both
    operands' decompose, the cascade, y = p q~ per channel and the compose
    tail."""
    per_coeff = (2 * channel_decompose_ops(t, S, t_prime, sau)
                 + t * (_canon(mode, window) + _mul_mod(mode))
                 + compose_tail_ops(t, L, quotient=quotient))
    return rows * (t * cascade_ops(n, mode, window) + n * per_coeff)


def bound(bytes_moved: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of the bytes
    over its memory rate and the operations over its peak rate."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _int64_params(params: ParenttParams, fn: str) -> ntt_mod.ChannelTables:
    if params.tables is None:
        raise ValueError(f"{fn}: the model covers the int64 kernel datapaths (v <= 31), "
                         f"got v={params.v}")
    return params.tables


def _shape(params: ParenttParams, fn: str) -> tuple[int, int, int, int, int, int, int]:
    """(n, t, S, L, t', mode, window) of int64 params."""
    mode, window = ntt_kernels.reduction_mode(_int64_params(params, fn))[:2]
    rp = params.plan
    return params.n, params.t, rp.seg_count, rp.L, rp.t_prime, mode, window


def work(params: ParenttParams, rows: int, earlier: bool = False) -> dict[str, tuple[int, int]]:
    """Kernel -> (bytes it must move, integer operations it needs) on
    ``rows`` rows of these params: each input read once, each output
    written once, as int64 words (``earlier``: the first kernels'
    operation counts, chip_smoke's ``bound_ms_earlier_count``).  K1, K3, K4 (and their multi-block forms) take (t, rows, n)
    residues, K5 and K6 rows x n coefficients, K2 (and K2-fs) the
    segments."""
    n, t, S, L, t_prime, mode, window = _shape(params, "work")
    sau = sau_ops(params.plan, earlier)
    polys = t * rows  # (channel, row) polynomials
    coeffs = rows * n
    return {
        "fused_polymul": (3 * polys * n * 8, polys * cascade_ops(n, mode, window)),
        "fused_e2e_polymul": ((2 * S + L) * coeffs * 8,
                              e2e_ops(n, t, S, L, t_prime, mode, window, rows, sau,
                                      quotient=not earlier)),
        "ntt_channels": (2 * polys * n * 8, polys * transform_ops(n, mode, window, inverse=False)),
        "intt_channels": (2 * polys * n * 8, polys * transform_ops(n, mode, window, inverse=True)),
        "decompose": ((S + t) * coeffs * 8, coeffs * channel_decompose_ops(t, S, t_prime, sau)),
        "compose": ((t + L) * coeffs * 8, coeffs * compose_ops(t, L, earlier)),
    }


# --------------------------------------------------------------------------
# the paths: which wrappers one fused_polymul_e2e calls
# --------------------------------------------------------------------------

# Kernel launches one call of a wrapper makes: K2-fs's wrapper runs its
# three launches (decompose, cascade, compose) in one C call and adds one
# to its ``launches``; every other wrapper launches once a call.
LAUNCHES_PER_CALL = {"fused_e2e_polymul_fs": 3}

# kernel (a ``kernels._build.SOURCES`` name) -> (module, wrapper name)
WRAPPERS = {
    "decompose": (crt_kernels, "decompose_cuda"),
    "compose": (crt_kernels, "compose_cuda"),
    "fused_polymul": (ntt_kernels, "fused_polymul_cuda"),
    "fused_polymul_fs": (ntt_kernels, "fused_polymul_fs_cuda"),
    "ntt_channels": (ntt_kernels, "ntt_channels_cuda"),
    "ntt_channels_fs": (ntt_kernels, "ntt_channels_fs_cuda"),
    "intt_channels": (ntt_kernels, "intt_channels_cuda"),
    "intt_channels_fs": (ntt_kernels, "intt_channels_fs_cuda"),
    "fused_e2e_polymul": (ntt_kernels, "fused_e2e_polymul_cuda"),
    "fused_e2e_polymul_fs": (ntt_kernels, "fused_e2e_polymul_fs_cuda"),
}


def path_launches(backend: str, n: int, t: int, S: int, L: int) -> dict[str, int]:
    """Kernel -> calls of its wrapper in one
    :func:`repro_torch.kernels.ops.fused_polymul_e2e` on ``backend`` at
    (n, t, S, L) (its kernels, :func:`repro_torch.kernels.ops.path_sources`):
    the decompose once an operand, the forward transform of ``cuda`` once
    an operand, every other kernel of the path once."""
    from repro_torch.kernels import ops

    twice = ("decompose", "ntt_channels", "ntt_channels_fs")
    return {name: 2 if name in twice else 1 for name in ops.path_sources(backend, n, t, S, L)}


def launches_of(calls: dict[str, int]) -> int:
    """Kernel launches of the wrapper calls ``calls`` (kernel -> calls)."""
    return sum(LAUNCHES_PER_CALL.get(name, 1) * k for name, k in calls.items())


def _resolve(params: ParenttParams, backend: str | None) -> str:
    from repro_torch.kernels import ops

    asked = params.backend if backend is None else backend
    return ops.resolve_backend(asked, params.device, params.n, params.t, params.v)


def operations(params: ParenttParams, rows: int, backend: str | None = None) -> int:
    """Integer operations of one end-to-end multiply of ``rows`` rows on
    ``backend``'s path, the sum of its kernels' counts: K2 or K2-fs
    :func:`e2e_ops`; ``cuda_fused`` two decomposes, the cascade and the
    compose; ``cuda`` and ``torch`` two decomposes, three transforms, the
    pointwise product and the compose (``torch`` counted as the same
    stage-by-stage function, in the kernels' regime)."""
    backend = _resolve(params, backend)
    n, t, S, L, t_prime, mode, window = _shape(params, "operations")
    if backend == "cuda_fused_e2e":
        return e2e_ops(n, t, S, L, t_prime, mode, window, rows)
    w = work(params, rows)
    stages = 2 * w["decompose"][1] + w["compose"][1]
    if backend == "cuda_fused":
        return stages + w["fused_polymul"][1]
    point = t * rows * n * _mul_mod(mode)
    return stages + 2 * w["ntt_channels"][1] + point + w["intt_channels"][1]


def hbm_traffic_model(params: ParenttParams, rows: int, backend: str | None = None,
                      schedule=None) -> dict[str, Any]:
    """Modeled device-memory bytes crossing kernel and stage boundaries for
    ONE end-to-end multiply of ``rows`` polynomials (both operands in,
    limbs out), per backend, as
    :func:`repro_torch.kernels.ops.fused_polymul_e2e` dispatches it:

    * ``torch``: no hand-written kernel; the logical stage boundaries
      (decompose 2 seg in / 2 res out, two NTTs, the pointwise product
      and the iNTT 9 res, compose res in / limbs out), the reference's
      ``jnp`` row;
    * ``cuda``: K5 x 2 (each reads its operand's S segments ONCE for all t
      channels, where the reference's t decompose calls re-read them t
      times), K3 x 2 or K3-fs x 2, the PyTorch pointwise product (2 res in
      / res out), K4 or K4-fs, K6: the same bytes as ``torch``, 6
      launches;
    * ``cuda_fused``: K5 x 2, K1 or K1-fs (2 res in / res out), K6;
    * ``cuda_fused_e2e``: K2 in one launch (segments in, limbs out,
      nothing between), or K2-fs in three with its 32-bit words between
      them (two residues written and read, y written and read: 24 t
      bytes a coefficient).

    K3-fs's and K4-fs's 32-bit scratch between a polynomial's two phases
    lies inside one launch (read back from L2) and is not counted.
    ``operations`` is :func:`operations`.  ``kernel_launches`` counts the
    launches of the hand-written kernels (K2-fs's three), which
    :func:`count_launches` counts from the wrapper calls of the dispatch
    itself.  The reference's TPU-only ``row_blk``, ``grid_row_steps`` and
    ``vmem_tile_bytes`` have no meaning on the card and are not here; the
    schedule changes no byte (the kernel backends choose their kernels
    by what fits a CTA)."""
    backend = _resolve(params, backend)
    _int64_params(params, "hbm_traffic_model")
    rp = params.plan
    n, t, S, L = params.n, params.t, rp.seg_count, rp.L
    B = 8  # int64 words at every kernel boundary
    seg = rows * n * S * B  # one operand's segments
    res = t * rows * n * B  # one full residue tensor
    limb = rows * n * L * B  # composed product limbs
    seg_in = 2 * seg
    if backend in ("torch", "cuda"):
        between = 12 * res
    elif backend == "cuda_fused":
        between = 6 * res
    elif ntt_kernels.e2e_fits(n, t, S, L):
        between = 0  # K2: nothing leaves the kernel between the stages
    else:
        between = 6 * t * rows * n * 4  # K2-fs's 32-bit words, written and read
    spec = schedule_mod.concrete_spec(n, params.schedule if schedule is None else schedule)
    return {
        "backend": backend,
        "rows": rows,
        "hbm_bytes": seg_in + between + limb,
        "kernel_launches": launches_of(path_launches(backend, n, t, S, L)),
        "segment_bytes_in": seg_in,
        "limb_bytes_out": limb,
        "intermediate_bytes": between,
        "schedule": str(spec),
        "schedule_depth": max(spec.depth, 1),
        "operations": operations(params, rows, backend),
    }


class _Counting:
    """Stands in for a kernel wrapper while :func:`wrapper_calls` counts:
    calls it and counts the calls, and forwards every attribute to it (a
    wrapper bumps its own ``launches`` through its module's name, which
    then names this stand-in)."""

    def __init__(self, fn):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "calls", 0)

    def __call__(self, *args, **kwargs):
        object.__setattr__(self, "calls", self.calls + 1)
        return self.fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


def wrapper_calls(params: ParenttParams, backend: str | None = None,
                  rows: int = 1) -> dict[str, int]:
    """Kernel -> calls of its wrapper that one
    :func:`repro_torch.kernels.ops.fused_polymul_e2e` of ``rows`` zero rows
    on ``backend`` makes, counted by running it with every wrapper of
    :data:`WRAPPERS` standing behind a counter for the call (the wrappers'
    own ``.launches`` move only on the card, where they move as well; on
    the CPU the wrappers run their plain versions).  Runs on the params'
    device; the wrappers are swapped module-wide, so no other thread
    should launch meanwhile."""
    from repro_torch.kernels import ops

    backend = _resolve(params, backend)
    z = torch.zeros((rows, params.n, params.plan.seg_count), dtype=torch.int64,
                    device=params.device)
    counters = {name: _Counting(getattr(mod, attr)) for name, (mod, attr) in WRAPPERS.items()}
    try:
        for name, (mod, attr) in WRAPPERS.items():
            setattr(mod, attr, counters[name])
        ops.fused_polymul_e2e(z, z, params, backend=backend)
    finally:
        for name, (mod, attr) in WRAPPERS.items():
            setattr(mod, attr, counters[name].fn)
    return {name: c.calls for name, c in counters.items() if c.calls}


def count_launches(params: ParenttParams, backend: str | None = None, rows: int = 1) -> int:
    """Kernel launches of one end-to-end multiply as dispatched
    (counterpart of the reference's ``count_pallas_launches``): the
    wrapper calls of :func:`wrapper_calls`, K2-fs's three launches a
    call.  The structural ground truth for
    ``hbm_traffic_model(...)["kernel_launches"]``."""
    return launches_of(wrapper_calls(params, backend, rows))


# --------------------------------------------------------------------------
# the stage schedule's structural cost
# --------------------------------------------------------------------------


def transform_cost_model(params: ParenttParams, *, schedule=None,
                         direction: str = "fwd") -> dict[str, Any]:
    """Structural cost of ONE NTT transform under a schedule.

    ``schedule``, ``depth``, ``splits``, ``stages``, ``lane_strides``,
    ``sublane_stages`` and ``vmem_transposes`` are the reference's,
    computed as it computes them (:func:`repro_torch.core.ntt.stage_lane_strides`):
    a description of the schedule's flow graph (which the ``torch``
    backend runs), not of the card's kernels, which choose their own
    split (``kernels.ntt.fs_split``).  ``reduction_ops`` is the PORT's
    count: the conditional subtractions of one (channel, row) transform's
    butterfly chain, per stage those of a CT (forward) or GS (inverse)
    butterfly of the tables' regime (:func:`_butterfly_selects`) times
    the stages, plus the exit canonicalize's (one at W = 2, two at W = 4,
    none strict); ``strict_reduction_ops`` the same in the strict Barrett
    regime.  The reference counts the selects of its traced Pallas kernel
    (``count_reduction_selects``), which has no counterpart on the card.
    ``operations`` is :func:`transform_ops` of one (channel, row)."""
    if direction not in ("fwd", "inv"):
        raise ValueError(f"direction must be 'fwd' or 'inv', got {direction!r}")
    spec = schedule_mod.concrete_spec(params.n, params.schedule if schedule is None else schedule)
    n = params.n
    stages = n.bit_length() - 1
    strides = ntt_mod.stage_lane_strides(n, spec)
    mode, window = ntt_kernels.reduction_mode(_int64_params(params, "transform_cost_model"))[:2]
    inverse = direction == "inv"
    per_stage = _butterfly_selects(mode, window)[inverse]
    strict = _butterfly_selects(ntt_kernels.MODE_BARRETT, 0)[inverse]
    return {
        "schedule": spec.kind,
        "spec": spec,
        "depth": max(spec.depth, 1) if spec.kind == "four_step" else 0,
        "splits": spec.splits,
        "vmem_transposes": 1 if spec.kind == "four_step" else 0,
        "direction": direction,
        "stages": stages,
        "lane_strides": strides,
        "sublane_stages": sum(1 for s in strides if 0 < s < 128),
        "lazy_window": window if mode == ntt_kernels.MODE_LAZY else None,
        "reduction_ops": per_stage * stages + _canon(mode, window) // COND_SUB,
        "strict_reduction_ops": strict * stages,
        "operations": transform_ops(n, mode, window, inverse),
    }
