"""Backend dispatch of the port (counterpart of ``repro.kernels.ops``).

Backends
--------
* ``"torch"``          — the plain-PyTorch reference datapath (strict
  butterflies, SAU/Barrett RNS pre/post); mirrors the reference's ``jnp``.
* ``"cuda"``           — per-stage CUDA kernels: decompose (K5), NTT(a)
  and NTT(b) (K3), the pointwise product in PyTorch elementwise ops, the
  iNTT (K4) and compose (K6) are separate launches, so the residues and
  spectra round-trip device memory between stages.  Mirrors ``pallas``.
* ``"cuda_fused"``     — decompose (K5), the cascade NTT -> (.) -> iNTT in
  one CUDA kernel (K1, :func:`repro_torch.kernels.ntt.fused_polymul_cuda`)
  and compose (K6).  Mirrors ``pallas_fused``.
* ``"cuda_fused_e2e"`` — decompose -> cascade -> compose in ONE CUDA
  kernel (K2, :func:`repro_torch.kernels.ntt.fused_e2e_polymul_cuda`)
  where a CTA holds its channels' polynomials (n <= 16384, up to a t that
  falls as n grows), in the multi-block K2-fs past it
  (:func:`repro_torch.kernels.ntt.fused_e2e_polymul_fs_cuda`: one call of
  three launches, only 32-bit lazy words between them); int64 residues
  never reach device memory.  Mirrors ``pallas_fused_e2e``.  The stage
  entry points have no single-kernel form under it and take the closest
  kernel datapath (:func:`_stage_backend`): the residue-domain product
  runs K1 (K1-fs), every other stage its ``cuda`` kernel.

``backend="auto"`` resolves at plan time: to ``cuda_fused_e2e`` on a CUDA
device where K2 holds the plan, or K2-fs at t <= 8, with S and L <= 16
(:func:`auto_backend`), to ``cuda_fused`` past it, and to ``torch`` on
the CPU.  The kernel backends accept CPU tensors
too: their wrappers then run the kernels' plain versions.  ``use_sau``
picks the Alg-2 SAU circuits or the generic decompose on the ``torch``
backend; the kernel backends always run the SAU circuits, as the
reference's Pallas backends do.

Schedules
---------
``schedule`` (a string or a resolved
:class:`repro_torch.core.schedule.ScheduleSpec`; by default the params'
``schedule``, ``"auto"``: four-step from n = 256) regroups one flow graph,
so every choice gives the same canonical outputs (DESIGN.md §6).  The
``torch`` backend runs what it names, as the reference's ``jnp`` does:
:func:`repro_torch.core.ntt.ntt_raw_hier` in the reference's chain for
four-step, the radix-2 loops otherwise.  The kernel backends record it
and choose their kernels by what fits a CTA: K1, K3 and K4 where the
polynomial fits one CTA's shared memory, their multi-block forms K1-fs,
K3-fs and K4-fs (on the card's own split, ``kernels.ntt.fs_split``)
where it does not.

Shape contracts: residues ``(t, ..., n)``, segments ``(..., n, S)``,
limbs ``(..., n, L)``; violations raise before any work.
"""
from __future__ import annotations

import torch

from repro_torch.core import ntt as ntt_mod
from repro_torch.core import primes as primes_mod
from repro_torch.core import rns as rns_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.modmath import mul_mod
from repro_torch.core.params import ParenttParams
from repro_torch.errors import UnknownKnobError
from repro_torch.kernels import crt as crt_kernels
from repro_torch.kernels import ntt as ntt_kernels

BACKENDS = ("torch", "cuda", "cuda_fused", "cuda_fused_e2e")
KERNEL_BACKENDS = ("cuda", "cuda_fused", "cuda_fused_e2e")


def validate_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise UnknownKnobError(
            f"unknown backend {backend!r}: expected one of {BACKENDS} or 'auto'",
            knob="backend", value=backend, alternatives=BACKENDS,
        )
    return backend


# the largest S and L at which backend="auto" took the e2e kernels
# before they served more (AUTO_E2E_T, tests/test_torch_channels.py)
AUTO_E2E_COUNTS = 16


def auto_backend(n: int, t: int, S: int, L: int) -> str:
    """``backend="auto"`` on a card at a plan's (n, t, S, L):
    ``cuda_fused_e2e`` where K2 holds it, or K2-fs at t <= 8, with S and L
    <= 16 (where auto took it before the e2e kernels served more);
    ``cuda_fused`` everywhere else, where no wall shows the e2e kernels no
    slower (at W1 and W2 chip_smoke's walls show them slower, PERF.md)."""
    if S <= AUTO_E2E_COUNTS and L <= AUTO_E2E_COUNTS and (
            ntt_kernels.e2e_fits(n, t, S, L)
            or (t <= ntt_kernels.MAX_CLUSTER and ntt_kernels.e2e_fs_fits(n, t, S, L))):
        return "cuda_fused_e2e"
    return "cuda_fused"


def resolve_backend(backend: str, device: torch.device, n: int, t: int, v: int) -> str:
    """A concrete backend for (n, t, v) on ``device``: ``"auto"`` is
    :func:`auto_backend` at the S and L of (n, t, v)'s primes on a card,
    the plain ``torch`` on the CPU."""
    if backend == "auto":
        if torch.device(device).type != "cuda":
            return "torch"
        return auto_backend(n, t, *rns_mod.counts(
            [p.q for p in primes_mod.default_prime_set(n, t, v)], v))
    return validate_backend(backend)


def serving_backends(n: int, t: int, S: int, L: int) -> tuple[str, ...]:
    """The kernel backends whose kernels one block's shared memory holds
    at (n, t, S, L): ``cuda`` and ``cuda_fused`` where K5 and K6 hold a row
    beside their channel tables (K1, K3, K4 and their multi-block forms
    take any t, and n up to 65536), ``cuda_fused_e2e`` where K2 or K2-fs
    holds it too."""
    if n > ntt_kernels.FS_MAX_N or not (crt_kernels.decompose_fits(t, S)
                                        and crt_kernels.compose_fits(t, L)):
        return ()
    if ntt_kernels.e2e_serves(n, t, S, L):
        return KERNEL_BACKENDS
    return ("cuda", "cuda_fused")


def resolve_schedule(params: ParenttParams, schedule=None) -> schedule_mod.ScheduleSpec:
    """The concrete schedule: explicit ``schedule`` > ``params.schedule``
    (``"auto"``: four-step from n = 256); a resolved spec passes through."""
    if schedule is None:
        schedule = params.schedule
    return schedule_mod.concrete_spec(params.n, schedule)


def _stage_backend(backend: str, cascade: bool = False) -> str:
    """Per-stage datapath of a backend: ``cuda_fused_e2e`` has no
    standalone-stage kernels, so its stage entry points take the closest
    kernel path (the cascade ``cuda_fused``, every other stage ``cuda``)."""
    backend = validate_backend(backend)
    if backend == "cuda_fused_e2e":
        return "cuda_fused" if cascade else "cuda"
    return backend


# --------------------------------------------------------------------------
# shape contracts
# --------------------------------------------------------------------------


def _check_residues(x: torch.Tensor, params: ParenttParams, fn: str) -> None:
    if x.dim() < 2 or x.shape[0] != params.t or x.shape[-1] != params.n:
        raise ValueError(
            f"{fn}: expected residues (t={params.t}, ..., n={params.n}), "
            f"got shape {tuple(x.shape)}"
        )


def _check_segments(z: torch.Tensor, params: ParenttParams, fn: str) -> None:
    S = params.plan.seg_count
    if z.dim() < 1 or z.shape[-1] != S:
        raise ValueError(
            f"{fn}: expected base-2^{params.v} segments (..., S={S}), "
            f"got shape {tuple(z.shape)}"
        )


def _require_tables(params: ParenttParams, fn: str) -> ntt_mod.ChannelTables:
    if params.tables is None:
        raise ValueError(
            f"{fn}: params (n={params.n}, t={params.t}, v={params.v}) have no "
            "int64-safe NTT tables (v > 31)"
        )
    return params.tables


# --------------------------------------------------------------------------
# stage dispatch
# --------------------------------------------------------------------------


def _fold_rows(x: torch.Tensor, params: ParenttParams) -> torch.Tensor:
    """(t, ..., n) -> contiguous (t, rows, n), the kernels' layout."""
    return x.reshape(params.t, -1, params.n).contiguous()


def _forward_kernel(n: int):
    """K3 where one CTA holds the polynomial, else K3-fs."""
    return ntt_kernels.ntt_channels_cuda if ntt_kernels.stage_fits(n) else \
        ntt_kernels.ntt_channels_fs_cuda


def _inverse_kernel(n: int):
    """K4 where one CTA holds the polynomial, else K4-fs."""
    return ntt_kernels.intt_channels_cuda if ntt_kernels.stage_fits(n) else \
        ntt_kernels.intt_channels_fs_cuda


def ntt_forward(a: torch.Tensor, params: ParenttParams, *, backend: str,
                schedule=None) -> torch.Tensor:
    """a: (t, ..., n) canonical residues -> forward NTT per RNS channel
    (natural order in, bit-reversed out)."""
    backend = _stage_backend(backend)
    spec = resolve_schedule(params, schedule)
    ct = _require_tables(params, "ntt_forward")
    _check_residues(a, params, "ntt_forward")
    if backend == "torch":
        return ntt_mod.ntt_channels(a, ct, spec)
    return _forward_kernel(params.n)(_fold_rows(a, params), ct).reshape(a.shape)


def ntt_inverse(a: torch.Tensor, params: ParenttParams, *, backend: str,
                schedule=None) -> torch.Tensor:
    """a: (t, ..., n) canonical bit-reversed spectra -> natural-order
    residues per RNS channel."""
    backend = _stage_backend(backend)
    spec = resolve_schedule(params, schedule)
    ct = _require_tables(params, "ntt_inverse")
    _check_residues(a, params, "ntt_inverse")
    if backend == "torch":
        return ntt_mod.intt_channels(a, ct, spec)
    return _inverse_kernel(params.n)(_fold_rows(a, params), ct).reshape(a.shape)


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, params: ParenttParams, *,
                   backend: str, schedule=None) -> torch.Tensor:
    """(t, ..., n) x (t, ..., n) -> negacyclic products per RNS channel."""
    backend = _stage_backend(backend, cascade=True)
    spec = resolve_schedule(params, schedule)
    ct = _require_tables(params, "negacyclic_mul")
    _check_residues(a, params, "negacyclic_mul")
    _check_residues(b, params, "negacyclic_mul")
    if a.shape != b.shape:
        raise ValueError(
            f"negacyclic_mul: operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}"
        )
    if backend == "torch":
        return ntt_mod.negacyclic_mul_channels(a, b, ct, spec)
    a3, b3 = _fold_rows(a, params), _fold_rows(b, params)
    if backend == "cuda_fused":
        cascade = (ntt_kernels.fused_polymul_cuda if ntt_kernels.cascade_fits(params.n)
                   else ntt_kernels.fused_polymul_fs_cuda)
        return cascade(a3, b3, ct).reshape(a.shape)
    # "cuda": per-stage kernels, the spectra round-trip device memory
    forward = _forward_kernel(params.n)
    fa, fb = forward(a3, ct), forward(b3, ct)
    q, _, eps = ntt_mod.channel_scalars(ct, 3)
    prod = mul_mod(fa, fb, q, eps, ct.mul_shifts)
    return _inverse_kernel(params.n)(prod, ct).reshape(a.shape)


def rns_decompose(z: torch.Tensor, params: ParenttParams, *, backend: str,
                  use_sau: bool = True) -> torch.Tensor:
    """z: (..., S) base-2^v segments -> residues (t, ...): on ``torch``
    through the Alg-2 SAU circuits, or the generic decompose when
    ``use_sau`` is False; every kernel backend runs the decompose kernel
    (K5), whatever ``use_sau``."""
    backend = _stage_backend(backend)
    _check_segments(z, params, "rns_decompose")
    if backend == "torch":
        fn = rns_mod.decompose_sau if use_sau else rns_mod.decompose
        return fn(z, params.plan)
    z2 = z.reshape(-1, z.shape[-1]).contiguous()
    return crt_kernels.decompose_cuda(z2, params.plan).reshape((params.t,) + z.shape[:-1])


def rns_compose(residues: torch.Tensor, params: ParenttParams, *, backend: str) -> torch.Tensor:
    """residues: (t, ...) -> (..., L) base-2^w limbs; every kernel backend
    runs the compose kernel (K6)."""
    backend = _stage_backend(backend)
    if residues.dim() < 1 or residues.shape[0] != params.t:
        raise ValueError(
            f"rns_compose: expected residues (t={params.t}, ...), got shape "
            f"{tuple(residues.shape)}"
        )
    if backend == "torch":
        return rns_mod.compose(residues, params.plan)
    r2 = residues.reshape(params.t, -1).contiguous()
    out = crt_kernels.compose_cuda(r2, params.plan)
    return out.reshape(residues.shape[1:] + (params.plan.L,))


# --------------------------------------------------------------------------
# end-to-end dispatch
# --------------------------------------------------------------------------


def fused_polymul_e2e(za: torch.Tensor, zb: torch.Tensor, params: ParenttParams, *,
                      backend: str, schedule=None, use_sau: bool = True) -> torch.Tensor:
    """za, zb: (..., n, S) segments -> (..., n, L) product limbs:
    decompose -> per-channel cascade -> compose.  On ``cuda_fused_e2e``
    all three run in one kernel, K2 where it holds (n, t, S, L), else
    K2-fs; other backends compose the stage dispatchers (``use_sau``:
    :func:`rns_decompose`)."""
    backend = validate_backend(backend)
    for name, z in (("za", za), ("zb", zb)):
        if z.dim() < 2 or z.shape[-2] != params.n:
            raise ValueError(
                f"fused_polymul_e2e: expected {name} segments (..., n={params.n}, "
                f"S={params.plan.seg_count}), got shape {tuple(z.shape)}"
            )
        _check_segments(z, params, "fused_polymul_e2e")
    if za.shape != zb.shape:
        raise ValueError(
            f"fused_polymul_e2e: operand shapes differ: {tuple(za.shape)} vs {tuple(zb.shape)}"
        )
    if backend != "cuda_fused_e2e":
        ra = rns_decompose(za, params, backend=backend, use_sau=use_sau)
        rb = rns_decompose(zb, params, backend=backend, use_sau=use_sau)
        prod = negacyclic_mul(ra, rb, params, backend=backend, schedule=schedule)
        return rns_compose(prod, params, backend=backend)
    ct = _require_tables(params, "fused_polymul_e2e")
    lead = za.shape[:-2]
    z3a = za.reshape((-1,) + za.shape[-2:]).contiguous()
    z3b = zb.reshape((-1,) + zb.shape[-2:]).contiguous()
    rp = params.plan
    e2e = (ntt_kernels.fused_e2e_polymul_cuda
           if ntt_kernels.e2e_fits(params.n, params.t, rp.seg_count, rp.L)
           else ntt_kernels.fused_e2e_polymul_fs_cuda)
    out = e2e(z3a, z3b, ct, params.plan)
    return out.reshape(lead + (params.n, params.plan.L))
