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
  kernel (K2, :func:`repro_torch.kernels.ntt.fused_e2e_polymul_cuda`);
  residues never reach device memory.  Mirrors ``pallas_fused_e2e``.  The
  stage entry points have no single-kernel form under it and take the
  closest kernel datapath (:func:`_stage_backend`): the residue-domain
  product runs K1, every other stage its ``cuda`` kernel.

``backend="auto"`` resolves to ``cuda_fused_e2e`` on a CUDA device and to
``torch`` on the CPU.  The kernel backends accept CPU tensors too: their
wrappers then run the kernels' plain versions.

Shape contracts: residues ``(t, ..., n)``, segments ``(..., n, S)``,
limbs ``(..., n, L)``; violations raise before any work.
"""
from __future__ import annotations

import torch

from repro_torch.core import ntt as ntt_mod
from repro_torch.core import rns as rns_mod
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


def resolve_backend(backend: str, device: torch.device) -> str:
    if backend == "auto":
        return "cuda_fused_e2e" if torch.device(device).type == "cuda" else "torch"
    return validate_backend(backend)


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


def ntt_forward(a: torch.Tensor, params: ParenttParams, *, backend: str) -> torch.Tensor:
    """a: (t, ..., n) canonical residues -> forward NTT per RNS channel
    (natural order in, bit-reversed out)."""
    backend = _stage_backend(backend)
    ct = _require_tables(params, "ntt_forward")
    _check_residues(a, params, "ntt_forward")
    if backend == "torch":
        return ntt_mod.ntt_channels(a, ct)
    return ntt_kernels.ntt_channels_cuda(_fold_rows(a, params), ct).reshape(a.shape)


def ntt_inverse(a: torch.Tensor, params: ParenttParams, *, backend: str) -> torch.Tensor:
    """a: (t, ..., n) canonical bit-reversed spectra -> natural-order
    residues per RNS channel."""
    backend = _stage_backend(backend)
    ct = _require_tables(params, "ntt_inverse")
    _check_residues(a, params, "ntt_inverse")
    if backend == "torch":
        return ntt_mod.intt_channels(a, ct)
    return ntt_kernels.intt_channels_cuda(_fold_rows(a, params), ct).reshape(a.shape)


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, params: ParenttParams, *,
                   backend: str) -> torch.Tensor:
    """(t, ..., n) x (t, ..., n) -> negacyclic products per RNS channel."""
    backend = _stage_backend(backend, cascade=True)
    ct = _require_tables(params, "negacyclic_mul")
    _check_residues(a, params, "negacyclic_mul")
    _check_residues(b, params, "negacyclic_mul")
    if a.shape != b.shape:
        raise ValueError(
            f"negacyclic_mul: operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}"
        )
    if backend == "torch":
        return ntt_mod.negacyclic_mul_channels(a, b, ct)
    a3, b3 = _fold_rows(a, params), _fold_rows(b, params)
    if backend == "cuda_fused":
        return ntt_kernels.fused_polymul_cuda(a3, b3, ct).reshape(a.shape)
    # "cuda": per-stage kernels, the spectra round-trip device memory
    fa = ntt_kernels.ntt_channels_cuda(a3, ct)
    fb = ntt_kernels.ntt_channels_cuda(b3, ct)
    q, _, eps = ntt_mod.channel_scalars(ct, 3)
    prod = mul_mod(fa, fb, q, eps, ct.mul_shifts)
    return ntt_kernels.intt_channels_cuda(prod, ct).reshape(a.shape)


def rns_decompose(z: torch.Tensor, params: ParenttParams, *, backend: str) -> torch.Tensor:
    """z: (..., S) base-2^v segments -> residues (t, ...) through the Alg-2
    SAU circuits; every kernel backend runs the decompose kernel (K5)."""
    backend = _stage_backend(backend)
    _check_segments(z, params, "rns_decompose")
    if backend == "torch":
        return rns_mod.decompose_sau(z, params.plan)
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
                      backend: str) -> torch.Tensor:
    """za, zb: (..., n, S) segments -> (..., n, L) product limbs:
    decompose -> per-channel cascade -> compose.  On ``cuda_fused_e2e``
    all three run in one kernel; other backends compose the stage
    dispatchers."""
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
        ra = rns_decompose(za, params, backend=backend)
        rb = rns_decompose(zb, params, backend=backend)
        return rns_compose(negacyclic_mul(ra, rb, params, backend=backend), params,
                           backend=backend)
    ct = _require_tables(params, "fused_polymul_e2e")
    lead = za.shape[:-2]
    z3a = za.reshape((-1,) + za.shape[-2:]).contiguous()
    z3b = zb.reshape((-1,) + zb.shape[-2:]).contiguous()
    out = ntt_kernels.fused_e2e_polymul_cuda(z3a, z3b, ct, params.plan)
    return out.reshape(lead + (params.n, params.plan.L))
