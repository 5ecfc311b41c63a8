"""Backend dispatch of the port (counterpart of ``repro.kernels.ops``).

Backends
--------
* ``"torch"``          — the plain-PyTorch reference datapath (strict
  butterflies, SAU/Barrett RNS pre/post); mirrors the reference's ``jnp``.
* ``"cuda_fused"``     — the cascade NTT -> (.) -> iNTT in one CUDA kernel
  (:func:`repro_torch.kernels.ntt.fused_polymul_cuda`); decompose and
  compose stay plain PyTorch until their kernels are ported.  Mirrors
  ``pallas_fused``.
* ``"cuda_fused_e2e"`` — decompose -> cascade -> compose in ONE CUDA
  kernel (:func:`repro_torch.kernels.ntt.fused_e2e_polymul_cuda`);
  residues never reach device memory.  Mirrors ``pallas_fused_e2e``.  The
  residue-domain product under it runs the fused cascade kernel.

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
from repro_torch.core.params import ParenttParams
from repro_torch.errors import UnknownKnobError
from repro_torch.kernels import ntt as ntt_kernels

BACKENDS = ("torch", "cuda_fused", "cuda_fused_e2e")
KERNEL_BACKENDS = ("cuda_fused", "cuda_fused_e2e")


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


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, params: ParenttParams, *,
                   backend: str) -> torch.Tensor:
    """(t, ..., n) x (t, ..., n) -> negacyclic products per RNS channel."""
    backend = validate_backend(backend)
    ct = _require_tables(params, "negacyclic_mul")
    _check_residues(a, params, "negacyclic_mul")
    _check_residues(b, params, "negacyclic_mul")
    if a.shape != b.shape:
        raise ValueError(
            f"negacyclic_mul: operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}"
        )
    if backend == "torch":
        return ntt_mod.negacyclic_mul_channels(a, b, ct)
    a3 = a.reshape(params.t, -1, params.n).contiguous()
    b3 = b.reshape(params.t, -1, params.n).contiguous()
    return ntt_kernels.fused_polymul_cuda(a3, b3, ct).reshape(a.shape)


def rns_decompose(z: torch.Tensor, params: ParenttParams) -> torch.Tensor:
    """z: (..., S) base-2^v segments -> residues (t, ...) through the Alg-2
    SAU circuits (plain PyTorch)."""
    _check_segments(z, params, "rns_decompose")
    return rns_mod.decompose_sau(z, params.plan)


def rns_compose(residues: torch.Tensor, params: ParenttParams) -> torch.Tensor:
    """residues: (t, ...) -> (..., L) base-2^w limbs (plain PyTorch)."""
    if residues.dim() < 1 or residues.shape[0] != params.t:
        raise ValueError(
            f"rns_compose: expected residues (t={params.t}, ...), got shape "
            f"{tuple(residues.shape)}"
        )
    return rns_mod.compose(residues, params.plan)


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
        ra = rns_decompose(za, params)
        rb = rns_decompose(zb, params)
        return rns_compose(negacyclic_mul(ra, rb, params, backend=backend), params)
    ct = _require_tables(params, "fused_polymul_e2e")
    lead = za.shape[:-2]
    z3a = za.reshape((-1,) + za.shape[-2:]).contiguous()
    z3b = zb.reshape((-1,) + zb.shape[-2:]).contiguous()
    out = ntt_kernels.fused_e2e_polymul_cuda(z3a, z3b, ct, params.plan)
    return out.reshape(lead + (params.n, params.plan.L))
