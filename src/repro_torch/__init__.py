"""PaReNTT on PyTorch + CUDA: the port of the JAX package ``repro`` to an
NVIDIA H100 (first slice: the int64-width multiplier).

    import repro_torch

    pl = repro_torch.plan(n=4096, t=6, v=30)   # tables uploaded to the card
    limbs = repro_torch.polymul(pl, za, zb)    # (..., n, S) -> (..., n, L)

The main path runs one hand-written CUDA kernel
(``csrc/fused_e2e_polymul.cu``); the residue-domain product
:func:`negacyclic_mul` runs the fused cascade kernel
(``csrc/fused_polymul.cu``).  ``plan(..., device="cpu")`` runs the
plain-PyTorch versions.  The package imports neither JAX nor ``repro``.
"""
from repro_torch.api import (
    BACKENDS,
    Plan,
    PlanConfig,
    from_limbs,
    negacyclic_mul,
    plan,
    plan_key,
    polymul,
    polymul_ints,
    to_segments,
)
from repro_torch.errors import PlanError, UnknownKnobError, UnservableConfigError

__all__ = [
    "BACKENDS",
    "Plan",
    "PlanConfig",
    "PlanError",
    "UnknownKnobError",
    "UnservableConfigError",
    "from_limbs",
    "negacyclic_mul",
    "plan",
    "plan_key",
    "polymul",
    "polymul_ints",
    "to_segments",
]
