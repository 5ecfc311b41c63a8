"""PaReNTT on PyTorch + CUDA: the port of the JAX package ``repro`` to an
NVIDIA H100 (the int64-width multiplier and its stage entry points).

    import repro_torch

    pl = repro_torch.plan(n=4096, t=6, v=30)   # tables uploaded to the card
    limbs = repro_torch.polymul(pl, za, zb)    # (..., n, S) -> (..., n, L)

The main path runs one hand-written CUDA kernel
(``csrc/fused_e2e_polymul.cu``; past one CTA, n = 32768 and 65536, its
multi-block form ``csrc/fused_e2e_polymul_fs.cu``); the residue-domain product
:func:`negacyclic_mul` runs the fused cascade kernel
(``csrc/fused_polymul.cu``), and :func:`ntt`, :func:`intt`,
:func:`decompose` and :func:`compose` run the stage kernels
(``csrc/ntt_channels.cu``, ``intt_channels.cu``, ``decompose.cu``,
``compose.cu``), as does every stage of ``backend="cuda"``.
``plan(..., device="cpu")`` runs the plain-PyTorch versions.
:func:`execute` is :func:`polymul` under the serving signature, and
:func:`plan_from_params` wraps an existing ``ParenttParams``.

The BFV layer of the paper's HE applications sits on these entry points:
:mod:`repro_torch.core.bfv` (``make_context``, ``keygen``, ``encrypt``,
``decrypt``, ``add``, ``add_many``, ``mul_plain``, ``noise_budget_bits``;
every product on :func:`negacyclic_mul`, every decrypt on
:func:`compose`), the host bigint reference with ct x ct multiplication
:mod:`repro_torch.core.bfv_ref`, HE gradient aggregation
:mod:`repro_torch.train.aggregation`, and the example
``python -m repro_torch.examples.encrypted_inference``.  The package
imports neither JAX nor ``repro``.
"""
from repro_torch.api import (
    BACKENDS,
    Plan,
    PlanConfig,
    ScheduleSpec,
    compose,
    decompose,
    execute,
    from_limbs,
    intt,
    negacyclic_mul,
    ntt,
    plan,
    plan_from_params,
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
    "ScheduleSpec",
    "UnknownKnobError",
    "UnservableConfigError",
    "compose",
    "decompose",
    "execute",
    "from_limbs",
    "intt",
    "negacyclic_mul",
    "ntt",
    "plan",
    "plan_from_params",
    "plan_key",
    "polymul",
    "polymul_ints",
    "to_segments",
]
