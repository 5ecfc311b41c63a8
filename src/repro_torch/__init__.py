"""PaReNTT on PyTorch + CUDA: the port of the JAX package ``repro`` to an
NVIDIA H100 (the multiplier at every width, its stage entry points, and
the batching engine that serves it).

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
:func:`plan_from_params` wraps an existing ``ParenttParams``.  Past
v = 31 a plan takes the wide width (v <= 46: the digit-split datapath of
:mod:`repro_torch.core.wide`, plain PyTorch on the plan's device) or the
oracle width (exact host Python ints); :func:`width_for` names it.

:mod:`repro_torch.serve` batches many small products into one dispatch
per plan (``PolymulEngine``: deadlines, backpressure, retries, a circuit
breaker down ``cuda_fused_e2e -> cuda_fused -> cuda``), with metrics and
request spans in :mod:`repro_torch.obs` and the launchers
``python -m repro_torch.launch.serve_crypto``, ``serve_soak`` and
``obs_report``.

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
    ORACLE_BACKEND,
    WIDE_BACKEND,
    WIDTHS,
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
    width_for,
)
from repro_torch.errors import (
    BackendFailedError,
    DeadlineExceededError,
    EngineError,
    PlanError,
    QueueFullError,
    UnknownKnobError,
    UnservableConfigError,
)

__all__ = [
    "BACKENDS",
    "BackendFailedError",
    "DeadlineExceededError",
    "EngineError",
    "ORACLE_BACKEND",
    "Plan",
    "PlanConfig",
    "PlanError",
    "QueueFullError",
    "ScheduleSpec",
    "UnknownKnobError",
    "UnservableConfigError",
    "WIDE_BACKEND",
    "WIDTHS",
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
    "width_for",
]
