"""Parameter sets tying together prime search, NTT tables and RNS plans
(PyTorch port of ``repro.core.params``).

The paper's preferred hardware config is t=6, v=30, n=4096 (a 180-bit q).
The port serves the int64 width (v <= 31); ``tables`` is None above it.
``backend`` is the datapath :func:`repro_torch.api.plan_from_params`
takes when its caller names none (a :data:`repro_torch.BACKENDS` entry
or ``"auto"``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import ntt as ntt_mod
from repro_torch.core import primes as primes_mod
from repro_torch.core import rns as rns_mod


@dataclasses.dataclass(frozen=True)
class ParenttParams:
    n: int
    v: int
    t: int
    primes: tuple[primes_mod.SpecialPrime, ...]
    plan: rns_mod.RnsPlan
    tables: ntt_mod.ChannelTables | None  # None for v > 31
    backend: str = "auto"  # default datapath of plan_from_params

    @property
    def q(self) -> int:
        return self.plan.q

    @property
    def qs(self):
        return self.plan.qs

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def with_backend(self, backend: str) -> "ParenttParams":
        from repro_torch.kernels.ops import validate_backend  # ops imports this module

        if backend != "auto":
            validate_backend(backend)
        return dataclasses.replace(self, backend=backend)


@functools.lru_cache(maxsize=None)
def _make_params_base(n: int, t: int, v: int, device: str) -> ParenttParams:
    specials = primes_mod.default_prime_set(n, t, v)
    qs = [s.q for s in specials]
    plan = rns_mod.make_plan(
        qs, n=n, v=v, beta_terms=[s.beta_terms for s in specials], device=device
    )
    tables = ntt_mod.make_channel_tables(qs, n, device=device) if v <= 31 else None
    return ParenttParams(n=n, v=v, t=t, primes=specials, plan=plan, tables=tables)


def make_params(n: int = 4096, t: int = 6, v: int = 30, device="cpu") -> ParenttParams:
    """Build (cached per device) params: primes, RNS plan and NTT tables,
    with their device copies uploaded once; ``with_backend`` variants
    share them."""
    return _make_params_base(n, t, v, str(torch.device(device)))
