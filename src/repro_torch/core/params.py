"""Parameter sets tying together prime search, NTT tables and RNS plans
(PyTorch port of ``repro.core.params``).

The paper's preferred hardware configs are t=6, v=30, n=4096 (a 180-bit
q) and the wide-word t=4, v=45.  Params carry v up to 60, as the
reference's do: the RNS plan's int64 constants (q_i, B^k mod q_i, q~_i,
the base-2^28 limbs) are exact at every such v, while ``tables`` (the
int64 kernels' NTT tables) is None above v = 31, where the wide and
oracle widths of :mod:`repro_torch.api` build their own.
``backend`` is the datapath :func:`repro_torch.api.plan_from_params`
takes when its caller names none (a :data:`repro_torch.BACKENDS` entry
or ``"auto"``), and ``schedule`` the NTT stage schedule it resolves
(:data:`repro_torch.core.schedule.SCHEDULE_STRINGS`, default ``"auto"``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import ntt as ntt_mod
from repro_torch.core import primes as primes_mod
from repro_torch.core import rns as rns_mod
from repro_torch.core.schedule import parse_schedule


@dataclasses.dataclass(frozen=True)
class ParenttParams:
    n: int
    v: int
    t: int
    primes: tuple[primes_mod.SpecialPrime, ...]
    plan: rns_mod.RnsPlan
    tables: ntt_mod.ChannelTables | None  # None for v > 31 (the wide and oracle widths)
    backend: str = "auto"  # default datapath of plan_from_params
    schedule: str = "auto"  # NTT stage schedule of plan_from_params

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

    def with_schedule(self, schedule: str) -> "ParenttParams":
        parse_schedule(schedule)
        return dataclasses.replace(self, schedule=schedule)


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
