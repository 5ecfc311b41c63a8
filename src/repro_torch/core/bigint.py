"""Multi-limb big-integer helpers (PyTorch port of ``repro.core.bigint``).

Big integers are last-axis tensors of limbs, least-significant first:
base-``2^v`` segments on the way in, base-``2^w`` limbs (w = 28) on the way
out.  The host helpers convert exactly through Python ints; the tensor
ops work on int64 tensors on any device.
"""
from __future__ import annotations

import numpy as np
import torch


def int_to_limbs(x: int, width: int, count: int) -> np.ndarray:
    if x < 0:
        raise ValueError(f"int_to_limbs takes non-negative ints, got {x}")
    mask = (1 << width) - 1
    out = np.zeros(count, dtype=np.int64)
    for i in range(count):
        out[i] = x & mask
        x >>= width
    if x:
        raise ValueError("limb count too small")
    return out


def ints_to_limbs(xs, width: int, count: int) -> np.ndarray:
    return np.stack([int_to_limbs(int(x), width, count) for x in xs])


def limbs_to_int(limbs, width: int) -> int:
    x = 0
    for i, l in enumerate(np.asarray(limbs).tolist()):
        x += int(l) << (width * i)
    return x


def limbs_to_ints(arr, width: int) -> list[int]:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    return [limbs_to_int(row, width) for row in arr.reshape(-1, arr.shape[-1])]


# --------------------------------------------------------------------------
# tensor limb ops (last axis = limbs, LSB first)
# --------------------------------------------------------------------------


def carry_normalize(x: torch.Tensor, width: int) -> torch.Tensor:
    """Propagate carries so every limb < 2^width (one running-carry pass;
    the caller sizes L so the final carry is zero)."""
    mask = (1 << width) - 1
    outs = []
    carry = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        s = x[..., i] + carry
        outs.append(s & mask)
        carry = s >> width
    return torch.stack(outs, dim=-1)


def compare_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b lexicographically from the most-significant limb (normalized
    inputs); bool over the leading dims."""
    ge = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    decided = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1] - 1, -1, -1):
        ai, bi = a[..., i], b[..., i]
        gt = ai > bi
        lt = ai < bi
        ge = torch.where(~decided & gt, True, ge)
        ge = torch.where(~decided & lt, False, ge)
        decided = decided | gt | lt
    return ge


def sub_limbs(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """a - b (requires a >= b), normalized limbs, with borrow propagation."""
    outs = []
    borrow = torch.zeros_like(a[..., 0])
    base = 1 << width
    for i in range(a.shape[-1]):
        d = a[..., i] - b[..., i] - borrow
        neg = d < 0
        outs.append(torch.where(neg, d + base, d))
        borrow = neg.to(a.dtype)
    return torch.stack(outs, dim=-1)


def cond_sub(a: torch.Tensor, m: torch.Tensor, width: int) -> torch.Tensor:
    """If a >= m subtract m, else keep a.  Normalized limbs."""
    ge = compare_ge(a, m)
    return torch.where(ge[..., None], sub_limbs(a, m, width), a)


def mod_by_subtraction(
    a: torch.Tensor, m: torch.Tensor, width: int, times: int
) -> torch.Tensor:
    """a mod m when a < (times+1) * m, via ``times`` conditional
    subtractions (the paper's post-processing tail)."""
    for _ in range(times):
        a = cond_sub(a, m, width)
    return a
