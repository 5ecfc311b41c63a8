"""Forward flash attention of the port: the CUDA kernel, its wrapper and
launch counter, and its plain PyTorch version (port of
``repro.kernels.attention``).

:func:`flash_attention_cuda` (``csrc/attention.cu``, K7) replaces the TPU
kernel ``flash_attention`` (``repro/kernels/attention.py:82``, body
``_kernel`` ``:33``): online-softmax attention with GQA, a causal mask, a
sliding window, a logit softcap, a query offset (decode) and any Sq, Skv.
The layout is the reference's: q ``(B, Sq, H, D)``, k and v
``(B, Skv, Hk, D)`` with H a multiple of Hk, out ``(B, Sq, H, D)`` in q's
dtype; scores, softmax and sums are float32.

:func:`flash_attention_ref` repeats the reference kernel's arithmetic
block by block: q scaled before ``q @ k^T``, softcap ``tanh(s/cap)*cap``,
masked scores set to the finite sentinel ``NEG_INF`` and the running max,
normaliser and accumulator updated per ``blk_k``-key block.  The sentinel
gives a query that sees no key at all (``window=8, q_offset=500,
Skv=100``) a defined answer: every score is ``NEG_INF``, so
``exp(s - m) = 1`` at all ``Skv_padded = ceil(Skv/blk_k)*blk_k``
positions and the output is ``sum(V[:Skv]) / Skv_padded``.  The kernel
takes ``Skv_padded`` from the wrapper and gives the same answer.

:func:`flash_attention` is the entry point.  The device of the tensors
decides: CPU tensors run the plain version, CUDA tensors launch the
kernel or raise.  K7 has three variants (see ``csrc/attention.cu``), and
:func:`attention_variant` picks one from (dtype, D, Sq, H / Hk) alone:
``wgmma`` (bf16 prefill on the tensor cores, P split into bf16 hi + lo),
``decode`` (bf16, at most ``DECODE_MAX_ROWS`` query rows per kv head:
split-KV with the combine in the same launch) and ``simt`` (float32 I/O,
CUDA cores).  ``flash_attention_cuda.launches`` counts the launches and
``flash_attention_cuda.variants`` the launches of each variant; nothing
else adds to them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand, ptr

DEFAULT_BLK_Q = 128
DEFAULT_BLK_K = 128
NEG_INF = -1e30  # finite: exp(-inf - -inf) would be NaN

# what the kernel is compiled for (csrc/attention.cu); 80 (zamba2-2.7b) is
# padded to 128 columns inside the kernel, never in device memory
HEAD_DIMS = (32, 64, 80, 128, 256)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("wgmma", "decode", "simt")
DECODE_MAX_ROWS = 8  # query rows (Sq * H / Hk) of one kv head the decode variant holds
DECODE_KEYS = 32  # keys per tile of the decode variant's ring
DECODE_BLOCKS_PER_SM = 2  # decode blocks one SM holds (shared memory)


def _shapes(q, k, v, fn: str) -> tuple[int, int, int, int, int, int]:
    """(B, Sq, Skv, H, Hk, D) of a q, k, v triple, or raise."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"{fn}: expected q (B, Sq, H, D) and k, v (B, Skv, Hk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, Hk, Dk = k.shape
    if Bk != B or Dk != D or Hk == 0 or H % Hk:
        raise ValueError(f"{fn}: k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(same B and D, H a multiple of Hk)")
    return B, Sq, Skv, H, Hk, D


def padded_keys(skv: int, blk_k: int) -> int:
    """Skv rounded up to whole ``blk_k`` blocks: the count a query that
    sees no key divides by."""
    return -(-skv // blk_k) * blk_k


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None, softcap: float = 0.0,
                        q_offset: int = 0, blk_k: int = DEFAULT_BLK_K) -> torch.Tensor:
    """Plain version of K7, on any device: the reference kernel's online
    softmax over ``blk_k``-key blocks in float32, one kv head (its H/Hk
    query heads) at a time, so that no (Sq, Skv) score matrix exists."""
    B, Sq, Skv, H, Hk, D = _shapes(q, k, v, "flash_attention_ref")
    g = H // Hk
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    out = torch.empty_like(q)
    for hk in range(Hk):
        qh = q[:, :, hk * g:(hk + 1) * g].transpose(1, 2).float() * scale  # (B, g, Sq, D)
        m = torch.full((B, g, Sq), NEG_INF, device=dev)
        l = torch.zeros((B, g, Sq), device=dev)
        acc = torch.zeros((B, g, Sq, D), device=dev)
        for j0 in range(0, padded_keys(Skv, blk_k), blk_k):
            kb = k[:, j0:j0 + blk_k, hk].float()  # (B, <= blk_k, D)
            vb = v[:, j0:j0 + blk_k, hk].float()
            pad = blk_k - kb.shape[1]  # the reference pads Skv with zeros
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))[:, None]
            vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))[:, None]
            s = qh @ kb.transpose(-1, -2)  # (B, g, Sq, blk_k)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            k_pos = j0 + torch.arange(blk_k, device=dev)[None, :]
            mask = k_pos < Skv
            if causal:
                mask = mask & (k_pos <= q_pos)
            if window:
                mask = mask & (k_pos > q_pos - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vb
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, :, hk * g:(hk + 1) * g] = o.transpose(1, 2).to(q.dtype)
    return out


def attention_variant(dtype: torch.dtype, D: int, Sq: int, group: int) -> str:
    """The K7 variant that serves q of ``dtype`` with head dim ``D``, ``Sq``
    query rows and ``group`` = H / Hk query heads per kv head: ``simt``
    for float32, ``decode`` for bf16 with at most ``DECODE_MAX_ROWS``
    rows per kv head, ``wgmma`` for the other bf16 shapes."""
    if dtype not in KERNEL_DTYPES or D not in HEAD_DIMS:
        raise ValueError(f"no K7 variant takes {dtype} at head dim {D}")
    if dtype == torch.float32:
        return "simt"
    return "decode" if Sq * group <= DECODE_MAX_ROWS else "wgmma"


@functools.lru_cache(maxsize=256)  # every decode step of a model asks again
def decode_splits(B: int, Hk: int, Skv: int, n_sm: int) -> tuple[int, int]:
    """(key splits, ``DECODE_KEYS``-key tiles per split) of the decode
    variant: at least one block per resident slot of the card (two waves
    of its SMs), at least 8 tiles a split, and of those the count whose
    last wave is fullest (the fewest splits on a tie)."""
    tiles = max(1, -(-Skv // DECODE_KEYS))
    slots = DECODE_BLOCKS_PER_SM * n_sm
    # (splits, tiles a split) for every split size of at least 8 tiles
    cuts = {-(-tiles // per): per for per in range(tiles, min(8, tiles) - 1, -1)}
    counts = [n for n in cuts if B * Hk * n >= slots] or [max(cuts)]

    def fill(n):  # share of the last wave's slots that hold a block
        blocks = B * Hk * n
        return blocks / (-(-blocks // slots) * slots)

    best = max(counts, key=lambda n: (fill(n), -n))
    return best, cuts[best]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_LL] * 3 + [_F] * 2 + [_P]
_DECODE_ARGTYPES = _ARGTYPES[:-1] + [_P, _P, _I, _I, _P]
_ENTRY = {"wgmma": "parentt_attention_wgmma", "decode": "parentt_attention_decode",
          "simt": "parentt_attention_simt"}
_counters: dict[torch.device, torch.Tensor] = {}  # decode: one int32 per (batch, kv head)
_sm_count: dict[torch.device, int] = {}


def _decode_counters(device: torch.device, n: int) -> torch.Tensor:
    """The decode combine's counters on ``device``, allocated once (and
    again only to grow); the kernel leaves them at zero."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = _counters[device] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return buf


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None, softcap: float = 0.0,
                         q_offset: int = 0, blk_k: int = DEFAULT_BLK_K) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hk, D) -> (B, Sq, H, D) in one launch
    of ``csrc/attention.cu`` on the current stream, of the variant
    :func:`attention_variant` names.  CPU tensors run the plain version.
    The kernel takes float32 or bfloat16 (all three alike), D in
    ``HEAD_DIMS`` and 16-byte aligned contiguous operands."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset, blk_k=blk_k)
    fn_name = "flash_attention_cuda"
    B, Sq, Skv, H, Hk, D = _shapes(q, k, v, fn_name)
    check_operand(q, (B, Sq, H, D), "q", fn_name, KERNEL_DTYPES)
    check_operand(k, (B, Skv, Hk, D), "k", fn_name, (q.dtype,))
    check_operand(v, (B, Skv, Hk, D), "v", fn_name, (q.dtype,))
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn_name}: head dim {D} is not one of {HEAD_DIMS}")
    if H > 65535 or B > 65535:
        raise ValueError(f"{fn_name}: H={H} and B={B} must stay below 65536 (grid limits)")
    variant = attention_variant(q.dtype, D, Sq, H // Hk)
    argtypes = _DECODE_ARGTYPES if variant == "decode" else _ARGTYPES
    launch = _build.load("attention", _ENTRY[variant], argtypes)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = [ptr(q), ptr(k), ptr(v), ptr(out), B, Sq, Skv, H, Hk, D, int(bool(causal)),
            int(window or 0), int(q_offset), padded_keys(Skv, blk_k), 1.0 / math.sqrt(D),
            float(softcap)]
    if variant == "decode":
        if q.device not in _sm_count:
            _sm_count[q.device] = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split, per = decode_splits(B, Hk, Skv, _sm_count[q.device])
        part = torch.empty(B * Hk * n_split * Sq * (H // Hk) * (D + 2), dtype=torch.float32,
                           device=q.device)
        args += [ptr(part), ptr(_decode_counters(q.device, B * Hk)), n_split, per]
    with torch.cuda.device(q.device):
        code = launch(*args, _build.stream_of(q))
    _build.check("attention", code)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variants[variant] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.variants = dict.fromkeys(VARIANTS, 0)


def flash_attention(q, k, v, *, causal: bool = True, window=None, softcap: float = 0.0,
                    q_offset: int = 0, blk_q: int = DEFAULT_BLK_Q,
                    blk_k: int = DEFAULT_BLK_K) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hk, D) -> (B, Sq, H, D), as the
    reference's ``flash_attention``.

    ``window`` None or 0 is global attention; ``q_offset`` is the absolute
    position of q[0] (decode: the cache fill level).  ``blk_q`` changes
    nothing in the result (query rows are independent) and is taken for
    the reference's signature; ``blk_k`` sets the padded key count a query
    that sees no key divides by.  CPU tensors run the plain version, CUDA
    tensors one launch of K7."""
    _shapes(q, k, v, "flash_attention")
    if blk_q < 1 or blk_k < 1:
        raise ValueError(f"flash_attention: blk_q={blk_q} and blk_k={blk_k} must be positive")
    return flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=int(window) if window else None, softcap=float(softcap),
        q_offset=int(q_offset), blk_k=blk_k,
    )


def hbm_bytes_per_call(B, Sq, Skv, H, Hk, D, *, blk_q=1024, itemsize=2):
    """Analytic HBM traffic of a production variant of this kernel (the
    reference's model, ``repro/kernels/attention.py:151``): Q and O touched
    once; K/V streamed once per q-block with the whole GQA group processed
    together, so no H/Hk re-read factor.  With ``blk_q >= Sq`` every
    operand moves once: the byte side of K7's bound in ``chip_smoke.py``.

    Compare against the materialized path: the (B, H, Sq, Skv) f32 score
    tensor alone is written once and read twice (softmax, PV)."""
    q_bytes = B * Sq * H * D * itemsize
    o_bytes = q_bytes
    kv_reuse = -(-Sq // blk_q)  # K/V re-read once per q-block
    kv_bytes = 2 * B * Skv * Hk * D * itemsize * kv_reuse
    return q_bytes + o_bytes + kv_bytes
