"""Constants carried across from the reference package.

:func:`tables_from_reference` builds the port's :class:`ChannelTables`
and :class:`RnsPlan` from a reference plan's constants exported as numpy
arrays, so both packages can run on identical constants; the tests use
it to hold the port's own host-built tables against the reference's.
The port never imports the reference: the caller does the export.

Keys of ``arrays`` (int64 numpy arrays, reference names):

* NTT tables: ``qs`` (t,), ``fwd``/``inv`` (t, n), ``half`` (t,), and,
  where the configuration has them, ``mul_eps`` (t,) and
  ``fwd_shoup``/``inv_shoup`` (t, n);
* four-step tables (n >= 4): ``fs_row_fwd``/``fs_row_inv`` (t, n2, n1),
  ``fs_sub_fwd``/``fs_sub_inv`` (a tuple of (t, r_l, c_l) per level of the
  chain beyond the first), and, with the Shoup tables,
  ``fs_row_fwd_shoup``/``fs_row_inv_shoup`` and
  ``fs_sub_fwd_shoup``/``fs_sub_inv_shoup``; each one missing is gathered
  from the stage tables as :func:`repro_torch.core.ntt.four_step_tables`
  builds it;
* decompose circuits (``repro.kernels.crt.plan_dec_arrays`` layout):
  ``sau_eps``, ``sau_s2``, ``acc_eps`` (t,), ``beta_e``/``beta_s``
  (t, terms), ``block_consts`` (t, n_blocks);
* compose: ``qi_tilde`` (t,), ``qi_star_limbs`` (t, L), ``q_limbs`` (L,).

A wide plan (31 < v <= 46) has none of these: its constants are the
reference's ``Plan.consts`` leaves, which :func:`tables_from_reference`
takes when ``arrays`` holds ``wide_fwd`` and returns as a wide plan's
``consts`` (:func:`wide_consts_from_reference`):

* ``wide_fwd``/``wide_inv`` (t, n): plain int64 twiddle tables;
* ``wide_beta_pows`` (t, S): B^k mod q_i; ``wide_qi_tilde`` (t,);
* ``wide_qi_star_limbs`` (t, L14) and ``wide_q_limbs`` (L14,): q / q_i and
  q in base-2^14 (``repro_torch.core.wide.POST_W``) limbs;
* ``wide_qs`` and ``wide_betas`` (t,): q_i = 2^v - beta_i.

:func:`params_from_reference` turns an LM's parameters exported from the
reference (``repro.models.model.init_params``, as nested dicts of numpy
arrays with the stacked leading layer axis) into the port's parameters.
"""
from __future__ import annotations

import numpy as np

import torch

from repro_torch.core import bigint, modmath, wide
from repro_torch.core.ntt import ChannelTables, four_step_tables
from repro_torch.core.rns import ChannelDecompose, RnsPlan
from repro_torch.models import layers, transformer

W = 28  # output limb width of the int64 width
T_PRIME = 3  # Alg-2 block width


def _get(arrays: dict, key: str) -> np.ndarray | None:
    x = arrays.get(key)
    return None if x is None else np.asarray(x, dtype=np.int64)


WIDE_KEYS = ("wide_fwd", "wide_inv", "wide_beta_pows", "wide_qi_tilde", "wide_qi_star_limbs",
             "wide_q_limbs", "wide_qs", "wide_betas")


def wide_consts_from_reference(arrays: dict[str, np.ndarray],
                               device="cpu") -> dict[str, torch.Tensor]:
    """A wide plan's ``consts`` on ``device`` from the reference's wide
    leaves (every key of :data:`WIDE_KEYS`), checked for consistency: the
    limbs spell prod(q_i) and q / q_i, q_i = 2^v - beta_i, and the twiddle
    tables are (t, n) residues below each q_i."""
    c = {k: _get(arrays, k) for k in WIDE_KEYS}
    missing = [k for k, x in c.items() if x is None]
    if missing:
        raise ValueError(f"wide constants missing: {missing}")
    qs, betas = c["wide_qs"], c["wide_betas"]
    t = qs.shape[0]
    v = max(int(q).bit_length() for q in qs)
    if any(int(q) != (1 << v) - int(b) for q, b in zip(qs, betas)):
        raise ValueError("wide_qs are not 2^v - wide_betas")
    if c["wide_fwd"].shape != c["wide_inv"].shape or c["wide_fwd"].shape[0] != t:
        raise ValueError(f"wide twiddles of shape {c['wide_fwd'].shape} for t={t}")
    if not (c["wide_fwd"] < qs[:, None]).all() or not (c["wide_inv"] < qs[:, None]).all():
        raise ValueError("wide twiddles are not residues of their channels")
    q = 1
    for qi in qs:
        q *= int(qi)
    if bigint.limbs_to_int(c["wide_q_limbs"], wide.POST_W) != q:
        raise ValueError("wide_q_limbs do not spell prod(qs) in base 2^14")
    stars = [bigint.limbs_to_int(row, wide.POST_W) for row in c["wide_qi_star_limbs"]]
    if stars != [q // int(qi) for qi in qs]:
        raise ValueError("wide_qi_star_limbs do not spell q / q_i in base 2^14")
    return {k: torch.tensor(x, device=device) for k, x in c.items()}


def tables_from_reference(arrays: dict[str, np.ndarray], device="cpu"):
    """(ChannelTables, RnsPlan) on ``device`` from exported reference
    constants (see the module docstring for the keys); for a wide plan's
    leaves (``wide_fwd`` present) its ``consts`` dict
    (:func:`wide_consts_from_reference`)."""
    if "wide_fwd" in arrays:
        return wide_consts_from_reference(arrays, device)
    qs = _get(arrays, "qs")
    fwd, inv = _get(arrays, "fwd"), _get(arrays, "inv")
    t, n = fwd.shape
    # special primes q = 2^v - beta have exactly v bits
    v = max(int(q).bit_length() for q in qs)
    eps = _get(arrays, "mul_eps")
    shifts = None
    if eps is not None:
        b = int(qs[0]).bit_length()
        shifts = (b - 1, b + 1)
    fwd_shoup, inv_shoup = _get(arrays, "fwd_shoup"), _get(arrays, "inv_shoup")
    window = beta = None
    if fwd_shoup is not None:
        window, beta = modmath.lazy_params(qs)
    four = four_step_tables(fwd, inv, fwd_shoup, inv_shoup)
    for key in four:
        given = arrays.get(key)
        if given is not None:
            four[key] = (tuple(np.asarray(x, dtype=np.int64) for x in given)
                         if isinstance(four[key], tuple) else _get(arrays, key))
    tables = ChannelTables(
        qs=qs, fwd=fwd, inv=inv, half=_get(arrays, "half"), mul_eps=eps,
        mul_shifts=shifts, fwd_shoup=fwd_shoup, inv_shoup=inv_shoup,
        lazy_window=window, shoup_beta=beta, device=device, **four,
    )

    q = 1
    for qi in qs:
        q *= int(qi)
    q_limbs = _get(arrays, "q_limbs")
    if bigint.limbs_to_int(q_limbs, W) != q:
        raise ValueError("q_limbs do not spell prod(qs) in base 2^28")
    seg_count = -(-q.bit_length() // v)
    beta_e, beta_s = _get(arrays, "beta_e"), _get(arrays, "beta_s")
    beta_terms = tuple(
        tuple((int(e), int(s)) for e, s in zip(beta_e[i], beta_s[i]) if s != 0)
        for i in range(t)
    )
    block_consts = _get(arrays, "block_consts")
    sau_eps, sau_s2, acc_eps = (_get(arrays, k) for k in ("sau_eps", "sau_s2", "acc_eps"))
    dec = tuple(
        ChannelDecompose(
            qi=int(qs[i]),
            beta_terms=beta_terms[i],
            block_consts=tuple(int(c) for c in block_consts[i]),
            sau_barrett=(int(sau_eps[i]), v - 1, int(sau_s2[i])),
            acc_barrett=(int(acc_eps[i]), v - 1, 4),
        )
        for i in range(t)
    )
    plan = RnsPlan(
        n=n, v=v, t=t, q=q, qs=qs, beta_terms=beta_terms, seg_count=seg_count,
        beta_pows=np.array(
            [[pow(1 << v, k, int(qi)) for k in range(seg_count)] for qi in qs], dtype=np.int64
        ),
        t_prime=T_PRIME, block_consts=block_consts, w=W, L=q_limbs.shape[0],
        qi_tilde=_get(arrays, "qi_tilde"), qi_star_limbs=_get(arrays, "qi_star_limbs"),
        q_limbs=q_limbs, dec=dec, device=device,
    )
    return tables, plan


# the reference's per-layer trees, stacked on a leading layer axis
STACKED = ("layers", "mamba_layers", "encoder", "decoder")


def params_from_reference(cfg, tree: dict, device="cpu") -> dict:
    """The port's LM parameters on ``device`` from the reference's param
    pytree of ``cfg`` as nested dicts of numpy arrays.  Each stacked tree
    (``STACKED``) becomes a list of per-layer dicts, its leading axis cut;
    every array becomes a float32 tensor, except the weights of
    ``layers.CAST_AT_USE`` (the experts' among them), which become
    ``layers.CDTYPE`` ones.  Raises ValueError where a stack's length is
    not ``cfg.n_layers``, or, for the ``layers`` of a transformer that
    interleaves dense and MoE layers (``moe_every == 2``), not its
    n_layers / 2 super-blocks."""

    def leaf(name: str, x) -> torch.Tensor:
        dtype = layers.CDTYPE if name in layers.CAST_AT_USE else torch.float32
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)

    def convert(node, name=""):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        return leaf(name, node)

    def unstack(node, i):
        if isinstance(node, dict):
            return {k: unstack(v, i) for k, v in node.items()}
        return node[i]

    def depth(node):
        return depth(next(iter(node.values()))) if isinstance(node, dict) else len(node)

    out = {}
    for key, node in tree.items():
        if key in STACKED:
            n = depth(node)
            want = transformer.stack_depth(cfg) if key == "layers" else cfg.n_layers
            if n != want:
                raise ValueError(f"{key}: {n} layers stacked, {cfg.name} has {want}")
            out[key] = [convert(unstack(node, i)) for i in range(n)]
        else:
            out[key] = convert(node, key)
    return out
