"""The port's MoE path on the CPU against the JAX package's: ``moe_apply``
(``repro_torch.models.layers``), the transformer's MoE branches (dbrx's
every-layer MoE, llama4-maverick's dense + MoE super-blocks), the
``Engine`` on reduced dbrx, and ``convert.params_from_reference`` on the
MoE trees.  The reduced configurations run with the reference's parameters
carried over by ``convert.params_from_reference`` and numpy-seeded inputs.

What is held, and to what:

* The slot tensor (each assignment's expert slot, or the sentinel E*C
  that drops it) exactly equal to the reference's, in bf16 and with
  float32 compute: at the default capacity, at capacity factor 0.25
  (tokens dropped; a port that granted capacity in (k, s) order would
  drop others, and the test shows it would), with a router built to tie
  (three experts with an all-zero column score exactly alike, so
  ``jax.lax.top_k``'s rule, the lower index first, decides) and with
  llama4's shared expert.
* ``moe_apply``'s output: with float32 compute in both packages within
  ``F32_TOL`` (1e-4, test_torch_models.py's), and in bf16 within the
  layers' bound there, 2e-2, taken of the output's largest |value|: the
  reduced experts' init (scale 1 / sqrt(E), the reference's) makes
  outputs of some hundreds, where one bf16 step is 2-4 (measured up to
  0.0074 of the largest value, 0.0033 RMS).
* Each arch's whole ``forward`` and ``decode_step`` (3 tokens into a
  seeded cache filled to 5, the cache written): float32 compute within
  ``F32_TOL``, the routing of every MoE layer the same; bf16 within
  test_torch_models.py's ``BF16_MAX`` / ``BF16_RMS``, at every position
  of the forward whose routing (each of its K experts, or dropped) is the
  same in both packages in every layer.  Routing is discontinuous: the
  two frameworks round bf16 at other places, and where two experts'
  scores lie within that rounding the choice can flip, which moves that
  token's output by the whole of an expert's.  Measured: 1 of the 40
  positions flips at reduced dbrx (layer 1; its logits 2.05 apart,
  0.52 of the largest) and 2 at llama4 (5.19 apart); ``MAX_FLIPS``
  bounds the count, and every flip is a near tie (``TIE_GAP``) or a
  capacity drop that a near tie moved.  The engine's test holds the
  slots whose routing has not parted.
* ``Engine`` on reduced dbrx against the reference's engine, as
  test_torch_lm_serve.py holds gemma2 and yi.

The reference's runs are traced one after another and compiled in
parallel threads at XLA's backend optimisation level 0, as
test_torch_models.py does; every bound here holds at the default level too.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import engine as jengine
from repro.sharding import ctx as jctx

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import Engine
from repro_torch.sharding import ctx as tctx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
# test_torch_models.py's bounds, for the same reasons
F32_TOL = 1e-4
LAYER_TOL = 2e-2
BF16_MAX, BF16_RMS = 0.06, 0.04
# test_torch_lm_serve.py's engine bounds
ENGINE_MAX, ENGINE_RMS = 0.02, 0.02
XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0}
MAX_FLIPS = 3  # of the forward's 40 positions whose bf16 routing may differ
# a flipped position's K-th and (K+1)-th router probabilities in the port lie
# within this of each other (measured 3.6e-4 at dbrx, 1.2e-4 at llama4,
# against medians of 0.022-0.074), or only its dropping changed
TIE_GAP = 2e-3
ENGINE_MAX_DIVERGED = 2  # of the engine's 4 slots whose routing may part
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
CACHE_POS = 5

# case -> (arch, config changes, tied router): layer 0's MoE block of the arch
MOE_CASES = {
    "default": ("dbrx-132b", {}, False),
    "drop": ("dbrx-132b", dict(capacity_factor=0.25), False),
    "tied": ("dbrx-132b", dict(top_k=3), True),
    "shared": ("llama4-maverick-400b-a17b", {}, False),
}


def _cfgs(arch: str, changes: dict | None = None):
    changes = changes or {}
    return (dataclasses.replace(jreg.get(arch).reduced(), **changes),
            dataclasses.replace(treg.get(arch).reduced(), **changes))


def _moe_params(tree: dict, arch: str) -> dict:
    """Layer 0's MoE ffn of a param tree (the reference's stacked arrays
    or the port's lists)."""
    layers = tree["layers"]
    if isinstance(layers, list):
        layers = layers[0]
        return (layers["moe"] if "moe" in layers else layers)["ffn"]
    block = layers["moe"] if "moe" in layers else layers
    return jax.tree.map(lambda a: a[0], block["ffn"])


def _moe_inputs(case: str) -> dict:
    """x (2, 20, D) and, for the tied case, a router whose columns 1..E-1
    are zero: those experts' logits are exactly 0 for every token."""
    arch, _, tied = MOE_CASES[case]
    cfg = treg.get(arch).reduced()
    rng = np.random.default_rng(11 + list(MOE_CASES).index(case))
    out = {"x": rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)}
    if tied:
        router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
        router[:, 0] = rng.normal(size=cfg.d_model) * 0.05
        out["router"] = router
    return out


def _batch(cfg, B=2, S=20, seed=0):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jnp.asarray(tokens), torch.as_tensor(tokens)


def _random_cache(cfg, seed: int = 3):
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in TM.init_cache(cfg, 2, 16).items() if k != "pos"}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _float32_compute(monkeypatch, packages=("jax", "torch")):
    for package in packages:
        mod, dt = (JL, jnp.float32) if package == "jax" else (TL, torch.float32)
        monkeypatch.setattr(mod, "CDTYPE", dt)


def _recording(mod, monkeypatch, seen: list):
    """``mod.moe_scatter`` recording each call's slot tensor."""
    orig = mod.moe_scatter

    def rec(slot, xk, n_rows):
        seen.append(slot)
        return orig(slot, xk, n_rows)

    monkeypatch.setattr(mod, "moe_scatter", rec)


# arch -> the slot tensors of the reference's bf16 forward, one a MoE layer,
# in order (jax.debug.callback from inside its scan)
_FORWARD_SLOTS: dict[str, list] = {}


def _decisions(slot, E: int, C: int, K: int) -> np.ndarray:
    """(B, S, K) expert of each assignment, -1 where dropped."""
    slot = np.asarray(slot)
    return np.where(slot < E * C, slot // C, -1).reshape(slot.shape[0], -1, K)


def _lowered(arch: str):
    """The reference's side of one arch as ONE jitted call, lowered, and its
    arguments: its params, and in bf16 and with float32 compute the forward
    logits, one decode_step of 3 tokens into a seeded cache filled to
    CACHE_POS (logits and cache), and each of the arch's MOE_CASES'
    (moe_apply output, slot tensor)."""
    jcfg = jreg.get(arch).reduced()
    cases = {c: _moe_inputs(c) for c, (a, _, _) in MOE_CASES.items() if a == arch}

    def run(key, tokens, cache, inputs):
        params = JM.init_params(key, jcfg)
        out = {}
        for name, (jdt, _) in DTYPES.items():
            with pytest.MonkeyPatch.context() as mp:
                if name == "f32":
                    _float32_compute(mp, ("jax",))
                c = {k: v.astype(jdt) for k, v in cache.items()}
                c["pos"] = jnp.asarray(CACHE_POS, jnp.int32)
                logits, new_cache = JM.decode_step(params, jcfg, c, {"tokens": tokens[:, :3]})
                with pytest.MonkeyPatch.context() as fwd:
                    if name == "bf16":
                        orig = jctx.moe_scatter
                        slots = _FORWARD_SLOTS.setdefault(arch, [])

                        def rec(slot, xk, n_rows):
                            jax.debug.callback(lambda s: slots.append(np.asarray(s)), slot,
                                               ordered=True)
                            return orig(slot, xk, n_rows)

                        fwd.setattr(jctx, "moe_scatter", rec)
                    model = (JM.forward(params, jcfg, {"tokens": tokens}), logits, new_cache)
                moe = {}
                for case, a in inputs.items():
                    ccfg = _cfgs(arch, MOE_CASES[case][1])[0]
                    p = dict(_moe_params(params, arch))
                    if "router" in a:
                        p["router"] = a["router"]
                    seen = []
                    _recording(jctx, mp, seen)
                    moe[case] = (JL.moe_apply(p, a["x"].astype(jdt), ccfg), seen[0])
                out[name] = (model, moe)
        return params, out

    args = (jax.random.PRNGKey(0), _batch(jcfg)[0], _random_cache(treg.get(arch).reduced()), cases)
    return jax.jit(run).lower(*args), args


@functools.lru_cache(maxsize=None)
def _compiled() -> dict:
    lowered = {arch: _lowered(arch) for arch in ARCHS}
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        jobs = {arch: pool.submit(low.compile, XLA_FAST_COMPILE)
                for arch, (low, _) in lowered.items()}
        return {arch: (job.result(), lowered[arch][1]) for arch, job in jobs.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    run, args = _compiled()[arch]
    return jax.tree.map(np.asarray, run(*args))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def _port_moe(case: str, monkeypatch):
    """(output, slot) of the port's moe_apply on the case, in the compute
    type the test has set."""
    arch, changes, _ = MOE_CASES[case]
    tcfg = _cfgs(arch, changes)[1]
    p = dict(_moe_params(convert.params_from_reference(tcfg, _reference(arch)[0]), arch))
    a = _moe_inputs(case)
    if "router" in a:
        p["router"] = torch.as_tensor(a["router"])
    seen = []
    _recording(tctx, monkeypatch, seen)
    return TL.moe_apply(p, torch.as_tensor(a["x"]).to(TL.CDTYPE), tcfg), seen[0]


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case, monkeypatch):
    """moe_apply on layer 0's MoE block: the slot tensor exactly the
    reference's and the output within LAYER_TOL in bf16, then the same
    with float32 compute in both packages, the output within F32_TOL."""
    arch, changes, tied = MOE_CASES[case]
    tcfg = _cfgs(arch, changes)[1]
    E, K = tcfg.n_experts, tcfg.top_k
    C = TL.moe_capacity(20, tcfg)
    for name in DTYPES:
        with monkeypatch.context() as mp:
            if name == "f32":
                _float32_compute(mp)
            want_out, want_slot = _reference(arch)[1][name][1][case]
            got_out, got_slot = _port_moe(case, mp)
        np.testing.assert_array_equal(got_slot.numpy(), want_slot, err_msg=f"{case} {name} slot")
        got_out, want_out = _np(got_out), _np(want_out)
        if name == "f32":
            np.testing.assert_allclose(got_out, want_out, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"{case} {name}")
        else:
            scale = np.abs(want_out).max()
            assert np.abs(got_out - want_out).max() <= LAYER_TOL * scale, case
    dropped = int((want_slot == E * C).sum())
    # the tied experts overflow their capacity: some of their tokens drop
    assert (dropped > 0) == (case in ("drop", "tied")), (case, dropped)
    if case == "drop":
        # granting capacity in (k, s) order instead would drop other tokens
        x = torch.as_tensor(_moe_inputs(case)["x"]).to(TL.CDTYPE)
        p = _moe_params(convert.params_from_reference(tcfg, _reference(arch)[0]), arch)
        flat_e = TL.top_k(TL.router_probs(x, p["router"]), K)[1]  # (B, S, K)
        ks = flat_e.transpose(1, 2).reshape(2, -1)  # (k, s) order
        onehot = torch.nn.functional.one_hot(ks, E)
        pos = torch.gather(torch.cumsum(onehot, 1) - onehot, 2, ks[..., None])[..., 0]
        kept_ks = (pos < C).reshape(2, K, -1).transpose(1, 2).reshape(2, -1).numpy()
        assert (kept_ks != (want_slot < E * C)).any()
    if tied:  # experts 1..E-1 tie at every token: the lowest of them comes first
        experts = np.where(want_slot < E * C, want_slot // C, -1).reshape(2, 20, K)
        first_tied = np.where(experts[..., 0] == 0, experts[..., 1], experts[..., 0])
        assert ((first_tied == 1) | (first_tied == -1)).all()


def _port_model(arch: str, monkeypatch, slots: list, gaps: list | None = None):
    """forward logits, decode logits and the new cache of the port on the
    reference's params, in the compute type the test has set; the
    forward's slot tensors appended to ``slots``, and to ``gaps`` each of
    its layers' (B, S) gap between the K-th and (K+1)-th router
    probability."""
    tcfg = treg.get(arch).reduced()
    tp = convert.params_from_reference(tcfg, _reference(arch)[0])
    tokens = _batch(tcfg)[1]
    cache = {k: torch.as_tensor(v).to(TL.CDTYPE) for k, v in _random_cache(tcfg).items()}
    cache["pos"] = CACHE_POS
    logits, new_cache = TM.decode_step(tp, tcfg, cache, {"tokens": tokens[:, :3]})
    assert new_cache["pos"] == CACHE_POS + 3
    with monkeypatch.context() as mp:
        _recording(tctx, mp, slots)
        if gaps is not None:
            probs = TL.router_probs

            def rec(x, router):
                p = probs(x, router)
                top = torch.sort(p, dim=-1, descending=True).values
                gaps.append((top[..., tcfg.top_k - 1] - top[..., tcfg.top_k]).numpy())
                return p

            mp.setattr(TL, "router_probs", rec)
        return TM.forward(tp, tcfg, {"tokens": tokens}), logits, new_cache


def _pairs(arch: str, want, got):
    (jfwd, jlogits, jcache), (tfwd, tlogits, tcache) = want, got
    return [(f"{arch} forward", jfwd, tfwd), (f"{arch} decode_step", jlogits, tlogits),
            (f"{arch} cache k", jcache["k"], tcache["k"]),
            (f"{arch} cache v", jcache["v"], tcache["v"])]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, monkeypatch):
    """forward and decode_step (the cache it writes included) of the
    reduced arch: within the bf16 bounds as shipped at the positions whose
    routing agrees, at most MAX_FLIPS positions not, then within F32_TOL
    with float32 compute in both packages, every routing the same.
    llama4's decode writes the dense block's and the MoE block's slots of
    its one super-block."""
    cfg = treg.get(arch).reduced()
    E, K, S = cfg.n_experts, cfg.top_k, 20
    C = TL.moe_capacity(S, cfg)
    want = _reference(arch)[1]["bf16"][0]
    slots, gaps = [], []
    pairs = _pairs(arch, want, _port_model(arch, monkeypatch, slots, gaps))
    ref_slots = _FORWARD_SLOTS[arch]
    assert len(slots) == len(ref_slots) == (cfg.n_layers // cfg.moe_every)
    flipped = np.zeros((2, S), bool)
    for a, b, gap in zip(ref_slots, slots, gaps):
        a, b = _decisions(a, E, C, K), _decisions(b, E, C, K)
        flips = (a != b).any(-1)
        drops_only = ((a == b) | (a == -1) | (b == -1)).all(-1)
        assert ((gap < TIE_GAP) | drops_only)[flips].all(), (arch, gap[flips])
        flipped |= flips
    assert flipped.sum() <= MAX_FLIPS, (arch, int(flipped.sum()))
    for name, w, g in pairs:
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, name
        if name.endswith("forward"):
            g, w = g[~flipped], w[~flipped]
        err = np.abs(g - w)
        assert err.max() <= BF16_MAX * np.abs(w).max(), (name, err.max(), np.abs(w).max())
        assert np.sqrt((err ** 2).mean() / (w ** 2).mean()) <= BF16_RMS, name
    _float32_compute(monkeypatch)
    slots = []
    pairs = _pairs(arch, _reference(arch)[1]["f32"][0], _port_model(arch, monkeypatch, slots))
    for name, w, g in pairs:
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def test_params_from_reference_takes_moe_stacks():
    """llama4's stack of n_layers / 2 super-blocks is taken, and no other
    depth; dbrx's n_layers; expert and shared-expert weights become bf16,
    the router stays float32; both match the port's own init in layout."""
    for arch in ARCHS:
        tcfg = treg.get(arch).reduced()
        tree = _reference(arch)[0]
        tp = convert.params_from_reference(tcfg, tree)
        own = TM.init_params(torch.Generator().manual_seed(0), tcfg)
        layout = lambda t: jax.tree.map(lambda x: (tuple(x.shape), x.dtype), t)  # noqa: E731
        assert layout(tp) == layout(own), arch
        ffn = _moe_params(tp, arch)
        assert ffn["router"].dtype == torch.float32
        assert {ffn[k].dtype for k in ("we_gate", "we_up", "we_down")} == {torch.bfloat16}
        assert len(tp["layers"]) == tcfg.n_layers // (2 if arch.startswith("llama4") else 1)
    llama = treg.get("llama4-maverick-400b-a17b").reduced()
    tree = _reference("llama4-maverick-400b-a17b")[0]
    assert set(convert.params_from_reference(llama, tree)["layers"][0]) == {"dense", "moe"}
    doubled = dict(tree, layers=jax.tree.map(lambda a: np.concatenate([a, a]), tree["layers"]))
    with pytest.raises(ValueError, match="1"):
        convert.params_from_reference(llama, doubled)


def test_engine_matches_reference(monkeypatch):
    """Both engines on reduced dbrx, 4 prompts in 4 slots, 8 new tokens:
    each step's logits with the reference's inputs fed to the port's
    decode_step, in the slots whose routing has agreed at every step so
    far (at most ENGINE_MAX_DIVERGED of the 4 not), and the port Engine's tokens
    where the margin allows (test_torch_lm_serve.py's rule) and the slot's
    routing has agreed."""
    arch = "dbrx-132b"
    jcfg, tcfg = _cfgs(arch)
    E, K, n_moe = tcfg.n_experts, tcfg.top_k, tcfg.n_layers
    jparams = jax.tree.map(jnp.asarray, _reference(arch)[0])
    tparams = convert.params_from_reference(tcfg, _reference(arch)[0])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in (5, 3, 7, 4)]
    max_new = 8
    jeng = jengine.Engine(jcfg, jparams, batch_slots=4, max_len=32)
    decode = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b),
                     compiler_options=XLA_FAST_COMPILE)
    calls, ref_slots = [], []

    def recorded(p, c, b):
        logits, c = decode(p, c, b)
        calls.append((np.asarray(b["tokens"]), np.asarray(logits)))
        return logits, c

    orig = jctx.moe_scatter

    def rec(slot, xk, n_rows):
        jax.debug.callback(lambda s: ref_slots.append(np.asarray(s)), slot, ordered=True)
        return orig(slot, xk, n_rows)

    jeng._decode = recorded
    with monkeypatch.context() as mp:
        mp.setattr(jctx, "moe_scatter", rec)
        want = jeng.generate(prompts, max_new=max_new)
    got = Engine(tcfg, tparams, batch_slots=4, max_len=32, device="cpu").generate(
        prompts, max_new=max_new)
    assert len(calls) == 1 + max_new and [len(o) for o in got] == [max_new] * len(prompts)
    assert len(ref_slots) == n_moe * len(calls)
    cache = TM.init_cache(tcfg, 4, 32)
    bounds, agreed = [], np.ones(4, bool)
    for step, (tokens, jlogits) in enumerate(calls):
        slots = []
        with monkeypatch.context() as mp:
            _recording(tctx, mp, slots)
            tlogits, cache = TM.decode_step(tparams, tcfg, cache,
                                            {"tokens": torch.as_tensor(tokens.copy())})
        C = TL.moe_capacity(tokens.shape[1], tcfg)
        for a, b in zip(ref_slots[n_moe * step:n_moe * (step + 1)], slots):
            agreed &= ~(_decisions(a, E, C, K) != _decisions(b, E, C, K)).any((1, 2))
        tlogits, jl = tlogits.numpy()[agreed], jlogits[agreed]
        err, scale = np.abs(tlogits - jl), np.abs(jl).max()
        assert err.max() <= ENGINE_MAX * scale, (step, err.max(), scale)
        assert np.sqrt((err ** 2).mean() / (jl ** 2).mean()) <= ENGINE_RMS
        bounds.append((ENGINE_MAX * scale, agreed.copy()))
    # measured: slot 1 at the prefill, slot 2 at the second decode step
    assert (~agreed).sum() <= ENGINE_MAX_DIVERGED, agreed
    held = 0
    for i in range(len(prompts)):
        for step, (_, jlogits) in enumerate(calls[:max_new]):
            top2 = np.sort(jlogits[i, -1])[-2:]
            bound, ok = bounds[step]
            if top2[1] - top2[0] <= 2 * bound or not ok[i]:
                break
            assert got[i][step] == want[i][step], (i, step)
            held += 1
    assert held, "no step's margin allowed a token check"
