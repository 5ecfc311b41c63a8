"""The port's LM serving path on the CPU: the configs against the JAX
package's, ``Engine.generate`` against the reference ``Engine`` on reduced
gemma2-2b and yi-6b (dbrx: tests/test_torch_moe.py), the ``serve``
launcher and the ``serve_lm`` example with ``--device cpu``, and what the
card's dispatch takes and refuses (tested without a card:
``layers.attention_route`` and ``model.check_device`` decide before any
launch).

The engine's tolerance: every step's logits, both packages fed the
reference's tokens, within ``ENGINE_MAX`` of the step's largest |logit|
(RMS within ``ENGINE_RMS``), and the port's own greedy tokens equal to the
reference's at every step whose top-2 margin in the reference exceeds
twice that bound (after the first step that does not, a request's inputs
may differ, so it is not held).  The bound is test_torch_models.py's bf16
bound (bf16 rounded at other places in the two frameworks) tightened to
what these two-layer dense models show: 0.9-1.0% of the largest logit;
that file's 6% is set by zamba2, whose shared block runs twice.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import model as JM
from repro.serve import engine as jengine

from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.examples import serve_lm
from repro_torch.launch import serve as serve_launch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import Engine
from repro_torch.serve import engine as tengine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ENGINE_MAX, ENGINE_RMS = 0.02, 0.02
# the reference's init and its engine's decode step compile at XLA's backend
# optimisation level 0, which takes about a third off their compile time;
# the bounds here hold at the default level too
XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0}
CPU = torch.device("cpu")
CUDA = torch.device("cuda")


def test_configs_match_reference():
    """Every arch's config and its reduced() equal the reference's field by
    field, as do SHAPES, RunConfig's defaults and the dry-run cells."""
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    for name, jcfg in jreg.ARCHS.items():
        tcfg = treg.get(name)
        for a, b in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert (a.head_dim_, a.padded_vocab, a.is_encdec, a.attention_free, a.subquadratic) == (
                b.head_dim_, b.padded_vocab, b.is_encdec, b.attention_free, b.subquadratic)
    assert {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
    run = dict(model=tbase.ModelConfig("m", "dense", 1, 8, 1, 1, 8, 8))
    jrun = dataclasses.asdict(jbase.RunConfig(model=jbase.ModelConfig("m", "dense", 1, 8, 1, 1, 8, 8)))
    assert dataclasses.asdict(tbase.RunConfig(**run)) == jrun
    for skipped in (False, True):
        assert [(c.name, s.name, why) for c, s, why in treg.cells(skipped)] == [
            (c.name, s.name, why) for c, s, why in jreg.cells(skipped)]
    with pytest.raises(KeyError):
        treg.get("gpt-7")


def _prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 3, 7, 4)]


@pytest.mark.parametrize("arch", ["gemma2-2b", "yi-6b"])
def test_engine_matches_reference(arch):
    """Both engines on 4 prompts in 4 slots, 8 new tokens: each step's
    logits with the reference's inputs fed to the port's decode_step, and
    the port Engine's tokens where the margin allows."""
    jcfg, tcfg = jreg.get(arch).reduced(), treg.get(arch).reduced()
    jparams = jax.jit(lambda key: JM.init_params(key, jcfg),
                      compiler_options=XLA_FAST_COMPILE)(jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jparams))
    prompts, max_new = _prompts(jcfg, 5), 8

    jeng = jengine.Engine(jcfg, jparams, batch_slots=4, max_len=32)
    # the engine's own jitted step (repro/serve/engine.py), compiled faster
    decode = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b),
                     compiler_options=XLA_FAST_COMPILE)
    calls = []

    def recorded(p, c, b):  # the reference's prefill and decode steps, in order
        logits, c = decode(p, c, b)
        calls.append((np.asarray(b["tokens"]), np.asarray(logits)))
        return logits, c

    jeng._decode = recorded
    want = jeng.generate(prompts, max_new=max_new)
    got = Engine(tcfg, tparams, batch_slots=4, max_len=32, device="cpu").generate(
        prompts, max_new=max_new)
    assert len(calls) == 1 + max_new and [len(o) for o in got] == [max_new] * len(prompts)

    cache = TM.init_cache(tcfg, 4, 32)
    bounds = []
    for tokens, jlogits in calls:
        tlogits, cache = TM.decode_step(tparams, tcfg, cache, {"tokens": torch.as_tensor(tokens)})
        tlogits = tlogits.numpy()
        err, scale = np.abs(tlogits - jlogits), np.abs(jlogits).max()
        assert err.max() <= ENGINE_MAX * scale, (arch, err.max(), scale)
        assert np.sqrt((err ** 2).mean() / (jlogits ** 2).mean()) <= ENGINE_RMS
        bounds.append(ENGINE_MAX * scale)
    held = 0  # tokens the margin allowed to hold
    for i in range(len(prompts)):
        for step, (_, jlogits) in enumerate(calls[:max_new]):
            top2 = np.sort(jlogits[i, -1])[-2:]
            if top2[1] - top2[0] <= 2 * bounds[step]:
                break
            assert got[i][step] == want[i][step], (arch, i, step)
            held += 1
    assert held, f"{arch}: no step's margin allowed a token check"


def test_serve_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch gemma2-2b --reduced
    --device cpu``: 4 requests of 16 tokens each, in the vocabulary."""
    outs = serve_launch.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu"])
    vocab = treg.get("gemma2-2b").reduced().vocab
    assert len(outs) == 4 and all(len(o) == 16 and 0 <= min(o) and max(o) < vocab for o in outs)
    assert capsys.readouterr().out.count("16 tokens") == 4


def test_serve_lm_example_on_cpu(capsys):
    """The example's three requests, on every family: seamless decodes
    over its cache's zero cross-attention memory, as the reference's
    engine does; dbrx and llama4 through their MoE layers."""
    for arch in ("yi-6b", "mamba2-130m", "zamba2-2.7b", "seamless-m4t-medium", "dbrx-132b",
                 "llama4-maverick-400b-a17b"):
        outs = serve_lm.main(["--arch", arch, "--max-new", "3", "--device", "cpu"])
        assert [len(o) for o in outs] == [3, 3, 3]
        assert "[ok] 3 requests decoded 3 tokens each" in capsys.readouterr().out


def test_card_dispatch_refusals():
    """What the card takes and refuses, decided before any launch: K7
    serves head dim 80 (zamba2-2.7b at full width) and refuses a head dim
    it is not built for (48), and takes one offset, not a positions
    tensor; the MoE configs pass on both devices.  The CPU takes all."""
    assert TL.attention_route(CPU, 80, torch.zeros(1, 1)) == "plain"
    assert TL.attention_route(CUDA, 256, 4096) == "k7"
    assert TL.attention_route(CUDA, 80, 0) == "k7"
    with pytest.raises(ValueError, match="head dim 48"):
        TL.attention_route(CUDA, 48, 0)
    with pytest.raises(ValueError, match="positions tensor"):
        TL.attention_route(CUDA, 128, torch.zeros(2, 3, dtype=torch.int32))
    zamba = treg.get("zamba2-2.7b")
    TM.check_device(zamba, CUDA)
    Engine(zamba, {}, device="cuda")  # no tensor to move: the check alone
    narrow = dataclasses.replace(treg.get("yi-6b"), head_dim=48)
    with pytest.raises(ValueError, match="head dim 48"):
        TM.check_device(narrow, CUDA)
    with pytest.raises(ValueError, match="head dim 48"):
        Engine(narrow, {}, device="cuda")
    TM.check_device(narrow, CPU)
    TM.check_device(treg.get("gemma2-2b"), CUDA)
    TM.check_device(treg.get("mamba2-130m"), CUDA)  # attention-free
    for arch in ("dbrx-132b", "llama4-maverick-400b-a17b"):
        for cfg in (treg.get(arch), treg.get(arch).reduced()):
            for device in (CPU, CUDA):
                TM.check_device(cfg, device)
                Engine(cfg, {}, device=device)
    for arch in ("gemma2-2b", "yi-6b", "dbrx-132b", "llama4-maverick-400b-a17b"):
        assert tengine.decode_throughput_model(treg.get(arch), 4, 8192) == {
            "kv_bytes_per_step": jengine.decode_throughput_model(jreg.get(arch), 4, 8192)[
                "kv_bytes_per_step"]}
