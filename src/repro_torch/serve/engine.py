"""Batched LM serving engine (port of ``repro.serve.engine``): prefill and
greedy decode with fixed batch slots.

``Engine(cfg, params, batch_slots=, max_len=, device="cuda")`` runs on the
card unless ``device="cpu"`` is passed; every attention of its models is
then K7 (``models.layers``).  ``generate`` left-pads the prompts into the
slot batch, prefills with one ``decode_step`` over the whole prompt, then
decodes ``max_new`` greedy steps.  Two departures from the reference,
neither of which changes a token:

* the prefill unembeds only the last position (``last_only``), the only
  one the reference reads: at gemma2-2b's vocabulary, 4 slots and a
  5000-token prompt the full logits would be 20 GB of float32;
* the greedy tokens stay on the device until the last step, and are read
  back once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4, max_len: int = 256,
                 device="cuda"):
        """``params`` as from ``models.model.init_params``, moved to
        ``device`` where they lie elsewhere.  Raises where ``cfg`` cannot
        run there (``models.model.check_device``)."""
        self.device = torch.device(device)
        M.check_device(cfg, self.device)
        self.cfg = cfg
        self.params = M.tree_map(lambda x: x.to(self.device), params)
        self.B, self.T = batch_slots, max_len

    def generate(self, prompts: list[np.ndarray], max_new: int = 16, greedy=True):
        """Batched greedy generation (``greedy`` is taken for the
        reference's signature): the prompts left-padded with token 0 into
        the slot batch, prefilled in one ``decode_step``, then ``max_new``
        decode steps.  Returns each prompt's ``max_new`` tokens."""
        if len(prompts) > self.B:
            raise ValueError(f"{len(prompts)} prompts for {self.B} slots")
        reqs = [Request(p, max_new) for p in prompts]
        while len(reqs) < self.B:
            reqs.append(Request(np.zeros(1, np.int32), 0, done=True))
        maxlen = max(len(r.prompt) for r in reqs)
        cache = M.init_cache(self.cfg, self.B, self.T, device=self.device)
        toks = np.zeros((self.B, maxlen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, maxlen - len(r.prompt):] = r.prompt  # left-pad
        logits, cache = self._prefill(toks, cache)
        last = logits[:, -1].argmax(dim=-1)
        steps = []
        for _ in range(max_new):
            steps.append(last)
            logits, cache = M.decode_step(self.params, self.cfg, cache, {"tokens": last[:, None]})
            last = logits[:, 0].argmax(dim=-1)
        out = torch.stack(steps, dim=1).cpu().numpy() if steps else np.zeros((self.B, 0), int)
        for i, r in enumerate(reqs):
            if not r.done:
                r.out.extend(int(t) for t in out[i])
        return [r.out for r in reqs if not r.done]

    def _prefill(self, toks, cache):
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        return M.decode_step(self.params, self.cfg, cache, batch, last_only=True)


def decode_throughput_model(cfg: ModelConfig, batch: int, kv_len: int) -> dict:
    """Analytical bytes/token for the decode step (roofline helper)."""
    hk, dh = cfg.n_kv_heads, cfg.head_dim_
    kv_bytes = 2 * cfg.n_layers * batch * kv_len * hk * dh * 2  # bf16
    return {"kv_bytes_per_step": kv_bytes}
