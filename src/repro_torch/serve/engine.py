"""Batched serving: prefill + decode steps and a batching server (port of
``repro.serve.engine``).

``make_prefill_step`` / ``make_decode_fn`` bind a config to the model's
prefill and decode; ``BatchedServer`` drives them for real requests: it
takes up to ``batch_slots`` queued prompts at a time, left-pads them with
token 0 (no pad mask: the reference's batching, kept as it is), prefills
them into caches of ``plen + max_new_tokens + 1`` positions and decodes
the batch step by step until every row has its tokens or has emitted
``eos_token``.  It runs eagerly under ``torch.inference_mode()`` on the
model's device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..models import decode_step, make_decode_caches, prefill
from ..models.common import ModelConfig

__all__ = ["BatchedServer", "ServeConfig", "make_decode_fn",
           "make_prefill_step"]


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_seq_len: int = 512
    temperature: float = 0.0  # 0 = greedy
    eos_token: int = -1  # -1 = never stop on token


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, caches, prefix_embeds=None):
        return prefill(params, cfg, tokens, caches,
                       prefix_embeds=prefix_embeds)

    return prefill_step


def make_decode_fn(cfg: ModelConfig):
    def decode_fn(params, token, pos, caches):
        return decode_step(params, cfg, token, pos, caches)

    return decode_fn


class BatchedServer:
    """Slot-based batching over a fixed decode batch.

    Greedy decoding (``temperature == 0``) takes the first largest logit,
    as the reference does.  Sampling draws from a ``torch.Generator`` on
    the model's device seeded with the step's position, where the
    reference draws ``jax.random.categorical(PRNGKey(pos))``: the two
    streams differ, so only greedy completions match the reference's.
    """

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig):
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.device = params.device
        self.decode = make_decode_fn(cfg)
        self.prefill = make_prefill_step(cfg)
        self.queue: List[list] = []

    def submit(self, prompt_tokens: list):
        self.queue.append(list(prompt_tokens))

    def _next_tokens(self, logits, pos: int, gen):
        if self.scfg.temperature > 0:
            gen.manual_seed(pos)
            probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)
        return torch.argmax(logits, dim=-1)[:, None]

    @torch.inference_mode()
    def run(self, max_new_tokens: int = 32):
        """Serve every queued request; returns the list of completions."""
        cfg, scfg = self.cfg, self.scfg
        gen = torch.Generator(device=self.device)
        results = []
        while self.queue:
            n = min(scfg.batch_slots, len(self.queue))
            batch = [self.queue.pop(0) for _ in range(n)]
            # pad prompts to a common length for one batched prefill
            plen = max(len(p) for p in batch)
            toks = np.zeros((len(batch), plen), np.int64)
            for i, p in enumerate(batch):
                toks[i, plen - len(p):] = p  # left-pad
            caches = make_decode_caches(cfg, len(batch),
                                        plen + max_new_tokens + 1,
                                        device=self.device)
            logits, caches = self.prefill(
                self.params, torch.from_numpy(toks).to(self.device), caches)
            outs = [[] for _ in batch]
            done = [False] * len(batch)
            pos = plen
            for _ in range(max_new_tokens):
                tok = self._next_tokens(logits, pos, gen)
                for i, t in enumerate(tok[:, 0].tolist()):
                    if not done[i]:
                        outs[i].append(t)
                        if t == scfg.eos_token:
                            done[i] = True
                if all(done):
                    break
                logits, caches = self.decode(self.params, tok, pos, caches)
                pos += 1
            results.extend(outs)
        return results
