"""LM serving engine: batched greedy generation with wave scheduling
(counterpart of ``repro/serving/engine.py``).

A wave = up to ``batch`` requests sharing one set of KV caches.  Slots run
in LOCKSTEP: at step t each slot feeds its own prompt token (teacher-forced)
until its prompt is exhausted, then its previously generated token --
variable-length prompts batch together with no padding-restart logic and a
single cache index.  When every slot in the wave is done, the next wave
starts on fresh caches.  The decode step is :func:`decode_step`, run eagerly
under ``torch.inference_mode()`` (the reference jits it).  Under a mesh
(``distributed.sharding``) the caches are DTensors and each step's tokens
are gathered to the host whole.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.models.model import LMModel


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int
    tokens: list = dataclasses.field(default_factory=list)


def decode_step(model: LMModel, caches: list, tokens: torch.Tensor):
    """One token per slot through the model: (new caches, the greedy next
    token of each slot).  ``argmax`` takes the first of tied maxima, as
    ``jnp.argmax`` does.  Runs under ``torch.inference_mode()``; under a
    mesh under ``torch.no_grad()``, since DTensor's views cannot take
    inference tensors."""
    with torch.no_grad() if sharding.on_mesh() else torch.inference_mode():
        logits, caches, _ = model.apply(tokens, caches=caches)
        return caches, torch.argmax(logits[:, -1, :], dim=-1)


class ServeEngine:
    def __init__(self, model: LMModel, batch: int, max_len: int):
        self.model = model
        self.batch = batch
        self.max_len = max_len

    def _run_wave(self, wave: list[Request]) -> None:
        b = self.batch
        lens = [len(r.prompt) for r in wave]
        horizon = max(
            len(r.prompt) + r.max_new_tokens - 1 for r in wave
        )
        assert horizon < self.max_len, "wave exceeds cache capacity"

        caches = self.model.init_caches(b, self.max_len)
        last = np.zeros((b,), np.int32)
        for i, r in enumerate(wave):
            last[i] = r.prompt[0]

        for t in range(horizon):
            tokens = torch.as_tensor(last, device=self.model.device)[:, None]
            caches, nxt = decode_step(self.model, caches, tokens)
            nxt_np = sharding.full(nxt).cpu().numpy()
            for i, r in enumerate(wave):
                if t + 1 < lens[i]:
                    last[i] = r.prompt[t + 1]          # still prefilling
                else:
                    gen = int(nxt_np[i])
                    if len(r.tokens) < r.max_new_tokens:
                        r.tokens.append(gen)
                    last[i] = gen

    def generate(
        self, prompts: list[np.ndarray], max_new_tokens: int
    ) -> list[list[int]]:
        requests = [
            Request(i, np.asarray(p, np.int32), max_new_tokens)
            for i, p in enumerate(prompts)
        ]
        for start in range(0, len(requests), self.batch):
            wave = requests[start : start + self.batch]
            while len(wave) < self.batch:       # pad the last wave
                wave = wave + [Request(-1, np.zeros(1, np.int32), max_new_tokens)]
            self._run_wave(wave[: self.batch])
        return [r.tokens for r in requests]
