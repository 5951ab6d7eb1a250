"""Deterministic synthetic LM data pipeline (counterpart of
``repro/data/tokens.py``).

Reproducible token batches (Zipfian marginals + a short-range induction
pattern so the loss actually decreases) with a background prefetch thread
and restart determinism: a batch is a pure function of (seed, step), drawn
with the reference's numpy calls in the reference's order, so the port and
the reference see the same arrays, and a restarted job resumes on exactly
the data it would have seen.  The arrays become tensors on the pipeline's
device (``None``: ``cuda:0``, raising without a card).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        batch: int,
        seq_len: int,
        seed: int = 0,
        frontend: str = "none",
        d_model: int = 0,
        mrope: bool = False,
        prefetch: int = 2,
        device=None,
    ):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.frontend = frontend
        self.d_model = d_model
        self.mrope = mrope
        self.prefetch = prefetch
        self.device = resolve_device(device)

    # -- pure function of (seed, step): restart determinism ------------------
    def arrays_at(self, step: int) -> dict[str, np.ndarray]:
        """The batch of ``step`` as numpy arrays: ``inputs`` (B, S) int32
        token ids, or (B, S, d_model) float32 embeddings for a stub frontend;
        ``targets`` (B, S) int32; ``mask`` (B, S) float32 ones;
        ``positions`` (B, S) int32, or (B, S, 3) for M-RoPE."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        b, s, v = self.batch, self.seq_len, self.vocab_size
        # Zipfian unigrams
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(b, s + 1), p=probs)
        # induction pattern: random repeats of earlier spans
        for i in range(b):
            if s >= 32:
                src = rng.integers(0, s // 2)
                length = int(rng.integers(8, 17))
                dst = int(rng.integers(s // 2, s + 1 - length))
                toks[i, dst:dst + length] = toks[i, src:src + length]
        out = {"targets": toks[:, 1:].astype(np.int32), "mask": np.ones((b, s), np.float32)}
        if self.frontend in ("vision_stub", "audio_stub"):
            out["inputs"] = rng.standard_normal((b, s, self.d_model)).astype(np.float32)
        else:
            out["inputs"] = toks[:, :-1].astype(np.int32)
        if self.mrope:
            pos = np.broadcast_to(np.arange(s)[None, :, None], (b, s, 3))
        else:
            pos = np.broadcast_to(np.arange(s)[None, :], (b, s))
        out["positions"] = np.ascontiguousarray(pos, np.int32)
        return out

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        """:meth:`arrays_at` as tensors on the pipeline's device."""
        return {k: torch.from_numpy(a).to(self.device) for k, a in self.arrays_at(step).items()}

    # -- prefetching iterator -------------------------------------------------
    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def pipeline_for(cfg, batch: int, seq_len: int, seed: int = 0, device=None) -> TokenPipeline:
    """Build a pipeline matching a ModelConfig's input modality."""
    return TokenPipeline(
        vocab_size=cfg.vocab_size,
        batch=batch,
        seq_len=seq_len,
        seed=seed,
        frontend=cfg.frontend,
        d_model=cfg.d_model,
        mrope=(cfg.pos_embedding == "mrope"),
        device=device,
    )
