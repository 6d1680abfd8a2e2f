"""Synthetic data pipeline: deterministic, seekable token / frame streams.

Produces next-token-prediction batches for text archs, frame batches for
the audio encoder, and interleaved text+VQ-token batches for the VLM —
matching each config's ``modality``.  A copy of the JAX package's
``train/data.py`` (numpy only): the same seed gives the same batches, bit
for bit.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class TokenStream:
    """Markov-ish synthetic token stream (compressible => learnable)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        v = cfg.vocab_size
        # low-entropy transition structure
        self._next = self.rng.integers(0, v, size=(v, 4))

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        if cfg.modality == "audio_frames":
            frames = self.rng.standard_normal(
                (self.batch, self.seq_len, cfg.d_model)).astype(np.float32)
            labels = self.rng.integers(
                0, cfg.vocab_size, size=(self.batch, self.seq_len))
            return {"inputs": frames, "labels": labels.astype(np.int32)}
        toks = np.empty((self.batch, self.seq_len + 1), np.int64)
        toks[:, 0] = self.rng.integers(0, cfg.vocab_size, size=self.batch)
        choice = self.rng.integers(0, 4, size=(self.batch, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = self._next[toks[:, t], choice[:, t]]
        if cfg.modality == "vq_image+text":
            # interleave a block of "image tokens" (upper half of the vocab)
            span = self.seq_len // 4
            start = int(self.rng.integers(0, self.seq_len - span))
            toks[:, start:start + span] = self.rng.integers(
                cfg.vocab_size // 2, cfg.vocab_size,
                size=(self.batch, span))
        return {"inputs": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
