"""Diffusion (DiT) stage engine + encode/custom engines (paper §3.3).

DiffusionEngine: per-stage request batching for DiT denoising. Requests
with the same output length bucket are batched and denoised together
(rectified-flow Euler); TeaCache-style velocity reuse via cache_interval.
Streaming inputs: a request whose condition arrives in chunks can be
configured chunk-wise (each chunk is synthesized independently — the
Qwen-Omni vocoder pattern) so synthesis overlaps upstream decoding.

EncodeEngine: batched single-forward stages (multimodal encoders — the
paper's footnote-3 'encoder as separate stage' case).

CustomEngine: arbitrary per-batch callables (e.g. the CNN vocoder of
Qwen3-Omni or MiMo-Audio's patch decoder).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.request import StageEvent
from repro_torch.device import engine_stream, on_stream
from repro_torch.models.dit import DiTConfig, sample as dit_sample


@dataclass(eq=False)              # identity equality: the generated eq
class _DiffJob:                   # would elementwise-compare cond arrays
    req_id: int                   # (and raise on mismatched chunk shapes
    cond: np.ndarray              # (Tc, cond_dim)    in queue.remove)
    out_len: int
    chunk_index: int = 0
    is_last_chunk: bool = True


class DiffusionEngine:
    def __init__(self, name: str, cfg: DiTConfig, params, *,
                 max_batch: int = 4, num_steps: Optional[int] = None,
                 cache_interval: int = 1, out_len_per_cond: float = 1.0,
                 seed: int = 0):
        self.name = name
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.num_steps = num_steps or cfg.num_steps
        self.cache_interval = cache_interval
        self.out_len_per_cond = out_len_per_cond
        self.queue: List[_DiffJob] = []
        self.device = params["in_proj"].device
        self.stream = engine_stream(self.device)     # its own, as AREngine's
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.busy_time = 0.0

    def enqueue(self, req_id: int, inputs: Dict[str, Any], sampling=None,
                data=None) -> None:
        cond = np.asarray(inputs["cond"])
        out_len = int(inputs.get("out_len",
                                 max(1, int(cond.shape[0]
                                            * self.out_len_per_cond))))
        self.queue.append(_DiffJob(
            req_id, cond, out_len,
            chunk_index=int(inputs.get("chunk_index", 0)),
            is_last_chunk=bool(inputs.get("is_last_chunk", True))))

    @property
    def has_work(self) -> bool:
        return bool(self.queue)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def step(self) -> List[StageEvent]:
        events: List[StageEvent] = []
        if not self.queue:
            return events
        t0 = time.perf_counter()
        self.steps += 1
        # bucket by (cond_len, out_len); batch the largest bucket
        buckets: Dict[tuple, List[_DiffJob]] = {}
        for job in self.queue:
            buckets.setdefault((job.cond.shape[0], job.out_len),
                               []).append(job)
        key_, jobs = max(buckets.items(), key=lambda kv: len(kv[1]))
        jobs = jobs[:self.max_batch]
        for j in jobs:
            self.queue.remove(j)
        # pad the batch to max_batch: every step samples ONE batch shape
        # (the shape a CUDA graph of the sampler would be captured at)
        conds = [j.cond for j in jobs]
        while len(conds) < self.max_batch:
            conds.append(np.zeros_like(conds[0]))
        with torch.no_grad(), on_stream(self.stream):
            cond = torch.as_tensor(np.stack(conds), device=self.device)
            out = dit_sample(self.cfg, self.params, cond, key_[1], self._gen,
                             num_steps=self.num_steps,
                             cache_interval=self.cache_interval).cpu().numpy()
        for i, j in enumerate(jobs):
            single_shot = j.is_last_chunk and j.chunk_index == 0
            events.append(StageEvent(
                j.req_id, "finished" if single_shot else "chunk",
                {"latent": out[i], "chunk_index": j.chunk_index},
                stage=self.name, chunk_index=j.chunk_index,
                is_last=j.is_last_chunk))
        self.busy_time += time.perf_counter() - t0
        return events


class EncodeEngine:
    """Batched encoder stage (one forward per request batch)."""

    def __init__(self, name: str, forward: Callable, *, max_batch: int = 8):
        self.name = name
        self.forward = forward            # forward(inputs_batch) -> outputs
        self.max_batch = max_batch
        self.queue: List[tuple] = []
        self.steps = 0
        self.busy_time = 0.0

    def enqueue(self, req_id, inputs, sampling=None, data=None) -> None:
        self.queue.append((req_id, inputs))

    @property
    def has_work(self) -> bool:
        return bool(self.queue)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def step(self) -> List[StageEvent]:
        events: List[StageEvent] = []
        if not self.queue:
            return events
        t0 = time.perf_counter()
        self.steps += 1
        batch, self.queue = (self.queue[:self.max_batch],
                             self.queue[self.max_batch:])
        outs = self.forward([inp for _, inp in batch])
        for (rid, inp), out in zip(batch, outs):
            ci = int(inp.get("chunk_index", 0))
            last = bool(inp.get("is_last_chunk", True))
            single_shot = last and ci == 0
            events.append(StageEvent(
                rid, "finished" if single_shot else "chunk", out,
                stage=self.name, chunk_index=ci, is_last=last))
        self.busy_time += time.perf_counter() - t0
        return events


class CustomEngine(EncodeEngine):
    """Arbitrary per-batch callable stage (CNN vocoder, patch codecs...)."""
