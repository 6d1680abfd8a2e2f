"""Request objects flowing through a stage graph.

Each request carries the paper's "predefined dictionary for storing
intermediate per-request data" (§3.3): transfer functions and per-stage
preprocess functions read and update ``request.data``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_req_counter = itertools.count()


@dataclass
class Request:
    inputs: Dict[str, Any]                    # initial model inputs
    req_id: int = field(default_factory=lambda: next(_req_counter))
    sampling: Dict[str, Any] = field(default_factory=dict)
    # the unified per-request data dict (paper §3.3): intermediate tensors
    # (hidden states, codec tokens, embeddings) keyed by producer stage.
    data: Dict[str, Any] = field(default_factory=dict)
    # telemetry
    arrival_time: float = field(default_factory=time.perf_counter)
    completion_time: Optional[float] = None
    first_output_time: Optional[float] = None   # TTFT of the FINAL output
    # (delivered, emitted, tokens) of each output-stage chunk, in the order
    # the router handed them over: ``perf_counter`` at delivery, the
    # ``StageEvent.t_emit`` of the chunk (None: its engine stamps none)
    chunk_times: List[tuple] = field(default_factory=list)
    stage_spans: Dict[str, List[float]] = field(default_factory=dict)
    # per-stage queueing delays (submit -> engine admission), seconds; a
    # stage fed by a streaming edge collects one sample per chunk
    queue_delays: Dict[str, List[float]] = field(default_factory=dict)
    # final outputs per output-stage
    outputs: Dict[str, Any] = field(default_factory=dict)
    failed: Optional[str] = None

    def mark_stage_start(self, stage: str) -> None:
        self.stage_spans.setdefault(stage, [time.perf_counter(), None])

    def mark_stage_end(self, stage: str) -> None:
        span = self.stage_spans.setdefault(stage, [time.perf_counter(), None])
        span[1] = time.perf_counter()

    @property
    def jct(self) -> Optional[float]:
        if self.completion_time is None:
            return None
        return self.completion_time - self.arrival_time

    def stage_time(self, stage: str) -> float:
        span = self.stage_spans.get(stage)
        if not span or span[1] is None:
            return 0.0
        return span[1] - span[0]

    def note_queue_delay(self, stage: str, delay: float) -> None:
        self.queue_delays.setdefault(stage, []).append(delay)

    def queue_delay(self, stage: str) -> float:
        """Total time this request spent queued in front of ``stage``."""
        return float(sum(self.queue_delays.get(stage, ())))


@dataclass
class StageEvent:
    """Emitted by engines: a finished stage output or a streamed chunk."""
    req_id: int
    kind: str                 # "finished" | "chunk"
    payload: Any
    stage: str = ""
    chunk_index: int = 0
    is_last: bool = False
    t_emit: Optional[float] = None    # perf_counter where the engine built it
