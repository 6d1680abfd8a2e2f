"""Stage abstraction (paper §3.2, Figure 3(b)).

A *stage* is one model component of an any-to-any pipeline (an AR LLM, a
DiT, an encoder, or a custom module), declared with:

  - ``kind``: which execution engine serves it ("ar" | "diffusion" |
    "encode" | "custom");
  - ``preprocess``: per-iteration hook that can inject data produced by
    preceding stages into the stage's model inputs (e.g. the Talker
    concatenating Thinker hidden states at every decode step);
  - ``resources``: engine knobs (max batch, KV pages, mesh axes / submesh)
    — the user-facing runtime configuration of Figure 3(c);
  - engine-specific model handles (config + params + step functions are
    owned by the engine, keeping the stage declaration model-agnostic).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    runtime_checkable)

from repro_torch.core.request import StageEvent

# preprocess(request_data: dict, model_inputs: dict) -> dict
PreprocessFn = Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]
# transfer(request_data: dict, payload: Any) -> dict  (downstream inputs)
TransferFn = Callable[[Dict[str, Any], Any], Dict[str, Any]]


@runtime_checkable
class StageEngine(Protocol):
    """What a stage execution engine must provide to be served.

    The contract the disaggregated backend relies on:

      - ``enqueue`` and ``step`` are only ever called from ONE thread (the
        stage's worker thread, or the main thread on the lock-step compat
        path) — engines need no internal locking;
      - ``step`` executes at most one iteration of work (one scheduler
        plan, one denoising batch, ...) and returns the StageEvents it
        produced: finished outputs, streamed chunks;
      - ``has_work`` is cheap and may be read from other threads for
        quiescence detection (it is advisory there — the worker's own
        thread re-checks before sleeping).
    """

    name: str

    def enqueue(self, req_id: int, inputs: Dict[str, Any], sampling: Any,
                data: Dict[str, Any]) -> None: ...

    def step(self) -> List[StageEvent]: ...

    @property
    def has_work(self) -> bool: ...

    @property
    def queue_depth(self) -> int: ...


@dataclass
class StageSpec:
    name: str
    kind: str                                   # ar | diffusion | encode | custom
    model: Any = None                           # engine-specific model bundle
    preprocess: Optional[PreprocessFn] = None
    resources: Dict[str, Any] = field(default_factory=dict)
    is_output: bool = False                     # terminal stage: emits request output

    def __post_init__(self):
        assert self.kind in ("ar", "diffusion", "encode", "custom"), self.kind


@dataclass
class StageEdge:
    src: str
    dst: str
    transfer: TransferFn
    streaming: bool = False                     # forward chunks before src finishes
    connector: str = "inline"                   # inline | shm | mooncake
