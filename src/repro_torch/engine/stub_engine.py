"""Deterministic stub stage engine (torch-free).

One item per ``step()`` with an optional GIL-releasing dwell — the
serving-layer benchmarks and the process-isolation smoke tests measure
the worker/transport machinery, not model compute, and a spawned child
importing this module pays no torch import.  ``make_stub`` is the
module-level builder the picklable :class:`~repro_torch.core.config.EngineSpec`
points at.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List

import numpy as np

from repro_torch.core.request import StageEvent


class StubEngine:
    """FIFO echo engine: each step finishes one queued item after
    ``dwell_s`` (a sleep, so replicas overlap like independent devices)
    and emits its inputs back as the finished payload."""

    def __init__(self, name: str, dwell_s: float = 0.0):
        self.name = name
        self.dwell_s = dwell_s
        self._q: deque = deque()
        self.busy_time = 0.0
        self.admitted: List[int] = []    # req ids, admission order

    def enqueue(self, req_id: int, inputs: Dict[str, Any], sampling: Any,
                data: Dict[str, Any]) -> None:
        self.admitted.append(req_id)
        self._q.append((req_id, dict(inputs)))

    @property
    def has_work(self) -> bool:
        return bool(self._q)

    @property
    def queue_depth(self) -> int:
        return len(self._q)

    def step(self) -> List[StageEvent]:
        if not self._q:
            return []
        rid, inputs = self._q.popleft()
        if self.dwell_s > 0:
            time.sleep(self.dwell_s)
        self.busy_time += self.dwell_s
        return [StageEvent(rid, "finished", inputs, stage=self.name)]


def make_stub(name: str = "stub", dwell_ms: float = 0.0) -> StubEngine:
    """EngineSpec target: ``repro_torch.engine.stub_engine:make_stub``."""
    return StubEngine(name, dwell_s=dwell_ms / 1e3)


class SeedableStubEngine(StubEngine):
    """Stub exposing the engine-side warm-seed protocol
    (``cached_prefix_pages`` / ``prefix_snapshot`` / ``seed_prefixes`` /
    ``prefix_hint``) with numpy payloads, so the cross-process seed
    transport moves real array bytes.  Each "page" is one small array
    whose contents encode its index — a receiver can verify the seeded
    snapshot byte-for-byte."""

    def __init__(self, name: str, pages: int = 0, dwell_s: float = 0.0):
        super().__init__(name, dwell_s)
        self.seeded_pages = 0
        self._pages: List[Dict[str, Any]] = [self._page(i)
                                             for i in range(pages)]

    @staticmethod
    def _page(i: int) -> Dict[str, Any]:
        return {"hash": i, "k": np.full((4, 8), i, np.float32),
                "v": np.full((4, 8), -i, np.float32)}

    @property
    def cached_prefix_pages(self) -> int:
        return len(self._pages)

    def prefix_snapshot(self, max_pages: int = 64) -> List[Dict[str, Any]]:
        return [dict(p) for p in self._pages[:max_pages]]

    def seed_prefixes(self, snapshot: Any) -> int:
        fresh = [p for p in snapshot
                 if p["hash"] not in {q["hash"] for q in self._pages}]
        self._pages.extend(fresh)
        self.seeded_pages += len(fresh)
        return len(fresh)

    def prefix_hint(self, hints: Any) -> int:
        return len(self._pages)

    def step(self) -> List[StageEvent]:
        # report the page inventory so tests can compare replica state
        # through ordinary finished events
        evs = super().step()
        for ev in evs:
            ev.payload = dict(ev.payload)
            ev.payload["pages"] = sorted(p["hash"] for p in self._pages)
        return evs


def make_seedable(name: str = "stub", pages: int = 0,
                  dwell_ms: float = 0.0) -> SeedableStubEngine:
    """EngineSpec target: ``repro_torch.engine.stub_engine:make_seedable``."""
    return SeedableStubEngine(name, pages=pages, dwell_s=dwell_ms / 1e3)
