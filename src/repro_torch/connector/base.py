"""Unified connector interface (paper §3.4).

A connector moves intermediate data objects (embeddings, hidden states,
codec tokens, audio/image tensors — and intra-stage KV / MM caches) between
stages through a common interface; only lightweight metadata rides the
control plane.

The connector surface is the channel API — ``send`` returns a
:class:`TransferHandle` immediately, ``recv`` blocks (or polls, via
``poll``) until the key has been published by the producer side, and
``release`` ends the object's lifetime explicitly.  This is what the
per-stage workers use: the router publishes on the upstream side and the
destination stage worker receives + deserializes in its own thread (or
process), overlapping transfers with compute.  A ``recv`` that waits out
its timeout raises :class:`TransferTimeout` carrying the key (and edge,
when the router attached one) so the failure is attributable per-request.

The original synchronous ``put`` / ``get`` / ``delete`` trio is
DEPRECATED (it duplicated the resident-bytes accounting path); the shims
below forward to ``send`` / ``recv`` / ``release`` and emit a
``DeprecationWarning``.  They disappear next release.

All entry points are thread-safe (one lock + condition per connector
instance: producers notify, consumers wait).

The three backends model the paper's deployment
topologies:
  - InlineConnector   — control-queue pass-by-reference (small payloads).
  - SharedMemoryConnector — single-node shm: payloads are serialized into a
    host buffer pool (a real copy, like /dev/shm) and deserialized on get.
  - MooncakeConnector — multi-node put/get store: serializing copy on both
    ends + a bandwidth/latency cost model for the TCP/RDMA hop.

Payloads are host (numpy) trees: an engine copies device tensors to the
host before it emits them, and the receiving engine uploads what it needs.
Connectors count bytes either way so Table 1 can be reproduced.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.connector import tree



class TransferTimeout(TimeoutError):
    """``recv(key, timeout)`` waited out its timeout.

    Carries the ``key`` (and the ``edge`` the router attached, when the
    recv ran inside a stage worker's resolve) so the router can fail the
    one request that owns the transfer instead of killing the worker."""

    def __init__(self, key: str, *, connector: str = "?",
                 edge: Optional[str] = None,
                 timeout: Optional[float] = None):
        self.key = key
        self.connector = connector
        self.edge = edge
        self.timeout = timeout
        where = f" on edge {edge!r}" if edge else ""
        after = f" after {timeout:.3f}s" if timeout is not None else ""
        super().__init__(
            f"connector[{connector}] recv({key!r}){where} timed out{after}")

    def with_edge(self, edge: str) -> "TransferTimeout":
        return TransferTimeout(self.key, connector=self.connector,
                               edge=edge, timeout=self.timeout)


@dataclass
class TransferStats:
    calls: int = 0
    bytes: int = 0
    wall_time: float = 0.0       # measured time spent in put+get
    modeled_time: float = 0.0    # cost-model time (e.g. RDMA hop)

    def record(self, nbytes: int, wall: float, modeled: float = 0.0) -> None:
        self.calls += 1
        self.bytes += nbytes
        self.wall_time += wall
        self.modeled_time += modeled


@dataclass
class TransferHandle:
    """Returned by ``send``: enough for the control plane to route the
    object without touching the data plane."""
    key: str
    nbytes: int
    t_send: float


class Connector:
    """put/get data plane + metadata control plane + async channel API.

    Concurrency contract: the heavy data-plane hooks (``_pack`` /
    ``_unpack`` — serialize and deserialize copies) run WITHOUT the
    connector lock, so two stage workers can deserialize concurrently and
    the router's publish never waits behind an in-progress recv.  Only the
    cheap control-plane hooks (``_publish`` / ``_fetch`` / ``_evict`` —
    dict bookkeeping) run under the lock.
    """

    name = "base"

    def __init__(self) -> None:
        self.stats = TransferStats()
        self._meta: Dict[str, dict] = {}       # guarded-by: _lock
        self._entries: Dict[str, Any] = {}     # guarded-by: _lock
        self._lock = threading.RLock()
        self._ready = threading.Condition(self._lock)

    # -- control plane ---------------------------------------------------
    def metadata(self, key: str) -> Optional[dict]:
        with self._lock:
            return self._meta.get(key)

    def poll(self, key: str) -> bool:
        """True once the key has been published and not yet released."""
        with self._lock:
            return key in self._meta

    # -- async channel API -------------------------------------------------
    def send(self, key: str, payload: Any) -> TransferHandle:
        """Publish a payload under ``key`` and wake any waiting ``recv``."""
        t0 = time.perf_counter()
        nbytes = payload_nbytes(payload)
        entry, modeled = self._pack(payload)         # heavy copy, unlocked
        with self._ready:
            self._publish(key, entry)
            self._meta[key] = {"nbytes": nbytes, "t_put": t0}
            self.stats.record(nbytes, time.perf_counter() - t0, modeled)
            self._ready.notify_all()
        return TransferHandle(key=key, nbytes=nbytes, t_send=t0)

    def recv(self, key: str, timeout: Optional[float] = None) -> Any:
        """Block until ``key`` is published, then load it.

        ``timeout=None`` waits forever; ``timeout=0`` is a non-blocking
        probe. Raises ``TimeoutError`` if the key never shows up.
        """
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        with self._ready:
            # the while condition re-checks after every wait, so a publish
            # racing the timeout expiry is never dropped
            while key not in self._meta:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise TransferTimeout(key, connector=self.name,
                                          timeout=timeout)
                self._ready.wait(remaining)
            entry = self._fetch(key)
        payload, modeled = self._unpack(entry)       # heavy copy, unlocked
        with self._lock:
            self.stats.wall_time += time.perf_counter() - t0
            self.stats.modeled_time += modeled
        return payload

    def release(self, key: str) -> None:
        """Explicitly end the object's lifetime (eviction)."""
        with self._lock:
            self._meta.pop(key, None)
            self._evict(key)

    # -- synchronous API (DEPRECATED shims, one release) -------------------
    def _deprecated(self, old: str, new: str) -> None:
        warnings.warn(
            f"Connector.{old}() is deprecated; use Connector.{new}() — "
            f"the send/recv/release channel API is the single surface "
            f"(and the single resident-bytes accounting path)",
            DeprecationWarning, stacklevel=3)

    def put(self, key: str, payload: Any) -> None:
        self._deprecated("put", "send")
        self.send(key, payload)

    def get(self, key: str) -> Any:
        self._deprecated("get", "recv")
        with self._ready:
            if key not in self._meta:
                raise KeyError(key)
        return self.recv(key, timeout=0.0)

    def delete(self, key: str) -> None:
        self._deprecated("delete", "release")
        self.release(key)

    # -- backend hooks -----------------------------------------------------
    # heavy data plane — run WITHOUT the connector lock, must not touch
    # shared state
    def _pack(self, payload: Any) -> Tuple[Any, float]:
        """payload -> (storable entry, modeled transfer time)."""
        return payload, 0.0

    def _unpack(self, entry: Any) -> Tuple[Any, float]:
        """stored entry -> (payload, modeled transfer time)."""
        return entry, 0.0

    # cheap control plane — run under the connector lock
    def _publish(self, key: str, entry: Any) -> None:  # requires-lock: _lock
        self._entries[key] = entry

    def _fetch(self, key: str) -> Any:  # requires-lock: _lock
        return self._entries[key]

    def _evict(self, key: str) -> None:  # requires-lock: _lock
        self._entries.pop(key, None)


def payload_nbytes(payload: Any) -> int:
    leaves = tree.leaves(payload)
    total = 0
    for leaf in leaves:
        if hasattr(leaf, "nbytes"):
            total += leaf.nbytes
        elif isinstance(leaf, (bytes, bytearray)):
            total += len(leaf)
        elif isinstance(leaf, (int, float, bool)):
            total += 8
        elif isinstance(leaf, str):
            total += len(leaf)
    return total
