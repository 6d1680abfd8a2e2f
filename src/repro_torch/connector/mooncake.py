"""Mooncake-style connector: cross-node put/get object store.

Data plane: serializing copy on put and on get (two memcpys, as in a real
distributed KV store client), plus a TCP/RDMA hop cost model
(latency + bytes/bandwidth) reported as ``stats.modeled_time`` — this
container has one node, so the wire time is modeled, not slept.  Both
copies run outside the connector lock (``_pack``/``_unpack``).
Control plane: metadata only ({key, nbytes, location}), as in the paper.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from repro_torch.connector import tree
from repro_torch.connector.base import Connector


class MooncakeConnector(Connector):
    name = "mooncake"

    def __init__(self, bandwidth_gbps: float = 12.5, latency_s: float = 30e-6):
        """Defaults model 100 GbE RDMA: 12.5 GB/s, 30us one-way latency."""
        super().__init__()
        self.bandwidth = bandwidth_gbps * 1e9
        self.latency = latency_s
        # store-side occupancy: objects published but not yet released
        # (the channel API makes lifetimes explicit, so this is auditable)
        self.resident_objects = 0              # guarded-by: _lock
        self.peak_resident_objects = 0         # guarded-by: _lock

    def _wire_time(self, nbytes: int) -> float:
        return self.latency + nbytes / self.bandwidth

    def _pack(self, payload: Any) -> Tuple[Any, float]:
        leaves, treedef = tree.flatten(payload)
        blobs = []
        nbytes = 0
        for leaf in leaves:
            if hasattr(leaf, "shape"):
                arr = np.asarray(leaf)
                raw = arr.tobytes()
                nbytes += len(raw)
                blobs.append(("arr", raw, arr.dtype.str, arr.shape))
            else:
                blobs.append(("py", leaf, None, None))
        return (blobs, treedef, nbytes), self._wire_time(nbytes)

    def _unpack(self, entry: Any) -> Tuple[Any, float]:
        blobs, treedef, nbytes = entry
        leaves = []
        for kind, data, dtype, shape in blobs:
            if kind == "arr":
                leaves.append(np.frombuffer(data, dtype=dtype).reshape(shape))
            else:
                leaves.append(data)
        return tree.unflatten(treedef, leaves), self._wire_time(nbytes)

    def _publish(self, key: str, entry: Any) -> None:  # requires-lock: _lock
        if key not in self._entries:
            self.resident_objects += 1
            self.peak_resident_objects = max(self.peak_resident_objects,
                                             self.resident_objects)
        self._entries[key] = entry

    def _evict(self, key: str) -> None:  # requires-lock: _lock
        if self._entries.pop(key, None) is not None:
            self.resident_objects -= 1


def make_connector(name: str, **kw) -> Connector:
    from repro_torch.connector.inline import InlineConnector
    from repro_torch.connector.shm import SharedMemoryConnector
    if name == "inline":
        return InlineConnector()
    if name == "shm":
        return SharedMemoryConnector()
    if name == "mooncake":
        return MooncakeConnector(**kw)
    raise ValueError(f"unknown connector {name!r}")
