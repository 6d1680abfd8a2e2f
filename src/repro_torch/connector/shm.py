"""Shared-memory connector: single-node large-payload transport.

Two data planes share the same channel API and resident accounting:

  - in-process (default): payloads are flattened to contiguous host
    buffers (a real serialize copy — the analogue of writing into
    /dev/shm) and reconstructed on recv.
  - ``cross_process=True``: payloads are written into **named**
    ``multiprocessing.shared_memory`` segments via
    :mod:`repro_torch.connector.shm_transport`.  ``recv`` in the publishing
    process attaches the same segment; a *different* process receives by
    shipping the picklable :meth:`manifest` over a control channel and
    calling :func:`shm_transport.read_manifest` — this is how process
    stage replicas and the warm-seed transport move tensors across the
    spawn boundary.  ``release`` unlinks the segment.

Both serialize/deserialize copies run outside the connector lock
(``_pack``/``_unpack``), so concurrent stage workers move data in
parallel.  The pool tracks resident bytes and a high-water mark so the
explicit-lifetime channel API (``send``/``recv``/``release``) can be
audited for leaks: a serving run that never releases its keys shows up
as a monotonically growing ``resident_bytes`` (and, cross-process, as
orphaned /dev/shm segments).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

from repro_torch.connector import shm_transport, tree
from repro_torch.connector.base import Connector
from repro_torch.connector.shm_transport import SegmentManifest


@dataclass
class _SegEntry:
    """A published cross-process payload: the creator's live mapping (for
    same-process recv + unlink) and the shippable manifest."""
    seg: Any
    manifest: SegmentManifest


class SharedMemoryConnector(Connector):
    name = "shm"

    def __init__(self, cross_process: bool = False) -> None:
        super().__init__()
        if cross_process and not shm_transport.available():
            raise RuntimeError(
                "cross_process=True needs multiprocessing.shared_memory")
        self.cross_process = cross_process
        self.resident_bytes = 0                # guarded-by: _lock
        self.peak_resident_bytes = 0           # guarded-by: _lock

    # -- data plane (runs without the connector lock) ----------------------
    def _pack(self, payload: Any) -> Tuple[Any, float]:
        if self.cross_process:
            seg, manifest = shm_transport.write_segment(payload)
            return _SegEntry(seg, manifest), 0.0
        leaves, treedef = tree.flatten(payload)
        bufs = []
        nbytes = 0
        for leaf in leaves:
            if hasattr(leaf, "shape"):
                arr = np.asarray(leaf)
                raw = arr.tobytes()
                nbytes += len(raw)
                bufs.append(("arr", raw, arr.dtype.str, arr.shape))
            else:
                bufs.append(("py", leaf, None, None))
        return (bufs, treedef, nbytes), 0.0

    def _unpack(self, entry: Any) -> Tuple[Any, float]:
        if isinstance(entry, _SegEntry):
            return shm_transport.read_manifest(entry.manifest), 0.0
        bufs, treedef, _ = entry
        leaves = []
        for kind, data, dtype, shape in bufs:
            if kind == "arr":
                leaves.append(np.frombuffer(data, dtype=dtype).reshape(shape))
            else:
                leaves.append(data)
        return tree.unflatten(treedef, leaves), 0.0

    # -- cross-process control plane ---------------------------------------
    def manifest(self, key: str) -> SegmentManifest:
        """Picklable descriptor of a published key for a receiver in
        ANOTHER process (``shm_transport.read_manifest`` rebuilds the
        payload there).  The publisher still owns the lifetime: call
        ``release(key)`` here once the remote side confirmed receipt."""
        with self._lock:
            entry = self._entries[key]
        if not isinstance(entry, _SegEntry):
            raise RuntimeError(
                f"connector[shm] key {key!r} was published in-process; "
                f"construct SharedMemoryConnector(cross_process=True) "
                f"to export manifests")
        return entry.manifest

    # -- bookkeeping (runs under the connector lock) -----------------------
    @staticmethod
    def _entry_nbytes(entry: Any) -> int:
        return (entry.manifest.nbytes if isinstance(entry, _SegEntry)
                else entry[2])

    def _publish(self, key: str, entry: Any) -> None:  # requires-lock: _lock
        if key in self._entries:
            self._evict(key)
        self._entries[key] = entry
        self.resident_bytes += self._entry_nbytes(entry)
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes)

    def _evict(self, key: str) -> None:  # requires-lock: _lock
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self.resident_bytes -= self._entry_nbytes(entry)
        if isinstance(entry, _SegEntry) and entry.seg is not None:
            try:
                entry.seg.close()
                entry.seg.unlink()
            except FileNotFoundError:    # remote side released it first
                pass
