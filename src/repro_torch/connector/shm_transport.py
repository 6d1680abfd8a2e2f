"""Named shared-memory data plane for cross-process transfers.

This is the transport that promotes the shm connector (and the process
stage workers built on it) from "host-buffer copy inside one address
space" to a genuinely cross-process hop: array payloads are written into
one named ``multiprocessing.shared_memory`` segment, and a small
picklable *manifest* (segment name + per-array slot layout + the
non-array skeleton of the payload) travels over the control channel —
a queue, pipe, or any other metadata path.  The receiving process
attaches the segment by name, copies the arrays out, and reconstructs
the payload; the creator (or anyone holding the manifest) unlinks the
segment to end its lifetime.

Deliberately import-light: numpy only, no torch — spawned worker
children attach manifests without paying the torch import.  Payload structure is
flattened with a small pure-python walk over dict/list/tuple containers
(everything the in-repo payloads use); non-array leaves ride inside the
manifest itself and are pickled by whatever carries it.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

try:                                     # unavailable on exotic platforms
    from multiprocessing import shared_memory as _shm
except ImportError:                      # pragma: no cover
    _shm = None


def available() -> bool:
    """True when named shared-memory segments can be created here."""
    return _shm is not None


@dataclass
class _ArrRef:
    """Marker inside a skeleton: leaf lives in segment slot ``i``."""
    i: int


@dataclass
class SegmentManifest:
    """Everything a *different process* needs to rebuild the payload.

    Picklable; ship it over any control channel.  ``slots`` are
    ``(dtype_str, shape, offset, size)`` views into the named segment;
    ``skeleton`` is the payload structure with arrays replaced by
    :class:`_ArrRef` markers and all other leaves inline.
    """
    segment: Optional[str]               # None: no arrays, skeleton-only
    nbytes: int
    slots: List[Tuple[str, tuple, int, int]] = field(default_factory=list)
    skeleton: Any = None


def _flatten(obj: Any, arrays: List[np.ndarray]) -> Any:
    """Payload -> skeleton; array leaves appended to ``arrays``."""
    if isinstance(obj, dict):
        return {k: _flatten(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        flat = [_flatten(v, arrays) for v in obj]
        return flat if isinstance(obj, list) else tuple(flat)
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        arrays.append(np.ascontiguousarray(np.asarray(obj)))
        return _ArrRef(len(arrays) - 1)
    return obj


def _unflatten(skel: Any, leaves: List[np.ndarray]) -> Any:
    if isinstance(skel, dict):
        return {k: _unflatten(v, leaves) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        flat = [_unflatten(v, leaves) for v in skel]
        return flat if isinstance(skel, list) else tuple(flat)
    if isinstance(skel, _ArrRef):
        return leaves[skel.i]
    return skel


def write_segment(payload: Any) -> Tuple[Optional[Any], SegmentManifest]:
    """Serialize ``payload`` into one named segment.

    Returns ``(shm, manifest)``; ``shm`` (kept by the creator for
    lifetime control) is None when the payload holds no arrays — the
    manifest alone carries it.
    """
    if _shm is None:
        raise RuntimeError("shared_memory unavailable on this platform")
    arrays: List[np.ndarray] = []
    skeleton = _flatten(payload, arrays)
    slots: List[Tuple[str, tuple, int, int]] = []
    offset = 0
    for a in arrays:
        slots.append((a.dtype.str, tuple(a.shape), offset, a.nbytes))
        offset += a.nbytes
    if not arrays or offset == 0:
        # no array bytes to share — but keep slot metadata so zero-size
        # arrays still rebuild with their dtype/shape
        return None, SegmentManifest(segment=None, nbytes=0, slots=slots,
                                     skeleton=skeleton)
    seg = _shm.SharedMemory(create=True, size=offset)
    for a, (_, _, off, size) in zip(arrays, slots):
        seg.buf[off:off + size] = a.tobytes()
    return seg, SegmentManifest(segment=seg.name, nbytes=offset,
                                slots=slots, skeleton=skeleton)


def _attach(name: str):
    """Attach an existing segment for a READ that does not adopt
    ownership.

    Tracker bookkeeping: spawned children inherit the parent's resource
    tracker (one shared cache for the whole process tree), so a segment
    is registered exactly once at create and unregistered exactly once
    at unlink — whichever process performs them.  A pre-3.13 attach
    re-registers the name, which is a harmless set no-op on the shared
    tracker; explicitly unregistering here (the classic "attach
    workaround") would instead drop the creator's live registration and
    make the eventual unlink crash the tracker.  3.13+ can say what it
    means with ``track=False``."""
    if sys.version_info >= (3, 13):      # track= landed in 3.13
        return _shm.SharedMemory(name=name, track=False)
    return _shm.SharedMemory(name=name)


def read_manifest(manifest: SegmentManifest) -> Any:
    """Rebuild the payload in THIS process (copying arrays out, so the
    result outlives the segment)."""
    leaves: List[np.ndarray] = []
    if manifest.segment is None:
        for dtype, shape, _, _ in manifest.slots:
            leaves.append(np.empty(shape, dtype=np.dtype(dtype)))
        return _unflatten(manifest.skeleton, leaves)
    seg = _attach(manifest.segment)
    try:
        for dtype, shape, off, size in manifest.slots:
            raw = bytes(seg.buf[off:off + size])
            leaves.append(np.frombuffer(raw, dtype=np.dtype(dtype))
                          .reshape(shape))
    finally:
        seg.close()
    return _unflatten(manifest.skeleton, leaves)


def release_manifest(manifest: SegmentManifest) -> None:
    """End the segment's lifetime from any process holding the manifest
    (idempotent: an already-unlinked segment is fine)."""
    if manifest.segment is None:
        return
    try:
        # plain (tracked) attach on purpose: unlink() below unregisters
        # the name from the process tree's shared resource tracker, so
        # the create-time registration balances no matter which process
        # performs the release
        seg = _shm.SharedMemory(name=manifest.segment)
    except FileNotFoundError:
        return
    try:
        seg.close()
        seg.unlink()
    except FileNotFoundError:            # pragma: no cover — racing release
        pass


# -- send/recv over a queue-like control channel ----------------------------

def ship(channel_put, payload: Any) -> None:
    """Write ``payload`` to a segment and put its manifest on a control
    channel (``channel_put`` is e.g. ``mp.Queue.put``).  Ownership of the
    segment passes to the receiver: the creator closes its mapping but
    does not unlink — ``read_and_release`` on the other side does."""
    seg, manifest = write_segment(payload)
    if seg is not None:
        seg.close()                      # tracker entry cleared at unlink
    channel_put(manifest)


def read_and_release(manifest: SegmentManifest) -> Any:
    """Receiver side of :func:`ship`: rebuild, then unlink."""
    try:
        return read_manifest(manifest)
    finally:
        release_manifest(manifest)
