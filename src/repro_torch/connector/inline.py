"""Inline connector: control-queue pass-by-reference for small payloads
(single-node, same-process engines).

No copy is made: ``send`` publishes the object reference and ``recv``
hands it straight to the consumer, so cross-thread visibility is provided
entirely by the base class's lock/condition pair.  The base class's
identity ``_pack``/``_unpack`` and dict ``_publish``/``_fetch``/``_evict``
are exactly that behavior."""
from __future__ import annotations

from repro_torch.connector.base import Connector


class InlineConnector(Connector):
    name = "inline"
