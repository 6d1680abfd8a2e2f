"""Mean per request of the PD hop, from the benchmark's spans in the
window: the prefill engine's ``extract_kv`` (host clock: it ends in a
copy to the host), the connector's ``send`` and ``recv`` (host clock)
and the decode engine's ``inject_kv`` (its stream's span on the card)."""
from omnibench import readers


def read(measured):
    extract = readers.spans(measured, "extract_kv")
    if not extract:
        return None
    total = (sum(s.host_s for s in extract)
             + sum(s.host_s for s in readers.spans(measured, "send"))
             + sum(s.host_s for s in readers.spans(measured, "recv"))
             + sum(s.seconds for s in readers.spans(measured, "inject_kv")))
    return 1e3 * total / len(extract)
