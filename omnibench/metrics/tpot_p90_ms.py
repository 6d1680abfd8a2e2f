"""p90 over requests of the mean gap between a request's streamed tokens,
(last token - first token) / (tokens - 1): over every request due in the
window of an open loop, and over the tokens inside the window of a
closed loop (every request with two or more there)."""
from omnibench import readers


def read(measured):
    v = readers.pct_finite([readers.per_request_tpot_s(measured, r)
                            for r in measured.counted], 90)
    return None if v is None else 1e3 * v
