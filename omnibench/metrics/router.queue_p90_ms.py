"""p90 over the requests due in the window of the summed queueing delay
the stage workers noted on each (``Request.queue_delays``: submit to the
engine's admission, every stage)."""
from omnibench import stats


def read(measured):
    delays = [sum(sum(v) for v in r.req.queue_delays.values()) for r in measured.counted
              if r.req.queue_delays]
    return 1e3 * stats.pct(delays, 90) if delays else None
