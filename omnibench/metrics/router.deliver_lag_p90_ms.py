"""p90 over the output chunks delivered in the window of the time from
the engine building a chunk's event (``StageEvent.t_emit``) to the
router handing it to its request (``Request.chunk_times``), outside the
profiled slice."""
from omnibench import stats


def read(measured):
    p = measured.profile
    lags = [t - e for r in measured.records for t, e, _ in getattr(r.req, "chunk_times", ())
            if e is not None and measured.in_window(t)
            and not (p is not None and p.t0 <= t <= p.t1)]
    return 1e3 * stats.pct(lags, 90) if lags else None
