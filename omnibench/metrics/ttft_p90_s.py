"""p90 over every request due in the window of its due instant to its
first streamed token; a request that failed or never finished lies
beyond every other."""
from omnibench import stats


def read(measured):
    if measured.window.loop != "open":
        return None
    return stats.pct([measured.latency(r, "first") for r in measured.counted], 90)
