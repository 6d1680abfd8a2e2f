"""p90 over every request due in the window of its due instant to its
last streamed token (job completion time)."""
from omnibench import stats


def read(measured):
    if measured.window.loop != "open":
        return None
    return stats.pct([measured.latency(r, "last") for r in measured.counted], 90)
