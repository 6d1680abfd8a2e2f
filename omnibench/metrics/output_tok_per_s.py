"""Every output token the clients received inside the window, whether or
not its request finished, over the window's seconds."""


def read(measured):
    n = sum(n for r in measured.records for t, n in r.stamps if measured.in_window(t))
    return n / measured.seconds
