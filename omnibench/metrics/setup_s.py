"""Process start to the window's opening: imports, the weights drawn on
the card, the engines and their KV pools, the kernels built or loaded,
the warm-up requests, and the traffic's pre-roll or ramp."""


def read(measured):
    return measured.setup_s
