"""The Mamba1 scan's one-step kernel (``mamba1_step_kernel``, which each
Mamba layer of a decode step launches once) against its roofline over the
profiled slice: the mean bound of a decode step's scan call (its active
rows' x, dt, B and C, A and D, h read and written, y written, at 3.35
TB/s; the family's ``scan_decode_call``) over the mean device time of
the kernel.  A prefill chunk of one token launches the same kernel for
one row, and is counted among the kernel's launches.  Nothing for a slice
whose device records miss most kernels, or for a family without Mamba
layers."""
from omnibench import counts, readers

STEP = "mamba1_step_kernel"


def read(measured):
    p = measured.profile
    fam = readers.family(measured)
    if p is None or not p.complete or not hasattr(fam, "scan_decode_call"):
        return None
    launches = sum(n for k, n in p.op_counts.items() if STEP in k)
    kernel_s = sum(s for k, s in p.op_seconds.items() if STEP in k)
    steps = [s for s in measured.spans if s.kind == "decode" and p.t0 <= s.t0 <= p.t1]
    if not launches or not steps:
        return None
    bounds = [counts.bound_s(*fam.scan_decode_call(measured.model, len(s.meta["contexts"])))
              for s in steps]
    return 100.0 * (sum(bounds) / len(bounds)) / (kernel_s / launches)
