"""Share of the card's bf16 peak (989 TFLOP/s) that the prefill chunks in
the window reach: the products and attention their tokens need (the
cell's family's ``prefill_chunk_flops``) over the chunks' time on their
stream."""
from omnibench import counts, readers


def read(measured):
    chunks = readers.spans(measured, "prefill_chunk")
    secs = sum(s.seconds for s in chunks)
    if not chunks or secs <= 0:
        return None
    fam = readers.family(measured)
    flops = sum(fam.prefill_chunk_flops(measured.model, s.meta["start"], s.meta["valid"])
                for s in chunks)
    return 100.0 * flops / (secs * counts.PEAK_FLOPS_BF16)
