"""The paged-attention kernel's share of its roofline over the profiled
slice: the mean bound of a call (each active row's K/V pages, q and the
output once each, at 3.35 TB/s; ``counts.paged_attention_call``) over
the mean device time of a call (split kernel plus combine kernel, by
the profiler).  Calls are the decode steps' in the slice, one per layer."""
from omnibench import counts

SPLIT, COMBINE = "paged_attention_split_kernel", "paged_attention_combine_kernel"


def read(measured):
    p = measured.profile
    if p is None or not p.complete:
        return None
    launches = sum(n for k, n in p.op_counts.items() if SPLIT in k)
    kernel_s = sum(s for k, s in p.op_seconds.items() if SPLIT in k or COMBINE in k)
    steps = [s for s in measured.spans if s.kind == "decode" and p.t0 <= s.t0 <= p.t1]
    if not launches or not steps:
        return None
    m, page = measured.model, measured.serve["page_size"]
    bounds = [counts.bound_s(*counts.paged_attention_call(
        m["num_heads"], m["num_kv_heads"], m["head_dim"], page, s.meta["contexts"]))
        for s in steps]
    return 100.0 * (sum(bounds) / len(bounds)) / (kernel_s / launches)
