"""Mean host time a decode call spends in its MoE blocks: the sum over
the layers of ``ln2`` through ``mlp_or_moe``'s residual add (the
``ffn_host_s`` that ``PagedRunner.decode`` notes on its ``model.decode``
span), outside the profiled slice; nothing for a model without experts."""
from omnibench.metrics import _program


def read(measured):
    if not measured.model.get("num_experts", 0):
        return None
    return _program.mean_ms([s.counts["ffn_host_s"]
                             for s in _program.spans(measured, "model.decode")
                             if "ffn_host_s" in s.counts])
