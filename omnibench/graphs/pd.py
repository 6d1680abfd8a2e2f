"""Prefill/decode disaggregation on one card: the port's two-stage PD
graph (``configs/pipelines.py: build_pd_disaggregated``), built from the
same parts with the benchmark's weights handed over in place.

A prefill engine computes the prompt (chunked, through the paged pool)
and samples the first token; the in-process ``shm`` connector carries
the prompt's KV to a decode engine, which serves the rest.  Both stages
are threads of this process on the one card.  The prefill engine keeps
its one-token default sampling; the decode engine has none, so each
request's own ``sampling`` holds, and it streams every token.
"""
from repro_torch.configs.pipelines import _kv, _kv_hop
from repro_torch.core.graph import StageGraph
from repro_torch.core.stage import StageSpec
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.sampling import SamplingParams

OUTPUT_STAGE = "decode"


def build(cfg, params, serve: dict, seed: int):
    mb, ms = serve["max_batch"], serve["max_seq"]
    common = dict(max_batch=mb, token_budget=serve["token_budget"],
                  chunk_size=serve["chunk_size"], seed=seed)
    prefill = AREngine("prefill", cfg, params, kv=_kv(mb, ms), emit_kv=True,
                       default_sampling=SamplingParams(max_new_tokens=1, temperature=0.0),
                       **common)
    decode = AREngine("decode", cfg, params, kv=_kv(mb, ms), stream_chunk=1,
                      default_sampling=None, **common)
    graph = StageGraph()
    graph.add_stage(StageSpec("prefill", "ar"))
    graph.add_stage(StageSpec("decode", "ar", is_output=True))
    graph.add_edge("prefill", "decode", _kv_hop, connector=serve["connector"])
    return graph, {"prefill": prefill, "decode": decode}
