"""One model as a one-stage AR graph, as ``launch/serve.py:
build_single_arch`` builds it, with the benchmark's weights handed over
in place, greedy per-request sampling (no default that would override
it) and every token streamed."""
from repro_torch.configs.pipelines import _kv
from repro_torch.core.graph import StageGraph
from repro_torch.core.stage import StageSpec
from repro_torch.engine.ar_engine import AREngine

OUTPUT_STAGE = "ar"


def build(cfg, params, serve: dict, seed: int):
    mb, ms = serve["max_batch"], serve["max_seq"]
    engine = AREngine(OUTPUT_STAGE, cfg, params, kv=_kv(mb, ms), max_batch=mb,
                      token_budget=serve["token_budget"], chunk_size=serve["chunk_size"],
                      stream_chunk=1, default_sampling=None, seed=seed)
    graph = StageGraph()
    graph.add_stage(StageSpec(OUTPUT_STAGE, "ar", is_output=True))
    return graph, {OUTPUT_STAGE: engine}
