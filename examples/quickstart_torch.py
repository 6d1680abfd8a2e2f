"""Quickstart: define a two-stage any-to-any pipeline with the stage-graph
API and serve a few requests.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.pipelines import _kv, tiny_lm
from repro_torch.convert import params_from_numpy
from repro_torch.core.graph import StageGraph
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.request import Request
from repro_torch.core.stage import StageSpec
from repro_torch.device import resolve_device
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.sampling import SamplingParams
from repro_torch.models import transformer as T


def run(device=None, weights=None):
    """Serve the 4 requests; ``weights`` ({"planner", "writer"}: numpy
    trees of the JAX package's layout) replace the seeded draws.  Returns
    the finished requests and the connector stats."""
    dev = resolve_device(device)
    # 1) models: a "planner" LM whose hidden states condition a "writer" LM
    planner_cfg = tiny_lm("planner", vocab=512)
    writer_cfg = tiny_lm("writer", vocab=512)
    if weights is None:
        planner_params = T.init_params(planner_cfg, torch.Generator(dev).manual_seed(0))
        writer_params = T.init_params(writer_cfg, torch.Generator(dev).manual_seed(1))
    else:
        planner_params = params_from_numpy(weights["planner"], dev)
        writer_params = params_from_numpy(weights["writer"], dev)

    # 2) engines: one per stage, independently configured (paper Fig 3(c))
    planner = AREngine("planner", planner_cfg, planner_params,
                       kv=_kv(4), max_batch=4, collect_hidden=True,
                       default_sampling=SamplingParams(max_new_tokens=8,
                                                       temperature=0.0))
    writer = AREngine("writer", writer_cfg, writer_params,
                      kv=_kv(4), max_batch=4,
                      default_sampling=SamplingParams(max_new_tokens=16,
                                                      temperature=0.7,
                                                      top_k=20))

    # 3) stage graph: nodes = stages, edges = transfer functions (Fig 3(b))
    graph = StageGraph()
    graph.add_stage(StageSpec("planner", "ar"))
    graph.add_stage(StageSpec("writer", "ar", is_output=True))
    graph.add_edge("planner", "writer",
                   lambda data, payload: {"prompt_embeds": payload["hidden"]},
                   connector="shm")

    # 4) serve
    orch = Orchestrator(graph, engines={"planner": planner, "writer": writer})
    rng = np.random.default_rng(0)
    for _ in range(4):
        orch.submit(Request(
            inputs={"tokens": rng.integers(0, 500, size=10).astype(np.int32)}))
    return {"requests": orch.run(),
            "connector_stats": {k: (s.calls, s.bytes)
                                for k, s in orch.connector_stats().items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    args = ap.parse_args()
    out = run(args.device)
    for req in out["requests"]:
        toks = req.outputs["writer"][0]["tokens"]
        print(f"req {req.req_id}: jct={req.jct:.3f}s "
              f"wrote {len(toks)} tokens: {toks[:8]}...")
    print("connector stats:", out["connector_stats"])


if __name__ == "__main__":
    main()
