"""Process-isolated stage replicas via ServeConfig.

A prefill→decode pipeline where the decode stage runs in spawned OS
processes: the child rebuilds its engine from a picklable EngineSpec,
prompt KV crosses the process boundary through the shared-memory
connector (named segments + manifests), and greedy outputs match the
all-thread run exactly.  Killing a process replica mid-run re-admits
its in-flight requests to the survivor — zero requests lost.

  PYTHONPATH=src python examples/process_isolation_torch.py [--device cuda]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.pipelines import build_pd_disaggregated
from repro_torch.core.config import ServeConfig, StageConfig
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.request import Request


def run(device=None, weights=None, *, cfg=None, prompts=None, max_new=8,
        max_seq=256, spawn=True):
    """Serve ``prompts`` (default: 4 of 5, 19, 33 and 12 tokens) with the
    decode stage as 2 spawned replicas, or with ``spawn=False`` every
    stage a thread of this process.  ``cfg`` (default a tiny LM) and
    ``max_seq`` size the model and its KV pages; ``weights``, a numpy
    tree of the JAX package's layout, replaces the seeded draw.  Returns
    the requests (in submission order and as they finished), the decode
    stage's metrics, each decode child's last status and the wall time
    from the first submit."""
    # 1) a pipeline bundle: every builder attaches picklable
    #    `engine_specs` ("module:callable" + kwargs) alongside the live
    #    engines — specs are the only engine form that can cross a
    #    spawn boundary (deterministic builders, same seed → same params;
    #    the spec carries the device and any given weights)
    graph, engines, bundle = build_pd_disaggregated(
        cfg, max_batch=4, max_new=max_new, max_seq=max_seq, device=device,
        weights=weights)

    # 2) one typed config for the whole serving surface: decode runs as
    #    2 spawned process replicas, prefill stays a thread
    config = ServeConfig(
        routing="affinity",
        stages={"decode": StageConfig(
            replicas=2,
            isolation="process",
            engine_spec=bundle["engine_specs"]["decode"])}) if spawn else None

    orch = Orchestrator(graph, engines, config=config)
    orch.start()                         # spawn now, before timing anything
    children = [w for _, w in orch._workers["decode"].workers()
                if hasattr(w, "wait_ready")]
    for w in children:                   # each child has built its engine
        w.wait_ready(timeout=w.ready_timeout)

    # 3) serve: prompt KV travels prefill→decode through the shm
    #    connector — cross_process=True ships segment manifests, so the
    #    decode child attaches the same named segment the prefill thread
    #    wrote (one copy, no pickling of the KV arrays)
    if prompts is None:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 500, size=n).astype(np.int32)
                   for n in (5, 19, 33, 12)]
    reqs = [Request(inputs={"tokens": p}) for p in prompts]
    t0 = time.perf_counter()
    for r in reqs:
        orch.submit(r)
    finished = orch.run(timeout=300.0)
    wall = time.perf_counter() - t0

    # 4) the process replicas report the same metrics as threads —
    #    WorkerMetrics snapshots ride the control pipe home
    return {"requests": reqs, "finished": finished,
            "decode": orch.stage_metrics()["decode"],
            "children": [dict(w.status) for w in children], "wall": wall}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    args = ap.parse_args()
    out = run(args.device)
    for req in out["finished"]:
        toks = req.outputs["decode"][0]["tokens"]
        print(f"req {req.req_id}: jct={req.jct:.3f}s "
              f"tokens={[int(t) for t in toks]}")
    m = out["decode"]
    print(f"decode: finished={m['finished']} n_replicas={m['n_replicas']} "
          f"replica_failures={m['replica_failures']}")


if __name__ == "__main__":
    main()
