"""Serving launcher of the PyTorch port (runs on the card by default).

Three modes:
  - pipeline (offline): serve an any-to-any stage-graph pipeline through
    the per-stage-worker backend, batch-submitted at t=0
      PYTHONPATH=src python -m repro_torch.launch.serve --pipeline qwen_omni \
          --requests 8 --max-batch 4
    pipelines: qwen_omni, qwen3_omni (CNN vocoder), glm_image, mimo_audio,
    pd (prefill -> decode, prompt KV over the connector)
  - pipeline --online: Poisson arrivals + admission control + streaming
    result consumption — each stage batches independently in its own
    worker thread while the front-end keeps admitting
      PYTHONPATH=src python -m repro_torch.launch.serve --pipeline qwen_omni \
          --online --requests 16 --rate 4.0 --max-inflight 8
  - single: serve one dense, MoE, SSM or hybrid architecture
    (smoke-scale) as a 1-stage graph
      PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b \
          --requests 4
      PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b
      PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b

``--device`` defaults to ``cuda``; without a card the launcher stops with
an error unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import queue
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.pipelines import (_kv, build_ar_dit, build_mimo_audio,
                                           build_pd_disaggregated, build_qwen_omni)
from repro_torch.core.config import ServeConfig
from repro_torch.core.graph import StageGraph
from repro_torch.core.metrics import stage_report, summarize, summarize_queueing
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.request import Request
from repro_torch.core.stage import StageSpec
from repro_torch.device import resolve_device
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.sampling import SamplingParams
from repro_torch.models import transformer as T


def build_single_arch(arch: str, max_batch: int, max_new: int, seed: int = 0,
                      prefix_cache: bool = False, device=None, *,
                      smoke: bool = True, max_seq: int = 256):
    """One dense, MoE, SSM or hybrid architecture as a one-stage AR graph.
    ``smoke=False`` serves the published config (``CONFIG``); ``max_seq``
    sizes each sequence's KV pages (or the hybrid's dense KV caches)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))

    def make_engine():
        return AREngine(
            arch, cfg, params, kv=_kv(max_batch, max_seq), max_batch=max_batch,
            enable_prefix_cache=prefix_cache,
            default_sampling=SamplingParams(max_new_tokens=max_new,
                                            temperature=0.8, top_k=20),
            seed=seed)

    graph = StageGraph()
    graph.add_stage(StageSpec(arch, "ar", is_output=True))
    return graph, {arch: make_engine()}, {
        "cfg": cfg, "params": params, "engine_factories": {arch: make_engine}}


def _make_inputs(pipeline, rng):
    if pipeline == "mimo_audio":
        return {"audio": rng.standard_normal((32, 16)).astype(np.float32)}
    return {"tokens": rng.integers(0, 200, size=int(
        rng.integers(6, 24))).astype(np.int32)}


def serve_online(orch: Orchestrator, pipeline=None, *, n_requests: int,
                 rate_hz: float, max_inflight: int, seed: int = 0,
                 time_limit: float = 300.0, verbose: bool = True):
    """Online front-end: Poisson arrivals, admission control (at most
    ``max_inflight`` requests in the backend; later arrivals wait in the
    admission queue), streaming consumption of completions as they finish.

    Request.arrival_time is stamped at the Poisson arrival instant, so JCT
    and TTFT include any admission-control wait.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate_hz, 1e-9),
                                         size=n_requests))
    inputs = [_make_inputs(pipeline, rng) for _ in range(n_requests)]

    orch.start()
    t0 = time.perf_counter()
    reqs, admission_q = [], []
    submitted = done = i = 0
    while done < n_requests:
        now = time.perf_counter() - t0
        while i < n_requests and arrivals[i] <= now:
            reqs.append(Request(inputs=inputs[i]))     # arrival stamp = now
            admission_q.append(reqs[-1])
            i += 1
        # admission control: bound the work resident in the backend
        while admission_q and submitted - done < max_inflight:
            orch.submit(admission_q.pop(0))
            submitted += 1
        try:                                   # streaming result consumption
            r = orch.completions.get(timeout=0.005)
            done += 1
            if verbose:
                state = "FAILED " + r.failed if r.failed else "ok"
                ttft = (r.first_output_time - r.arrival_time
                        if r.first_output_time else float("nan"))
                print(f"  req {r.req_id}: jct={r.jct:.3f}s ttft={ttft:.3f}s "
                      f"[{state}]")
        except queue.Empty:
            pass
        if orch.worker_error:                  # fail fast on a dead stage
            print(f"stage worker died: {orch.worker_error} "
                  f"({done}/{n_requests} served)")
            break
        if time.perf_counter() - t0 > time_limit:
            print(f"time limit {time_limit}s hit with {done}/{n_requests}")
            break
    wall = time.perf_counter() - t0
    # nothing is in flight on the normal exit; on the abnormal exits we
    # must NOT block draining a backlog past the measurement window
    orch.shutdown(drain=False)
    return reqs, wall


_EPILOG = """\
serving configuration (ServeConfig):
  Every flag below the line funnels through ServeConfig.from_args into
  one typed, validated config object — the same API library callers use:

      from repro_torch.core.config import ServeConfig, StageConfig, EngineSpec
      config = ServeConfig(
          backend="threaded", routing="affinity", queue_capacity=64,
          stages={"decode": StageConfig(
              replicas=2, isolation="process",
              engine_spec=EngineSpec(
                  "repro_torch.configs.pipelines:build_stage_engine",
                  {"pipeline": "pd", "stage": "decode"}))})
      orch = Orchestrator(graph, engines, config=config)

  isolation="process" serves a stage from spawned OS processes, each of
  which rebuilds its engine from the spec on the spec's device: request
  tensors travel through named shared-memory segments, a dead replica is
  detected by heartbeat and its in-flight requests re-admitted to the
  survivors.

examples:
  # 2 talker replicas, affinity routing
  python -m repro_torch.launch.serve --pipeline qwen_omni --requests 16 \\
      --replicas talker=2

  # decode stage in its own process, 5s recv timeout
  python -m repro_torch.launch.serve --pipeline pd --requests 8 \\
      --isolation decode=process --recv-timeout 5
"""


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pipeline", default=None,
                    choices=[None, "qwen_omni", "qwen3_omni", "glm_image",
                             "mimo_audio", "pd"])
    ap.add_argument("--arch", default=None,
                    help="serve one dense, SSM or hybrid architecture's "
                         "SMOKE_CONFIG")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="threaded",
                    choices=["threaded", "sync"],
                    help="threaded = per-stage workers (default); "
                         "sync = lock-step ablation baseline")
    ap.add_argument("--online", action="store_true",
                    help="Poisson arrivals + admission control + streaming "
                         "result consumption (threaded backend only)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="--online arrival rate (req/s)")
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="--online admission control limit")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="block-level KV prefix caching on every AR stage "
                         "(default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--replicas", default=None, metavar="STAGE=N[,STAGE=N]",
                    help="serve a stage with N engine replicas, e.g. "
                         "--replicas talker=2 (threaded backend)")
    ap.add_argument("--routing", default="affinity",
                    choices=["round_robin", "least_loaded", "affinity"],
                    help="replica routing policy (default affinity)")
    ap.add_argument("--isolation", default=None,
                    metavar="STAGE=MODE[,..]|MODE",
                    help="replica isolation per stage (thread|process), "
                         "e.g. --isolation decode=process; a bare mode "
                         "applies to every stage. process replicas run "
                         "in spawned workers with shared-memory tensor "
                         "transport (threaded backend only)")
    ap.add_argument("--queue-capacity", dest="queue_capacity", type=int,
                    default=64,
                    help="bounded per-stage worker inbox (backpressure)")
    ap.add_argument("--recv-timeout", dest="recv_timeout", type=float,
                    default=60.0,
                    help="connector receive timeout in seconds")
    ap.add_argument("--no-warm-seed", dest="warm_seed",
                    action="store_false", default=True,
                    help="disable warm-seeding scaled-up replicas")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the ScalingController: move replicas to the "
                         "bottleneck stage at runtime from WorkerMetrics "
                         "(busy fraction + backlog pressure)")
    ap.add_argument("--replica-budget", type=int, default=None,
                    help="--autoscale global replica budget (default: the "
                         "total launched replicas; extra headroom lets the "
                         "controller ADD replicas instead of moving them)")
    ap.add_argument("--scale-interval", type=float, default=0.25,
                    help="--autoscale decision window in seconds")
    args = ap.parse_args()

    if args.replicas and args.backend != "threaded":
        ap.error("--replicas requires --backend threaded")
    if args.isolation and args.backend != "threaded":
        ap.error("--isolation requires --backend threaded")
    if args.online and args.backend != "threaded":
        ap.error("--online requires --backend threaded")
    if args.autoscale and args.backend != "threaded":
        ap.error("--autoscale requires --backend threaded")
    device = resolve_device(args.device)

    if args.pipeline == "qwen_omni":
        graph, engines, bundle = build_qwen_omni(
            max_batch=args.max_batch, prefix_cache=args.prefix_cache,
            device=device)
    elif args.pipeline == "qwen3_omni":
        graph, engines, bundle = build_qwen_omni(
            max_batch=args.max_batch, vocoder_kind="cnn",
            prefix_cache=args.prefix_cache, device=device)
    elif args.pipeline == "glm_image":
        graph, engines, bundle = build_ar_dit(
            "glm_image", max_batch=args.max_batch,
            prefix_cache=args.prefix_cache, device=device)
    elif args.pipeline == "mimo_audio":
        graph, engines, bundle = build_mimo_audio(
            max_batch=args.max_batch, prefix_cache=args.prefix_cache,
            device=device)
    elif args.pipeline == "pd":
        graph, engines, bundle = build_pd_disaggregated(
            max_batch=args.max_batch, max_new=args.max_new,
            prefix_cache=args.prefix_cache, device=device)
    elif args.arch:
        graph, engines, bundle = build_single_arch(
            args.arch, args.max_batch, args.max_new, args.seed,
            prefix_cache=args.prefix_cache, device=device)
    else:
        ap.error("pass --pipeline or --arch")

    try:
        config = ServeConfig.from_args(
            args, engine_factories=bundle.get("engine_factories"),
            engine_specs=bundle.get("engine_specs"))
        orch = Orchestrator(graph, engines, config=config)
    except ValueError as e:
        ap.error(str(e))
    scaler = None
    if args.autoscale:
        from repro_torch.core.scaling import ScalingConfig, ScalingController
        scaler = ScalingController(orch, ScalingConfig(
            interval=args.scale_interval,
            replica_budget=args.replica_budget)).start()
    rng = np.random.default_rng(args.seed)

    if args.online:
        reqs, wall = serve_online(
            orch, args.pipeline, n_requests=args.requests,
            rate_hz=args.rate, max_inflight=args.max_inflight,
            seed=args.seed)
    else:
        t0 = time.perf_counter()
        if args.backend == "threaded":
            orch.start()          # admissions route through stage workers
        reqs = []
        for _ in range(args.requests):
            reqs.append(Request(inputs=_make_inputs(args.pipeline, rng)))
            orch.submit(reqs[-1])
        orch.run()
        wall = time.perf_counter() - t0

    m = summarize(reqs, wall_time=wall)
    done = [r for r in reqs if r.completion_time is not None]
    print(f"completed {len(done)}/{args.requests} requests "
          f"in {wall:.2f}s  ({m['req_per_s']:.2f} req/s)  "
          f"backend={args.backend} device={device}")
    print(f"JCT p50={m['jct_p50']:.3f}s p95={m['jct_p95']:.3f}s  "
          f"TTFT p50={m['ttft_p50']:.3f}s")
    if args.backend == "threaded":
        print(stage_report(orch.stage_metrics()))
        qd = summarize_queueing(reqs)
        if qd:
            print("per-request queueing delay:",
                  {k: f"p95={v['p95']*1e3:.2f}ms" for k, v in qd.items()})
        if args.replicas or args.isolation or args.autoscale:
            print("replicas:", orch.replica_counts(),
                  f"routing={args.routing}")
        if scaler is not None:
            print(f"autoscale: {scaler.windows} windows, "
                  f"{len(scaler.action_log())} action(s)")
            for a in scaler.action_log():
                src = f" from {a['donor']}" if "donor" in a else ""
                seed = (f" warm-seeded {a['warm_seed']['pages']} pages"
                        if "warm_seed" in a else "")
                print(f"  {a['kind']} -> {a['stage']}{src} "
                      f"(pressure={a['pressure']:.2f} "
                      f"busy={a['busy']:.2f} backlog={a['backlog']:.0f}) "
                      f"replicas={a['replicas']}{seed}")
    else:
        print("stage busy:", {k: round(v, 3)
                              for k, v in orch.stage_busy_times().items()})
    for kind, st in orch.connector_stats().items():
        print(f"connector[{kind}]: {st.calls} transfers, {st.bytes} bytes, "
              f"{st.wall_time*1e3:.2f} ms wall")
    for name in graph.stages:
        ps: dict = {}
        for eng in orch.stage_replicas[name]:       # summed over replicas
            for k, v in (getattr(eng, "prefix_stats", None) or {}).items():
                ps[k] = ps.get(k, 0) + v
        if ps.get("lookups"):
            tot = ps["cached_tokens"] + ps["computed_tokens"]
            rate = 100.0 * ps["cached_tokens"] / tot if tot else 0.0
            print(f"prefix-cache[{name}]: hits={ps['hits']}/"
                  f"{ps['lookups']} cached={ps['cached_tokens']} "
                  f"(full-block {ps.get('full_block_tokens', 0)} + "
                  f"partial {ps.get('partial_tokens', 0)} in "
                  f"{ps.get('partial_hits', 0)} partial hits) "
                  f"computed={ps['computed_tokens']} tokens "
                  f"(hit-rate {rate:.1f}%)")
    if len(done) < args.requests or any(r.failed for r in reqs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
