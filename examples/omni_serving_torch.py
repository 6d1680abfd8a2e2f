"""End-to-end driver: serve a Thinker->Talker->Vocoder any-to-any pipeline
(Qwen-Omni style, paper Fig 4) with batched requests and streaming synthesis,
and compare against the monolithic HF-style baseline.

  PYTHONPATH=src python examples/omni_serving_torch.py [--requests 8] [--device cuda]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.baselines.monolithic import MonolithicQwenOmni
from repro_torch.configs.pipelines import build_qwen_omni
from repro_torch.convert import load_numpy_, params_from_numpy
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.request import Request
from repro_torch.models.dit import DiTConfig, init_dit


def run(requests=8, thinker_tokens=10, talker_tokens=40, device=None,
        weights=None):
    """Serve ``requests`` prompts disaggregated, then through the
    monolithic baseline.  ``weights`` (any of the bundle's
    "thinker_params", "talker_params", "codec_embed", "dit_params", and
    "vocoder" for the baseline's DiT: numpy trees of the JAX package's
    layout) replace the seeded draws.  Returns the requests, the wall
    time, stage busy times, the baseline's results and both mean JCTs."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, size=int(rng.integers(8, 24))
                            ).astype(np.int32) for _ in range(requests)]
    weights = dict(weights or {})

    # ---------------- disaggregated serving (this work) ----------------
    graph, engines, bundle = build_qwen_omni(
        max_batch=4, thinker_tokens=thinker_tokens,
        talker_tokens=talker_tokens, stream_chunk=8, dit_steps=4,
        device=device)
    vocoder_weights = weights.pop("vocoder", None)
    for key, tree in weights.items():
        load_numpy_(bundle[key], tree)
    orch = Orchestrator(graph, engines)
    # warmup (the first calls build the kernels' libraries on the card)
    orch.submit(Request(inputs={"tokens": prompts[0]}))
    orch.run()
    t0 = time.perf_counter()
    reqs = [Request(inputs={"tokens": p}) for p in prompts]
    for r in reqs:
        orch.submit(r)
    orch.run()
    wall = time.perf_counter() - t0

    # ---------------- monolithic baseline ------------------------------
    vcfg = DiTConfig(name="voc", num_layers=2, d_model=128, num_heads=4,
                     d_ff=256, in_dim=32, cond_dim=128, num_steps=4)
    dev = bundle["thinker_params"]["embed"].device
    vparams = (init_dit(vcfg, torch.Generator(dev).manual_seed(9))
               if vocoder_weights is None
               else params_from_numpy(vocoder_weights, dev))
    mono = MonolithicQwenOmni(bundle, (vcfg, vparams), dit_steps=4)
    mono.run(prompts[:1])                        # warmup
    res = mono.run(prompts)
    return {"requests": reqs, "wall": wall,
            "stage_busy": orch.stage_busy_times(), "monolithic": res,
            "jct": float(np.mean([r.jct for r in reqs])),
            "jct_monolithic": float(np.mean([r["jct"] for r in res]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--thinker-tokens", type=int, default=10)
    ap.add_argument("--talker-tokens", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    args = ap.parse_args()

    out = run(args.requests, args.thinker_tokens, args.talker_tokens,
              args.device)
    reqs = out["requests"]
    print(f"[disaggregated] {len(reqs)} requests in {out['wall']:.2f}s | "
          f"mean JCT {out['jct']:.3f}s | "
          f"stage busy {dict((k, round(v, 2)) for k, v in out['stage_busy'].items())}")
    for r in reqs[:2]:
        wavs = r.outputs["vocoder"]
        n = sum(c["latent"].shape[0] for c in wavs)
        print(f"  req {r.req_id}: text={r.data['thinker_tokens'][:6]}... "
              f"audio_frames={n} (streamed {len(wavs)} chunks)")
    print(f"[monolithic]    mean JCT {out['jct_monolithic']:.3f}s")
    print(f"JCT reduction: {100 * (1 - out['jct'] / out['jct_monolithic']):.1f}% "
          f"(paper reports up to 91.4% for Qwen3-Omni)")


if __name__ == "__main__":
    main()
