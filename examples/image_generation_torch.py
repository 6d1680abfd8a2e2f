"""GLM-Image style AR -> DiT pipeline: the LLM 'understands' the prompt and
emits VQ semantic tokens; a DiT decodes them into image latents.

  PYTHONPATH=src python examples/image_generation_torch.py [--device cuda]
"""
import argparse

import numpy as np

from repro_torch.configs.pipelines import build_ar_dit
from repro_torch.convert import load_numpy_
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.request import Request


def run(device=None, weights=None):
    """Serve 4 prompts of 12 tokens; ``weights`` (any of the bundle's
    "llm_params", "vq_embed", "dit_params": numpy trees of the JAX
    package's layout) replace the seeded draws.  Returns the finished
    requests."""
    graph, engines, bundle = build_ar_dit(
        "glm_image", max_batch=4, ar_tokens=16, image_latents=64,
        dit_steps=8, cache_interval=2,   # TeaCache-style reuse on
        device=device)
    for key, tree in (weights or {}).items():
        load_numpy_(bundle[key], tree)
    orch = Orchestrator(graph, engines)
    rng = np.random.default_rng(0)
    for i in range(4):
        orch.submit(Request(
            inputs={"tokens": rng.integers(0, 500, size=12).astype(np.int32)}))
    return {"requests": orch.run()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    args = ap.parse_args()
    for req in run(args.device)["requests"]:
        latent = req.outputs["glm_image_dit"][0]["latent"]
        print(f"req {req.req_id}: jct={req.jct:.3f}s image latent "
              f"{latent.shape} (std={latent.std():.3f})")


if __name__ == "__main__":
    main()
