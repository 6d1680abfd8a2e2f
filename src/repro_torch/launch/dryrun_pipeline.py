"""Production-scale PIPELINE dry-run: the paper's actual deployment case.

A Qwen3-Omni-like pipeline at full scale, with the paper's per-stage
accelerator allocation (Fig 3(c)) mapped to submeshes of one 16x16 pod:

  - Thinker  = qwen3-moe-30b-a3b (the assigned arch)   -> 16x8 submesh
  - Talker   = ~2B dense AR                            -> 16x4 submesh
  - Vocoder  = 24L DiT                                  -> 16x4 submesh

Each stage's serve step runs on meta DTensors on ITS OWN submesh, as
``launch/dryrun.py`` runs a step: a fresh fake process group of 256 ranks
per stage, this process playing a rank that lies inside the stage's
submesh, so the step's collectives are the stage's own.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline

Writes ``experiments/pipeline_dryrun_torch.json``: per stage its ranks,
``run_s``, ``args_gb_dev`` (argument bytes per device) and
``collective_bytes`` (their total), as the JAX package's records, whose
``compile_s`` and ``temp_gb_dev`` are XLA's alone.
"""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.launch.dryrun import (MetaGenerator, fake_world, meta_inputs, meta_params,
                                      run_step)
from repro_torch.launch.mesh import make_production_mesh, make_stage_submesh
from repro_torch.models import transformer as T
from repro_torch.models.dit import DiTConfig, dit_forward, init_dit
from repro_torch.sharding import specs as S
from repro_torch.sharding.context import DistContext

P = S.P

TALKER_CFG = ModelConfig(
    name="qwen3-omni-talker-2b", arch_type="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=5632, vocab_size=8192,   # codec vocabulary
    source="Qwen3-Omni technical report (talker, approx.)",
)

VOCODER_CFG = DiTConfig(
    name="qwen-omni-vocoder-dit", num_layers=24, d_model=1024, num_heads=16,
    d_ff=4096, in_dim=128, cond_dim=2048, num_steps=20, dtype="bfloat16")

B, CACHE = 64, 8192
# each stage's slice of the model axis, and the rank it runs at (row 0 of
# the 16x16 grid, the slice's first column)
STAGES = (("thinker(qwen3-moe-30b, 16x8)", 0, 8),
          ("talker(2B, 16x4)", 8, 12),
          ("vocoder(DiT-24L, 16x4)", 12, 16))


def carve(mesh) -> list:
    """The three stage submeshes of the 16x16 mesh, along "model"."""
    return [make_stage_submesh(mesh, "model", lo, hi) for _, lo, hi in STAGES]


def _decode_stage(cfg: ModelConfig, mesh):
    params_tpl = meta_params(cfg)
    params = S.distribute(params_tpl, mesh, S.param_specs(cfg, params_tpl, mesh), meta=True)
    cache_tpl = T.init_decode_cache(cfg, B, CACHE, device="meta")
    cspecs = S.kv_cache_specs(cfg, mesh, B)
    cache = S.distribute(cache_tpl, mesh, {k: cspecs[k] for k in cache_tpl}, meta=True)
    tok = meta_inputs(mesh, {"t": ((B, 1), torch.int32, P("data", None))})["t"]

    def step(params, cache, tokens):
        pos = torch.full((B,), CACHE - 1, dtype=torch.int32, device="meta")
        with torch.no_grad():
            return T.forward_decode(cfg, params, cache, tokens, pos)
    return step, (params, cache, tok)


def _vocoder_stage(mesh):
    vcfg = VOCODER_CFG
    vparams_tpl = init_dit(vcfg, MetaGenerator())
    # the rules go by leaf name, so the thinker's config serves
    vspecs = S.param_specs(get_config("qwen3_moe_30b_a3b"), vparams_tpl, mesh)
    vparams = S.distribute(vparams_tpl, mesh, vspecs, meta=True)
    ins = meta_inputs(mesh, {
        "x_t": ((B, 512, vcfg.in_dim), torch.bfloat16, P("data", None, None)),
        "t": ((B,), torch.float32, P("data")),
        "cond": ((B, 256, vcfg.cond_dim), torch.bfloat16, P("data", None, None))})

    def step(params, x_t, t, cond):
        with torch.no_grad():
            return dit_forward(vcfg, params, x_t, t, cond)
    return step, (vparams, ins["x_t"], ins["t"], ins["cond"])


def run_stage(i: int) -> dict:
    """Stage ``i`` of ``STAGES`` on a fresh fake world of 256 ranks."""
    name, lo, _ = STAGES[i]
    t0 = time.time()
    with fake_world(256, rank=lo):
        sub = carve(make_production_mesh("cpu"))[i]
        if i == 0:
            fn, args = _decode_stage(get_config("qwen3_moe_30b_a3b"), sub)
        elif i == 1:
            fn, args = _decode_stage(TALKER_CFG, sub)
        else:
            fn, args = _vocoder_stage(sub)
        got = run_step(fn, args, DistContext(mesh=sub, data_axes=("data",)))
    return {"stage": name, "devices": int(sub.mesh.numel()), "rank": lo,
            "run_s": round(time.time() - t0, 2),
            "args_gb_dev": round(got["argument_size_in_bytes"] / 1e9, 3),
            "collective_bytes": got["collective_bytes"].get("total", 0),
            "matmul_flops": got["matmul_flops"]}


def main() -> None:
    results = [run_stage(i) for i in range(len(STAGES))]
    os.makedirs("experiments", exist_ok=True)
    with open("experiments/pipeline_dryrun_torch.json", "w") as f:
        json.dump(results, f, indent=1)
    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
