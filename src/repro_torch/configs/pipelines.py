"""Any-to-any pipeline definitions (tiny) mirroring the paper's evaluated
models (§4.1):

  - qwen_omni   : Thinker (AR) -> Talker (AR) -> Vocoder (DiT)
                  [Qwen2.5-Omni Fig 4]

Each builder returns (StageGraph, engines dict, bundle).  Model sizes
are smoke-scale; the stage-graph machinery is the one the full configs
would use.  Builders take ``device`` (default ``cuda``) and draw their
parameters from a ``torch.Generator`` seeded with ``seed``.  The
Qwen3-Omni CNN vocoder and the other pipelines (glm_image, bagel, pd,
epd, mimo_audio) wait for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import EngineSpec
from repro_torch.core.graph import StageGraph
from repro_torch.core.stage import StageSpec
from repro_torch.device import resolve_device
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.diffusion_engine import DiffusionEngine
from repro_torch.engine.kv_cache import PagedKVConfig
from repro_torch.engine.sampling import SamplingParams
from repro_torch.models import transformer as T
from repro_torch.models.dit import DiTConfig, init_dit

D = 128  # shared hidden size of the tiny pipeline stages


def build_stage_engine(pipeline: str, stage: str, **kwargs):
    """Rebuild ONE stage engine of a named pipeline from builder kwargs:
    the module-level :class:`EngineSpec` target of a stage.  Builders
    derive params deterministically from ``seed``, so a rebuilt engine
    carries the same weights as the original on the same device."""
    builder = _BUILDERS.get(pipeline)
    if builder is None:
        raise ValueError(f"unknown pipeline {pipeline!r} "
                         f"(have {sorted(_BUILDERS)})")
    _, engines, _ = builder(**kwargs)
    if stage not in engines:
        raise ValueError(f"pipeline {pipeline!r} has no stage {stage!r} "
                         f"(have {sorted(engines)})")
    return engines[stage]


def stage_engine_specs(pipeline: str, stages, **kwargs):
    """Picklable per-stage :class:`EngineSpec` mapping for a pipeline
    built with exactly ``kwargs``."""
    return {s: EngineSpec("repro_torch.configs.pipelines:build_stage_engine",
                          {"pipeline": pipeline, "stage": s, **kwargs})
            for s in stages}


def tiny_lm(name: str, vocab: int = 512, layers: int = 2) -> ModelConfig:
    return ModelConfig(
        name=name, arch_type="dense", num_layers=layers, d_model=D,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=vocab,
        dtype="float32", rope_theta=10_000.0)


def _kv(max_batch: int, max_seq: int = 256) -> PagedKVConfig:
    page = 16
    pages_per_seq = max_seq // page
    return PagedKVConfig(num_pages=max_batch * pages_per_seq + 8,
                         page_size=page, max_pages_per_seq=pages_per_seq)


def _host_randn(gen: torch.Generator, shape, std: float) -> np.ndarray:
    return (torch.randn(shape, generator=gen, device=gen.device) * std
            ).cpu().numpy().astype(np.float32)


# ----------------------------------------------------------------------------
# Qwen-Omni: Thinker -> Talker -> Vocoder
# ----------------------------------------------------------------------------

def build_qwen_omni(*, max_batch: int = 8, thinker_tokens: int = 24,
                    talker_tokens: int = 72, stream_chunk: int = 16,
                    vocoder_kind: str = "dit", dit_steps: int = 8,
                    cache_interval: int = 1, prefix_cache: bool = False,
                    seed: int = 0, device=None):
    if vocoder_kind != "dit":
        raise NotImplementedError(
            f"vocoder_kind={vocoder_kind!r}: the CNN vocoder is not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    thinker_cfg = tiny_lm("thinker")
    talker_cfg = tiny_lm("talker", vocab=256)
    thinker_params = T.init_params(thinker_cfg, gen)
    talker_params = T.init_params(talker_cfg, gen)
    codec_embed = _host_randn(gen, (talker_cfg.vocab_size, D), 0.1)

    def talker_preprocess(data, state):
        """Re-inject the Thinker hidden state at every Talker decode step."""
        h = data.get("thinker_hidden")
        if h is None or state["phase"] != "decode":
            return {}
        i = min(state["step"], h.shape[0] - 1)
        return {"extra_embed": h[i]}

    mm_proj = _host_randn(gen, (32, D), 0.1)

    def mm_encode(data, state):
        """mm_encode hook (Fig 4): precomputed audio/image/video frontend
        embeddings (the stubbed modality frontend) are projected and
        concatenated ahead of the Thinker text prompt."""
        mm = data.get("mm_embeds")           # (frames, 32) from the stub
        if mm is None or state["phase"] != "prefill":
            return {}
        data["mm_frames_used"] = mm.shape[0]
        return {"prompt_prepend": np.asarray(mm, np.float32) @ mm_proj}

    # engine factories: replica 0 below is the first call; scale_up /
    # --replicas build extra replicas from the SAME initialized params
    # (each replica gets its own scheduler, allocator and KV pool)
    def make_thinker():
        return AREngine(
            "thinker", thinker_cfg, thinker_params, kv=_kv(max_batch),
            max_batch=max_batch, collect_hidden=True, preprocess=mm_encode,
            enable_prefix_cache=prefix_cache,
            default_sampling=SamplingParams(max_new_tokens=thinker_tokens,
                                            temperature=0.8, top_k=20),
            seed=seed)

    def make_talker():
        return AREngine(
            "talker", talker_cfg, talker_params, kv=_kv(max_batch),
            max_batch=max_batch, preprocess=talker_preprocess,
            stream_chunk=stream_chunk, enable_prefix_cache=prefix_cache,
            default_sampling=SamplingParams(max_new_tokens=talker_tokens,
                                            temperature=0.8, top_k=20),
            seed=seed + 1)

    thinker = make_thinker()
    talker = make_talker()

    dit_cfg = DiTConfig(name="vocoder", num_layers=2, d_model=D,
                        num_heads=4, d_ff=256, in_dim=32, cond_dim=D,
                        num_steps=dit_steps)
    dit_params = init_dit(dit_cfg, gen)

    def make_vocoder():
        return DiffusionEngine(
            "vocoder", dit_cfg, dit_params,
            max_batch=max_batch, cache_interval=cache_interval,
            out_len_per_cond=2.0, seed=seed + 2)
    vocoder = make_vocoder()

    graph = StageGraph()
    graph.add_stage(StageSpec("thinker", "ar"))
    graph.add_stage(StageSpec("talker", "ar"))
    graph.add_stage(StageSpec("vocoder", "diffusion", is_output=True))

    def thinker2talker(data, payload):
        data["thinker_hidden"] = payload["hidden"]
        data["thinker_tokens"] = payload["tokens"]
        return {"prompt_embeds": payload["hidden"]}

    def talker2vocoder(data, payload):
        toks = payload["tokens"]
        return {"cond": codec_embed[toks]}

    graph.add_edge("thinker", "talker", thinker2talker, connector="shm")
    graph.add_edge("talker", "vocoder", talker2vocoder, streaming=True,
                   connector="inline")
    engines = {"thinker": thinker, "talker": talker, "vocoder": vocoder}
    bundle = {"thinker_cfg": thinker_cfg, "thinker_params": thinker_params,
              "talker_cfg": talker_cfg, "talker_params": talker_params,
              "dit_cfg": dit_cfg, "dit_params": dit_params,
              "codec_embed": codec_embed,
              "thinker_tokens": thinker_tokens,
              "talker_tokens": talker_tokens,
              "engine_factories": {"thinker": make_thinker,
                                   "talker": make_talker,
                                   "vocoder": make_vocoder},
              "engine_specs": stage_engine_specs(
                  "qwen_omni", ("thinker", "talker", "vocoder"),
                  max_batch=max_batch, thinker_tokens=thinker_tokens,
                  talker_tokens=talker_tokens, stream_chunk=stream_chunk,
                  vocoder_kind=vocoder_kind, dit_steps=dit_steps,
                  cache_interval=cache_interval, prefix_cache=prefix_cache,
                  seed=seed, device=str(dev))}
    return graph, engines, bundle


# build_stage_engine dispatch table (late-bound: the helper sits above
# the builders it names)
_BUILDERS = {
    "qwen_omni": build_qwen_omni,
}
