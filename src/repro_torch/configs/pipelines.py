"""Any-to-any pipeline definitions (tiny) mirroring the paper's evaluated
models (§4.1):

  - qwen_omni   : Thinker (AR) -> Talker (AR) -> Vocoder (DiT or CNN)
                  [Qwen2.5-Omni Fig 4 / Qwen3-Omni]
  - glm_image   : AR LLM -> DiT image decoder            [GLM-Image]
  - bagel       : understanding AR -> generation DiT     [BAGEL, MoT-as-stages]
  - pd / epd    : prefill -> decode (and encoder -> prefill -> decode)
                  disaggregation, prompt KV over the unified connector
  - mimo_audio  : patch encoder -> AR LLM -> patch decoder [MiMo-Audio]

Each builder returns (StageGraph, engines dict, bundle).  Model sizes
are smoke-scale (``build_pd_disaggregated`` also takes a published
config); the stage-graph machinery is the one the full configs would
use.  Builders take ``device`` (default ``cuda``) and draw their
parameters from a ``torch.Generator`` seeded with ``seed``, so a stage
rebuilt from its ``engine_specs`` entry in a spawned process carries the
same weights on the same device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import EngineSpec
from repro_torch.core.graph import StageGraph
from repro_torch.core.stage import StageSpec
from repro_torch.device import resolve_device
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.diffusion_engine import (CustomEngine, DiffusionEngine,
                                                 EncodeEngine)
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


def _randn(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * std


def _host_randn(gen: torch.Generator, shape, std: float) -> np.ndarray:
    return _randn(gen, shape, std).cpu().numpy().astype(np.float32)


def _conv1d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv_general_dilated(x, w, (1,), "SAME", ("NWC", "WIO", "NWC"))``
    for a 3-tap kernel: x (B, T, I), w (3, I, O) -> (B, T, O), as three
    shifted matmuls (not ``F.conv1d``: cuDNN may take TF32 for f32, while
    a matmul follows the same f32 precision setting as every other matmul
    of the port)."""
    xp = F.pad(x, (0, 0, 1, 1))
    return xp[:, :-2] @ w[0] + xp[:, 1:-1] @ w[1] + xp[:, 2:] @ w[2]


# ----------------------------------------------------------------------------
# Qwen-Omni: Thinker -> Talker -> Vocoder
# ----------------------------------------------------------------------------

def build_qwen_omni(*, max_batch: int = 8, thinker_tokens: int = 24,
                    talker_tokens: int = 72, stream_chunk: int = 16,
                    vocoder_kind: str = "dit", dit_steps: int = 8,
                    cache_interval: int = 1, prefix_cache: bool = False,
                    seed: int = 0, device=None):
    if vocoder_kind not in ("dit", "cnn"):
        raise ValueError(f"vocoder_kind must be 'dit' or 'cnn', not {vocoder_kind!r}")
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

    vocoder_weights: dict = {}
    if vocoder_kind == "dit":
        dit_cfg = DiTConfig(name="vocoder", num_layers=2, d_model=D,
                            num_heads=4, d_ff=256, in_dim=32, cond_dim=D,
                            num_steps=dit_steps)
        dit_params = init_dit(dit_cfg, gen)
        vocoder_weights = {"dit_cfg": dit_cfg, "dit_params": dit_params}

        def make_vocoder():
            return DiffusionEngine(
                "vocoder", dit_cfg, dit_params,
                max_batch=max_batch, cache_interval=cache_interval,
                out_len_per_cond=2.0, seed=seed + 2)
    else:  # Qwen3-Omni style lightweight CNN vocoder
        w1 = _randn(gen, (3, D, D), 0.05)      # (K, I, O), as the JAX package's WIO
        w2 = _randn(gen, (3, D, 32), 0.05)
        vocoder_weights = {"w1": w1, "w2": w2}

        @torch.no_grad()
        def _conv_stack(cond: torch.Tensor) -> torch.Tensor:   # (B, T, D) -> (B, 2T, 32)
            x = _conv1d_same(cond, w1)
            x = F.gelu(x, approximate="tanh")                    # jax.nn.gelu's default
            x = x.repeat_interleave(2, dim=1)                    # 2x upsample in time
            return _conv1d_same(x, w2)

        def vocode(batch_inputs):
            conds = [np.asarray(i["cond"]) for i in batch_inputs]
            tmax = max(c.shape[0] for c in conds)
            stacked = np.stack([np.pad(c, ((0, tmax - c.shape[0]), (0, 0)))
                                for c in conds])
            out = _conv_stack(torch.as_tensor(stacked, dtype=torch.float32,
                                              device=dev)).cpu().numpy()
            res = []
            for i, inp in enumerate(batch_inputs):
                n = inp["cond"].shape[0] * 2
                res.append({"latent": out[i, :n],
                            "chunk_index": inp.get("chunk_index", 0)})
            return res

        def make_vocoder():
            return CustomEngine("vocoder", vocode, max_batch=max_batch)
    vocoder = make_vocoder()

    graph = StageGraph()
    graph.add_stage(StageSpec("thinker", "ar"))
    graph.add_stage(StageSpec("talker", "ar"))
    graph.add_stage(StageSpec("vocoder",
                              "diffusion" if vocoder_kind == "dit"
                              else "custom", is_output=True))

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
              **vocoder_weights, "codec_embed": codec_embed,
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




# ----------------------------------------------------------------------------
# GLM-Image / BAGEL: AR LLM -> DiT generator
# ----------------------------------------------------------------------------

def build_ar_dit(name: str = "glm_image", *, max_batch: int = 8,
                 ar_tokens: int = 32, image_latents: int = 64,
                 dit_steps: int = 8, cache_interval: int = 1,
                 prefix_cache: bool = False, seed: int = 0, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    llm_cfg = tiny_lm(f"{name}_llm")
    llm_params = T.init_params(llm_cfg, gen)
    vq_embed = _host_randn(gen, (llm_cfg.vocab_size, D), 0.1)
    dit_cfg = DiTConfig(name=f"{name}_dit", num_layers=2, d_model=D,
                        num_heads=4, d_ff=256, in_dim=32, cond_dim=D,
                        num_steps=dit_steps)
    dit_params = init_dit(dit_cfg, gen)

    def make_llm():
        return AREngine(
            f"{name}_llm", llm_cfg, llm_params, kv=_kv(max_batch),
            max_batch=max_batch, collect_hidden=True,
            enable_prefix_cache=prefix_cache,
            default_sampling=SamplingParams(max_new_tokens=ar_tokens,
                                            temperature=0.8, top_k=20),
            seed=seed)

    def make_dit():
        return DiffusionEngine(f"{name}_dit", dit_cfg, dit_params,
                               max_batch=max_batch,
                               cache_interval=cache_interval, seed=seed + 1)

    llm = make_llm()
    dit = make_dit()

    graph = StageGraph()
    graph.add_stage(StageSpec(f"{name}_llm", "ar"))
    graph.add_stage(StageSpec(f"{name}_dit", "diffusion", is_output=True))

    def llm2dit(data, payload):
        return {"cond": vq_embed[payload["tokens"]],
                "out_len": image_latents}

    graph.add_edge(f"{name}_llm", f"{name}_dit", llm2dit, connector="shm")
    return graph, {f"{name}_llm": llm, f"{name}_dit": dit}, {
        "llm_cfg": llm_cfg, "llm_params": llm_params, "vq_embed": vq_embed,
        "ar_tokens": ar_tokens, "image_latents": image_latents,
        "dit_cfg": dit_cfg, "dit_params": dit_params,
        "engine_factories": {f"{name}_llm": make_llm,
                             f"{name}_dit": make_dit},
        "engine_specs": stage_engine_specs(
            name, (f"{name}_llm", f"{name}_dit"), max_batch=max_batch,
            ar_tokens=ar_tokens, image_latents=image_latents,
            dit_steps=dit_steps, cache_interval=cache_interval,
            prefix_cache=prefix_cache, seed=seed, device=str(dev))}


# ----------------------------------------------------------------------------
# Prefill-Decode disaggregation (paper §3.4: the unified connector also
# carries intra-stage transfers — prompt KV from a prefill engine to a
# decode engine, vLLM PD-disaggregation style)
# ----------------------------------------------------------------------------

def _kv_hop(data, payload):
    """prefill -> decode: the prompt's KV (bf16 as its bits, with the type
    tag ``runner.kv_to_host`` gives), its length and the token the
    prefill engine sampled from its last position."""
    return {"kv_seed": (payload["kv_k"], payload["kv_v"]),
            "kv_dtype": payload["kv_dtype"],
            "prompt_len": payload["prompt_len"],
            "first_token": int(payload["tokens"][0])}


def build_pd_disaggregated(cfg: ModelConfig = None, *, max_batch: int = 4,
                           max_new: int = 8, temperature: float = 0.0,
                           connector: str = "shm",
                           prefix_cache: bool = False, seed: int = 0,
                           max_seq: int = 256, device=None, weights=None):
    """``cfg`` defaults to a tiny LM; a published config (e.g.
    ``configs/internlm2_1_8b.py: CONFIG``) serves at full width, with
    ``max_seq`` tokens of KV pages per sequence.  ``temperature`` reaches
    both engines, so a decode stage rebuilt from its spec samples the
    same way.  ``weights``, a numpy tree of the JAX package's layout,
    replaces the seeded draw; the specs carry it, so a stage rebuilt in a
    spawned process serves the same weights."""
    dev = resolve_device(device)
    custom_cfg = cfg is not None
    cfg = cfg or tiny_lm("pd_lm", vocab=512)
    if weights is None:
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    else:
        params = params_from_numpy(weights, dev)

    def make_prefill():
        return AREngine(
            "prefill", cfg, params, kv=_kv(max_batch, max_seq), max_batch=max_batch,
            emit_kv=True, collect_hidden=False,
            enable_prefix_cache=prefix_cache,
            default_sampling=SamplingParams(max_new_tokens=1,
                                            temperature=temperature),
            seed=seed)

    def make_decode():
        return AREngine(
            "decode", cfg, params, kv=_kv(max_batch, max_seq), max_batch=max_batch,
            default_sampling=SamplingParams(max_new_tokens=max_new,
                                            temperature=temperature),
            seed=seed)

    prefill = make_prefill()
    decode = make_decode()

    graph = StageGraph()
    graph.add_stage(StageSpec("prefill", "ar"))
    graph.add_stage(StageSpec("decode", "ar", is_output=True))
    graph.add_edge("prefill", "decode", _kv_hop, connector=connector)
    spec_kwargs = dict(max_batch=max_batch, max_new=max_new,
                       temperature=temperature, connector=connector,
                       prefix_cache=prefix_cache, seed=seed, max_seq=max_seq,
                       device=str(dev))
    if custom_cfg:
        spec_kwargs["cfg"] = cfg             # ModelConfig pickles fine
    if weights is not None:
        spec_kwargs["weights"] = weights     # numpy arrays pickle too
    return graph, {"prefill": prefill, "decode": decode}, {
        "cfg": cfg, "params": params,
        "engine_factories": {"prefill": make_prefill,
                             "decode": make_decode},
        "engine_specs": stage_engine_specs("pd", ("prefill", "decode"),
                                           **spec_kwargs)}


# ----------------------------------------------------------------------------
# EPD disaggregation (paper §3.4 / Singh et al.): Encoder, Prefill and
# Decode each on their own engine; the MM cache (encoder embeddings) and
# the prompt KV both travel through the unified connector.
# ----------------------------------------------------------------------------

def build_epd_disaggregated(*, max_batch: int = 4, max_new: int = 8,
                            frame_dim: int = 32, connector: str = "shm",
                            seed: int = 0, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = tiny_lm("epd_lm", vocab=512)
    params = T.init_params(cfg, gen)
    w_enc = _host_randn(gen, (frame_dim, D), 0.1)

    def encode(batch_inputs):
        # stubbed modality frontend: frames -> prompt embeddings (MM cache)
        return [{"prompt_embeds": np.asarray(i["frames"], np.float32)
                 @ w_enc} for i in batch_inputs]

    def make_encoder():
        return EncodeEngine("encoder", encode, max_batch=max_batch)

    def make_prefill():
        return AREngine(
            "prefill", cfg, params, kv=_kv(max_batch), max_batch=max_batch,
            emit_kv=True,
            default_sampling=SamplingParams(max_new_tokens=1,
                                            temperature=0.0),
            seed=seed)

    def make_decode():
        return AREngine(
            "decode", cfg, params, kv=_kv(max_batch), max_batch=max_batch,
            default_sampling=SamplingParams(max_new_tokens=max_new,
                                            temperature=0.0),
            seed=seed)

    encoder = make_encoder()
    prefill = make_prefill()
    decode = make_decode()

    graph = StageGraph()
    graph.add_stage(StageSpec("encoder", "encode"))
    graph.add_stage(StageSpec("prefill", "ar"))
    graph.add_stage(StageSpec("decode", "ar", is_output=True))
    graph.add_edge("encoder", "prefill", lambda d, p: p,
                   connector=connector)            # MM cache hop
    graph.add_edge("prefill", "decode", _kv_hop,
                   connector=connector)            # prompt-KV hop
    return graph, {"encoder": encoder, "prefill": prefill,
                   "decode": decode}, {
        "cfg": cfg, "params": params, "w_enc": w_enc,
        "engine_factories": {"encoder": make_encoder,
                             "prefill": make_prefill,
                             "decode": make_decode},
        "engine_specs": stage_engine_specs(
            "epd", ("encoder", "prefill", "decode"), max_batch=max_batch,
            max_new=max_new, frame_dim=frame_dim, connector=connector,
            seed=seed, device=str(dev))}


# ----------------------------------------------------------------------------
# MiMo-Audio: patch encoder -> AR LLM -> patch decoder
# ----------------------------------------------------------------------------

def build_mimo_audio(*, max_batch: int = 8, ar_tokens: int = 48,
                     patch: int = 4, prefix_cache: bool = False,
                     seed: int = 0, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    llm_cfg = tiny_lm("mimo_llm")
    llm_params = T.init_params(llm_cfg, gen)
    w_enc = _host_randn(gen, (patch * 16, D), 0.1)
    w_dec = _host_randn(gen, (D, patch * 16), 0.1)
    tok_embed = _host_randn(gen, (llm_cfg.vocab_size, D), 0.1)

    def encode(batch_inputs):
        res = []
        for inp in batch_inputs:
            audio = np.asarray(inp["audio"])        # (frames, 16)
            n = (audio.shape[0] // patch) * patch
            patches = audio[:n].reshape(-1, patch * 16)
            res.append({"prompt_embeds": patches @ w_enc})
        return res

    def decode(batch_inputs):
        res = []
        for inp in batch_inputs:
            emb = tok_embed[np.asarray(inp["tokens"])]
            res.append({"audio": emb @ w_dec})
        return res

    def make_enc():
        return EncodeEngine("patch_enc", encode, max_batch=max_batch)

    def make_llm():
        return AREngine(
            "mimo_llm", llm_cfg, llm_params, kv=_kv(max_batch),
            max_batch=max_batch, enable_prefix_cache=prefix_cache,
            default_sampling=SamplingParams(max_new_tokens=ar_tokens,
                                            temperature=0.8, top_k=20),
            seed=seed)

    def make_dec():
        return CustomEngine("patch_dec", decode, max_batch=max_batch)

    enc = make_enc()
    llm = make_llm()
    dec = make_dec()

    graph = StageGraph()
    graph.add_stage(StageSpec("patch_enc", "encode"))
    graph.add_stage(StageSpec("mimo_llm", "ar"))
    graph.add_stage(StageSpec("patch_dec", "custom", is_output=True))
    graph.add_edge("patch_enc", "mimo_llm", lambda d, p: p, connector="shm")
    graph.add_edge("mimo_llm", "patch_dec",
                   lambda d, p: {"tokens": p["tokens"]}, connector="inline")
    return graph, {"patch_enc": enc, "mimo_llm": llm, "patch_dec": dec}, {
        "llm_cfg": llm_cfg, "llm_params": llm_params, "patch": patch,
        "ar_tokens": ar_tokens, "w_enc": w_enc, "w_dec": w_dec,
        "tok_embed": tok_embed,
        "engine_factories": {"patch_enc": make_enc, "mimo_llm": make_llm,
                             "patch_dec": make_dec},
        "engine_specs": stage_engine_specs(
            "mimo_audio", ("patch_enc", "mimo_llm", "patch_dec"),
            max_batch=max_batch, ar_tokens=ar_tokens, patch=patch,
            prefix_cache=prefix_cache, seed=seed, device=str(dev))}


def _build_glm_image(**kw):
    return build_ar_dit("glm_image", **kw)


def _build_bagel(**kw):
    return build_ar_dit("bagel", **kw)


# build_stage_engine dispatch table (late-bound: the helper sits above
# the builders it names)
_BUILDERS = {
    "qwen_omni": build_qwen_omni,
    "glm_image": _build_glm_image,
    "bagel": _build_bagel,
    "pd": build_pd_disaggregated,
    "epd": build_epd_disaggregated,
    "mimo_audio": build_mimo_audio,
}
