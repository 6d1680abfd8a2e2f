"""Model parameters and the embedding/unembedding of the dense path.

  init_params(cfg, gen)          -> params (layer-stacked ``blocks``)
  _embed / _unembed              -> token embedding / final norm + lm head

The per-layer forward passes live in ``engine/runner.py`` (paged KV);
``forward_full``/``forward_prefill``/``forward_decode`` and the SSM and
hybrid families wait for their slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``.  The layout
    is the JAX package's: ``blocks`` leaves carry a leading num_layers
    axis."""
    if cfg.arch_type in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.arch_type} models wait for the port of models/mamba.py")
    dtype = L.torch_dtype(cfg.dtype)
    p: dict = {}
    if cfg.modality != "audio_frames":
        emb = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype, device=gen.device)
        for lo in range(0, cfg.vocab_size, 1 << 14):     # bounded f32 temporaries
            hi = min(lo + (1 << 14), cfg.vocab_size)
            emb[lo:hi] = torch.randn((hi - lo, cfg.d_model), generator=gen,
                                     device=gen.device) * 0.02
        p["embed"] = emb
    p["final_ln"] = L.init_rmsnorm(cfg.d_model, dtype, gen.device)
    p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype)
    p["blocks"] = L.stack_init(lambda g: L.init_block(cfg, g), gen, cfg.num_layers)
    return p


def _embed(cfg: ModelConfig, params: dict, inputs: torch.Tensor) -> torch.Tensor:
    if cfg.modality == "audio_frames":
        return inputs  # precomputed frame embeddings (stub frontend)
    return params["embed"][inputs]


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_ln"], x, cfg.rmsnorm_eps)
    return L.matmul(x, params["lm_head"])
