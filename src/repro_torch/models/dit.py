"""Diffusion Transformer (DiT): the generator stage for vocoder / image /
video synthesis (Peebles & Xie 2023 style, adaLN-zero conditioning, with
cross-attention to conditioning tokens from the upstream AR stage).

Used by the diffusion engine (rectified-flow Euler sampling) for the
Talker→Vocoder and AR→image pipelines.  Self- and cross-attention go
through ``ops.flash_attention(causal=False)``: the CUDA kernel on the
card, its plain version on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (_dense_init, init_rmsnorm, matmul, project,
                                       rmsnorm, stack_init, torch_dtype, tree_map,
                                       unproject)


@dataclass(frozen=True)
class DiTConfig:
    name: str = "dit"
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    in_dim: int = 64          # latent channels per position
    cond_dim: int = 256       # conditioning token dim (upstream hidden size)
    num_steps: int = 20       # default denoising steps
    rmsnorm_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of t in [0,1]. t: (B,) -> (B, dim)."""
    half = dim // 2
    log_base = torch.log(torch.tensor(10_000.0, dtype=torch.float32))
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32) / half
                      ).to(t.device)
    ang = t[:, None].float() * 1000.0 * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def init_dit(cfg: DiTConfig, gen: torch.Generator) -> dict:
    d, f, nh, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    dt = torch_dtype(cfg.dtype)
    dev = gen.device

    def blk(g):
        return {
            "ln1": init_rmsnorm(d, dt, dev),
            "wq": _dense_init(g, (d, nh, hd), d, dt),
            "wk": _dense_init(g, (d, nh, hd), d, dt),
            "wv": _dense_init(g, (d, nh, hd), d, dt),
            "wo": _dense_init(g, (nh, hd, d), d, dt),
            "ln_x": init_rmsnorm(d, dt, dev),
            "xwq": _dense_init(g, (d, nh, hd), d, dt),
            "xwk": _dense_init(g, (cfg.cond_dim, nh, hd), cfg.cond_dim, dt),
            "xwv": _dense_init(g, (cfg.cond_dim, nh, hd), cfg.cond_dim, dt),
            "xwo": _dense_init(g, (nh, hd, d), d, dt),
            "ln2": init_rmsnorm(d, dt, dev),
            "wg": _dense_init(g, (d, f), d, dt),
            "wd": _dense_init(g, (f, d), f, dt),
            # adaLN-zero: 6 modulations (shift/scale/gate for attn and mlp)
            "ada": torch.zeros((d, 6 * d), dtype=dt, device=dev),
        }

    return {
        "in_proj": _dense_init(gen, (cfg.in_dim, d), cfg.in_dim, dt),
        "t_mlp1": _dense_init(gen, (d, d), d, dt),
        "t_mlp2": _dense_init(gen, (d, d), d, dt),
        "blocks": stack_init(blk, gen, cfg.num_layers),
        "final_ln": init_rmsnorm(d, dt, dev),
        "out_proj": torch.zeros((d, cfg.in_dim), dtype=dt, device=dev),  # zero-init output
    }


def _attn(cfg: DiTConfig, q_in, kv_in, wq, wk, wv, wo):
    q = project(q_in, wq)
    k = project(kv_in, wk)
    v = project(kv_in, wv)
    o = ops.flash_attention(q, k, v, causal=False)
    return unproject(o, wo)


def dit_forward(cfg: DiTConfig, params: dict, x_t: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
    """Predict velocity. x_t: (B, T, in_dim); t: (B,); cond: (B, Tc, cond_dim)."""
    h = matmul(x_t, params["in_proj"])
    temb = timestep_embedding(t, cfg.d_model).to(h.dtype)
    temb = matmul(F.silu(matmul(temb, params["t_mlp1"])), params["t_mlp2"])  # (B, d)
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        lp = tree_map(lambda a: a[i], blocks)
        mods = torch.chunk(matmul(F.silu(temb), lp["ada"]), 6, dim=-1)
        sh1, sc1, g1, sh2, sc2, g2 = [m[:, None, :] for m in mods]
        a = rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps) * (1 + sc1) + sh1
        h = h + g1 * _attn(cfg, a, a, lp["wq"], lp["wk"], lp["wv"], lp["wo"])
        xa = rmsnorm(lp["ln_x"], h, cfg.rmsnorm_eps)
        h = h + _attn(cfg, xa, cond, lp["xwq"], lp["xwk"], lp["xwv"], lp["xwo"])
        m = rmsnorm(lp["ln2"], h, cfg.rmsnorm_eps) * (1 + sc2) + sh2
        h = h + g2 * matmul(F.silu(matmul(m, lp["wg"])), lp["wd"])
    h = rmsnorm(params["final_ln"], h, cfg.rmsnorm_eps)
    return matmul(h, params["out_proj"])


def sample(cfg: DiTConfig, params: dict, cond: torch.Tensor, out_len: int,
           noise: torch.Tensor | torch.Generator, num_steps: int | None = None,
           cache_interval: int = 1) -> torch.Tensor:
    """Rectified-flow Euler sampler: integrate dx/dt = v from t=1 (noise) to 0.

    ``noise`` is the initial x, (B, out_len, in_dim), or a generator on
    cond's device to draw it from.  cache_interval > 1 enables
    TeaCache-style reuse: the velocity is recomputed every
    ``cache_interval`` steps and reused in between.
    """
    steps = num_steps or cfg.num_steps
    b = cond.shape[0]
    dtype = torch_dtype(cfg.dtype)
    if isinstance(noise, torch.Generator):
        x = torch.randn((b, out_len, cfg.in_dim), generator=noise,
                        device=cond.device).to(dtype)
    else:
        x = noise.to(device=cond.device, dtype=dtype)
    dt = np.float32(1.0 / steps)
    v = torch.zeros_like(x)
    for i in range(steps):
        if i % cache_interval == 0:
            t = np.float32(1.0) - np.float32(i) * dt      # f32, as the JAX loop
            v = dit_forward(cfg, params, x, torch.full((b,), float(t), device=x.device),
                            cond)
        x = x - float(dt) * v
    return x
