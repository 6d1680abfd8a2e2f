"""Mamba blocks: Mamba1 (falcon-mamba) and Mamba2/SSD (zamba2).

Full-sequence (prefill) and single-token decode paths.  The decode
"KV cache" of an SSM layer is a constant-size recurrent state: the
stage's ``StateRunner`` keeps it per slot instead of paged KV.

Written to compute what the JAX package computes, in its order:
  - the causal convolution is its shift-and-add loop over the kernel
    taps, not ``F.conv1d`` (cuDNN may take TF32 for f32 and sums in
    another order);
  - softplus is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` is
    (``F.softplus`` turns into the identity above 20);
  - ``dt_bias`` is cast to the activations' type before it is added, A is
    ``-exp(A_log)`` in f32, and the conv state keeps the activations'
    type: f32 in prefill (the runner's embeddings are f32 rows), the
    model dtype in decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, init_rmsnorm, matmul, rmsnorm, torch_dtype


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def mamba2_head_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner // (cfg.ssm_heads or max(1, cfg.d_inner // 64))


def n_heads2(cfg: ModelConfig) -> int:
    return cfg.ssm_heads or max(1, cfg.d_inner // 64)


def init_mamba(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One Mamba layer's parameters drawn from ``gen`` on ``gen.device``;
    ``A_log``, ``D`` and ``dt_bias`` are f32, the rest in ``cfg.dtype``."""
    d, di, n, cw = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dtype = torch_dtype(cfg.dtype)
    dev = gen.device

    def full(shape, value, dt=torch.float32):
        return torch.full(shape, value, dtype=dt, device=dev)

    p = {"ln": init_rmsnorm(d, dtype, dev)}
    if cfg.ssm_version == 1:
        r = dt_rank(cfg)
        p.update({
            "in_proj": _dense_init(gen, (d, 2 * di), d, dtype),
            "conv_w": _dense_init(gen, (cw, di), cw, dtype),
            "conv_b": full((di,), 0.0, dtype),
            "x_proj": _dense_init(gen, (di, r + 2 * n), di, dtype),
            "dt_proj": _dense_init(gen, (r, di), r, dtype),
            "dt_bias": full((di,), -4.0),                 # softplus ~ small dt
            "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)
                               ).expand(di, n).contiguous(),
            "D": full((di,), 1.0),
            "out_proj": _dense_init(gen, (di, d), di, dtype),
        })
        if cfg.ssm_dt_norms:
            p.update({"dt_ln": init_rmsnorm(r, dtype, dev), "b_ln": init_rmsnorm(n, dtype, dev),
                      "c_ln": init_rmsnorm(n, dtype, dev)})
    else:
        nh = n_heads2(cfg)
        conv_ch = di + 2 * n
        p.update({
            # in_proj -> [z (di), x (di), B (n), C (n), dt (nh)]
            "in_proj": _dense_init(gen, (d, 2 * di + 2 * n + nh), d, dtype),
            "conv_w": _dense_init(gen, (cw, conv_ch), cw, dtype),
            "conv_b": full((conv_ch,), 0.0, dtype),
            "dt_bias": full((nh,), -4.0),
            "A_log": full((nh,), 0.0),
            "D": full((nh,), 1.0),
            "gate_ln": init_rmsnorm(di, dtype, dev),
            "out_proj": _dense_init(gen, (di, d), di, dtype),
        })
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) for every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None):
    """Depthwise causal conv along S. x: (B, S, ch); w: (cw, ch).

    state: (B, cw-1, ch) trailing inputs of the previous segment (None for
    zero history).  Returns (y (B, S, ch), new_state (B, cw-1, ch)).
    """
    cw = w.shape[0]
    bsz, s, ch = x.shape
    if state is None:
        state = torch.zeros((bsz, cw - 1, ch), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                         # (B, S+cw-1, ch)
    y = sum(xp[:, i:i + s] * w[i][None, None] for i in range(cw))
    new_state = xp[:, s:]                                     # last cw-1 inputs
    return F.silu(y + b[None, None]), new_state


def mamba1_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, state: tuple | None = None):
    """x: (B, S, d). state: (h (B, di, n), conv (B, cw-1, di)) or None.
    Returns (y (B, S, d), new_state).  With ``cfg.ssm_dt_norms`` (Jamba)
    the low-rank dt, B and C go through RMSNorms after ``x_proj``."""
    di, n = cfg.d_inner, cfg.ssm_state
    r = dt_rank(cfg)
    h0, conv0 = state if state is not None else (None, None)
    xz = matmul(x, p["in_proj"])                              # (B, S, 2di)
    xs, z = xz[..., :di], xz[..., di:]
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], conv0)
    proj = matmul(xs, p["x_proj"])                            # (B, S, r+2n)
    dtr, Bm, Cm = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    if cfg.ssm_dt_norms:
        eps = cfg.rmsnorm_eps
        dtr = rmsnorm(p["dt_ln"], dtr, eps)
        Bm, Cm = rmsnorm(p["b_ln"], Bm, eps), rmsnorm(p["c_ln"], Cm, eps)
    dt = softplus(matmul(dtr, p["dt_proj"]) + p["dt_bias"].to(x.dtype))
    A = -torch.exp(p["A_log"])                                # (di, n)
    y, h = ops.mamba1_scan(xs, dt, A, Bm, Cm, p["D"], h0)
    y = y * F.silu(z)
    return matmul(y, p["out_proj"]), (h, conv_state)


def mamba2_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, state: tuple | None = None):
    """x: (B, S, d). state: (h (B, nh, hp, n), conv (B, cw-1, di+2n)) or None."""
    di, n = cfg.d_inner, cfg.ssm_state
    nh, hp = n_heads2(cfg), mamba2_head_dim(cfg)
    h0, conv0 = state if state is not None else (None, None)
    proj = matmul(x, p["in_proj"])                            # (B, S, 2di+2n+nh)
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * n]
    dt = softplus(proj[..., 2 * di + 2 * n:] + p["dt_bias"].to(x.dtype))   # (B, S, nh)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv0)
    xs = xbc[..., :di].reshape(*x.shape[:2], nh, hp)
    Bm, Cm = xbc[..., di:di + n], xbc[..., di + n:]
    A = -torch.exp(p["A_log"])                                # (nh,)
    y, h = ops.mamba2_scan(xs, dt, A, Bm, Cm, p["D"], h0)
    y = y.reshape(*x.shape[:2], di)
    y = rmsnorm(p["gate_ln"], y * F.silu(z), cfg.rmsnorm_eps)
    return matmul(y, p["out_proj"]), (h, conv_state)


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor, state: tuple | None = None):
    """Pre-norm residual Mamba block. Returns (x, new_state)."""
    fwd = mamba1_forward if cfg.ssm_version == 1 else mamba2_forward
    y, new_state = fwd(cfg, p, rmsnorm(p["ln"], x, cfg.rmsnorm_eps), state)
    return x + y, new_state


def init_mamba_state(cfg: ModelConfig, batch: int, device=None):
    """Zero recurrent state for one Mamba layer: (h f32, conv in cfg.dtype)."""
    di, n, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dtype = torch_dtype(cfg.dtype)
    if cfg.ssm_version == 1:
        h_shape, conv_ch = (batch, di, n), di
    else:
        h_shape, conv_ch = (batch, n_heads2(cfg), mamba2_head_dim(cfg), n), di + 2 * n
    return (torch.zeros(h_shape, dtype=torch.float32, device=device),
            torch.zeros((batch, cw - 1, conv_ch), dtype=dtype, device=device))
