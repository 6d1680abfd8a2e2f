"""The ``mamba1`` family: attention-free Mamba1 blocks (``arch_type``
"ssm"), as the port lays them out for ``StateRunner``: top-level
``embed``, ``final_ln`` and ``lm_head``, and ``mamba`` whose leaves
stack the layers on a leading axis.

Each layer is a pre-norm residual block: RMSNorm -> ``in_proj`` to
(x, z) -> a depthwise causal conv of ``ssm_conv`` taps with a bias, then
SiLU -> ``x_proj`` to (dt, B, C) -> dt through ``dt_proj`` plus
``dt_bias``, then softplus -> the selective scan, with A = -exp(A_log),
h <- exp(dt A) h + dt B x, y = C . h + D x -> y * SiLU(z) -> ``out_proj``.
d_inner is ``ssm_expand`` x d_model and the dt rank is ceil(d_model / 16),
Mamba's default.

Weights are drawn as ``weights.py`` draws the transformer's: each layer
from a generator of its own, in the served type (``A_log``, ``D`` and
``dt_bias`` in f32, as the port keeps them).  ``dt_bias``, ``A_log`` and
``D`` are drawn around values that keep the scan's memory a few to some
tens of steps long, so that a decode that loses its state reads wrong.

The plain reference runs in f32 with TF32 off and scans one position
after another; it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from omnibench import weights
from omnibench.reference.model import Products, no_tf32, rmsnorm

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}
#: operations of the scan a state element and token: dt.A, its exp, the
#: decay's product and the add, dt B x's product with B, and C . h's
#: product and add
SCAN_OPS = 7


def dims(m: dict) -> tuple:
    """(d_model, d_inner, state size, conv taps, dt rank)."""
    d = m["d_model"]
    return d, m["ssm_expand"] * d, m["ssm_state"], m["ssm_conv"], -(-d // 16)


def layer_shapes(m: dict) -> list:
    """(path, shape, std, mean, dtype name) of each leaf of one layer, in
    draw order."""
    d, di, n, cw, r = dims(m)
    dt = m["dtype"]
    return [
        (("ln", "scale"), (d,), weights.NORM_STD, 1.0, dt),
        (("in_proj",), (d, 2 * di), 1 / math.sqrt(d), 0.0, dt),
        (("conv_w",), (cw, di), 1 / math.sqrt(cw), 0.0, dt),
        (("conv_b",), (di,), weights.NORM_STD, 0.0, dt),
        (("x_proj",), (di, r + 2 * n), 1 / math.sqrt(di), 0.0, dt),
        (("dt_proj",), (r, di), 1 / math.sqrt(r), 0.0, dt),
        (("dt_bias",), (di,), 0.5, -3.0, "float32"),
        (("A_log",), (di, n), 0.5, 0.5, "float32"),
        (("D",), (di,), weights.NORM_STD, 1.0, "float32"),
        (("out_proj",), (di, d), 1 / math.sqrt(di), 0.0, dt),
    ]


def program_params(m: dict, seed: int, device) -> dict:
    return {"embed": weights.top(m, seed, device, "embed"),
            "final_ln": {"scale": weights.top(m, seed, device, "final_ln")},
            "lm_head": weights.top(m, seed, device, "lm_head"),
            "mamba": weights.stack(layer_shapes(m), seed, range(m["num_layers"]), device)}


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

def block(m: dict, p: dict, h: torch.Tensor, mm: Products) -> torch.Tensor:
    """One layer over one sequence's rows h (S, d), in f32."""
    _, di, _, cw, r = dims(m)
    n = m["ssm_state"]
    s = h.shape[0]
    xz = mm(rmsnorm(h, p["ln"]["scale"], m["rmsnorm_eps"]), p["in_proj"])
    x, z = xz[:, :di], xz[:, di:]
    xp = torch.cat([x.new_zeros(cw - 1, di), x])
    w = p["conv_w"].float()
    x = F.silu(sum(xp[i:i + s] * w[i] for i in range(cw)) + p["conv_b"].float())
    proj = mm(x, p["x_proj"])
    dt = F.softplus(mm(proj[:, :r], p["dt_proj"]) + p["dt_bias"].float())
    B, C = proj[:, r:r + n], proj[:, r + n:]
    A = -torch.exp(p["A_log"].float())
    state = x.new_zeros(di, n)
    ys = []
    for t in range(s):
        state = torch.exp(dt[t, :, None] * A) * state + (dt[t] * x[t])[:, None] * B[t]
        ys.append(state @ C[t])
    y = (torch.stack(ys) + x * p["D"].float()) * F.silu(z)
    return h + mm(y, p["out_proj"])


@torch.no_grad()
def logits(m: dict, seed: int, seqs: list, rows: list, device, quant=None) -> list:
    """f32 logits of each sequence ``seqs[j]`` at its positions ``rows[j]``,
    each layer drawn again from ``seed``; ``quant="fp8"`` rounds every
    product's operands to e4m3 (the control)."""
    mm = Products(quant)
    leaves = layer_shapes(m)
    with no_tf32():
        emb = weights.top(m, seed, device, "embed")
        hs = [emb[torch.as_tensor(s, dtype=torch.long, device=device)].float() for s in seqs]
        del emb
        for i in range(m["num_layers"]):
            p = weights.draw(leaves, seed, i, device)
            hs = [block(m, p, h, mm) for h in hs]
            del p
        scale = weights.top(m, seed, device, "final_ln")
        head = weights.top(m, seed, device, "lm_head")
        return [mm(rmsnorm(h[torch.as_tensor(r, dtype=torch.long, device=device)], scale,
                           m["rmsnorm_eps"]), head)
                for h, r in zip(hs, rows)]


# ---------------------------------------------------------------------------
# work counts
# ---------------------------------------------------------------------------

def _product_params(m: dict) -> int:
    d, di, n, _, r = dims(m)
    return d * 2 * di + di * (r + 2 * n) + r * di + di * d


def _flops_per_token(m: dict) -> int:
    """Every layer's products, conv (a multiply and an add a tap and
    channel) and scan."""
    _, di, n, cw, _ = dims(m)
    return m["num_layers"] * (2 * _product_params(m) + 2 * cw * di + SCAN_OPS * di * n)


def prefill_chunk_flops(m: dict, start: int, valid: int) -> int:
    """``valid`` prompt tokens: the work a token needs does not grow with
    its position.  The unembedding is left out, as the transformer's
    count leaves it out."""
    return valid * _flops_per_token(m)


def decode_step(m: dict, contexts, routed_experts=None) -> tuple:
    """(flops, bytes) of one batched decode step with ``len(contexts)``
    active rows.  Bytes: every weight read once (``dt_bias``, ``A_log``
    and ``D`` in f32), each active row's embedding, its recurrent state
    (h in f32, the conv's last inputs in the served type) read and written
    in every layer, and its logits."""
    if routed_experts is not None:
        raise ValueError("a mamba1 model routes to no expert")
    d, di, n, cw, _ = dims(m)
    L, V, elt = m["num_layers"], m["vocab_size"], ELT[m["dtype"]]
    rows = len(contexts)
    flops = rows * (_flops_per_token(m) + 2 * d * V)
    layer = (d + _product_params(m) + cw * di + di) * elt + (di + di * n + di) * 4
    weights_ = L * layer + d * V * elt + d * elt
    state = L * 2 * (di * n * 4 + (cw - 1) * di * elt)
    return flops, weights_ + rows * (d * elt + state + V * elt)
