"""The plain reference of the ``transformer`` family
(``families/transformer.py``): a float32 forward of the dense and MoE
transformers the configurations name, in plain PyTorch, with TF32 off.
Other families' references reuse its products, norm and TF32 switch.

It imports nothing of the program.  It draws each layer's weights again
from the run's seed (``omnibench.weights``), one layer at a time, and
runs every sequence through that layer before drawing the next, so that
it fits on the card beside nothing else once the program's state is
freed (a MoE layer's experts are widened to f32 one expert at a time).

The block is the pre-norm block of the port's model family:
RMSNorm (f32 statistics) -> GQA attention with split-half RoPE, causal
over the whole sequence -> residual -> RMSNorm -> SwiGLU MLP, or a MoE:
an f32 softmax router, the top k experts per token (ties to the lower
index), their weights renormalised to sum to one, and every routed
(token, expert) pair computed (the configurations are dropless) ->
residual; then the final RMSNorm and the LM head.

``quant="fp8"`` is the control: the same forward with every product's
operands rounded to float8 e4m3 (per-row scales for activations,
per-column scales for weights), accumulated in f32.  The router stays
f32, as a lower-precision serving path would keep it.
"""
from __future__ import annotations

import contextlib

import torch

from omnibench import weights

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``, back in f32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Products:
    """x @ w in f32, or with fp8 operands for the control."""

    def __init__(self, quant: str | None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.quant = quant

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.quant == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0..S-1, split-half rotation."""
    s, _, hd = x.shape
    half = hd // 2
    inv = torch.exp(-torch.log(torch.tensor(float(theta)))
                    * torch.arange(half, dtype=torch.float32) / half).to(x.device)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: dict, p: dict, x: torch.Tensor, mm: Products) -> torch.Tensor:
    d, hd = m["d_model"], m["head_dim"]
    nq, nkv = m["num_heads"], m["num_kv_heads"]
    s = x.shape[0]
    q = mm(x, p["wq"].reshape(d, nq * hd)).reshape(s, nq, hd)
    k = mm(x, p["wk"].reshape(d, nkv * hd)).reshape(s, nkv, hd)
    v = mm(x, p["wv"].reshape(d, nkv * hd)).reshape(s, nkv, hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    g = nq // nkv
    qg = q.reshape(s, nkv, g, hd) * hd ** -0.5
    scores = torch.einsum("skgh,tkh->kgst", qg, k)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("kgst,tkh->skgh", probs, v).reshape(s, nq * hd)
    return mm(o, p["wo"].reshape(nq * hd, d))


def mlp(p: dict, x: torch.Tensor, mm: Products) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, p["wg"])) * mm(x, p["wu"]), p["wd"])


def route(m: dict, router: torch.Tensor, x: torch.Tensor):
    """(weights (T, k) renormalised, expert ids (T, k)) of the f32 router."""
    gates = torch.softmax(x.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = m["experts_per_token"]
    w = vals[:, :k]
    return w / w.sum(-1, keepdim=True), idx[:, :k]


def moe(m: dict, p: dict, x: torch.Tensor, mm: Products) -> torch.Tensor:
    """Every routed (token, expert) pair, one expert at a time."""
    w, idx = route(m, p["router"], x)
    y = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        xe = x[tok]
        h = (torch.nn.functional.silu(mm(xe, p["wg"][e])) * mm(xe, p["wu"][e]))
        y.index_add_(0, tok, mm(h, p["wd"][e]) * w[tok, slot, None])
    return y


def block(m: dict, p: dict, h: torch.Tensor, mm: Products) -> torch.Tensor:
    eps = m["rmsnorm_eps"]
    h = h + attention(m, p["attn"], rmsnorm(h, p["ln1"]["scale"], eps), mm)
    hn = rmsnorm(h, p["ln2"]["scale"], eps)
    return h + (moe(m, p["moe"], hn, mm) if "moe" in p else mlp(p["mlp"], hn, mm))


@torch.no_grad()
def logits(m: dict, seed: int, seqs: list, rows: list, device,
           quant: str | None = None) -> list:
    """f32 logits of each sequence ``seqs[j]`` (int ids) at its positions
    ``rows[j]``, weights drawn again from ``seed`` layer by layer."""
    mm = Products(quant)
    with no_tf32():
        emb = weights.top(m, seed, device, "embed")
        hs = [emb[torch.as_tensor(s, dtype=torch.long, device=device)].float()
              for s in seqs]
        del emb
        for i in range(m["num_layers"]):
            p = weights.layer(m, seed, i, device)
            hs = [block(m, p, h, mm) for h in hs]
            del p
        scale = weights.top(m, seed, device, "final_ln")
        head = weights.top(m, seed, device, "lm_head")
        out = []
        for h, r in zip(hs, rows):
            idx = torch.as_tensor(r, dtype=torch.long, device=device)
            out.append(mm(rmsnorm(h[idx], scale, m["rmsnorm_eps"]), head))
        return out
