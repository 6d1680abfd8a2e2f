"""The ``jamba`` family: AI21's Jamba layers, attention and Mamba1 mixers
interleaved, each followed by a dense SwiGLU or a MoE feed-forward, as the
port lays out a model of interleaved kinds (``ModelConfig.interleaved``)
for ``PagedRunner``: top-level ``embed``, ``final_ln`` and ``lm_head``,
and one stack per kind of layer, in order of depth, whose leaves carry a
leading axis: ``attn`` and ``mamba`` mixers, ``mlp`` and ``moe``
feed-forwards, each row with its RMSNorm (``ln``).

Layer i (transformers 4.57.6, ``models/jamba/modeling_jamba.py``):

- its mixer is attention where i % attn_layer_period == attn_layer_offset
  and Mamba1 elsewhere; its feed-forward is the MoE where
  i % expert_layer_period == expert_layer_offset and a dense SwiGLU
  elsewhere; both halves pre-norm and residual;
- attention: GQA without positional encoding, causal;
- Mamba1: ``families/mamba1.py``'s block, with learnable RMSNorms on the
  low-rank dt and on B and C after ``x_proj`` (``JambaMambaMixer``):
  x, z = in_proj(x); x = SiLU(conv(x) + conv_b); dt, B, C = x_proj(x);
  dt, B, C = norms; dt = softplus(dt_proj(dt) + dt_bias); the selective
  scan with A = -exp(A_log); y = (C . h + D x) * SiLU(z); out_proj(y);
- MoE: an f32 softmax router over all ``router_experts``; each token's
  top ``experts_per_token`` keep their softmax weights as they are (not
  renormalised, ``JambaSparseMoeBlock``).  This card holds
  ``num_experts`` of them, from ``expert_offset`` on, and computes only
  their part, as one card of expert parallelism does before the exchange;
  the reference leaves the absent experts' part out the same way.

Weights are drawn as ``weights.py`` draws the transformer's: each layer's
leaves (its mixer's, then its feed-forward's) from a generator of its
own, ``weights.derive(seed, "layer", i)``, in the served type; the router,
``dt_bias``, ``A_log`` and ``D`` in f32, as the port keeps them; of a MoE
layer only the held experts are drawn.

The plain reference runs in f32 with TF32 off, redraws each layer from the
seed and scans Mamba one position after another; it imports nothing of
the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from omnibench import weights
from omnibench.reference.model import Products, mlp, no_tf32, rmsnorm

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}
#: operations of the scan a state element and token, as ``families/mamba1.py``
#: counts them
SCAN_OPS = 7
EXPERT_LEAVES = ("wg", "wu", "wd")


def dims(m: dict) -> tuple:
    """(d_model, d_inner, state size, conv taps, dt rank)."""
    d = m["d_model"]
    return d, m["ssm_expand"] * d, m["ssm_state"], m["ssm_conv"], -(-d // 16)


def kinds(m: dict) -> list:
    """(mixer, feed-forward) of each layer: ``attn`` or ``mamba``, ``moe``
    or ``mlp``."""
    ap, ao = m["attn_layer_period"], m["attn_layer_offset"]
    ep, eo = m["expert_layer_period"], m["expert_layer_offset"]
    return [("attn" if i % ap == ao else "mamba", "moe" if i % ep == eo else "mlp")
            for i in range(m["num_layers"])]


def router_width(m: dict) -> int:
    return m.get("router_experts") or m["num_experts"]


def kind_leaves(m: dict, kind: str) -> list:
    """(path, shape, std, mean, dtype name) of each leaf of one layer of
    ``kind``, rooted at the kind's name, in draw order."""
    d, di, n, cw, r = dims(m)
    hd, nq, nkv, f = m["head_dim"], m["num_heads"], m["num_kv_heads"], m["d_ff"]
    dt = m["dtype"]
    ln = [((kind, "ln", "scale"), (d,), weights.NORM_STD, 1.0, dt)]
    if kind == "attn":
        return ln + [
            (("attn", "wq"), (d, nq, hd), 1 / math.sqrt(d), 0.0, dt),
            (("attn", "wk"), (d, nkv, hd), 1 / math.sqrt(d), 0.0, dt),
            (("attn", "wv"), (d, nkv, hd), 1 / math.sqrt(d), 0.0, dt),
            (("attn", "wo"), (nq, hd, d), 1 / math.sqrt(nq * hd), 0.0, dt)]
    if kind == "mamba":
        return ln + [
            (("mamba", "in_proj"), (d, 2 * di), 1 / math.sqrt(d), 0.0, dt),
            (("mamba", "conv_w"), (cw, di), 1 / math.sqrt(cw), 0.0, dt),
            (("mamba", "conv_b"), (di,), weights.NORM_STD, 0.0, dt),
            (("mamba", "x_proj"), (di, r + 2 * n), 1 / math.sqrt(di), 0.0, dt),
            (("mamba", "dt_ln", "scale"), (r,), weights.NORM_STD, 1.0, dt),
            (("mamba", "b_ln", "scale"), (n,), weights.NORM_STD, 1.0, dt),
            (("mamba", "c_ln", "scale"), (n,), weights.NORM_STD, 1.0, dt),
            (("mamba", "dt_proj"), (r, di), 1 / math.sqrt(r), 0.0, dt),
            (("mamba", "dt_bias"), (di,), 0.5, -3.0, "float32"),
            (("mamba", "A_log"), (di, n), 0.5, 0.5, "float32"),
            (("mamba", "D"), (di,), weights.NORM_STD, 1.0, "float32"),
            (("mamba", "out_proj"), (di, d), 1 / math.sqrt(di), 0.0, dt)]
    if kind == "mlp":
        return ln + [
            (("mlp", "wg"), (d, f), 1 / math.sqrt(d), 0.0, dt),
            (("mlp", "wu"), (d, f), 1 / math.sqrt(d), 0.0, dt),
            (("mlp", "wd"), (f, d), 1 / math.sqrt(f), 0.0, dt)]
    E = m["num_experts"]
    return ln + [
        (("moe", "router"), (d, router_width(m)), 1 / math.sqrt(d), 0.0, "float32"),
        (("moe", "wg"), (E, d, f), 1 / math.sqrt(d), 0.0, dt),
        (("moe", "wu"), (E, d, f), 1 / math.sqrt(d), 0.0, dt),
        (("moe", "wd"), (E, f, d), 1 / math.sqrt(f), 0.0, dt)]


def layer_leaves(m: dict, i: int) -> list:
    mixer, ffn = kinds(m)[i]
    return kind_leaves(m, mixer) + kind_leaves(m, ffn)


def program_params(m: dict, seed: int, device) -> dict:
    """The port's tree: each layer drawn by ``weights.draw`` from its own
    generator and copied into the rows of its kinds' stacks."""
    ks = kinds(m)
    names = [k for pair in ks for k in pair]
    count = {k: names.count(k) for k in dict.fromkeys(names)}
    out = {"embed": weights.top(m, seed, device, "embed"),
           "final_ln": {"scale": weights.top(m, seed, device, "final_ln")},
           "lm_head": weights.top(m, seed, device, "lm_head")}
    for kind, n in count.items():
        for path, shape, _, _, dt in kind_leaves(m, kind):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = torch.empty((n, *shape), dtype=getattr(torch, dt),
                                         device=device)

    def copy(dst: dict, src: dict, row: int) -> None:
        for key, t in src.items():
            if isinstance(t, dict):
                copy(dst[key], t, row)
            else:
                dst[key][row].copy_(t)

    rows = dict.fromkeys(count, 0)
    for i, pair in enumerate(ks):
        p = weights.draw(layer_leaves(m, i), seed, i, device)
        for kind in pair:
            copy(out[kind], p[kind], rows[kind])
            rows[kind] += 1
        del p
    return out


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

def attention(m: dict, p: dict, x: torch.Tensor, mm: Products) -> torch.Tensor:
    """Causal GQA over one sequence's rows x (S, d), no positional encoding."""
    d, hd = m["d_model"], m["head_dim"]
    nq, nkv = m["num_heads"], m["num_kv_heads"]
    s = x.shape[0]
    q = mm(x, p["wq"].reshape(d, nq * hd)).reshape(s, nq, hd)
    k = mm(x, p["wk"].reshape(d, nkv * hd)).reshape(s, nkv, hd)
    v = mm(x, p["wv"].reshape(d, nkv * hd)).reshape(s, nkv, hd)
    g = nq // nkv
    qg = q.reshape(s, nkv, g, hd) * hd ** -0.5
    scores = torch.einsum("skgh,tkh->kgst", qg, k)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("kgst,tkh->skgh", probs, v).reshape(s, nq * hd)
    return mm(o, p["wo"].reshape(nq * hd, d))


def mamba(m: dict, p: dict, x: torch.Tensor, mm: Products) -> torch.Tensor:
    """The Mamba1 mixer over one sequence's rows x (S, d), scanned one
    position after another from a zero state."""
    _, di, n, cw, r = dims(m)
    eps = m["rmsnorm_eps"]
    s = x.shape[0]
    xz = mm(x, p["in_proj"])
    xs, z = xz[:, :di], xz[:, di:]
    xp = torch.cat([xs.new_zeros(cw - 1, di), xs])
    w = p["conv_w"].float()
    xs = F.silu(sum(xp[i:i + s] * w[i] for i in range(cw)) + p["conv_b"].float())
    proj = mm(xs, p["x_proj"])
    dtr = rmsnorm(proj[:, :r], p["dt_ln"]["scale"], eps)
    B = rmsnorm(proj[:, r:r + n], p["b_ln"]["scale"], eps)
    C = rmsnorm(proj[:, r + n:], p["c_ln"]["scale"], eps)
    dt = F.softplus(mm(dtr, p["dt_proj"]) + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    state = xs.new_zeros(di, n)
    ys = []
    for t in range(s):
        state = torch.exp(dt[t, :, None] * A) * state + (dt[t] * xs[t])[:, None] * B[t]
        ys.append(state @ C[t])
    y = (torch.stack(ys) + xs * p["D"].float()) * F.silu(z)
    return mm(y, p["out_proj"])


def moe(m: dict, p: dict, x: torch.Tensor, mm: Products) -> torch.Tensor:
    """The held experts' part of the MoE layer: every routed (token, held
    expert) pair, one expert at a time, weighted by its softmax weight over
    all the router's experts."""
    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = m["experts_per_token"]
    w, idx = vals[:, :k], idx[:, :k]
    if m.get("renormalize_topk", True):
        w = w / w.sum(-1, keepdim=True)
    lo, held = m.get("expert_offset", 0), m["num_experts"]
    y = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        if not lo <= e < lo + held:
            continue
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        xe = x[tok]
        h = F.silu(mm(xe, p["wg"][e - lo])) * mm(xe, p["wu"][e - lo])
        y.index_add_(0, tok, mm(h, p["wd"][e - lo]) * w[tok, slot, None])
    return y


def block(m: dict, kind: tuple, p: dict, h: torch.Tensor, mm: Products) -> torch.Tensor:
    """One layer of ``kind`` (mixer, feed-forward) over rows h (S, d)."""
    mixer, ffn = kind
    eps = m["rmsnorm_eps"]
    q = p[mixer]
    h = h + (attention if mixer == "attn" else mamba)(m, q, rmsnorm(h, q["ln"]["scale"], eps),
                                                     mm)
    f = p[ffn]
    hn = rmsnorm(h, f["ln"]["scale"], eps)
    return h + (moe(m, f, hn, mm) if ffn == "moe" else mlp(f, hn, mm))


@torch.no_grad()
def logits(m: dict, seed: int, seqs: list, rows: list, device, quant=None) -> list:
    """f32 logits of each sequence ``seqs[j]`` at its positions ``rows[j]``,
    each layer drawn again from ``seed``; ``quant="fp8"`` rounds every
    product's operands to e4m3 (the control; the router stays f32)."""
    mm = Products(quant)
    with no_tf32():
        emb = weights.top(m, seed, device, "embed")
        hs = [emb[torch.as_tensor(s, dtype=torch.long, device=device)].float() for s in seqs]
        del emb
        for i, kind in enumerate(kinds(m)):
            p = weights.draw(layer_leaves(m, i), seed, i, device)
            hs = [block(m, kind, p, h, mm) for h in hs]
            del p
        scale = weights.top(m, seed, device, "final_ln")
        head = weights.top(m, seed, device, "lm_head")
        return [mm(rmsnorm(h[torch.as_tensor(r, dtype=torch.long, device=device)], scale,
                           m["rmsnorm_eps"]), head)
                for h, r in zip(hs, rows)]


# ---------------------------------------------------------------------------
# work counts
# ---------------------------------------------------------------------------

def _numel(shape) -> int:
    return math.prod(shape)


def held(m: dict) -> tuple:
    """(parameters, bytes) the card holds: every leaf the program is given."""
    d, V, elt = m["d_model"], m["vocab_size"], ELT[m["dtype"]]
    params, nbytes = 2 * d * V + d, (2 * d * V + d) * elt
    for i in range(m["num_layers"]):
        for _, shape, _, _, dt in layer_leaves(m, i):
            params += _numel(shape)
            nbytes += _numel(shape) * ELT[dt]
    return params, nbytes


def state_bytes(m: dict) -> int:
    """One slot's recurrent state: each Mamba layer's h in f32 and its conv
    window (the last taps - 1 inputs) in the served type."""
    _, di, n, cw, _ = dims(m)
    n_mamba = sum(mixer == "mamba" for mixer, _ in kinds(m))
    return n_mamba * (di * n * 4 + (cw - 1) * di * ELT[m["dtype"]])


def _product_params(m: dict, kind: str) -> int:
    """Weights one token multiplies in a layer half of ``kind`` (of a MoE:
    the router and one expert)."""
    d, di, n, _, r = dims(m)
    f, hd, nq, nkv = m["d_ff"], m["head_dim"], m["num_heads"], m["num_kv_heads"]
    return {"attn": d * nq * hd + 2 * d * nkv * hd + nq * hd * d,
            "mamba": d * 2 * di + di * (r + 2 * n) + r * di + di * d,
            "mlp": 3 * d * f,
            "moe": 3 * d * f}[kind]


def _flops_per_token(m: dict) -> int:
    """Every layer's products, a Mamba layer's conv (a multiply and an add
    a tap and channel) and scan; of a MoE layer the router and, on average,
    the share of the token's top k that the held experts are (the counts
    see no pairs)."""
    d, di, n, cw, _ = dims(m)
    R, k, E = router_width(m), m["experts_per_token"], m["num_experts"]
    out = 0
    for mixer, ffn in kinds(m):
        out += 2 * _product_params(m, mixer)
        if mixer == "mamba":
            out += 2 * cw * di + SCAN_OPS * di * n
        out += (2 * d * R + 2 * _product_params(m, "moe") * k * E // R if ffn == "moe"
                else 2 * _product_params(m, "mlp"))
    return out


def _attention_flops(m: dict, positions) -> int:
    """Scores and weighted sum of queries at ``positions`` over every
    earlier position and their own, in every attention layer."""
    n_attn = sum(mixer == "attn" for mixer, _ in kinds(m))
    return 4 * m["num_heads"] * m["head_dim"] * n_attn * sum(p + 1 for p in positions)


def prefill_chunk_flops(m: dict, start: int, valid: int) -> int:
    """``valid`` prompt tokens at positions [start, start + valid); the
    unembedding left out, as the transformer's count leaves it out."""
    return valid * _flops_per_token(m) + _attention_flops(m, range(start, start + valid))


def decode_step(m: dict, contexts, routed_experts=None) -> tuple:
    """(flops, bytes) of one batched decode step whose active rows hold
    ``contexts`` tokens each (the new one included).  Bytes: every weight
    read once, of each MoE layer only the held experts its active rows
    routed to (``routed_experts[j]`` distinct ones in the j-th MoE
    layer); each active row's embedding, its K and V in every attention
    layer and the new ones written, its Mamba states read and written (h
    in f32, the conv window in the served type), and its logits."""
    ks = kinds(m)
    n_moe = sum(ffn == "moe" for _, ffn in ks)
    if routed_experts is None or len(routed_experts) != n_moe:
        raise ValueError(f"a step's bytes need the held experts routed to in each of "
                         f"{n_moe} MoE layers, got {routed_experts!r}")
    d, V, elt = m["d_model"], m["vocab_size"], ELT[m["dtype"]]
    nkv, hd, f = m["num_kv_heads"], m["head_dim"], m["d_ff"]
    rows = len(contexts)
    flops = rows * (_flops_per_token(m) + 2 * d * V) + _attention_flops(
        m, [c - 1 for c in contexts])
    weights_ = (d * V + d) * elt
    for i in range(len(ks)):
        for path, shape, _, _, dt in layer_leaves(m, i):
            if path[0] != "moe" or path[-1] not in EXPERT_LEAVES:
                weights_ += _numel(shape) * ELT[dt]
    weights_ += sum(routed_experts) * 3 * d * f * elt
    n_attn = sum(mixer == "attn" for mixer, _ in ks)
    kv_row = n_attn * 2 * nkv * hd * elt
    nbytes = (weights_ + rows * (d * elt + 2 * state_bytes(m) + V * elt)
              + sum(contexts) * kv_row + rows * kv_row)
    return flops, nbytes


def scan_decode_call(m: dict, rows: int) -> tuple:
    """(flops, bytes) of one Mamba layer's one-step scan over ``rows``
    active rows: their x, dt, B and C read in the served type, A and D in
    f32, h read and written in f32, y written."""
    _, di, n, _, _ = dims(m)
    elt = ELT[m["dtype"]]
    per_row = 2 * di * elt + 2 * n * elt + 2 * di * n * 4 + di * elt
    return rows * (SCAN_OPS * di * n + 2 * di), rows * per_row + di * n * 4 + di * 4
