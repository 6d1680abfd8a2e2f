"""Operations and bytes that a step's inputs need, worked out from shapes,
and the card's data-sheet peaks.

The peaks are those of ``repro_torch/launch/mesh.py``, copied so that a
change to the program cannot move them: one NVIDIA H100 SXM at its 700 W
limit, 989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of HBM.
A share of a peak is stated with the card's power limit beside it.

The model counts here are the ``transformer`` family's; another family
counts its own layers (``families/<family>.py``).  ``m`` is the
``model`` section of a configuration file (d_model, num_layers,
num_heads, num_kv_heads, head_dim, d_ff, vocab_size and, for a MoE,
num_experts and experts_per_token).  Counts are of what the inputs
need, not of what the program happens to compute: padding rows,
inactive batch rows and experts no token was routed to count nothing.
"""
from __future__ import annotations

from typing import Iterable, Sequence

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def attn_proj_params(m: dict) -> int:
    d, hd = m["d_model"], m["head_dim"]
    nq, nkv = m["num_heads"], m["num_kv_heads"]
    return d * nq * hd + 2 * d * nkv * hd + nq * hd * d


def ffn_params_per_token(m: dict) -> int:
    """Weights one token's feed-forward multiplies: the dense MLP, or the
    router and its top-k experts."""
    d, f = m["d_model"], m["d_ff"]
    if m.get("num_experts", 0):
        return d * m["num_experts"] + m["experts_per_token"] * 3 * d * f
    return 3 * d * f


def attention_flops(m: dict, positions: Iterable[int]) -> int:
    """Scores and weighted sum for queries at ``positions``, each attending
    causally to every earlier position and itself, in every layer."""
    per_key = 4 * m["num_heads"] * m["head_dim"] * m["num_layers"]
    return per_key * sum(p + 1 for p in positions)


def prefill_chunk_flops(m: dict, start: int, valid: int) -> int:
    """A chunk of ``valid`` prompt tokens at positions [start, start+valid):
    every product of every layer and the attention the chunk needs.  The
    unembedding of the prompt's last token is left out: the runner's
    call does not say which chunk is a prompt's last, and it is 0.2% of
    a full chunk at InternLM2-1.8B's widths."""
    per_token = 2 * m["num_layers"] * (attn_proj_params(m) + ffn_params_per_token(m))
    return valid * per_token + attention_flops(m, range(start, start + valid))


def decode_step(m: dict, contexts: Sequence[int],
                routed_experts: Sequence[int] | None = None,
                elt: int = 2) -> tuple:
    """(flops, bytes) of one batched decode step whose active rows hold
    ``contexts`` tokens each (the new token included).  Bytes: every
    weight read once (for a MoE only the experts the step routed to,
    ``routed_experts[i]`` distinct ones in layer i; the router is f32),
    each active row's embedding, its context's K and V in every layer,
    the new K and V written, and its logits."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    nkv, hd = m["num_kv_heads"], m["head_dim"]
    rows = len(contexts)
    flops = (rows * (2 * L * (attn_proj_params(m) + ffn_params_per_token(m)) + 2 * d * V)
             + attention_flops(m, [c - 1 for c in contexts]))
    weights = L * (attn_proj_params(m) + 2 * d) * elt + d * V * elt + d * elt
    if m.get("num_experts", 0):
        if routed_experts is None:
            raise ValueError("a MoE step's bytes need the experts it routed to")
        weights += L * d * m["num_experts"] * 4
        weights += sum(routed_experts) * 3 * d * m["d_ff"] * elt
    else:
        weights += L * 3 * d * m["d_ff"] * elt
    kv_row = L * 2 * nkv * hd * elt
    nbytes = (weights + rows * d * elt + sum(contexts) * kv_row + rows * kv_row
              + rows * V * elt)
    return flops, nbytes


def paged_attention_call(nq: int, nkv: int, hd: int, page: int,
                         seq_lens: Sequence[int], elt: int = 2) -> tuple:
    """(flops, bytes) of one paged-attention call over the active rows'
    ``seq_lens``: each row's K and V pages read once, q read and the
    output written once."""
    pages = sum(-(-s // page) for s in seq_lens)
    nbytes = pages * page * nkv * hd * 2 * elt + 2 * len(seq_lens) * nq * hd * elt
    flops = 4 * nq * hd * sum(seq_lens)
    return flops, nbytes
