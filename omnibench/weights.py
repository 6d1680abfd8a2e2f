"""Seeded weights, drawn on the device in the type they are served in.

Each layer's leaves come from a generator of their own, seeded by the
run's seed and the layer's index, and are drawn in a fixed order with
``normal_`` straight into a tensor of the leaf's shape and type (no host
copy, no f32 temporary).  So the plain reference can draw any one layer
again from the seed alone, and never reads what the program was given.

``program_params`` lays the draws out as the program takes them (the
port's parameter tree: top-level embedding, final norm and LM head, and
``blocks`` whose leaves stack the layers on a leading axis);
``layer``/``top`` give the same values one layer at a time.

Distributions follow the port's own initialisation (normal, standard
deviation 1/sqrt(fan-in); the embedding 0.02), except the norm scales,
which are drawn around 1 (standard deviation 0.1) rather than set to 1,
so that the comparison sees whether each norm applies its scale.
"""
from __future__ import annotations

import hashlib
import math

import torch

NORM_STD = 0.1
EMBED_STD = 0.02


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed and a leaf's tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def _normal(shape, std: float, dtype, gen: torch.Generator, mean: float = 0.0):
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    return t.normal_(mean, std, generator=gen)


def layer_shapes(m: dict) -> list:
    """(path, shape, std, mean, dtype name) of each leaf of one layer, in
    draw order.  The router of a MoE is f32, as the port keeps it."""
    d, hd, f = m["d_model"], m["head_dim"], m["d_ff"]
    nq, nkv = m["num_heads"], m["num_kv_heads"]
    dt = m["dtype"]
    leaves = [
        (("ln1", "scale"), (d,), NORM_STD, 1.0, dt),
        (("attn", "wq"), (d, nq, hd), 1 / math.sqrt(d), 0.0, dt),
        (("attn", "wk"), (d, nkv, hd), 1 / math.sqrt(d), 0.0, dt),
        (("attn", "wv"), (d, nkv, hd), 1 / math.sqrt(d), 0.0, dt),
        (("attn", "wo"), (nq, hd, d), 1 / math.sqrt(nq * hd), 0.0, dt),
        (("ln2", "scale"), (d,), NORM_STD, 1.0, dt),
    ]
    if m.get("num_experts", 0):
        E = m["num_experts"]
        leaves += [
            (("moe", "router"), (d, E), 1 / math.sqrt(d), 0.0, "float32"),
            (("moe", "wg"), (E, d, f), 1 / math.sqrt(d), 0.0, dt),
            (("moe", "wu"), (E, d, f), 1 / math.sqrt(d), 0.0, dt),
            (("moe", "wd"), (E, f, d), 1 / math.sqrt(f), 0.0, dt),
        ]
    else:
        leaves += [
            (("mlp", "wg"), (d, f), 1 / math.sqrt(d), 0.0, dt),
            (("mlp", "wu"), (d, f), 1 / math.sqrt(d), 0.0, dt),
            (("mlp", "wd"), (f, d), 1 / math.sqrt(f), 0.0, dt),
        ]
    return leaves


def layer(m: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``'s leaves as a nested dict of fresh tensors."""
    gen = _gen(device, seed, "layer", i)
    out: dict = {}
    for (group, leaf), shape, std, mean, dt in layer_shapes(m):
        out.setdefault(group, {})[leaf] = _normal(shape, std, getattr(torch, dt), gen, mean)
    return out


def top(m: dict, seed: int, device, which: str) -> torch.Tensor:
    """One top-level leaf: ``embed`` (V, d), ``final_ln`` (d,) or
    ``lm_head`` (d, V), each from a generator of its own."""
    d, V, dt = m["d_model"], m["vocab_size"], getattr(torch, m["dtype"])
    gen = _gen(device, seed, which)
    if which == "embed":
        return _normal((V, d), EMBED_STD, dt, gen)
    if which == "final_ln":
        return _normal((d,), NORM_STD, dt, gen, 1.0)
    if which == "lm_head":
        return _normal((d, V), 1 / math.sqrt(d), dt, gen)
    raise ValueError(f"no top-level leaf {which!r}")


def program_params(m: dict, seed: int, device) -> dict:
    """The program's parameter tree, each layer drawn by ``layer`` and
    copied into its row of the stacked leaves."""
    L = m["num_layers"]
    blocks: dict = {}
    for (group, leaf), shape, _, _, dt in layer_shapes(m):
        blocks.setdefault(group, {})[leaf] = torch.empty(
            (L, *shape), dtype=getattr(torch, dt), device=device)
    for i in range(L):
        for group, leaves in layer(m, seed, i, device).items():
            for leaf, t in leaves.items():
                blocks[group][leaf][i].copy_(t)
    return {"embed": top(m, seed, device, "embed"),
            "final_ln": {"scale": top(m, seed, device, "final_ln")},
            "lm_head": top(m, seed, device, "lm_head"),
            "blocks": blocks}
