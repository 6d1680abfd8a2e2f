"""Seeded weights, drawn on the device in the type they are served in:
the ``transformer`` family's layout (``families/transformer.py``), and
the drawing that every family's layout shares (``draw``, ``stack``).

Each layer's leaves come from a generator of their own, seeded by the
run's seed and the layer's index, and are drawn in a fixed order with
``normal_`` straight into a tensor of the leaf's shape and type (no host
copy, no f32 temporary).  So the plain reference can draw any one layer
again from the seed alone, and never reads what the program was given.

``program_params`` lays the draws out as the program takes them (the
port's parameter tree: top-level embedding, final norm and LM head, and
``blocks`` whose leaves stack the layers on a leading axis);
``layer``/``top`` give the same values one layer at a time.  A family
with other layers gives ``draw`` and ``stack`` its own list of leaves.

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


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def normal(shape, std: float, dtype, gen: torch.Generator, mean: float = 0.0):
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


def draw(leaves: list, seed: int, i: int, device) -> dict:
    """Layer ``i``'s ``leaves`` ((path, shape, std, mean, dtype name), in
    draw order) as a nested dict of fresh tensors, from the layer's own
    generator."""
    gen = generator(device, seed, "layer", i)
    out: dict = {}
    for path, shape, std, mean, dt in leaves:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = normal(shape, std, getattr(torch, dt), gen, mean)
    return out


def stack(leaves: list, seed: int, layers, device) -> dict:
    """The ``layers``' draws of ``leaves`` stacked on a leading axis, each
    layer drawn by ``draw`` and copied into its row."""
    layers = list(layers)
    out: dict = {}
    for path, shape, _, _, dt in leaves:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty((len(layers), *shape), dtype=getattr(torch, dt),
                                     device=device)

    def copy(dst: dict, src: dict, row: int) -> None:
        for key, t in src.items():
            if isinstance(t, dict):
                copy(dst[key], t, row)
            else:
                dst[key][row].copy_(t)

    for row, i in enumerate(layers):
        copy(out, draw(leaves, seed, i, device), row)
    return out


def layer(m: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``'s leaves as a nested dict of fresh tensors."""
    return draw(layer_shapes(m), seed, i, device)


def top(m: dict, seed: int, device, which: str) -> torch.Tensor:
    """One top-level leaf: ``embed`` (V, d), ``final_ln`` (d,) or
    ``lm_head`` (d, V), each from a generator of its own."""
    d, V, dt = m["d_model"], m["vocab_size"], getattr(torch, m["dtype"])
    gen = generator(device, seed, which)
    if which == "embed":
        return normal((V, d), EMBED_STD, dt, gen)
    if which == "final_ln":
        return normal((d,), NORM_STD, dt, gen, 1.0)
    if which == "lm_head":
        return normal((d, V), 1 / math.sqrt(d), dt, gen)
    raise ValueError(f"no top-level leaf {which!r}")


def program_params(m: dict, seed: int, device) -> dict:
    """The program's parameter tree, each layer drawn by ``layer`` and
    copied into its row of the stacked leaves."""
    blocks = stack(layer_shapes(m), seed, range(m["num_layers"]), device)
    return {"embed": top(m, seed, device, "embed"),
            "final_ln": {"scale": top(m, seed, device, "final_ln")},
            "lm_head": top(m, seed, device, "lm_head"),
            "blocks": blocks}
