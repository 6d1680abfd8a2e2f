"""Adaptive sharding rules: logical-dim -> mesh-axis PartitionSpecs, and
their DTensor placements.

Rules (the JAX package's ``sharding/specs.py``, as pure data):
  - parameters: tensor-parallel over "model" (heads / ffn / experts / vocab),
    replicated over "data" and "pod";
  - batch dims shard over ("pod","data") when divisible;
  - decode KV caches shard kv-heads over "model" when divisible by the
    model-axis size, else the sequence axis (context parallelism); with
    batch=1 (long_500k) the sequence axis also takes the data axis.

The rules take any mesh: a ``DeviceMesh`` (its ``mesh_dim_names`` and
``shape``), or a stand-in with ``axis_names`` and a ``shape`` mapping
(the tests' FakeMesh).  ``fit_spec`` makes every spec divide its dims
evenly, so a DTensor's shards are all of one size.

New in the port: ``placements`` turns a spec into DTensor placements,
``distribute`` a tensor tree into DTensors (real, or meta ones of the
right local shape for the dry-run).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names.  A tuple, as ``jax.sharding.PartitionSpec`` compares, with its
    normalisation: an entry of one name is that name, an empty one None."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 0:
                    return None
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _sizes(mesh) -> dict:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


# ----------------------------------------------------------------------------
# parameter specs, by param-tree path
# ----------------------------------------------------------------------------

_PARAM_RULES = {
    # name-suffix -> spec WITHOUT the stacked-layer leading dim
    "embed": P("model", None),
    "lm_head": P(None, "model"),
    "wq": P(None, "model", None),      # (d, nq, hd)
    "wk": P(None, "model", None),
    "wv": P(None, "model", None),
    "wo": P("model", None, None),      # (nq, hd, d)
    "bq": P("model", None),
    "bk": P("model", None),
    "bv": P("model", None),
    "wg": P(None, "model"),            # (d, f)
    "wu": P(None, "model"),
    "wd": P("model", None),            # (f, d)
    "router": P(None, "model"),        # (d, E)
    "in_proj": P(None, "model"),       # (d, 2di[+...])
    "conv_w": P(None, "model"),        # (cw, ch)
    "conv_b": P("model"),
    "x_proj": P("model", None),        # (di, r+2n)
    "dt_proj": P(None, "model"),       # (r, di)
    "dt_bias": P("model"),
    "A_log": P("model"),               # (di, n) or (nh,) -- padded below
    "D": P("model"),
    "out_proj": P("model", None),      # (di, d)
    "scale": P(None),                  # rmsnorm
    # DiT extras
    "xwq": P(None, "model", None), "xwk": P(None, "model", None),
    "xwv": P(None, "model", None), "xwo": P("model", None, None),
    "ada": P(None, "model"), "in_projd": P(None, "model"),
    "t_mlp1": P(None, "model"), "t_mlp2": P("model", None),
}

# MoE expert-stacked weights get the expert dim sharded instead
_MOE_RULES = {
    "wg": P("model", None, None),      # (E, d, f)
    "wu": P("model", None, None),
    "wd": P("model", None, None),      # (E, f, d)
}


def fit_spec(mesh, shape: Tuple[int, ...], spec: P) -> P:
    """Make a spec legal for an even split: every named axis must evenly
    divide its dim.  Axes that don't fit are dropped; if "model" gets
    dropped entirely, it is re-placed on the largest dim it divides (so
    params stay tensor-parallel even when the preferred dim is too small,
    e.g. 8 kv heads on a model=16 axis -> shard head_dim instead)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts = parts[:len(shape)]
    dropped = []
    for i, (dim, p) in enumerate(zip(shape, parts)):
        if p is None:
            continue
        if dim % axis_size(mesh, p) != 0:
            dropped.append(p)
            parts[i] = None
    for p in dropped:
        if p in parts:
            continue
        cands = [i for i, (dim, q) in enumerate(zip(shape, parts))
                 if q is None and dim % axis_size(mesh, p) == 0 and dim > 1]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            parts[best] = p
    return P(*parts)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (the counterpart
    of ``jax.tree_util.tree_map_with_path``; a path holds the dict keys
    and list indices down to the leaf; a PartitionSpec is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params, mesh=None) -> Any:
    """PartitionSpec tree matching ``params`` (handles stacked-layer dims)."""

    def spec_for(path, leaf):
        names = [str(k) for k in path]
        last = names[-1]
        in_moe = "moe" in names
        rules = _MOE_RULES if (in_moe and last in _MOE_RULES) else _PARAM_RULES
        base = rules.get(last)
        if base is None:
            return P()
        # stacked-layer leading dims: params under "blocks"/"mamba" carry an
        # extra (L,) axis relative to the single-layer shapes.
        extra = leaf.ndim - len(base)
        if extra < 0:  # e.g. A_log (nh,) vs rule (di,n): trim
            base = P(*base[:leaf.ndim])
            extra = leaf.ndim - len(base)
        spec = P(*([None] * extra), *base)
        if mesh is not None:
            spec = fit_spec(mesh, tuple(leaf.shape), spec)
        return spec

    return map_with_path(spec_for, params)


# ----------------------------------------------------------------------------
# activation / cache specs
# ----------------------------------------------------------------------------

def batch_spec(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """Best batch sharding: the largest prefix of ("pod","data") dividing B."""
    axes = data_axes(mesh)
    while axes and batch % axis_size(mesh, axes) != 0:
        axes = axes[:-1]
    return axes or None


def token_specs(cfg: ModelConfig, mesh, batch: int) -> P:
    b = batch_spec(mesh, batch)
    if cfg.modality == "audio_frames":
        return P(b, None, None)
    return P(b, None)


def kv_cache_specs(cfg: ModelConfig, mesh, batch: int, seq_shard_axes=None) -> dict:
    """Specs for the decode cache dict of init_decode_cache."""
    msize = axis_size(mesh, "model")
    b = batch_spec(mesh, batch)
    specs = {}
    if "k" in _cache_keys(cfg):
        if cfg.num_kv_heads % msize == 0:
            kvspec = P(None, b, seq_shard_axes, "model", None)
        else:
            # context parallelism: shard the sequence axis over "model"
            kvspec = P(None, b, ("model",) if seq_shard_axes is None
                       else seq_shard_axes, None, None)
        if b is None and batch == 1:
            # batch=1 long-context: sequence takes the data axes too
            prev = kvspec[2]
            prev_axes = ((prev,) if isinstance(prev, str)
                         else tuple(prev or ()))
            kvspec = P(None, None, ("data",) + prev_axes, *kvspec[3:])
        specs["k"] = kvspec
        specs["v"] = kvspec
        # int8 KV quantization scales: same layout minus the head_dim axis
        sc = P(*tuple(kvspec)[:-1])
        specs["k_scale"] = sc
        specs["v_scale"] = sc
    if cfg.arch_type in ("ssm", "hybrid"):
        if cfg.ssm_version == 1:
            specs["ssm_h"] = P(None, b, "model", None)       # (L,B,di,n)
        else:
            specs["ssm_h"] = P(None, b, "model", None, None)  # (L,B,nh,hp,n)
        specs["ssm_conv"] = P(None, b, None, "model")        # (L,B,cw-1,ch)
    return specs


def _cache_keys(cfg: ModelConfig):
    keys = []
    if cfg.arch_type in ("dense", "moe", "vlm", "audio", "hybrid"):
        keys += ["k", "v"]
    if cfg.arch_type in ("ssm", "hybrid"):
        keys += ["ssm_h", "ssm_conv"]
    return keys


# ----------------------------------------------------------------------------
# DTensor placements
# ----------------------------------------------------------------------------

def placements(mesh, spec: P) -> tuple:
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dim.  An entry that
    names several axes, e.g. ("pod", "data"), shards its tensor dim over
    each of them; DTensor splits a dim over mesh dims in mesh order, which
    is the JAX spec's major-to-minor order only when the entry lists the
    axes in mesh order, so any other order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, p in enumerate(spec):
        if p is None:
            continue
        axes = (p,) if isinstance(p, str) else tuple(p)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {p!r} lists its axes out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(mesh, shape, spec: P) -> Tuple[int, ...]:
    """The shape of one shard of a tensor of ``shape`` laid out by ``spec``
    (every sharded dim divides evenly, as ``fit_spec`` makes it)."""
    out = list(shape)
    for dim, p in enumerate(spec):
        if p is None:
            continue
        n = axis_size(mesh, p)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split {n} ways ({spec})")
        out[dim] //= n
    return tuple(out)


def distribute(tree, mesh, spec_tree, meta: bool = False):
    """A tree of tensors as DTensors laid out by ``spec_tree`` (specs
    re-fitted to each leaf's shape).  ``meta=True`` takes only each
    leaf's shape and dtype and gives meta DTensors whose local tensor has
    the shard's shape: nothing is allocated and nothing is sent (the
    dry-run); otherwise ``distribute_tensor`` scatters real values."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(leaf, spec):
        spec = fit_spec(mesh, tuple(leaf.shape), spec)
        pl = placements(mesh, spec)
        if not meta:
            return distribute_tensor(leaf, mesh, pl)
        local = torch.empty(local_shape(mesh, leaf.shape, spec), dtype=leaf.dtype,
                            device="meta")
        stride = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta").stride()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=torch.Size(leaf.shape), stride=stride)

    return zip_map(one, tree, spec_tree)


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts and the spec tree beside it."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)
