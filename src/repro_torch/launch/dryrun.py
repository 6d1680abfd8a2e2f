"""Multi-pod dry-run: every (arch x shape x mesh) stepped on meta DTensors.

Usage (no card, nothing allocated):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_14b \
      --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The counterpart of the JAX package's dry-run, which lowers and compiles
each step for the production mesh on forced host devices.  Here a fake
process group (``FakeStore``, backend "fake") of the mesh's world size
stands in for the cluster, this process is one rank of it (rank 0 unless
``--rank``), and the step runs eagerly on DTensors whose local tensors
live on the meta device: every shape and placement is real, no byte is
allocated and no collective moves data.  The meta device is the design,
not a fallback: the dry-run touches no card, as the JAX one runs on host
devices.  On meta tensors the kernel wrappers take their plain versions
(``ops._use_cuda`` is false), as the JAX dry-run's ``ops.get_backend``
picks ``ref`` off the TPU.

Arguments take their placements from the fitted specs of
``sharding/specs.py``: parameters (``param_specs``), optimizer moments
(``opt_specs``, ZeRO along "data" unless ``--no-zero``), inputs
(``input_specs``) and decode caches (``kv_cache_specs``).  The step is
the port's own: ``train/step.py: make_train_step``, ``forward_prefill``
(called without ``remat``: the port's prefill has none, and under
``no_grad`` it would change nothing) or ``forward_decode`` at position
``seq_len - 1``, under ``distribution(DistContext(...))``.  The plain
Mamba1 scan runs as ``ref.mamba1_scan_chunked`` on sequences longer than
64 (``chunked_mamba1_scan``): the step-by-step scan of a 4096-token train
shape is 64 times as many Python steps.

``DryRunMode`` watches the step: DTensor sharding propagation places
every op, and where it has no strategy for an op at its inputs'
placements (a view that would split a sharded dim unevenly), or its
strategy asks for a redistribution this torch cannot make, the op runs
on replicated inputs, as GSPMD resolves a conflict by resharding;
an in-place write into a sharded tensor (a decode step's cache column)
stays on each rank's shard, only its values and indices replicated, as
GSPMD partitions a scatter.  Those ops are counted in
``replicated_ops``.  The math never changes.

Each record keeps the JAX record's keys that have a counterpart:
``arch``, ``shape``, ``mesh``, ``moe_impl``, ``status``, ``reason``,
``attn_variant``, ``kv_cache_dtype``, ``remat``, ``padded_heads``,
``error``, ``traceback``; ``argument_size_in_bytes`` and
``output_size_in_bytes`` per device (the local shards' bytes);
``collective_bytes`` by kind (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``) and ``total``: the result tensors'
bytes of each collective as it is dispatched, the JAX parser's
convention.  It adds ``run_s`` (building the meta arguments and running
the step), ``collective_calls`` and ``matmul_flops`` (per device, the
products that ``torch.utils.flop_counter`` knows: not XLA's ``flops``,
which counts every op).

Left out, as XLA's alone: ``lower_s``, ``compile_s``,
``temp_size_in_bytes``, ``generated_code_size_in_bytes``, ``bytes``,
``uncorrected_total``, and the HLO parser ``collective_bytes`` with its
while-loop trip counts: the port's layer loop is Python, so every
collective is counted once per call and nothing needs correcting.  A
mesh on the "cpu" device type has no all-to-all in DTensor, which moves
a shard between dims with an all-gather instead (counted as such).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ModelConfig, ShapeConfig,
                                      get_config, shape_skips, variant_for_shape)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as S
from repro_torch.sharding.context import DistContext, distribution
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step

P = S.P

# collectives by the name of their op: the functional collectives that
# DTensor issues, and the c10d ops of torch.distributed's own calls
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _global_meta(a):
    """DTensors as plain meta tensors of their global shapes."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        return torch.empty(a.shape, dtype=a.dtype, device="meta")
    if isinstance(a, (list, tuple)):
        return type(a)(_global_meta(x) for x in a)
    return a


def _replicate(a):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(a, DTensor):
        return a.redistribute(a.device_mesh, [Replicate()] * a.device_mesh.ndim)
    if isinstance(a, (list, tuple)):
        return type(a)(_replicate(x) for x in a)
    return a


class DryRunMode(TorchDispatchMode):
    """Counts, per device, the collectives' result bytes by kind and the
    products' operations, and runs an op that DTensor cannot place on
    replicated inputs (see the module docstring).

    A DTensor op is handed to DTensor (``NotImplemented`` on the nested
    call), with this mode active again, so that the local ops and the
    collectives DTensor issues for it come back here on local tensors."""

    def __init__(self):
        super().__init__()
        self.collective_bytes: Counter = Counter()
        self.collective_calls: Counter = Counter()
        self.replicated_ops: Counter = Counter()
        self.matmul_flops = 0
        self._in_dtensor = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation deriving an output's global
            # shape on fake tensors: no part of the step
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented
            self._in_dtensor += 1
            try:
                with self:
                    try:
                        return func(*args, **kwargs)
                    except (RuntimeError, NotImplementedError):
                        # DTensor has no strategy for the op at these
                        # placements, or cannot make the redistribution its
                        # strategy asks for; an error of the op itself
                        # comes back from the replicated run below
                        pass
                    self.replicated_ops[str(func)] += 1
                    if func._schema.is_mutable and args[0].to_local().is_meta:
                        # an in-place write (a decode step's cache column):
                        # each rank writes its own shard where it lies, as
                        # GSPMD partitions a scatter; only the written
                        # values and indices are replicated.  The op runs
                        # on meta tensors of the global shapes, which
                        # checks them
                        func(*_global_meta(args), **{k: _global_meta(v)
                                                      for k, v in kwargs.items()})
                        _replicate((args[1:], tuple(kwargs.values())))
                        return args[0]
                    rargs = _replicate(args)
                    out = func(*rargs, **{k: _replicate(v) for k, v in kwargs.items()})
                    if func._schema.is_mutable:          # write back in the original layout
                        dst = args[0]
                        dst.copy_(rargs[0].redistribute(dst.device_mesh, dst.placements))
                        return dst
                    return out
            finally:
                self._in_dtensor -= 1
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        kind = _COLLECTIVES.get(packet.__name__)
        if kind is not None:
            # a functional collective returns its result; c10d's ops (named
            # with a trailing "_") write it into their first argument
            nb = _nbytes(args[0] if packet.__name__.endswith("_") else out)
            self.collective_bytes[kind] += nb
            self.collective_bytes["total"] += nb
            self.collective_calls[kind] += 1
        elif packet in flop_registry:
            self.matmul_flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        return out


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process being
    ``rank``: collectives are accepted and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized in this process")
    dist.init_process_group("fake", world_size=world_size, rank=rank, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def chunked_mamba1_scan(chunk: int = 64):
    """The plain Mamba1 scan of sequences longer than ``chunk`` computed
    as ``ref.mamba1_scan_chunked`` (the same function, by chunks: about
    S / chunk + 3 chunk Python steps where ``ref.mamba1_scan`` takes S),
    which is what lets an SSM's train and prefill shapes finish on
    DTensors.  Decode steps (S = 1) keep the step-by-step scan."""
    from repro_torch.kernels import ref
    plain = ref.mamba1_scan

    def scan(x, dt, A, B, C, D, h0=None):
        if x.shape[1] > chunk:
            return ref.mamba1_scan_chunked(x, dt, A, B, C, D, h0, chunk=chunk)
        return plain(x, dt, A, B, C, D, h0)

    ref.mamba1_scan = scan
    try:
        yield
    finally:
        ref.mamba1_scan = plain


@contextlib.contextmanager
def propagation():
    """What a step on DTensors runs under: plain tensors that meet a
    DTensor count as replicated (``implicit_replication``), and
    ``DryRunMode`` counts and places the ops.  Yields the mode."""
    from torch.distributed.tensor.experimental import implicit_replication
    mode = DryRunMode()
    with implicit_replication(), mode:
        yield mode


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta, so that ``init_params`` draws
    every leaf as a meta tensor: shapes and types with no storage."""

    @property
    def device(self):
        return torch.device("meta")


def meta_params(cfg: ModelConfig) -> dict:
    return T.init_params(cfg, MetaGenerator())


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    return _nbytes(tree)


def opt_specs(params_tpl, pspecs, mesh):
    """ZeRO-ish optimizer-state sharding: additionally shard the stacked
    layer dim (or first unsharded dim divisible by the data axis) over
    "data"."""
    dsize = S.axis_size(mesh, "data")

    def f(tpl, spec):
        parts = list(spec) + [None] * (tpl.ndim - len(spec))
        for i, (dim, p) in enumerate(zip(tpl.shape, parts)):
            if p is None and dim % dsize == 0 and dim > 0:
                parts[i] = "data"
                break
        return P(*parts)

    return S.zip_map(f, params_tpl, pspecs)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """(global shape, dtype, spec) of every model input of this shape."""
    B, Ssz = shape.global_batch, shape.seq_len
    tok_spec = S.token_specs(cfg, mesh, B)
    frames = cfg.modality == "audio_frames"
    if frames:
        tok = ((B, Ssz, cfg.d_model), torch.bfloat16, tok_spec)
    else:
        tok = ((B, Ssz), torch.int32, tok_spec)
    if shape.kind == "train":
        lbl_spec = P(*tok_spec[:2]) if len(tok_spec) > 1 else tok_spec
        return {"inputs": tok, "labels": ((B, Ssz), torch.int32, lbl_spec)}
    if shape.kind == "prefill":
        return {"inputs": tok}
    # decode: one token per sequence + full cache
    if frames:
        return {"tokens": ((B, 1, cfg.d_model), torch.bfloat16, tok_spec)}
    return {"tokens": ((B, 1), torch.int32, P(tok_spec[0], None))}


def meta_inputs(mesh, ins: dict) -> dict:
    tpl = {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt, _) in ins.items()}
    return S.distribute(tpl, mesh, {k: sp for k, (_, _, sp) in ins.items()}, meta=True)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, remat="full",
               zero_opt: bool = True):
    """Returns (fn, args as meta DTensors)."""
    params_tpl = meta_params(cfg)
    pspecs = S.param_specs(cfg, params_tpl, mesh)
    params = S.distribute(params_tpl, mesh, pspecs, meta=True)
    ins = meta_inputs(mesh, input_specs(cfg, shape, mesh))

    if shape.kind == "train":
        opt_tpl = init_opt_state(params_tpl)
        osp = opt_specs(params_tpl, pspecs, mesh) if zero_opt else pspecs
        opt = S.distribute(opt_tpl, mesh, {"mu": osp, "nu": osp, "step": P()}, meta=True)
        step = make_train_step(cfg, AdamWConfig(),
                               remat="dots" if remat == "dots" else True)
        return step, (params, opt, ins["inputs"], ins["labels"])

    if shape.kind == "prefill":
        def serve_prefill(params, inputs):
            with torch.no_grad():
                logits, cache = T.forward_prefill(cfg, params, inputs, shape.seq_len)
            return logits[:, -1], cache
        return serve_prefill, (params, ins["inputs"])

    # decode
    cache_tpl = T.init_decode_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cspecs_d = S.kv_cache_specs(cfg, mesh, shape.global_batch)
    cache = S.distribute(cache_tpl, mesh, {k: cspecs_d[k] for k in cache_tpl}, meta=True)

    def serve_decode(params, cache, tokens):
        pos = torch.full((shape.global_batch,), shape.seq_len - 1, dtype=torch.int32,
                         device="meta")
        with torch.no_grad():
            return T.forward_decode(cfg, params, cache, tokens, pos)
    return serve_decode, (params, cache, ins["tokens"])


def _mesh_for(multi_pod: bool, mesh_shape: str):
    if mesh_shape:
        # alternative factorization of the same rank count, e.g. "32,8"
        from torch.distributed.device_mesh import init_device_mesh
        dims = tuple(int(x) for x in mesh_shape.split(","))
        axes = ("pod", "data", "model")[-len(dims):]
        return init_device_mesh("cpu", dims, mesh_dim_names=axes), axes[:-1]
    mesh = make_production_mesh("cpu", multi_pod=multi_pod)
    return mesh, (("pod", "data") if multi_pod else ("data",))


def _write(rec: dict, outdir: str, tag_suffix: str) -> None:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh'].replace('x', '_')}" + tag_suffix
        with open(os.path.join(outdir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)


def run_step(fn, args, ctx: DistContext) -> dict:
    """Run ``fn(*args)`` on its DTensors under ``ctx`` and ``propagation``:
    the record's measured keys."""
    with distribution(ctx), chunked_mamba1_scan(), propagation() as mode:
        out = fn(*args)
    return {"argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(out),
            "collective_bytes": dict(mode.collective_bytes),
            "collective_calls": dict(mode.collective_calls),
            "matmul_flops": mode.matmul_flops,
            "replicated_ops": dict(mode.replicated_ops)}


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            moe_impl: str = "gspmd", tag_suffix: str = "",
            pad_heads: int = 0, mesh_shape: str = "",
            kv_dtype: str = "", remat: str = "full",
            zero_opt: bool = True, rank: int = 0, smoke: bool = False) -> dict:
    """One combo on a fake world of the mesh's size, at ``rank``.
    ``smoke`` takes the arch's smoke config (the tests' small meshes)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch, smoke=smoke)
    skip = shape_skips(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_shape.replace(",", "x") if mesh_shape
           else ("2x16x16" if multi_pod else "16x16")}
    if moe_impl != "gspmd":
        rec["moe_impl"] = moe_impl
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        _write(rec, outdir, tag_suffix)
        return rec
    cfg = variant_for_shape(cfg, shape)
    rec["attn_variant"] = cfg.attn_variant
    if kv_dtype:
        cfg = cfg.replace(kv_cache_dtype=kv_dtype)
        rec["kv_cache_dtype"] = kv_dtype
    if remat != "full":
        rec["remat"] = remat
    if pad_heads:
        # physical head padding: round q/kv head counts up to a multiple of
        # the model-axis size so heads shard evenly (padded heads have zero
        # output rows: a layout change, not a model change)
        up = lambda n: -(-n // pad_heads) * pad_heads  # noqa: E731
        rec["padded_heads"] = [up(cfg.num_heads), up(cfg.num_kv_heads)]
        cfg = cfg.replace(num_heads=up(cfg.num_heads), num_kv_heads=up(cfg.num_kv_heads))
    t0 = time.time()
    try:
        world = (math.prod(int(x) for x in mesh_shape.split(",")) if mesh_shape
                 else 512 if multi_pod else 256)
        with fake_world(world, rank):
            mesh, dp = _mesh_for(multi_pod, mesh_shape)
            ctx = DistContext(mesh=mesh, data_axes=dp, moe_impl=moe_impl)
            fn, args = build_step(cfg, shape, mesh, remat=remat, zero_opt=zero_opt)
            rec.update(run_step(fn, args, ctx))
        rec["run_s"] = round(time.time() - t0, 2)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    _write(rec, outdir, tag_suffix)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--moe", default="gspmd", choices=["gspmd", "ep"])
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="round head counts up to this multiple")
    ap.add_argument("--mesh-shape", default="",
                    help="override mesh factorization, e.g. 32,8")
    ap.add_argument("--kv-dtype", default="", choices=["", "int8"])
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--no-zero", action="store_true",
                    help="disable ZeRO optimizer-state sharding")
    ap.add_argument("--rank", type=int, default=0, help="the fake rank this process plays")
    args = ap.parse_args(argv)
    combos = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))
    for a, s in combos:
        rec = run_one(a, s, args.multi_pod, args.out, moe_impl=args.moe,
                      tag_suffix=args.tag, pad_heads=args.pad_heads,
                      mesh_shape=args.mesh_shape, kv_dtype=args.kv_dtype,
                      remat=args.remat, zero_opt=not args.no_zero, rank=args.rank)
        brief = {k: v for k, v in rec.items() if k != "traceback"}
        print(json.dumps(brief), flush=True)


if __name__ == "__main__":
    main()
