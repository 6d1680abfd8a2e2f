"""The port's dry-run (``repro_torch/launch/dryrun.py``): steps on meta
DTensors under a fake process group.

  - ``run_one`` on a fake (2, 4) mesh at smoke configs records
    ``status: "ok"`` for a dense arch at train, prefill and decode, the MoE
    at train with ``gspmd`` and ``ep``, the SSM at decode, the hybrid at
    train, prefill (the chunked Mamba2 scan) and decode, and HuBERT at
    train (its decode is skipped);
  - ``argument_size_in_bytes`` equals, exactly, the local shard bytes that
    the JAX dry-run's fitted specs give on its ``eval_shape`` shapes
    (``repro.launch.dryrun`` imported in a subprocess: it forces 512 host
    devices);
  - an expert-parallel prefill's all-reduce bytes are those of the code:
    per MoE layer y (T_loc x d x 4 bytes: the partial sums cross in f32),
    the expert counts (E x 4) and the aux's mean over the data axis (4);
    per layer the partial sums of attention's row-sharded products (f32);
    and the embedding's rows, looked up where the table's vocabulary
    shard lies and summed over "model" (T_loc x d x 2, bf16);
  - the same train step on REAL DTensors on four ``gloo`` ranks of the CPU
    (f32, a (2, 2) mesh, ZeRO moments) gives the JAX package's unsharded
    ``make_train_step``: loss and grad norm within 2e-5 (f32, sums in
    other orders), every updated parameter and first moment within 2e-5
    (the train-parity test's tolerance);
  - one full config on the meta 16x16 mesh; the CLI's JSON.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_moe_ep import spawn_ranks

from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
         "total"}


def _smoke(arch, shape, moe="gspmd"):
    return D.run_one(arch, shape, False, "", moe_impl=moe, mesh_shape="2,4", smoke=True)


@pytest.mark.parametrize("arch,shape,moe", [
    ("qwen2_5_14b", "train_4k", "gspmd"), ("qwen2_5_14b", "prefill_32k", "gspmd"),
    ("qwen2_5_14b", "decode_32k", "gspmd"), ("qwen3_moe_30b_a3b", "train_4k", "gspmd"),
    ("qwen3_moe_30b_a3b", "train_4k", "ep"), ("falcon_mamba_7b", "decode_32k", "gspmd"),
    ("zamba2_2_7b", "decode_32k", "gspmd"), ("zamba2_2_7b", "train_4k", "gspmd"),
    ("zamba2_2_7b", "prefill_32k", "gspmd"), ("hubert_xlarge", "train_4k", "gspmd")])
def test_run_one_steps_on_a_fake_mesh(arch, shape, moe):
    rec = _smoke(arch, shape, moe)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "2x4" and rec["argument_size_in_bytes"] > 0
    assert rec["output_size_in_bytes"] > 0 and rec["matmul_flops"] > 0
    assert set(rec["collective_bytes"]) <= KINDS and rec["collective_bytes"]["total"] > 0
    assert ("moe_impl" in rec) == (moe == "ep")


def test_run_one_skips_an_encoder_decode():
    rec = _smoke("hubert_xlarge", "decode_32k")
    assert rec["status"] == "skipped" and "encoder" in rec["reason"]


_JAX_ARG_BYTES = r"""
import json, sys
import jax
import numpy as np
from repro.configs.base import INPUT_SHAPES, get_config
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
out = {}
for combo in sys.argv[1].split(","):
    arch, shape, *pod = combo.split(":")
    cfg = get_config(arch, smoke=not pod)
    fn, args = D.build_step(cfg, INPUT_SHAPES[shape],
                            make_production_mesh(multi_pod=True) if pod else mesh)
    out[combo] = sum(int(np.prod(a.sharding.shard_shape(a.shape))) * a.dtype.itemsize
                     for a in jax.tree.leaves(args))
print("BYTES" + json.dumps(out))
"""

#: smoke configs on a (2, 4) mesh, and (":pod") one full config on the
#: 2x16x16 mesh of 512 ranks
_BYTE_COMBOS = ("qwen2_5_14b:train_4k", "qwen3_moe_30b_a3b:decode_32k",
                "falcon_mamba_7b:decode_32k", "zamba2_2_7b:prefill_32k",
                "hubert_xlarge:train_4k", "internlm2_1_8b:long_500k",
                "qwen2_5_14b:decode_32k:pod")


def _jax_subprocess(script, combos, tag):
    """Run ``script`` (the JAX package, imported in a subprocess: its
    dry-run module forces 512 host devices) on ``combos``; its JSON line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, ",".join(combos)],
                       env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith(tag)]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][len(tag):])


@pytest.fixture(scope="module")
def jax_arg_bytes():
    return _jax_subprocess(_JAX_ARG_BYTES, _BYTE_COMBOS, "BYTES")


@pytest.mark.parametrize("combo", _BYTE_COMBOS)
def test_argument_bytes_equal_the_jax_fitted_specs(combo, jax_arg_bytes):
    arch, shape, *pod = combo.split(":")
    if pod:
        rec = D.run_one(arch, shape, True, "")
        assert rec["status"] == "ok" and rec["mesh"] == "2x16x16", rec.get("traceback")
        assert rec["argument_size_in_bytes"] == jax_arg_bytes[combo]
        return
    from repro_torch.configs.base import INPUT_SHAPES
    with D.fake_world(8):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        _, args = D.build_step(get_config(arch, smoke=True), INPUT_SHAPES[shape], mesh)
        assert D.local_bytes(args) == jax_arg_bytes[combo]


# The JAX dry-run's collective count: ``collective_bytes`` of the
# partitioned HLO that XLA compiles for a (2, 4) mesh.  Its axes are of
# type Auto (GSPMD propagates the fitted specs), as ``jax.make_mesh`` made
# them before jax 0.7; under the Explicit axes it makes now, the smoke
# configs' embedding gather does not trace.
_JAX_COLLECTIVES = r"""
import json, sys
import jax
from repro.configs.base import INPUT_SHAPES, get_config, variant_for_shape
from repro.launch import dryrun as D
from repro.sharding.context import DistContext, distribution
mesh = jax.make_mesh((2, 4), ("data", "model"), (jax.sharding.AxisType.Auto,) * 2,
                     devices=jax.devices()[:8])
out = {}
for combo in sys.argv[1].split(","):
    arch, shape = combo.split(":")
    cfg = variant_for_shape(get_config(arch, smoke=True), INPUT_SHAPES[shape])
    fn, args = D.build_step(cfg, INPUT_SHAPES[shape], mesh)
    with distribution(DistContext(mesh=mesh, data_axes=("data",))), mesh:
        out[combo] = D.collective_bytes(jax.jit(fn).lower(*args).compile().as_text())
print("COLL" + json.dumps(out))
"""

_COLL_COMBOS = ("qwen2_5_14b:train_4k", "qwen2_5_14b:prefill_32k",
                "internlm2_1_8b:prefill_32k", "qwen3_moe_30b_a3b:decode_32k",
                "falcon_mamba_7b:decode_32k")
#: the port's collective bytes a device over XLA's, on the smoke combos
#: (measured 0.60-1.36 with torch 2.13; the JAX side moves bf16 data in
#: f32 on the CPU, the port in bf16 where no partial sum is combined)
COLLECTIVE_BAND = (0.5, 1.5)
#: held differences (ROADMAP.md), each with its own measured band: the
#: MoE's dense dispatch at decode, where XLA all-gathers the f32 updates
#: of its scatter into the (E, C, d) expert buffer and the port gathers
#: the bf16 token rows once before it (0.37 with torch 2.13)
HELD_BANDS = {"qwen3_moe_30b_a3b:decode_32k": (0.3, 0.5)}


@pytest.fixture(scope="module")
def jax_collectives():
    return _jax_subprocess(_JAX_COLLECTIVES, _COLL_COMBOS, "COLL")


@pytest.mark.parametrize("combo", _COLL_COMBOS)
def test_collective_bytes_lie_in_a_band_of_xlas(combo, jax_collectives):
    """No op ran on replicated inputs, and the port's total collective
    bytes a device lie within ``COLLECTIVE_BAND`` of the JAX dry-run's
    (or within the combo's held band)."""
    arch, shape = combo.split(":")
    rec = _smoke(arch, shape)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["replicated_ops"] == {}
    lo, hi = HELD_BANDS.get(combo, COLLECTIVE_BAND)
    ratio = rec["collective_bytes"]["total"] / jax_collectives[combo]["total"]
    assert lo <= ratio <= hi, (ratio, rec["collective_bytes"], jax_collectives[combo])


def test_ep_prefill_all_reduce_bytes_are_the_codes():
    cfg = get_config("qwen3_moe_30b_a3b", smoke=True)
    rec = _smoke("qwen3_moe_30b_a3b", "prefill_32k", "ep")
    assert rec["status"] == "ok", rec.get("traceback")
    t_loc = 32 // 2 * 32768                       # B 32 over data 2, S 32768
    ep = t_loc * cfg.d_model * 4 + cfg.num_experts * 4 + 4
    # attention's row-sharded products, summed in f32: the output
    # projection, and K and V (2 KV heads do not divide "model" 4, so wk
    # and wv are sharded on d_model)
    attn = t_loc * (cfg.d_model + 2 * cfg.num_kv_heads * cfg.head_dim) * 4
    embed = t_loc * cfg.d_model * 2               # the lookup's rows, summed in bf16
    assert (rec["collective_bytes"]["all-reduce"]
            == cfg.num_layers * (ep + attn) + embed)
    assert rec["collective_calls"]["all-reduce"] == cfg.num_layers * 6 + 1


def test_full_config_on_the_production_mesh():
    rec = D.run_one("qwen2_5_14b", "decode_32k", False, "")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16"
    # 14.77 B bf16 parameters over 16 model ranks, plus the cache's shard
    assert rec["argument_size_in_bytes"] > 14.7e9 * 2 / 16


def test_cli_writes_its_json(tmp_path, capsys):
    D.main(["--arch", "internlm2_1_8b", "--shape", "decode_32k", "--mesh-shape", "2,4",
            "--moe", "ep", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "internlm2_1_8b__decode_32k__2_4.json").read_text())
    assert rec["status"] == "ok"
    assert {"arch", "shape", "mesh", "moe_impl", "attn_variant", "argument_size_in_bytes",
            "output_size_in_bytes", "collective_bytes", "matmul_flops", "run_s"} <= set(rec)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "traceback" not in printed and printed["status"] == "ok"


# ---------------------------------------------------------------------------
# the train step on real DTensors, four gloo ranks, against JAX
# ---------------------------------------------------------------------------

ARCH = "qwen2_5_14b"
OPT = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _train_rank(rank, world, data_path, out_path):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import specs as S
    from repro_torch.sharding.context import DistContext, distribution
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    d = np.load(data_path)
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    params = _unflatten({k[2:]: torch.from_numpy(d[k]) for k in d.files if k.startswith("p/")})
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pspecs = S.param_specs(cfg, params, mesh)
    dparams = S.distribute(params, mesh, pspecs)
    state = opt.init_opt_state(params)
    osp = D.opt_specs(params, pspecs, mesh)
    dstate = S.distribute(state, mesh, {"mu": osp, "nu": osp, "step": S.P()})
    tok = S.token_specs(cfg, mesh, d["inputs"].shape[0])
    ins = S.distribute({"inputs": torch.from_numpy(d["inputs"]),
                        "labels": torch.from_numpy(d["labels"])}, mesh,
                       {"inputs": tok, "labels": tok})
    step = make_train_step(cfg, opt.AdamWConfig(**OPT))
    with distribution(DistContext(mesh=mesh)), D.propagation() as mode:
        dparams, dstate, metrics = step(dparams, dstate, ins["inputs"], ins["labels"])
    assert mode.collective_bytes["total"] > 0
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    out = {f"p/{k}": full(v).detach().numpy() for k, v in _flatten(dparams).items()}
    out.update({f"mu/{k}": full(v).numpy() for k, v in _flatten(dstate["mu"]).items()})
    out["loss"] = full(metrics["loss"]).numpy()
    out["grad_norm"] = full(metrics["grad_norm"]).numpy()
    if rank == 0:
        np.savez(out_path, **out)


def test_train_step_on_real_dtensors_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.models import transformer as jT
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    from repro_torch.train.data import TokenStream
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(0))
    b = next(TokenStream(cfg, 4, 16, seed=0))
    jp, js, jm = jax.jit(jstep.make_train_step(jcfg, jopt.AdamWConfig(**OPT)))(
        jparams, jopt.init_opt_state(jparams), jnp.asarray(b["inputs"]),
        jnp.asarray(b["labels"]))
    flat = {f"p/{k}": np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray,
                                                                       jparams)).items()}
    data_path, out_path = str(tmp_path / "data.npz"), str(tmp_path / "out.npz")
    np.savez(data_path, inputs=b["inputs"], labels=b["labels"], **flat)
    spawn_ranks(_train_rank, 4, tmp_path, data_path, out_path)
    got = np.load(out_path)
    np.testing.assert_allclose(got["loss"], np.asarray(jm["loss"]), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["grad_norm"], np.asarray(jm["grad_norm"]), rtol=2e-5,
                               atol=2e-5)
    for prefix, tree in (("p", jp), ("mu", js["mu"])):
        for k, v in _flatten(jax.tree.map(np.asarray, tree)).items():
            np.testing.assert_allclose(got[f"{prefix}/{k}"], v, rtol=2e-5, atol=2e-5,
                                       err_msg=f"{prefix}/{k}")
