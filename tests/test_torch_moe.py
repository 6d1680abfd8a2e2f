"""The port's MoE slice against the JAX package, with the same weights
(carried across by params_from_numpy) and the same numpy inputs:

  - ``moe_forward`` at the two smoke MoE configs (Qwen3-30B-A3B's and
    Mixtral-8x7B's), lossless and with capacity drops (a router biased
    so that one expert overflows), in f32 and bf16, with equal aux loss;
  - ``capacity`` over a grid of token counts, and top-k's tie order;
  - ``forward_full``, ``forward_prefill`` and ``forward_decode`` for a
    dense model and both MoE configs (Mixtral's with a sliding window
    shorter than the prompt, so its decode cache is a ring), and
    ``forward_full`` for the SSM and hybrid smoke configs too;
  - ``PagedRunner`` prefill chunks and batched decode steps, and greedy
    ``AREngine`` token streams, for both MoE configs.

Tolerances: f32 2e-5, bf16 2e-2 of the values' scale (rtol = atol).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.engine import ar_engine as jar
from repro.engine import runner as jrun
from repro.engine.kv_cache import PagedKVConfig as JKV
from repro.engine.sampling import SamplingParams as JSP
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.configs.pipelines import tiny_lm
from repro_torch.convert import params_from_numpy
from repro_torch.engine import ar_engine as tar
from repro_torch.engine import runner as trun
from repro_torch.engine.kv_cache import PagedKVConfig as TKV
from repro_torch.engine.sampling import SamplingParams as TSP
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT

torch.set_num_threads(1)

MOE_ARCHS = ("qwen3_moe_30b_a3b", "mixtral_8x7b")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs(arch, dtype="float32", **kw):
    """The port's smoke config and the JAX package's, field for field."""
    cfg = tbase.get_config(arch, smoke=True).replace(dtype=dtype, **kw)
    return cfg, jbase.ModelConfig(**dataclasses.asdict(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    g, w = _np(got), _np(want)
    tol = TOL[dtype]
    if dtype == "bfloat16":                 # of the values' scale
        tol *= max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _moe_params(jcfg, seed, bias_expert=None):
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    if bias_expert is not None:             # nearly every token's choice: one expert
        jp = dict(jp)
        jp["router"] = jp["router"].at[:, bias_expert].add(0.02)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(jcfg, shape, seed, bias=0.0):
    x = np.random.default_rng(seed).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    return x + bias


# ---------------------------------------------------------------------------
# moe_forward, capacity, top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drops", [False, True], ids=["lossless", "drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, dtype, drops, monkeypatch):
    cf = 1.25 if drops else 1e9
    cfg, jcfg = _cfgs(arch, dtype, capacity_factor=cf)
    # drops: the router's column 0 is raised, and the inputs carry a
    # positive mean, so that nearly every token picks expert 0 and it
    # overflows (mildly: saturated gates would tie the other experts at
    # zero, where XLA flushes denormals and PyTorch does not)
    jp, tp = _moe_params(jcfg, seed=1, bias_expert=0 if drops else None)
    x = _x(jcfg, (3, 24), seed=2, bias=0.5 if drops else 0.0)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jaux = jmoe.moe_forward(jcfg, jp, jx)
    counter = torch.zeros((), dtype=torch.long)
    monkeypatch.setattr(tmoe, "drop_counter", counter)
    ty, taux = tmoe.moe_forward(cfg, tp, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-5, atol=2e-5)
    # the drop case drops: its capacity is below expert 0's count; the
    # counter holds the pairs past each expert's capacity in JAX's routing
    topi = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jx.reshape(-1, cfg.d_model).astype(jnp.float32) @ jp["router"]),
        cfg.experts_per_token)[1])
    c = tmoe.capacity(72, cfg)
    counts = np.bincount(topi.reshape(-1), minlength=cfg.num_experts)
    assert (counts[0] > c) == drops
    assert int(counter) == int(np.maximum(counts - c, 0).sum())


@pytest.mark.parametrize("tokens", [1, 2, 7, 8, 9, 31, 64, 100, 257, 512, 4096])
@pytest.mark.parametrize("arch", MOE_ARCHS + ("qwen3_moe_30b_a3b:full",))
def test_capacity_matches_jax(arch, tokens):
    name, _, full = arch.partition(":")
    cfg = tbase.get_config(name, smoke=not full)
    jcfg = jbase.get_config(name, smoke=not full)
    assert tmoe.capacity(tokens, cfg) == jmoe.capacity(tokens, jcfg)


def test_top_k_ties_go_to_the_lower_index_as_in_jax():
    gates = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), 2)
    tv, ti = tmoe.top_k(torch.from_numpy(gates), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2], [0, 1], [0, 2]]


def test_moe_forward_on_tied_experts_matches_jax():
    """Two experts with equal router columns tie for every token: the
    lower one must win in both packages (the other is the second pick)."""
    cfg, jcfg = _cfgs("mixtral_8x7b", capacity_factor=1.25)
    jp = dict(jmoe.init_moe(jcfg, jax.random.PRNGKey(4)))
    jp["router"] = jp["router"].at[:, 3].set(jp["router"][:, 1])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = _x(jcfg, (2, 16), seed=5)
    jy, jaux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.moe_forward(cfg, tp, torch.from_numpy(x))
    _close(ty, jy, "float32")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# forward_full / forward_prefill / forward_decode
# ---------------------------------------------------------------------------

def _model(kind, dtype="float32", seed=3):
    if kind == "dense":
        cfg = tiny_lm("t", vocab=256).replace(dtype=dtype)
        jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    elif kind == "dense-swa":
        cfg = tiny_lm("t", vocab=256).replace(dtype=dtype, attn_variant="swa",
                                              sliding_window=16)
        jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    else:
        cfg, jcfg = _cfgs(kind, dtype)
        if kind == "mixtral_8x7b":              # a window shorter than the prompt
            cfg, jcfg = cfg.replace(sliding_window=16), jcfg.replace(sliding_window=16)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


MODELS = ("dense", "dense-swa") + MOE_ARCHS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", MODELS + ("falcon_mamba_7b", "zamba2_2_7b"))
def test_forward_full_matches_jax(kind, dtype):
    cfg, jcfg, jp, tp = _model(kind, dtype)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    jl, jaux = jT.forward_full(jcfg, jp, jnp.asarray(toks), remat=False)
    tl, taux = tT.forward_full(cfg, tp, torch.from_numpy(toks).long())
    assert tl.dtype == getattr(torch, dtype)
    _close(tl, jl, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-5, atol=2e-5)
    assert (float(taux) > 0) == cfg.is_moe


@pytest.mark.parametrize("kind", MODELS)
def test_forward_prefill_and_decode_match_jax(kind):
    """A 21-token prefill (past the SWA window of 16: the cache is a
    ring) into a 64-column cache, then 6 decode steps of two rows; both
    packages are fed the tokens the JAX logits pick."""
    cfg, jcfg, jp, tp = _model(kind)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    jl, jc = jT.forward_prefill(jcfg, jp, jnp.asarray(toks), 64, remat=False)
    tl, tc = tT.forward_prefill(cfg, tp, torch.from_numpy(toks).long(), 64)
    _close(tl, jl, "float32")
    assert set(tc) == set(jc)
    for name in jc:
        _close(tc[name], jc[name], "float32")
    pos = 21
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = jT.forward_decode(jcfg, jp, jc, jnp.asarray(nxt), jnp.array([pos]))
        tl, tc = tT.forward_decode(cfg, tp, tc, torch.from_numpy(nxt).long(),
                                   torch.tensor([pos]))
        _close(tl, jl, "float32")
        pos += 1
    for name in jc:
        _close(tc[name], jc[name], "float32")


def test_init_decode_cache_matches_jax_layout():
    for kind in MODELS:
        cfg, jcfg, _, _ = _model(kind)
        jc = jT.init_decode_cache(jcfg, 3, 64)
        tc = tT.init_decode_cache(cfg, 3, 64)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}


def test_moe_blocks_init_with_the_jax_layout():
    cfg, jcfg = _cfgs("qwen3_moe_30b_a3b")
    tp = tT.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name), jp)
    got = tp["blocks"]
    for k in ("router", "wg", "wu", "wd"):
        assert (tuple(got["moe"][k].shape), str(got["moe"][k].dtype).split(".")[1]) \
            == shapes["blocks"]["moe"][k]
    assert "mlp" not in got and got["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# PagedRunner and AREngine
# ---------------------------------------------------------------------------

KV = dict(num_pages=40, page_size=8, max_pages_per_seq=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_paged_runner_moe_matches_jax(arch, dtype):
    """Chunks of 16 with padding (the padded rows are routed too, and
    with C = 10 of 16 rows an expert can overflow), then 6 batched decode
    steps with an inactive third slot."""
    cfg, jcfg, jp, tp = _model(arch, dtype)
    if dtype == "bfloat16":
        # bf16 decode rounds the router's input in both packages, a last
        # ulp apart, and that flips a choice between two near-tied experts
        # (a jump in the logits no tolerance holds; seen at a gap of 0.2%):
        # a router four times as sharp keeps the choices apart
        jp = jax.tree.map(lambda a: a, jp)
        jp["blocks"]["moe"]["router"] = jp["blocks"]["moe"]["router"] * 4.0
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jr, tr = jrun.PagedRunner(jcfg, jp, JKV(**KV)), trun.PagedRunner(cfg, tp, TKV(**KV))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (13, 21)]
    tables = np.array([np.arange(8), np.arange(8, 16), np.zeros(8)], np.int32)
    chunk, last = 16, []
    for s, p in enumerate(prompts):
        emb = jr.embed(p)
        for c0 in range(0, len(p), chunk):
            n = min(chunk, len(p) - c0)
            e = np.pad(emb[c0:c0 + n], ((0, chunk - n), (0, 0)))
            jl, jh = jr.prefill_chunk(jnp.asarray(e)[None], tables[s], c0, n)
            tl, th = tr.prefill_chunk(torch.from_numpy(e)[None], tables[s], c0, n)
            _close(tl[:n], jl[:n], dtype)
            _close(th[:n], jh[:n], dtype)
        last.append(int(jnp.argmax(jl[n - 1])))
    positions = np.array([len(p) for p in prompts] + [0], np.int32)
    active = np.array([True, True, False])
    toks = last + [0]
    for _ in range(6):
        emb = np.stack([jr.embed(np.array([t], np.int32))[0] for t in toks])[:, None]
        jl, _ = jr.decode(jnp.asarray(emb, jnp.dtype(dtype)), tables, positions, active)
        tl, _ = tr.decode(torch.from_numpy(emb).to(getattr(torch, dtype)), tables,
                          positions, active)
        _close(tl[:2], jl[:2], dtype)
        toks = [int(t) for t in np.asarray(jnp.argmax(jl, -1))]
        positions = positions + active


def _run_engine(mod, sp_cls, cfg, params, prompts, n_new, **kw):
    kv_cls = JKV if mod is jar else TKV
    eng = mod.AREngine("eng", cfg, params,
                       kv=kv_cls(num_pages=64, page_size=8, max_pages_per_seq=16),
                       max_batch=4, token_budget=64, chunk_size=16,
                       default_sampling=sp_cls(max_new_tokens=n_new, temperature=0.0), **kw)
    out = {}
    for i, p in enumerate(prompts):
        eng.enqueue(i, {"tokens": p}, sp_cls(), {})
    for _ in range(1000):
        for ev in eng.step():
            if ev.kind == "finished":
                out[ev.req_id] = [int(t) for t in ev.payload["tokens"]]
        if not eng.has_work:
            break
    return out


@pytest.mark.parametrize("kw", [dict(), dict(enable_prefix_cache=True)],
                         ids=["no-cache", "radix"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_moe_greedy_tokens_match_jax(arch, kw):
    cfg, jcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=n)
                               .astype(np.int32)]) for n in (3, 11, 0, 26)]
    want = _run_engine(jar, JSP, jcfg, jp, prompts, 10, **kw)
    got = _run_engine(tar, TSP, cfg, tp, prompts, 10, **kw)
    assert got == want and len(got) == len(prompts)


def test_serve_cli_moe_arch_on_cpu(tmp_path):
    """--arch qwen3_moe_30b_a3b serves the smoke config as a one-stage AR
    graph (the CLI's own path, on the CPU)."""
    import argparse

    from repro_torch.launch.serve import build_single_arch
    graph, engines, bundle = build_single_arch("qwen3_moe_30b_a3b", 2, 4, 0, device="cpu")
    eng = engines["qwen3_moe_30b_a3b"]
    assert bundle["cfg"].is_moe and "moe" in bundle["params"]["blocks"]
    from repro_torch.core.config import ServeConfig
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.request import Request
    orch = Orchestrator(graph, engines, config=ServeConfig.from_args(
        argparse.Namespace(backend="threaded"),
        engine_factories=bundle["engine_factories"]))
    orch.start()
    reqs = [Request(inputs={"tokens": np.arange(n, dtype=np.int32)}) for n in (5, 9)]
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=60.0)
    assert all(not r.failed and len(r.outputs["qwen3_moe_30b_a3b"][0]["tokens"]) == 4
               for r in reqs)
    assert eng.device.type == "cpu"
