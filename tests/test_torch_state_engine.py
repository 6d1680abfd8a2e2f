"""The port's SSM and hybrid serving path against the JAX package's, with
the same weights (carried across by params_from_numpy) and the same
inputs: ``forward_prefill``/``forward_decode``, the ring cache of a
sliding-window hybrid, ``StateRunner`` and ``AREngine``, and the
single-arch builder served through the Orchestrator.

Tolerances: f32 logits and caches at 1e-4 (the scans and the einsums sum
in other orders over up to 24 steps); a bf16 model at 2e-2 of the
logits' scale and decode over an int8 KV cache at 1e-2 of it, as
tests/test_torch_engine.py holds those runs (a last-ulp difference can
flip a bf16 or int8 rounding).  Engines must produce identical greedy
tokens in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.orchestrator import Orchestrator as JOrch
from repro.core.request import Request as JReq
from repro.engine import ar_engine as jar
from repro.engine.kv_cache import PagedKVConfig as JKV
from repro.engine.sampling import SamplingParams as JSP
from repro.launch.serve import build_single_arch as jbuild
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.core.request import Request as TReq
from repro_torch.engine import ar_engine as tar
from repro_torch.engine import runner as trun
from repro_torch.engine.kv_cache import PagedKVConfig as TKV
from repro_torch.engine.sampling import SamplingParams as TSP
from repro_torch.launch.serve import build_single_arch as tbuild
from repro_torch.models import transformer as tT

torch.set_num_threads(1)

ARCHS = ["falcon_mamba_7b", "zamba2_2_7b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arch, dtype="float32", seed=0, **kw):
    cfg = tbase.get_config(arch, smoke=True).replace(dtype=dtype, **kw)
    jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    jp = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _close(got, want, dtype="float32", kv=""):
    g, w = _np(got), _np(want)
    if dtype == "bfloat16" or kv == "int8":
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=(2e-2 if kv == "" else 1e-2) * scale)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,dtype,kv", [
    ("falcon_mamba_7b", "float32", ""), ("zamba2_2_7b", "float32", ""),
    ("zamba2_2_7b", "float32", "int8"), ("falcon_mamba_7b", "bfloat16", ""),
    ("zamba2_2_7b", "bfloat16", "")])
def test_prefill_and_decode_logits_and_caches_match_jax(arch, dtype, kv):
    cfg, jcfg, jp, tp = _pair(arch, dtype, kv_cache_dtype=kv)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    max_seq = 24
    jl, jc = jax.jit(lambda t: jT.forward_prefill(jcfg, jp, t, max_seq, remat=False))(
        jnp.asarray(toks[:, :10]))
    tl, tc = tT.forward_prefill(cfg, tp, torch.from_numpy(toks[:, :10]).long(), max_seq)
    _close(tl, jl, dtype)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name], dtype)
    # four decode steps from the prefilled cache, in the cache's own dtype
    tcache = tT.init_decode_cache(cfg, 2, max_seq)
    for name in tcache:
        tcache[name].copy_(tc[name])
    jcache = jax.tree.map(lambda c, t: c.astype(t.dtype), jc,
                          jT.init_decode_cache(jcfg, 2, max_seq))
    jdec = jax.jit(lambda c, t, p: jT.forward_decode(jcfg, jp, c, t, p))
    for i in range(10, 14):
        pos = np.full((2,), i, np.int32)
        jl, jcache = jdec(jcache, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        tl, tcache = tT.forward_decode(cfg, tp, tcache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                       torch.from_numpy(pos))
        _close(tl, jl, dtype, kv)
    for name in jcache:
        assert tcache[name].dtype == getattr(torch, str(jcache[name].dtype)), name
        if kv == "int8" and name in ("k", "v"):     # codes agree but for rare rounding flips
            flips = np.abs(_np(tcache[name]) - _np(jcache[name]))
            assert flips.max() <= 1 and (flips > 0).mean() < 1e-3
        else:
            _close(tcache[name], jcache[name], dtype, kv)


@pytest.mark.parametrize("prompt_len", [5, 12])
def test_sliding_window_hybrid_decode_equals_prefill_of_longer_prompt(prompt_len):
    """With a window of 8 columns the hybrid's KV caches are rings (the
    port's counterpart of test_ring_cache.py, without forward_full): the
    decode logits at step i equal the last prefill logits of the prompt
    extended by i tokens."""
    cfg, _, _, tp = _pair("zamba2_2_7b", attn_variant="swa", sliding_window=8)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, prompt_len + 6)).astype(np.int64))
    max_seq = 32
    logits, c1 = tT.forward_prefill(cfg, tp, toks[:, :prompt_len], max_seq)
    assert c1["k"].shape[2] == 8
    cache = tT.init_decode_cache(cfg, 1, max_seq)
    for name in cache:
        cache[name].copy_(c1[name])
    for i in range(6):
        pos = prompt_len + i
        lo, cache = tT.forward_decode(cfg, tp, cache, toks[:, pos:pos + 1], torch.tensor([pos]))
        want, _ = tT.forward_prefill(cfg, tp, toks[:, :pos + 1], max_seq)
        np.testing.assert_allclose(_np(lo[:, 0]), _np(want[:, -1]), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_runner_prefill_decode_and_inactive_slots_match_jax(arch):
    """Prefill into slots 2 and 0, then batched decode with slot 1
    inactive: logits match the JAX runner's, slot 1's state and KV stay
    untouched (zeros), and the active slots' state matches."""
    from repro.engine import runner as jrun
    cfg, jcfg, jp, tp = _pair(arch)
    kvc = dict(num_pages=16, page_size=8, max_pages_per_seq=4)
    jr = jrun.StateRunner(jcfg, jp, JKV(**kvc), 3)
    tr = trun.StateRunner(cfg, tp, TKV(**kvc), 3)
    rng = np.random.default_rng(3)
    toks = {}
    for slot, n in ((2, 11), (0, 7)):
        p = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        emb = jr.embed(p)
        np.testing.assert_array_equal(trun.embed(tr.params, p), emb)
        jl, _ = jr.prefill(jnp.asarray(emb)[None], slot)
        tl, th = tr.prefill(torch.from_numpy(emb)[None], slot)
        assert th is None and tl.shape == (n, cfg.vocab_size)
        _close(tl, jl)
        toks[slot] = (int(jnp.argmax(jl[-1])), n)
    active = np.array([True, False, True])
    positions = np.array([toks[0][1], 0, toks[2][1]], np.int32)
    last = [toks[0][0], 0, toks[2][0]]
    for _ in range(3):
        emb = np.stack([jr.embed(np.array([t], np.int32))[0] for t in last])[:, None]
        jl, _ = jr.decode(jnp.asarray(emb), None, positions, active)
        tl, _ = tr.decode(torch.from_numpy(emb), None, positions, active)
        _close(tl[active], jl[active])
        last = [int(t) for t in np.asarray(jnp.argmax(jl, -1))]
        positions = positions + active
    for name, c in tr.cache.items():
        assert float(c[:, 1].abs().sum()) == 0.0, name
        _close(c[:, [0, 2]], jr.cache[name][:, np.array([0, 2])])


def _run_engine(mod, sp_cls, cfg, params, prompts, n_new, **kw):
    kv_cls = JKV if mod is jar else TKV
    eng = mod.AREngine("eng", cfg, params, kv=kv_cls(num_pages=64, page_size=8,
                                                     max_pages_per_seq=8),
                       max_batch=4, chunk_size=16,
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
    return out, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(arch):
    """Six requests on four slots: batched decode, inactive slots once the
    first four finish, and slot reuse by the last two."""
    cfg, jcfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 3, 14, 6, 11, 5)]
    want, _ = _run_engine(jar, JSP, jcfg, jp, prompts, 6, token_budget=64)
    got, teng = _run_engine(tar, TSP, cfg, tp, prompts, 6, token_budget=64)
    assert got == want and len(got) == len(prompts)
    assert teng.runner.whole_prompts and teng.scheduler.chunk_size == teng.kv.max_seq


def test_engine_prefills_a_prompt_longer_than_the_token_budget_whole():
    """The JAX engine splits a prompt longer than its token budget and
    restarts the state for each piece; the port budgets a step for whole
    prompts, so its tokens equal the JAX engine's with a budget that
    holds the prompt."""
    cfg, jcfg, jp, tp = _pair("falcon_mamba_7b")
    prompts = [np.random.default_rng(5).integers(0, cfg.vocab_size, size=40).astype(np.int32)]
    want, _ = _run_engine(jar, JSP, jcfg, jp, prompts, 4, token_budget=64)
    got, teng = _run_engine(tar, TSP, cfg, tp, prompts, 4, token_budget=16)
    assert got == want
    assert teng.scheduler.token_budget == 4 * teng.kv.max_seq


def _load(dst, src) -> None:
    """Copy a numpy tree of the JAX package into the port's tensors, in
    place (the engines hold views of these tensors)."""
    if isinstance(dst, dict):
        for k in dst:
            _load(dst[k], src[k])
    else:
        dst.copy_(params_from_numpy(src))


def _serve(graph, engines, orch_cls, req_cls, sp_cls, prompts, arch):
    engines[arch].default_sampling = sp_cls(max_new_tokens=8, temperature=0.0)
    orch = orch_cls(graph, engines)
    orch.start()
    reqs = [req_cls(inputs={"tokens": p}) for p in prompts]
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=120.0)
    assert all(r.completion_time is not None and not r.failed for r in reqs)
    return [[int(t) for t in r.outputs[arch][0]["tokens"]] for r in reqs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_single_arch_serves_falcon_mamba_like_jax(monkeypatch, dtype):
    """The smoke config as the CLI builds it, served through both
    packages' Orchestrators with the JAX weights carried across.  In f32
    (the builders' config with its dtype replaced) the greedy tokens are
    identical.  In the published bf16 only the first token, sampled from
    the f32 prefill, must be: XLA fuses bf16 elementwise chains and
    rounds inside them at other places than eager PyTorch, so near-tied
    logits of a random model part after a few decode steps (the bf16 path
    is held to its tolerance by the tests above)."""
    import repro.launch.serve as jserve
    import repro_torch.launch.serve as tserve
    for mod in (jserve, tserve):
        get = mod.get_config
        monkeypatch.setattr(mod, "get_config",
                            lambda a, smoke, get=get: get(a, smoke=smoke).replace(dtype=dtype))
    arch = "falcon_mamba_7b"
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 200, size=int(n)).astype(np.int32) for n in (6, 17, 23)]
    jgraph, jeng, _ = jbuild(arch, 2, 8)
    tgraph, teng, tbundle = tbuild(arch, 2, 8, device="cpu")
    assert isinstance(teng[arch].runner, trun.StateRunner)
    assert tbundle["cfg"].dtype == dtype
    _load(tbundle["params"], jax.tree.map(np.asarray, jeng[arch].runner.params))
    want = _serve(jgraph, jeng, JOrch, JReq, JSP, prompts, arch)
    got = _serve(tgraph, teng, TOrch, TReq, TSP, prompts, arch)
    assert [len(t) for t in got] == [8] * len(prompts)
    if dtype == "float32":
        assert got == want
    else:
        assert [t[0] for t in got] == [t[0] for t in want]
