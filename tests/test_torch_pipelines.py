"""The port's other pipelines (qwen3_omni with the CNN vocoder, glm_image,
bagel, pd, epd, mimo_audio) against the JAX package's, with the JAX
weights carried across (``convert.params_from_numpy``; the draws the JAX
bundle does not expose are recomputed with its own ``jax.random`` calls)
and greedy sampling on every AR stage, all in f32 on the CPU.

Held: greedy tokens of every AR stage identical; the CNN vocoder's
latents within 1e-5; DiT outputs by count and shape (a DiT batch shares
one noise draw, so their values depend on thread timing; the DiT's
values are held at module level in test_torch_models.py); PD and EPD
tokens equal to a unified engine's and to the JAX package's; the KV hop's
connector bytes at least the prompt KV's size.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import pipelines as jp
from repro.core.orchestrator import Orchestrator as JOrch
from repro.core.request import Request as JReq
from repro.engine.sampling import SamplingParams as JSP
from repro_torch.configs import pipelines as tp
from repro_torch.convert import params_from_numpy
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.core.request import Request as TReq
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.sampling import SamplingParams as TSP

torch.set_num_threads(1)
TOL = 1e-5


def _load(dst, src) -> None:
    """Copy a numpy tree of the JAX package into the port's tensors, in
    place (the engines hold views of these tensors)."""
    if isinstance(dst, dict):
        for k in dst:
            _load(dst[k], src[k])
    else:
        dst.copy_(params_from_numpy(src))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _greedy(engines, sp_cls, names, n_tokens):
    for name in names:
        engines[name].default_sampling = sp_cls(max_new_tokens=n_tokens, temperature=0.0)


def _tap(graph, src, key="ar_tokens"):
    """Record the tokens ``src`` hands to its successor in each request's data."""
    for edge in graph.edges:
        if edge.src == src:
            inner = edge.transfer

            def tapped(data, payload, inner=inner):
                data.setdefault(key, []).append([int(t) for t in payload["tokens"]])
                return inner(data, payload)
            edge.transfer = tapped


def _serve(orch_cls, req_cls, graph, engines, inputs, timeout=120.0):
    orch = orch_cls(graph, engines)
    orch.start()
    reqs = [req_cls(inputs=dict(i)) for i in inputs]
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=timeout)
    assert all(r.completion_time is not None and not r.failed for r in reqs), \
        [r.failed for r in reqs]
    return reqs, orch


def _token_prompts(n, lo=6, hi=20, vocab=200, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, size=int(k)).astype(np.int32)}
            for k in rng.integers(lo, hi, size=n)]


# ---------------------------------------------------------------------------
# qwen3_omni: Thinker -> Talker -> CNN vocoder
# ---------------------------------------------------------------------------

QKW = dict(max_batch=4, thinker_tokens=5, talker_tokens=12, stream_chunk=6,
           vocoder_kind="cnn", seed=0)


def _jax_cnn_weights(seed=0):
    """The JAX builder's w1, w2 (pipelines.py:161-163), drawn again."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    wk = jax.random.split(ks[3], 2)
    return (np.asarray(jax.random.normal(wk[0], (3, jp.D, jp.D)) * 0.05),
            np.asarray(jax.random.normal(wk[1], (3, jp.D, 32)) * 0.05))


def _qwen3(carry_from=None):
    if carry_from is None:
        graph, engines, bundle = jp.build_qwen_omni(**QKW)
        sp = JSP
    else:
        graph, engines, bundle = tp.build_qwen_omni(**QKW, device="cpu")
        sp = TSP
        for name in ("thinker_params", "talker_params"):
            _load(bundle[name], _np(carry_from[name]))
        bundle["codec_embed"][...] = np.asarray(carry_from["codec_embed"])
        w1, w2 = _jax_cnn_weights()
        bundle["w1"].copy_(torch.tensor(w1))
        bundle["w2"].copy_(torch.tensor(w2))
    engines["thinker"].default_sampling = sp(max_new_tokens=QKW["thinker_tokens"],
                                             temperature=0.0)
    engines["talker"].default_sampling = sp(max_new_tokens=QKW["talker_tokens"],
                                            temperature=0.0)
    _tap(graph, "talker", "talker_chunks")
    return graph, engines, bundle


def test_cnn_vocoder_latents_match_jax_on_a_padded_batch():
    _, jeng, _ = jp.build_qwen_omni(**QKW)
    _, teng, tb = tp.build_qwen_omni(**QKW, device="cpu")
    w1, w2 = _jax_cnn_weights()
    tb["w1"].copy_(torch.tensor(w1))
    tb["w2"].copy_(torch.tensor(w2))
    rng = np.random.default_rng(1)
    batch = [{"cond": rng.standard_normal((n, jp.D)).astype(np.float32),
              "chunk_index": i} for i, n in enumerate((6, 3, 1))]
    jout = jeng["vocoder"].forward(batch)
    tout = teng["vocoder"].forward(batch)
    for a, b, inp in zip(tout, jout, batch):
        assert a["chunk_index"] == b["chunk_index"] == inp["chunk_index"]
        assert a["latent"].shape == b["latent"].shape == (2 * inp["cond"].shape[0], 32)
        np.testing.assert_allclose(a["latent"], b["latent"], rtol=TOL, atol=TOL)
    # as in the JAX package, a short row's last latent sees the batch's zero
    # padding through both convolutions, so it depends on its batch
    alone = teng["vocoder"].forward(batch[1:2])[0]["latent"]
    np.testing.assert_allclose(alone[:-1], tout[1]["latent"][:-1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [1, 2, 7])
def test_cnn_vocoder_conv_is_a_same_padded_conv1d(t):
    """The three shifted matmuls are the 3-tap "SAME" convolution."""
    g = torch.Generator().manual_seed(t)
    x = torch.randn((2, t, 8), generator=g)
    w = torch.randn((3, 8, 4), generator=g)
    want = torch.nn.functional.conv1d(x.transpose(1, 2), w.permute(2, 1, 0),
                                      padding=1).transpose(1, 2)
    torch.testing.assert_close(tp._conv1d_same(x, w), want, rtol=1e-5, atol=1e-5)


def test_qwen3_omni_greedy_tokens_and_cnn_latents_match_jax():
    # 12 Talker tokens in chunks of 6: every vocoder row is 6 long, so no
    # row is padded and the latents do not depend on how chunks batch
    prompts = _token_prompts(3)
    jg, je, jb = _qwen3()
    jreqs, _ = _serve(JOrch, JReq, jg, je, prompts)
    tg, te, _ = _qwen3(carry_from=jb)
    treqs, _ = _serve(TOrch, TReq, tg, te, prompts)
    for j, t in zip(jreqs, treqs):
        assert t.data["thinker_tokens"].tolist() == j.data["thinker_tokens"].tolist()
        assert t.data["talker_chunks"] == j.data["talker_chunks"]
        jc = sorted(j.outputs["vocoder"], key=lambda p: p["chunk_index"])
        tc = sorted(t.outputs["vocoder"], key=lambda p: p["chunk_index"])
        assert [p["chunk_index"] for p in tc] == [p["chunk_index"] for p in jc] == [0, 1]
        for a, b in zip(tc, jc):
            assert a["latent"].shape == b["latent"].shape == (12, 32)
            np.testing.assert_allclose(a["latent"], b["latent"], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# glm_image and bagel: AR LLM -> DiT
# ---------------------------------------------------------------------------

AKW = dict(max_batch=4, ar_tokens=6, image_latents=16, dit_steps=2, seed=0)


@pytest.mark.parametrize("name", ["glm_image", "bagel"])
def test_ar_dit_greedy_tokens_match_jax_and_dit_outputs_by_shape(name):
    prompts = _token_prompts(3, seed=2)
    jg, je, jb = jp.build_ar_dit(name, **AKW)
    tg, te, tb = tp.build_ar_dit(name, **AKW, device="cpu")
    _load(tb["llm_params"], _np(jb["llm_params"]))
    _load(tb["dit_params"], _np(je[f"{name}_dit"].params))
    tb["vq_embed"][...] = np.asarray(jb["vq_embed"])
    runs = []
    for g, e, sp, orch, req in ((jg, je, JSP, JOrch, JReq), (tg, te, TSP, TOrch, TReq)):
        _greedy(e, sp, [f"{name}_llm"], AKW["ar_tokens"])
        _tap(g, f"{name}_llm")
        runs.append(_serve(orch, req, g, e, prompts)[0])
    for j, t in zip(*runs):
        assert t.data["ar_tokens"] == j.data["ar_tokens"]
        assert len(t.data["ar_tokens"][0]) == AKW["ar_tokens"]
        to, jo = t.outputs[f"{name}_dit"], j.outputs[f"{name}_dit"]
        assert len(to) == len(jo) == 1
        assert to[0]["latent"].shape == jo[0]["latent"].shape == (AKW["image_latents"], 32)
        assert np.isfinite(to[0]["latent"]).all()
    assert set(tb["engine_specs"]) == {f"{name}_llm", f"{name}_dit"}
    assert tb["engine_specs"][f"{name}_llm"].kwargs["pipeline"] == name


# ---------------------------------------------------------------------------
# PD and EPD disaggregation
# ---------------------------------------------------------------------------

def _unified(cfg, params, inputs, max_new, max_batch=4):
    eng = AREngine("u", cfg, params, kv=tp._kv(max_batch), max_batch=max_batch,
                   default_sampling=TSP(max_new_tokens=max_new, temperature=0.0))
    for i, inp in enumerate(inputs):
        eng.enqueue(i, inp, TSP(), {})
    out = {}
    for _ in range(500):
        for ev in eng.step():
            if ev.kind == "finished":
                out[ev.req_id] = [int(t) for t in ev.payload["tokens"]]
        if not eng.has_work:
            break
    return [out[i] for i in range(len(inputs))]


def test_pd_tokens_match_unified_and_jax_and_kv_rides_the_connector():
    rng = np.random.default_rng(0)
    prompts = [{"tokens": rng.integers(0, 500, size=n).astype(np.int32)}
               for n in (5, 19, 33, 12)]
    jg, je, jb = jp.build_pd_disaggregated(max_batch=4, max_new=8)
    tg, te, tb = tp.build_pd_disaggregated(max_batch=4, max_new=8, device="cpu")
    _load(tb["params"], _np(jb["params"]))
    jreqs, _ = _serve(JOrch, JReq, jg, je, prompts)
    treqs, orch = _serve(TOrch, TReq, tg, te, prompts)
    want = _unified(tb["cfg"], tb["params"], prompts, 8)
    for i, (j, t) in enumerate(zip(jreqs, treqs)):
        got = [int(x) for x in t.outputs["decode"][0]["tokens"]]
        assert got == want[i] == [int(x) for x in j.outputs["decode"][0]["tokens"]]
        assert len(got) == 8
    st = orch.connector_stats()["shm"]
    cfg = tb["cfg"]
    kv_bytes = sum(cfg.num_layers * len(p["tokens"]) * cfg.num_kv_heads * cfg.head_dim * 2 * 4
                   for p in prompts)
    assert st.calls == 4 and st.bytes >= kv_bytes
    assert te["decode"].steps >= 7 and not te["decode"].scheduler.running


def test_pd_builder_carries_cfg_device_and_max_seq_in_its_specs():
    cfg = tp.tiny_lm("pd_custom", vocab=300)
    _, engines, bundle = tp.build_pd_disaggregated(cfg, max_batch=2, max_seq=512,
                                                   temperature=0.0, device="cpu")
    spec = bundle["engine_specs"]["decode"]
    assert spec.kwargs["cfg"] is cfg and spec.kwargs["device"] == "cpu"
    assert spec.kwargs["max_seq"] == 512 and spec.kwargs["temperature"] == 0.0
    assert engines["decode"].runner.kv.max_seq == 512
    rebuilt = spec.build()               # what a spawned child does
    assert torch.equal(rebuilt.runner.params["embed"], engines["decode"].runner.params["embed"])
    assert rebuilt.runner.k_pages.shape == engines["decode"].runner.k_pages.shape


def test_epd_tokens_match_unified_and_jax():
    rng = np.random.default_rng(0)
    frames = [{"frames": rng.standard_normal((n, 32)).astype(np.float32)} for n in (7, 15)]
    jg, je, jb = jp.build_epd_disaggregated(max_batch=2, max_new=6)
    tg, te, tb = tp.build_epd_disaggregated(max_batch=2, max_new=6, device="cpu")
    _load(tb["params"], _np(jb["params"]))
    tb["w_enc"][...] = np.asarray(jb["w_enc"])
    jreqs, _ = _serve(JOrch, JReq, jg, je, frames)
    treqs, orch = _serve(TOrch, TReq, tg, te, frames)
    want = _unified(tb["cfg"], tb["params"],
                    [{"prompt_embeds": f["frames"] @ tb["w_enc"]} for f in frames], 6,
                    max_batch=2)
    for i, (j, t) in enumerate(zip(jreqs, treqs)):
        got = [int(x) for x in t.outputs["decode"][0]["tokens"]]
        assert got == want[i] == [int(x) for x in j.outputs["decode"][0]["tokens"]]
    assert orch.connector_stats()["shm"].calls >= 4          # both hops


# ---------------------------------------------------------------------------
# mimo_audio: patch encoder -> AR LLM -> patch decoder
# ---------------------------------------------------------------------------

MKW = dict(max_batch=4, ar_tokens=6, patch=4, seed=0)


def _jax_mimo_weights(seed=0, patch=4, vocab=512):
    """The JAX builder's w_enc, w_dec and tok_embed (pipelines.py:421-429)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    f = patch * 16
    return (np.asarray(jax.random.normal(ks[1], (f, jp.D)) * 0.1, np.float32),
            np.asarray(jax.random.normal(ks[2], (jp.D, f)) * 0.1, np.float32),
            np.asarray(jax.random.normal(ks[3], (vocab, jp.D)) * 0.1, np.float32))


def test_mimo_audio_greedy_tokens_and_decoded_audio_match_jax():
    rng = np.random.default_rng(3)
    audio = [{"audio": rng.standard_normal((n, 16)).astype(np.float32)} for n in (32, 18, 9)]
    jg, je, jb = jp.build_mimo_audio(**MKW)
    tg, te, tb = tp.build_mimo_audio(**MKW, device="cpu")
    _load(tb["llm_params"], _np(je["mimo_llm"].runner.params))   # not in the JAX bundle
    for key, val in zip(("w_enc", "w_dec", "tok_embed"), _jax_mimo_weights()):
        tb[key][...] = val
    runs = []
    for g, e, sp, orch, req in ((jg, je, JSP, JOrch, JReq), (tg, te, TSP, TOrch, TReq)):
        _greedy(e, sp, ["mimo_llm"], MKW["ar_tokens"])
        _tap(g, "mimo_llm")
        runs.append(_serve(orch, req, g, e, audio)[0])
    for j, t in zip(*runs):
        assert t.data["ar_tokens"] == j.data["ar_tokens"]
        a, b = t.outputs["patch_dec"][0]["audio"], j.outputs["patch_dec"][0]["audio"]
        assert a.shape == b.shape == (MKW["ar_tokens"], MKW["patch"] * 16)
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the dispatch table
# ---------------------------------------------------------------------------

def test_builders_table_matches_jax_and_rebuilds_each_stage():
    assert set(tp._BUILDERS) == set(jp._BUILDERS) == {
        "qwen_omni", "glm_image", "bagel", "pd", "epd", "mimo_audio"}
    eng = tp.build_stage_engine("mimo_audio", "patch_dec", device="cpu")
    assert eng.name == "patch_dec"
    with pytest.raises(ValueError, match="no stage"):
        tp.build_stage_engine("pd", "encoder", device="cpu")
    with pytest.raises(ValueError, match="unknown pipeline"):
        tp.build_stage_engine("qwen4", "x", device="cpu")
    with pytest.raises(ValueError, match="vocoder_kind"):
        tp.build_qwen_omni(vocoder_kind="wavenet", device="cpu")
