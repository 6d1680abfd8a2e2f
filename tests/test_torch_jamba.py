"""AI21-Jamba2-Mini's interleaved layers on the port's serving path:
attention and Mamba1 mixers, dense and MoE feed-forwards, served by
``AREngine`` through ``PagedRunner`` (paged KV for the attention layers, a
Mamba state per slot beside it), held on the CPU to the benchmark's plain
reference (``omnibench/families/jamba.py``) on its seeded weights.

The smoke size keeps one whole period of the published layout: 8 layers,
attention at layer 4, the MoE on odd layers, the router over twice the
experts held (8, of which 4 here).  Both sides run in f32, so they differ
only in the order of their sums (the chunked prefill's attention and the
paged decode's, the dense expert dispatch, the chunked scan against a
position-by-position one): at this size they agree to under 1e-5 with
logits up to about 4, and are held to 1e-4.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:           # the benchmark's plain reference lives at the root
    sys.path.insert(0, str(REPO))

from omnibench import spec  # noqa: E402
from omnibench.reference.model import Products  # noqa: E402
from repro_torch.configs import base, jamba2_mini, qwen3_moe_30b_a3b  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.engine.ar_engine import AREngine  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVConfig  # noqa: E402
from repro_torch.engine.runner import PagedRunner  # noqa: E402
from repro_torch.engine.sampling import SamplingParams  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)

JAMBA = spec.family("jamba")
SMOKE = jamba2_mini.SMOKE_CONFIG
#: the family's model section at the smoke size, in f32, dropless
M = dict(dataclasses.asdict(SMOKE), dtype="float32", capacity_factor=1e9)
CFG = base.ModelConfig(**M)
SEED = 2**31 + 29
TOL = 1e-4
KV = dict(num_pages=72, page_size=16, max_pages_per_seq=16)
#: prompts of 1 to 4 chunks of 16
PROMPTS = [40, 9, 33, 50, 17, 7]


def _engine(params=None, max_batch=4, **kw):
    return AREngine("ar", CFG, params if params is not None
                    else JAMBA.program_params(M, SEED, "cpu"),
                    kv=PagedKVConfig(**KV), max_batch=max_batch, chunk_size=16,
                    token_budget=24, **kw)


def _serve(eng, prompts: dict, max_new=8, starts=None):
    """Serve ``prompts`` greedily; returns ({rid: served tokens}, {rid: the
    logits each served token was sampled from, stacked}); ``starts``, a
    list, gets each prefill chunk's start."""
    logits: dict = {}
    decode, sample, prefill = eng.runner.decode, eng._sample, eng.runner.prefill_chunk

    def recording_prefill(embeds, table, start, valid, **kw):
        if starts is not None:
            starts.append(start)
        return prefill(embeds, table, start, valid, **kw)

    def recording_decode(embeds, tables, positions, active):
        out = decode(embeds, tables, positions, active)
        for rid, seq in eng.scheduler.running.items():
            if active[seq.slot] and not seq.in_prefill:
                logits.setdefault(rid, []).append(out[0][seq.slot].clone())
        return out

    def recording_sample(rid, lg):
        logits.setdefault(rid, []).append(lg.clone())
        return sample(rid, lg)

    eng.runner.decode, eng._sample = recording_decode, recording_sample
    eng.runner.prefill_chunk = recording_prefill
    for rid, p in prompts.items():
        eng.enqueue(rid, {"tokens": p}, SamplingParams(max_new_tokens=max_new,
                                                       temperature=0.0), {})
    served = {}
    while eng.has_work:
        for ev in eng.step():
            if ev.kind == "finished":
                served[ev.req_id] = ev.payload["tokens"].tolist()
    return served, {rid: torch.stack(v) for rid, v in logits.items()}


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(0, M["vocab_size"], n).astype(np.int32)
            for rid, n in enumerate(lengths)}


@pytest.fixture(scope="module")
def served():
    """The smoke prompts served by one engine, with the program's spans."""
    keep = metrics.spans
    metrics.spans = type(keep)(maxlen=metrics.MAX_SPANS)
    try:
        starts = []
        tokens, logits = _serve(_engine(), _prompts(PROMPTS), starts=starts)
        spans = [s for s in metrics.spans if s.engine == "ar"]
    finally:
        metrics.spans = keep
    return _prompts(PROMPTS), tokens, logits, spans, starts


def test_the_engine_agrees_with_the_plain_reference(served):
    prompts, tokens, logits, spans, _ = served
    assert sorted(tokens) == list(range(len(PROMPTS)))
    for rid, toks in tokens.items():
        p = prompts[rid].tolist()
        rows = list(range(len(p) - 1, len(p) - 1 + len(toks)))
        want = JAMBA.logits(M, SEED, [p + toks[:-1]], [rows], "cpu")[0]
        assert logits[rid].shape == want.shape
        err = (logits[rid] - want).abs().max().item()
        assert err < TOL, (rid, err)
    # a prompt went on by chunks in steps that also decoded other requests
    phases: dict = {}
    for s in spans:
        phases.setdefault(s.parent, {})[s.name] = s.counts
    assert any("model.decode" in ph and ph.get("engine.prefill", {}).get("mamba_carries")
               for ph in phases.values())


def test_each_prefill_chunk_notes_whether_it_began_or_carried_a_state(served):
    *_, spans, starts = served
    pre = [s for s in spans if s.name == "engine.prefill"]
    resets = sum(s.counts.get("mamba_resets", 0) for s in pre)
    carries = sum(s.counts.get("mamba_carries", 0) for s in pre)
    assert resets == starts.count(0) == len(PROMPTS)
    assert carries == len(starts) - len(PROMPTS) >= sum(-(-n // 16) - 1 for n in PROMPTS)


def test_a_model_without_mamba_layers_notes_no_state():
    cfg = qwen3_moe_30b_a3b.SMOKE_CONFIG.replace(dtype="float32")
    keep = metrics.spans
    metrics.spans = type(keep)(maxlen=metrics.MAX_SPANS)
    try:
        eng = AREngine("q", cfg, T.init_params(cfg, torch.Generator().manual_seed(0)),
                       kv=PagedKVConfig(**KV), max_batch=2, chunk_size=16)
        _serve(eng, _prompts([20, 5]), max_new=3)
        counts = [s.counts for s in metrics.spans if s.engine == "q"]
    finally:
        metrics.spans = keep
    assert counts and not any("mamba_resets" in c or "mamba_carries" in c for c in counts)


def test_a_reused_slot_starts_from_a_zero_state():
    params = JAMBA.program_params(M, SEED, "cpu")
    prompts = _prompts([37, 21], seed=3)
    _, both = _serve(_engine(params, max_batch=1), prompts)
    _, alone = _serve(_engine(params, max_batch=1), {1: prompts[1]})
    assert torch.equal(both[1], alone[1])


def test_decode_leaves_an_inactive_rows_state_as_it_was():
    """An inactive row's slot may hold a prompt half prefilled: a decode
    step writes the active rows' states alone, and keeps the distinct
    held experts the active rows routed to."""
    b = 6
    runner = PagedRunner(CFG, JAMBA.program_params(M, SEED, "cpu"), PagedKVConfig(**KV),
                         max_batch=b)
    gen = torch.Generator().manual_seed(1)
    runner.ssm_h.copy_(torch.randn(runner.ssm_h.shape, generator=gen))
    runner.ssm_conv.copy_(torch.randn(runner.ssm_conv.shape, generator=gen))
    before = runner.ssm_h.clone(), runner.ssm_conv.clone()
    active = np.array([True, False, True, True, False, True])
    tables = (np.arange(b)[:, None] * 4 + 1 + np.arange(16)[None]).astype(np.int32) % 72
    seen, route = [], moe.route

    def recording(*a, **k):
        out = route(*a, **k)
        seen.append(out[2])
        return out

    keep, moe.route = metrics.spans, recording
    metrics.spans = type(keep)(maxlen=metrics.MAX_SPANS)
    try:
        trace = metrics.StepTrace("cpu", metrics.StepTotals(), first="model.decode")
        trace.worked = True
        runner.decode(torch.randn((b, 1, CFG.d_model), generator=gen), tables,
                      np.full(b, 5, np.int32), active)
        trace.finish()
        kept = [s.kept for s in metrics.spans if s.name == "model.decode"][0]
    finally:
        metrics.spans, moe.route = keep, route
    for now, was in zip((runner.ssm_h, runner.ssm_conv), before):
        assert torch.equal(now[:, ~active], was[:, ~active])
        assert not torch.equal(now[:, active], was[:, active])
    live = torch.as_tensor(active)
    want = [len({e for e in ids[live].flatten().tolist() if e < CFG.num_experts})
            for ids in seen]
    assert len(seen) == 4 and kept["routed_experts"].tolist() == want


def test_the_held_shares_add_up_to_the_uncut_layer():
    """Two cards of EP 2, experts [0, 4) and [4, 8): their parts of the
    MoE layer add up to the layer with all 8 experts (a card's share
    of a stated deployment), on the port and in the plain reference."""
    uncut = CFG.replace(num_experts=8, router_experts=0)
    p = moe.init_moe(uncut, torch.Generator().manual_seed(2))
    x = torch.randn((2, 9, CFG.d_model), generator=torch.Generator().manual_seed(3))
    whole = moe.moe_forward(uncut, p, x)[0]
    parts = []
    for lo in (0, 4):
        share = CFG.replace(num_experts=4, router_experts=8, expert_offset=lo)
        held = {"router": p["router"], **{k: p[k][lo:lo + 4] for k in ("wg", "wu", "wd")}}
        parts.append(moe.moe_forward(share, held, x)[0])
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5, atol=1e-6)
    ref = JAMBA.moe(dict(M, num_experts=8, router_experts=8), p, x.reshape(-1, CFG.d_model),
                    Products(None))
    torch.testing.assert_close(whole.reshape(-1, CFG.d_model), ref, rtol=1e-5, atol=1e-6)


def test_top_k_weights_are_renormalised_for_qwen_and_not_for_jamba():
    assert qwen3_moe_30b_a3b.SMOKE_CONFIG.renormalize_topk and not SMOKE.renormalize_topk
    router = torch.randn((CFG.d_model, 8), generator=torch.Generator().manual_seed(4))
    x = torch.randn((5, CFG.d_model), generator=torch.Generator().manual_seed(5))
    gates, w, ids = moe.route(router, x, 2)
    torch.testing.assert_close(w.sum(-1), torch.ones(5))
    gates, raw, same = moe.route(router, x, 2, renormalize=False)
    assert torch.equal(same, ids) and torch.equal(raw, gates.gather(1, ids))
    assert (raw.sum(-1) < 1).all()


@pytest.mark.parametrize("what", ["spec_ngram", "emit_kv", "extract_kv", "inject_kv",
                                  "copy_pages"])
def test_what_cannot_carry_a_mamba_state_refuses_the_model(what):
    """A prefix-cache hit's copy-on-write fork, a PD KV hop and speculative
    verification move or rewind pages, which hold no Mamba state: each
    refuses the model rather than serve it wrong."""
    engine_kw = {"spec_ngram": {"spec_ngram": (2, 3)}, "emit_kv": {"emit_kv": True}}
    params = JAMBA.program_params(M, SEED, "cpu")
    if what in engine_kw:
        with pytest.raises(ValueError, match="Mamba"):
            _engine(params, **engine_kw[what])
        return
    runner = _engine(params).runner
    table = np.arange(4, dtype=np.int32)
    call = {"extract_kv": lambda: runner.extract_kv(table, 20),
            "inject_kv": lambda: runner.inject_kv(np.zeros((4, 32, 2, 16), np.float32),
                                                  np.zeros((4, 32, 2, 16), np.float32),
                                                  table, 20),
            "copy_pages": lambda: runner.copy_pages([1], [2])}[what]
    before = runner.k_pages.clone()
    with pytest.raises(ValueError, match="Mamba"):
        call()
    assert torch.equal(runner.k_pages, before)


def test_a_prefix_cache_asked_for_is_off_and_serves_no_hit():
    """The serving CLI asks every AR stage for prefix caching: a model with
    Mamba layers is served with the cache off, as the state families are,
    so the same prompt twice hits nothing and is served the same."""
    params = JAMBA.program_params(M, SEED, "cpu")
    eng = _engine(params, max_batch=1, enable_prefix_cache=True)
    assert not eng.enable_prefix_cache
    p = _prompts([40], seed=5)[0]
    _, logits = _serve(eng, {0: p, 1: p.copy()})
    assert eng.prefix_stats["hits"] == 0 and eng.prefix_snapshot() == []
    assert torch.equal(logits[0], logits[1])


def test_the_config_at_published_widths():
    cfg = jamba2_mini.CONFIG
    assert cfg.layer_layout == "MMMMAMMM" * 4
    assert [i for i in range(32) if cfg.is_moe_layer(i)] == list(range(1, 32, 2))
    assert cfg.router_width == 16 and cfg.num_experts == 8 and not cfg.renormalize_topk
    # held on the card: 28 Mamba, 4 attention and 16 dense layers, 8 of 16
    # experts in 16 layers with their 16-wide routers, norms, embedding, head
    assert cfg.param_count() == 29_021_745_024
    m = spec.read_json(REPO / "omnibench/configs/jamba2_mini_ep2.json")["model"]
    assert base.ModelConfig(**m).replace(name=cfg.name, source=cfg.source,
                                         capacity_factor=cfg.capacity_factor) == cfg
    assert JAMBA.held(m)[0] == cfg.param_count()
    assert "jamba2_mini" not in base.ARCH_IDS
    assert base.get_config("jamba2_mini", smoke=True) is SMOKE


def test_the_dense_cache_paths_refuse_interleaved_kinds():
    params = T.init_params(CFG, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="PagedRunner"):
        T.forward_full(CFG, params, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="PagedRunner"):
        T.init_decode_cache(CFG, 2, 64)


def test_init_params_lays_out_what_the_reference_draws():
    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from (leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)])

    port = dict(leaves(T.init_params(CFG, torch.Generator().manual_seed(0))))
    drawn = dict(leaves(JAMBA.program_params(M, 5, "cpu")))
    assert port.keys() == drawn.keys()
    for path, t in port.items():
        assert (t.shape, t.dtype) == (drawn[path].shape, drawn[path].dtype), path


def test_the_reference_is_transformers_jamba():
    """The plain reference against Hugging Face's own Jamba (transformers'
    ``JambaForCausalLM``, its plain PyTorch path), with the experts not
    held here set to zero: the held share is the whole model then.  Its
    heads are d_model / num_heads wide."""
    transformers = pytest.importorskip("transformers")
    m = dict(M, head_dim=M["d_model"] // M["num_heads"])
    hc = transformers.JambaConfig(
        vocab_size=m["vocab_size"], hidden_size=m["d_model"], intermediate_size=m["d_ff"],
        num_hidden_layers=8, num_attention_heads=m["num_heads"],
        num_key_value_heads=m["num_kv_heads"], num_experts=8, num_experts_per_tok=2,
        attn_layer_period=8, attn_layer_offset=4, expert_layer_period=2, expert_layer_offset=1,
        mamba_d_state=m["ssm_state"], mamba_d_conv=4, mamba_expand=2,
        mamba_dt_rank=m["d_model"] // 16, mamba_conv_bias=True, mamba_proj_bias=False,
        rms_norm_eps=m["rmsnorm_eps"], use_mamba_kernels=False, tie_word_embeddings=False)
    hc._attn_implementation = "eager"
    hf = transformers.JambaForCausalLM(hc).float().eval()
    p = JAMBA.program_params(m, 11, "cpu")
    d = m["d_model"]
    sd = {"model.embed_tokens.weight": p["embed"], "lm_head.weight": p["lm_head"].T,
          "model.final_layernorm.weight": p["final_ln"]["scale"]}
    row = dict.fromkeys(("attn", "mamba", "mlp", "moe"), 0)
    for i, (mixer, ffn) in enumerate(JAMBA.kinds(m)):
        a = _row(p[mixer], row[mixer])
        f = _row(p[ffn], row[ffn])
        row[mixer] += 1
        row[ffn] += 1
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = a["ln"]["scale"]
        sd[pre + "pre_ff_layernorm.weight"] = f["ln"]["scale"]
        if mixer == "attn":
            for n in "qkv":
                sd[pre + f"self_attn.{n}_proj.weight"] = a["w" + n].reshape(d, -1).T
            sd[pre + "self_attn.o_proj.weight"] = a["wo"].reshape(-1, d).T
        else:
            mp = pre + "mamba."
            sd.update({mp + "in_proj.weight": a["in_proj"].T,
                       mp + "conv1d.weight": a["conv_w"].T[:, None, :],
                       mp + "conv1d.bias": a["conv_b"], mp + "x_proj.weight": a["x_proj"].T,
                       mp + "dt_proj.weight": a["dt_proj"].T, mp + "dt_proj.bias": a["dt_bias"],
                       mp + "A_log": a["A_log"], mp + "D": a["D"],
                       mp + "out_proj.weight": a["out_proj"].T})
            for n in ("dt", "b", "c"):
                sd[mp + f"{n}_layernorm.weight"] = a[f"{n}_ln"]["scale"]
        names = (("gate", "wg"), ("up", "wu"), ("down", "wd"))
        if ffn == "mlp":
            for n, w in names:
                sd[pre + f"feed_forward.{n}_proj.weight"] = f[w].T
            continue
        sd[pre + "feed_forward.router.weight"] = f["router"].T
        for e in range(8):
            for n, w in names:
                t = f[w][e].T if e < m["num_experts"] else torch.zeros_like(f[w][0].T)
                sd[pre + f"feed_forward.experts.{e}.{n}_proj.weight"] = t
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not missing and not unexpected
    ids = torch.randint(0, m["vocab_size"], (1, 37), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf(ids, use_cache=False).logits[0]
    got = JAMBA.logits(m, 11, [ids[0].tolist()], [list(range(37))], "cpu")[0]
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def _row(tree: dict, j: int) -> dict:
    """Row ``j`` of a stacked tree."""
    return {k: _row(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}
