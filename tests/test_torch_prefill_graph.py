"""``PagedRunner.prefill_chunk``'s fixed-shape body on the CPU, where it
runs eagerly (on the card the same body is captured as one CUDA graph and
replayed: ``tests/test_torch_cuda.py``).

Every row of the chunk is computed.  A padding row writes what the last
valid row writes, to the same place, and a Mamba layer carries its state
over the padding with dt 0 and gives the padding nothing.  So against a
chunk that runs its Mamba layers over the valid rows alone and writes the
valid rows' K/V alone (``_valid_rows_only``, what the runner did before),
every row of the residual stream, the pools and the slots' states must
come out the same, and no page the request does not own may change.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import jamba2_mini, qwen3_moe_30b_a3b
from repro_torch.core import metrics
from repro_torch.engine.kv_cache import PagedKVConfig
from repro_torch.engine.runner import PagedRunner
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe
from repro_torch.models import transformer as T

torch.set_num_threads(1)

C, PAGE, PP, SLOTS = 16, 8, 6, 3
#: the request's pages (neither contiguous nor from 0); the pool's others are no one's
TABLE = np.array([7, 2, 11, 5, 9, 13], np.int32)


def _config(which, kv_cache_dtype=""):
    """In f32, so that the pools hold the chunk's K/V unrounded."""
    if which == "qwen":       # at capacity 1.25, so padding rows take expert slots
        cfg = qwen3_moe_30b_a3b.SMOKE_CONFIG
    else:                     # Mamba at layers 0-3 and 5-7, attention at 4, MoE on odd ones
        cfg = jamba2_mini.SMOKE_CONFIG
    return cfg.replace(dtype="float32", kv_cache_dtype=kv_cache_dtype)


def _runners(cfg, n=2, seed=0):
    """``n`` runners over the same weights, random pools and random slot
    states (stale ones: each chunk at start 0 must ignore its slot's).
    The first MoE layer's router is zero: every row, padding rows too,
    picks the same experts, more than their capacity."""
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    (params["moe"] if cfg.interleaved else params["blocks"]["moe"])["router"][0].zero_()
    kv = PagedKVConfig(num_pages=16, page_size=PAGE, max_pages_per_seq=PP)
    runners = [PagedRunner(cfg, params, kv, max_batch=SLOTS, chunk_size=C) for _ in range(n)]
    gen = torch.Generator().manual_seed(seed + 1)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales", "ssm_h", "ssm_conv"):
        t = getattr(runners[0], name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
        else:
            t.copy_((torch.rand(t.shape, generator=gen) + 0.5).to(t.dtype))
        for r in runners[1:]:
            getattr(r, name).copy_(t)
    return runners


def _valid_rows_only(r, embeds, table, start, valid, slot):
    """The chunk as the runner computed it before its fixed-shape body: a
    Mamba layer over the valid rows alone (from the slot's state, none at
    start 0), its output padded with zeros; the valid rows' K/V written
    alone."""
    cfg, page = r.cfg, r.kv.page_size
    h, c = embeds.clone(), embeds.shape[1]
    bt = torch.as_tensor(table, dtype=torch.long)
    pos = start + torch.arange(c)
    written = pos[:valid]
    pid, wslot = bt[written // page], written % page
    for i, lp in enumerate(r._layers):
        hn = L.rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps)
        j = r._pool[i]
        if "mamba" in lp:
            hs, cs = r.ssm_h[j, slot], r.ssm_conv[j, slot]
            state = None if start == 0 else (hs[None], cs[None].to(hn.dtype))
            y, (h_last, conv) = M.mamba1_forward(cfg, lp["mamba"], hn[:, :valid], state)
            hs.copy_(h_last[0])
            cs.copy_(conv[0])
            h = h + F.pad(y, (0, 0, 0, c - valid))
        else:
            q, k, v = L._qkv(cfg, lp["attn"], hn)
            if cfg.rope_theta:
                q = L.rope(q, pos[None], cfg.rope_theta)
                k = L.rope(k, pos[None], cfg.rope_theta)
            r._write_kv(j, k[0, :valid], v[0, :valid], pid, wslot)
            kp, vp, ksp, vsp = r._layer_pools(j)
            if r.quant:
                k_all = (kp[bt].float() * ksp[bt][..., None]).to(h.dtype)
                v_all = (vp[bt].float() * vsp[bt][..., None]).to(h.dtype)
            else:
                k_all, v_all = kp[bt], vp[bt]
            shape = (1, -1, cfg.num_kv_heads, cfg.head_dim)
            o = ref.chunk_attention(q, k_all.reshape(shape), v_all.reshape(shape), start,
                                    window=r._window)
            h = h + L.unproject(o, lp["attn"]["wo"])
        hn = L.rmsnorm(lp["ln2"], h, cfg.rmsnorm_eps)
        h = h + L.mlp_or_moe(cfg, lp, hn)
    return T._unembed(cfg, r.params, h)[0], h[0]


def _pools(r):
    return {n: getattr(r, n).clone() for n in ("k_pages", "v_pages", "k_scales", "v_scales",
                                               "ssm_h", "ssm_conv")
            if getattr(r, n) is not None}


def _written(start, valid):
    """(page, slot) of each position the chunk's valid rows write."""
    pos = np.arange(start, start + valid)
    return TABLE[pos // PAGE], pos % PAGE


def _close(got, want):
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("which", ["qwen", "jamba"])
@pytest.mark.parametrize("valid", [1, 5, C - 1, C])
@pytest.mark.parametrize("start", [0, 2 * C], ids=["first", "carried"])
@pytest.mark.parametrize("kv_cache_dtype", ["", "int8"], ids=["f32", "int8"])
def test_the_chunk_equals_its_valid_rows_alone(which, valid, start, kv_cache_dtype,
                                               monkeypatch):
    """Every row's logits and residual stream, padding rows included (a
    MoE layer routes them, so they must hold what they held), the pages
    the valid rows write and the slot's Mamba state agree with the valid
    rows alone; every other page position and every other slot's state
    is bit for bit as it was; and the same (token, expert) pairs drop."""
    cfg = _config(which, kv_cache_dtype)
    body, plain = _runners(cfg)
    before = _pools(body)
    embeds = torch.randn((1, C, cfg.d_model), generator=torch.Generator().manual_seed(valid))
    embeds[:, valid:] = 0.0                                  # as ``prefill`` pads
    slot = 1
    monkeypatch.setattr(moe, "drop_counter", torch.zeros((), dtype=torch.long))
    got = body.prefill_chunk(embeds, TABLE, start, valid, slot=slot)
    dropped = int(moe.drop_counter)
    monkeypatch.setattr(moe, "drop_counter", torch.zeros((), dtype=torch.long))
    want = _valid_rows_only(plain, embeds, TABLE, start, valid, slot)
    assert dropped == int(moe.drop_counter) > 0
    for g, w in zip(got, want):
        assert g.shape == (C, w.shape[1])
        _close(g, w)
    pages, slots = _written(start, valid)
    for name, was in before.items():
        now, other = getattr(body, name), getattr(plain, name)
        if name.startswith("ssm"):
            _close(now[:, slot], other[:, slot])
            keep = [s for s in range(SLOTS) if s != slot]
            assert torch.equal(now[:, keep], was[:, keep]), name
            continue
        _close(now[:, pages, slots], other[:, pages, slots])
        untouched = torch.ones(now.shape[1:3], dtype=torch.bool)
        untouched[pages, slots] = False
        assert torch.equal(now[:, untouched], was[:, untouched]), name
        assert torch.equal(other[:, untouched], was[:, untouched]), name


@pytest.mark.parametrize("valid", [1, 6, C - 1, C])
@pytest.mark.parametrize("start", [0, C], ids=["first", "carried"])
def test_the_mamba_state_is_the_scan_over_the_valid_rows_alone(valid, start):
    """Layer 0 of the Jamba-shaped model is a Mamba layer, whose input is
    the chunk's embeddings normed: its slot state after the chunk (h and
    the conv window) is the plain scan's over the valid rows alone, from
    the slot's state before (none at start 0)."""
    cfg = _config("jamba")
    (runner,) = _runners(cfg, n=1)
    slot = 2
    h0, conv0 = runner.ssm_h[0, slot].clone(), runner.ssm_conv[0, slot].clone()
    embeds = torch.randn((1, C, cfg.d_model), generator=torch.Generator().manual_seed(3))
    runner.prefill_chunk(embeds, TABLE, start, valid, slot=slot)
    lp = runner._layers[0]
    hn = L.rmsnorm(lp["ln1"], embeds, cfg.rmsnorm_eps)
    state = None if start == 0 else (h0[None], conv0[None])
    _, (h, conv) = M.mamba1_forward(cfg, lp["mamba"], hn[:, :valid], state)
    for got, want in ((runner.ssm_h[0, slot], h[0]), (runner.ssm_conv[0, slot], conv[0])):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("valid", [3, C])
def test_a_chunk_at_start_0_ignores_the_slots_stale_state(valid):
    cfg = _config("jamba")
    stale, fresh = _runners(cfg)
    slot = 0
    fresh.ssm_h[:, slot] = 0.0
    fresh.ssm_conv[:, slot] = 0.0
    assert not torch.equal(stale.ssm_h[:, slot], fresh.ssm_h[:, slot])
    embeds = torch.randn((1, C, cfg.d_model), generator=torch.Generator().manual_seed(4))
    outs = [r.prefill_chunk(embeds, TABLE, 0, valid, slot=slot) for r in (stale, fresh)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(stale.ssm_h, fresh.ssm_h) and torch.equal(stale.ssm_conv, fresh.ssm_conv)


@pytest.mark.parametrize("valid", [0, C + 1])
def test_a_chunk_without_valid_rows_or_past_its_rows_is_refused(valid):
    """A padding row repeats the last valid row's write: with no valid
    row there is none to repeat, and nothing may be written."""
    (runner,) = _runners(_config("qwen"), n=1)
    before = _pools(runner)
    with pytest.raises(ValueError, match="valid"):
        runner.prefill_chunk(torch.zeros((1, C, runner.cfg.d_model)), TABLE, 0, valid)
    for name, was in before.items():
        assert torch.equal(getattr(runner, name), was)


def test_the_cpu_chunk_notes_it_ran_eagerly():
    (runner,) = _runners(_config("jamba"), n=1)
    trace = metrics.StepTrace("cpu", metrics.StepTotals(), first="engine.prefill")
    trace.worked = True
    embeds = torch.randn((1, C, runner.cfg.d_model))
    for start in (0, C):
        runner.prefill_chunk(embeds, TABLE, start, C, slot=1)
    trace.phase(None)
    trace.finish()
    noted = trace._closed[0][4]
    assert noted["prefill_eager"] == 2 and noted["mamba_resets"] == noted["mamba_carries"] == 1
    assert not {"prefill_graph_replays", "prefill_graph_captures"} & set(noted)
    assert runner._prefill_graph is None


def test_held_notes_are_tallied_apart_on_their_thread():
    import threading

    trace = metrics.StepTrace("t", metrics.StepTotals(), first="engine.prefill")
    metrics.note(a=1)
    with metrics.held() as held:
        metrics.note(a=2, b=3)
        other = threading.Thread(target=metrics.note, kwargs={"a": 10})
        other.start()
        other.join(timeout=30)
        with metrics.held() as inner:
            metrics.note(b=4)
        metrics.note(b=1)
    assert not other.is_alive()
    metrics.note(**held)
    trace.phase(None)
    trace.finish()
    assert (held, inner, trace._closed[0][4]) == ({"a": 2, "b": 4}, {"b": 4}, {"a": 3, "b": 4})
