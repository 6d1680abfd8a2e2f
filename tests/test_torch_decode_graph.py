"""``PagedRunner.decode``'s fixed-shape body on the CPU, where it runs
eagerly (on the card the same body is captured as one CUDA graph and
replayed: ``tests/test_torch_cuda.py``).

Every row of the batch is computed and writes its K/V; an inactive row
writes what the first active row writes, to the same slot.  So the pools
must come out bit for bit as they do when only the active rows write
(what the runner did before, and what the JAX package's dropped writes
leave), everywhere in the pools and not only in the pages the active rows
own; every row's logits and hidden state must be bit for bit the same
too, and a MoE layer must drop the same (token, expert) pairs.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.pipelines import tiny_lm
from repro_torch.core import metrics
from repro_torch.engine import runner as trun
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.kv_cache import PagedKVConfig
from repro_torch.engine.sampling import SamplingParams
from repro_torch.models import moe
from repro_torch.models import transformer as T

torch.set_num_threads(1)

B, PAGE, PP, NUM_PAGES = 16, 8, 4, 80
#: the active slots of each step: slot 0 inactive in most, rows joining
#: and leaving between steps
STEPS = [[1, 2, 5, 9, 15], [1, 2, 3, 5, 9, 15], [0, 2, 3, 5, 9, 10, 11, 12, 13, 14],
         [3, 14], list(range(B)), [7]]


def _config(family, dtype, kv_cache_dtype):
    cfg = tiny_lm("t", vocab=128).replace(dtype=dtype, kv_cache_dtype=kv_cache_dtype)
    if family == "moe":
        # 16 rows x top-2 over 8 experts at capacity 1.25: 8 slots an expert
        cfg = cfg.replace(arch_type="moe", num_experts=8, experts_per_token=2, d_ff=64,
                          capacity_factor=1.25)
    return cfg


def _runners(cfg, seed=0):
    """Two runners over the same weights and the same random pools."""
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    if cfg.is_moe:
        # a zero router ties every gate, so every row picks experts 0 and 1:
        # 16 pairs for 8 slots, and the first layer drops pairs at every step
        params["blocks"]["moe"]["router"][0].zero_()
    kv = PagedKVConfig(num_pages=NUM_PAGES, page_size=PAGE, max_pages_per_seq=PP)
    a, b = trun.PagedRunner(cfg, params, kv), trun.PagedRunner(cfg, params, kv)
    gen = torch.Generator().manual_seed(seed + 1)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        pool = getattr(a, name)
        if pool is None:
            continue
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen, dtype=torch.int8))
        else:
            pool.copy_(torch.rand(pool.shape, generator=gen).to(pool.dtype))
        getattr(b, name).copy_(pool)
    return a, b


def _only_active_rows_write(runner, active):
    """Make ``runner``'s decode write the active rows' K/V alone."""
    write = runner._write_kv
    rows = torch.as_tensor(np.nonzero(active)[0])
    runner._write_kv = lambda i, k, v, pid, slot: write(i, k[rows], v[rows], pid[rows],
                                                        slot[rows])


@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize("dtype,kv_cache_dtype", [
    ("float32", ""), ("bfloat16", ""), ("float32", "int8")], ids=["f32", "bf16", "int8"])
def test_inactive_rows_leave_the_pools_as_if_they_did_not_exist(family, dtype,
                                                                kv_cache_dtype, monkeypatch):
    cfg = _config(family, dtype, kv_cache_dtype)
    full, ref = _runners(cfg)
    rng = np.random.default_rng(7)
    # slot s owns pages s*PP+1 .. s*PP+PP (page 0 and the last pages owned by none)
    own = np.arange(B)[:, None] * PP + 1 + np.arange(PP)[None]
    pos = rng.integers(0, 12, size=B)
    wrote = 0
    for live in STEPS:
        active = np.zeros(B, bool)
        active[live] = True
        # inactive slots carry stale tables and positions, pages of other slots too
        tables = np.where(active[:, None], own,
                          rng.integers(0, NUM_PAGES, size=(B, PP))).astype(np.int32)
        positions = np.where(active, pos, rng.integers(0, PP * PAGE, size=B)).astype(np.int32)
        embeds = torch.randn((B, 1, cfg.d_model),
                             generator=torch.Generator().manual_seed(int(pos.sum())))
        embeds = embeds.to(getattr(torch, dtype))
        outs, drops = [], []
        for runner, only_active in ((full, False), (ref, True)):
            counter = torch.zeros((), dtype=torch.long)
            monkeypatch.setattr(moe, "drop_counter", counter)
            if only_active:
                _only_active_rows_write(runner, active)
            outs.append(runner.decode(embeds, tables, positions, active))
            if only_active:
                del runner._write_kv
            drops.append(int(counter))
        for got, want in zip(*outs):
            assert torch.equal(got, want)
        assert drops[0] == drops[1]
        if family == "moe":
            assert drops[0] > 0
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            if getattr(full, name) is not None:
                assert torch.equal(getattr(full, name), getattr(ref, name)), name
        wrote += int(active.sum())
        pos = pos + active
    assert wrote == sum(len(s) for s in STEPS)


def test_a_batch_with_no_active_row_writes_nothing():
    # its inactive rows would have no active row's write to repeat: refused
    cfg = _config("dense", "float32", "")
    runner, _ = _runners(cfg)
    before = runner.k_pages.clone(), runner.v_pages.clone()
    with pytest.raises(ValueError, match="active row"):
        runner.decode(torch.randn((B, 1, cfg.d_model)), np.zeros((B, PP), np.int32),
                      np.zeros(B, np.int32), np.zeros(B, bool))
    assert torch.equal(runner.k_pages, before[0]) and torch.equal(runner.v_pages, before[1])


@pytest.mark.parametrize("live", [STEPS[0], STEPS[3], list(range(B))], ids=["5", "2", "all"])
def test_a_moe_step_keeps_the_experts_its_active_rows_routed_to(live, monkeypatch):
    cfg = _config("moe", "float32", "")
    runner, _ = _runners(cfg)
    # a random router, so that rows pick experts of their own
    gen = torch.Generator().manual_seed(5)
    runner.params["blocks"]["moe"]["router"].copy_(
        torch.randn(runner.params["blocks"]["moe"]["router"].shape, generator=gen))
    runner = trun.PagedRunner(cfg, runner.params, runner.kv)
    seen, route = [], moe.route

    def recording(router, xf, k):
        out = route(router, xf, k)
        seen.append(out[2])
        return out

    monkeypatch.setattr(moe, "route", recording)
    monkeypatch.setattr(metrics, "spans", type(metrics.spans)(maxlen=metrics.MAX_SPANS))
    active = np.zeros(B, bool)
    active[live] = True
    own = np.arange(B)[:, None] * PP + 1 + np.arange(PP)[None]
    trace = metrics.StepTrace("cpu", metrics.StepTotals(), first="model.decode")
    trace.worked = True
    runner.decode(torch.randn((B, 1, cfg.d_model), generator=gen), own.astype(np.int32),
                  np.full(B, 3, np.int32), active)
    trace.finish()
    kept = [s.kept for s in metrics.spans if s.name == "model.decode"]
    want = [len(set(ids[torch.as_tensor(live)].flatten().tolist())) for ids in seen]
    assert len(seen) == cfg.num_layers and max(want) > cfg.experts_per_token
    assert kept[0]["routed_experts"].tolist() == want


def test_a_dense_step_keeps_nothing(monkeypatch):
    monkeypatch.setattr(metrics, "spans", type(metrics.spans)(maxlen=metrics.MAX_SPANS))
    runner, _ = _runners(_config("dense", "float32", ""))
    trace = metrics.StepTrace("cpu", metrics.StepTotals(), first="model.decode")
    trace.worked = True
    runner.decode(torch.randn((B, 1, runner.cfg.d_model)), np.zeros((B, PP), np.int32),
                  np.zeros(B, np.int32), np.ones(B, bool))
    trace.finish()
    assert [s.kept for s in metrics.spans if s.name == "model.decode"] == [{}]


def test_held_launches_are_tallied_apart_on_their_thread():
    import threading

    from repro_torch.kernels import build
    counter = build.LaunchCounter()
    counter.add()
    with counter.held() as held:
        counter.add()
        counter.add(3)
        other = threading.Thread(target=counter.add, args=(10,))
        other.start()
        other.join()
        with counter.held() as inner:
            counter.add(2)
        counter.add()
    assert (counter.value, held, inner) == (11, [5], [2])
    counter.add(held[0])
    assert counter.value == 16


def test_the_cpu_decode_phase_notes_its_layer_loop_and_no_graph(monkeypatch):
    monkeypatch.setattr(metrics, "spans", type(metrics.spans)(maxlen=metrics.MAX_SPANS))
    cfg = _config("moe", "float32", "")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = AREngine("cpu", cfg, params, max_batch=4, chunk_size=16,
                   kv=PagedKVConfig(num_pages=32, page_size=8, max_pages_per_seq=8),
                   default_sampling=SamplingParams(max_new_tokens=4, temperature=0.0))
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.enqueue(i, {"tokens": rng.integers(0, 128, 5 + i).astype(np.int32)},
                    SamplingParams(), {})
    for _ in range(50):
        eng.step()
        if not eng.has_work:
            break
    decode = [s for s in metrics.spans if s.engine == "cpu" and s.name == "model.decode"]
    assert len(decode) >= 3
    for s in decode:
        assert "graph_replays" not in s.counts and "graph_captures" not in s.counts
        assert s.kept["routed_experts"].shape == (cfg.num_layers,)
    assert eng.runner._graph is None
