"""The ``jamba`` family (``families/jamba.py``) and the readers of its cell:
a tiny configuration of it (``jamba_tiny.json`` beside this file) served on
the CPU through ``graphs/ar.py`` and ``PagedRunner`` comes out correct,
and not correct under three planted faults of the per-slot Mamba state
and the router; its counts at published widths are the hand counts; the
two readers added with it read planted slices and spans."""
import time
from collections import deque
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from omnibench import counts, harness, probes, spec, weights
from repro_torch.core import metrics as program_metrics
from repro_torch.engine.runner import PagedRunner
from repro_torch.models import moe

JAMBA = spec.family("jamba")
PUBLISHED = spec.read_json(spec.ROOT / "omnibench/configs/jamba2_mini_ep2.json")["model"]
TINY_CONFIG = {"name": "jamba_tiny",
               "source": "https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json",
               "file": "omnibench/tests/jamba_tiny.json", "reduced": [],
               "why": "one period of Jamba's interleaved layers at a CPU test's size"}
TINY_CELL = {"name": "jamba_tiny.backlog", "config": "jamba_tiny", "traffic": "lmsys_backlog32",
             "chips": 1, "why": "closed loop at a CPU test's size: prompts over several chunks "
                                "beside other requests' decode"}
#: prompts of 1 to 4 chunks of 16 (the tiny configuration's chunk)
CLOSED = dict(loop="closed", clients=4, prompt=dict(dist="uniform", min=8, max=60),
              output=dict(dist="uniform", min=6, max=16))
OPEN = dict(loop="open", rate_per_s=3.0, schedule_seed=1, pre_s=1.0, grace_s=30.0,
            prompt=dict(dist="lognormal", mean=30, sigma=0.7, min=8, max=60),
            output=dict(dist="uniform", min=4, max=12))
_load = spec.load_benchmark


def bench() -> dict:
    """BENCHMARK.json with the tiny configuration and its cell added, reported
    by every metric that the published cell reports."""
    b = _load()
    b["configs"].append(dict(TINY_CONFIG))
    b["workloads"].append(dict(TINY_CELL))
    for m in b["end_to_end"] + b["per_layer"]:
        if "jamba2_mini.chat_backlog" in m.get("workloads", []):
            m["workloads"].append(TINY_CELL["name"])
    return b


def run(seed: int = 2147483653, trace: int = 0, loop: str = "closed", seconds: float = 2.0):
    args = harness.parse(["--workload", TINY_CELL["name"], "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    with mock.patch.object(spec, "load_benchmark", bench):
        return harness.run_once(args, time.perf_counter(), device="cpu",
                                traffic_override=CLOSED if loop == "closed" else OPEN,
                                require_card=False, check_modules=False)


# ---- whole runs on the CPU ----------------------------------------------------

@pytest.mark.parametrize("loop", ["closed", "open"])
def test_a_sound_run_is_correct(loop):
    res = run(loop=loop)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"setup_s", "output_tok_per_s"} <= set(res["metrics"])


def test_a_traced_run_prints_the_cells_metrics():
    res = run(trace=1, seed=2147483659)
    assert res["correct"], res["compared"]
    printed = res["metrics"]
    # prompts of up to 60 tokens in chunks of 16: 1 to 4 chunks each (the few
    # prompts a slow traced window begins may be one chunk each)
    assert 1 <= printed["engine.prefill_chunks_per_prompt"]["value"] <= 4
    for name in ("engine.decode_rows_per_step", "model.decode_step_ms",
                 "mfu.decode_step_program", "engine.step_ms", "model.decode_host_ms"):
        assert name in printed, name
    # the kernels' and the device's readers need the card's profile
    assert "mamba1_scan_roofline" not in printed


def _state_dropped_at_a_chunk_boundary(monkeypatch):
    """Every prefill chunk scans from a zero state."""
    orig = PagedRunner._prefill_mamba
    monkeypatch.setattr(PagedRunner, "_prefill_mamba",
                        lambda self, j, p, hn, slot, start, valid:
                        orig(self, j, p, hn, slot, 0, valid))


def _inactive_rows_overwritten(monkeypatch):
    """A decode step writes every row's state, an inactive row's too."""
    orig = PagedRunner._decode_mamba
    monkeypatch.setattr(PagedRunner, "_decode_mamba",
                        lambda self, j, p, hn, live: orig(self, j, p, hn, torch.ones_like(live)))


def _router_renormalised(monkeypatch):
    """The top-k weights renormalised to sum to one, as Mixtral's are."""
    orig = moe.route
    monkeypatch.setattr(moe, "route", lambda router, xf, k, renormalize=True:
                        orig(router, xf, k))


@pytest.mark.parametrize("fault", [_state_dropped_at_a_chunk_boundary,
                                   _inactive_rows_overwritten, _router_renormalised],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run()
    assert not res["correct"], res["compared"]


# ---- counts at published widths -----------------------------------------------

def test_what_the_card_holds_at_published_widths():
    """28 Mamba layers of 105,308,448 (with their conv bias and dt, B, C
    norms), 4 attention layers of 41,943,040, 16 dense MLPs and 16 x 8
    held experts of 176,160,768, 16 routers of 4096 x 16, 64 layer norms
    and the final one of 4096, the embedding and the head of 65536 x 4096:
    29.02 B parameters, 58.05 GB in bf16 with the router, dt_bias, A_log
    and D in f32; 16.06 MB of state a slot."""
    params = (28 * 105_308_448 + 4 * 41_943_040 + 16 * 176_160_768
              + 16 * (8 * 176_160_768 + 4096 * 16) + 65 * 4096 + 2 * 65536 * 4096)
    f32 = 16 * 4096 * 16 + 28 * (8192 + 8192 * 16 + 8192)
    assert JAMBA.held(PUBLISHED) == (params, 2 * params + 2 * f32)
    assert params == 29_021_745_024 and 2 * params + 2 * f32 == 58_053_844_736
    assert JAMBA.state_bytes(PUBLISHED) == 28 * (8192 * 16 * 4 + 3 * 8192 * 2) == 16_056_320


def test_a_decode_steps_bytes():
    m, held = PUBLISHED, JAMBA.held(PUBLISHED)[1]
    emb = 65536 * 4096 * 2
    # every expert held routed to, one row of 100 tokens: every weight but the
    # embedding table, the row's embedding, states, K and V of 4 layers, logits
    _, one = JAMBA.decode_step(m, [100], [8] * 16)
    kv = 4 * 2 * 8 * 128 * 2
    assert one == held - emb + 4096 * 2 + 2 * 16_056_320 + 101 * kv + 65536 * 2
    _, fewer = JAMBA.decode_step(m, [100], [7] * 16)
    assert one - fewer == 16 * 3 * 4096 * 14336 * 2
    with pytest.raises(ValueError):
        JAMBA.decode_step(m, [100], [8] * 15)
    with pytest.raises(ValueError):
        JAMBA.decode_step(m, [100])


def test_a_scan_calls_bytes_and_a_prefill_chunks_flops():
    # 32 rows: x, dt and y (8192 bf16 each), B and C (16 bf16), h read and
    # written (8192 x 16 f32); A (8192 x 16) and D (8192) f32 once
    flops, nbytes = JAMBA.scan_decode_call(PUBLISHED, 32)
    assert nbytes == 32 * (3 * 8192 * 2 + 2 * 16 * 2 + 2 * 8192 * 16 * 4) + 8192 * 17 * 4
    assert flops == 32 * (7 * 8192 * 16 + 2 * 8192)
    # a tiny one by hand: d 32, d_inner 64, state 4, conv 4, dt rank 2; two
    # layers, attention at layer 1 (4 heads of 8, 2 KV heads), a MoE of 2
    # of 4 experts (top 2) at layer 1, a dense MLP at layer 0, width 48
    m = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=48,
             vocab_size=10, num_experts=2, router_experts=4, experts_per_token=2,
             ssm_state=4, ssm_expand=2, ssm_conv=4, attn_layer_period=2, attn_layer_offset=1,
             expert_layer_period=2, expert_layer_offset=1, dtype="bfloat16")
    mamba = 2 * (32 * 128 + 64 * 10 + 2 * 64 + 64 * 32) + 2 * 4 * 64 + 7 * 64 * 4
    attn = 2 * (32 * 32 + 2 * 32 * 16 + 32 * 32)
    mlp = 2 * 3 * 32 * 48
    moe_ = 2 * 32 * 4 + mlp * 2 * 2 // 4          # the router, half the top-2 pairs held
    per_token = mamba + mlp + attn + moe_
    assert JAMBA.prefill_chunk_flops(m, 5, 3) == 3 * per_token + 4 * 4 * 8 * (6 + 7 + 8)


# ---- the readers on planted slices and spans ------------------------------------

STEP = "void repro::(anonymous namespace)::mamba1_step_kernel<__nv_bfloat16>(...)"


def _measured(family="jamba", kernels=1000, scan_s=0.0056, steps=4):
    """A slice of 1 s at t 10-11 with ``steps`` decode steps of 32 and 16
    active rows (28 scans each) and the scan's kernel taking ``scan_s``."""
    decode = [probes.Span("decode", "ar", 10.1 + i / 5, 10.2 + i / 5,
                          meta={"contexts": [50] * (32 if i % 2 else 16)})
              for i in range(steps)]
    p = probes.Profile(1.0, 10.0, 11.0, 0.5, {STEP: scan_s, "other": 0.4},
                       {STEP: 28 * steps, "other": 900}, kernels, 1200, [])
    return SimpleNamespace(model=PUBLISHED, profile=p, spans=decode,
                           cell=SimpleNamespace(family=family))


def test_the_scan_roofline_on_a_planted_slice():
    read = spec.load_module("metrics", "mamba1_scan_roofline").read
    bounds = [counts.bound_s(*JAMBA.scan_decode_call(PUBLISHED, r)) for r in (16, 32) * 2]
    want = 100 * (sum(bounds) / 4) / (0.0056 / 112)
    assert read(_measured()) == pytest.approx(want)
    assert 10 < want < 100
    assert read(_measured(kernels=100)) is None            # the slice lost its kernels
    assert read(_measured(family="transformer")) is None   # no Mamba layer
    assert read(_measured(steps=0)) is None


def _prefill(t0, engine="ar", **kept):
    return program_metrics.Span("engine.prefill", engine, t0, t0 + 0.05, 0, counts=kept)


def test_the_chunks_a_prompt_took_on_planted_spans(monkeypatch):
    read = spec.load_module("metrics", "engine.prefill_chunks_per_prompt").read
    measured = SimpleNamespace(records=[SimpleNamespace(stage="ar")], profile=None,
                               in_window=lambda t: 10.0 <= t < 20.0)
    spans = [_prefill(11.0, mamba_resets=2, mamba_carries=1), _prefill(12.0, mamba_carries=2),
             _prefill(13.0, mamba_resets=1),
             # before the window, and another engine's: not counted
             _prefill(5.0, mamba_resets=1, mamba_carries=7),
             _prefill(14.0, engine="other", mamba_carries=9)]
    monkeypatch.setattr(program_metrics, "spans", deque(spans))
    assert read(measured) == pytest.approx((3 + 3) / 3)
    monkeypatch.setattr(program_metrics, "spans", deque([_prefill(11.0, prefill_tokens=40)]))
    assert read(measured) is None                          # a model without Mamba layers
    monkeypatch.delattr(program_metrics, "spans")
    assert read(measured) is None                          # a program without the tracer


# ---- the family's layout --------------------------------------------------------

def test_the_layers_are_drawn_again_the_same():
    m = spec.read_json(spec.ROOT / TINY_CONFIG["file"])["model"]
    p = JAMBA.program_params(m, 77, "cpu")
    for i in (1, 4):                         # Mamba + MoE, attention + dense MLP
        again = weights.draw(JAMBA.layer_leaves(m, i), 77, i, "cpu")
        mixer, ffn = JAMBA.kinds(m)[i]
        rows = {k: sum(k in pair for pair in JAMBA.kinds(m)[:i]) for k in (mixer, ffn)}
        for kind in (mixer, ffn):
            for key, t in again[kind].items():
                got = p[kind][key]
                if isinstance(t, dict):
                    t, got = t["scale"], got["scale"]
                assert torch.equal(got[rows[kind]], t), (i, kind, key)
