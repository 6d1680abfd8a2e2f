"""Each configuration's architecture family (``families/<family>.py``):
the default ``transformer`` hands on to ``weights.py``,
``reference/model.py`` and ``counts.py`` unchanged; ``mamba1`` draws,
counts and serves through a runner with no page pool; a configuration
that names a family with no module is refused."""
import json
import math
import shutil
from unittest import mock

import pytest
import torch

import cpu_cell
from omnibench import counts, harness, spec, weights
from omnibench.reference import model as reference

QWEN = spec.read_json(spec.ROOT / "omnibench/configs/qwen3_moe_30b_a3b.json")["model"]
PD = spec.read_json(spec.ROOT / "omnibench/configs/internlm2_1_8b_pd.json")["model"]
QWEN_CPU = {**QWEN, **cpu_cell.MODEL, **cpu_cell.MOE}
MAMBA = spec.read_json(spec.ROOT / cpu_cell.MAMBA_CONFIG["file"])["model"]
TRANSFORMER, MAMBA1 = spec.family("transformer"), spec.family("mamba1")


def _leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_the_default_family_is_the_transformer():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        assert spec.cell(bench, w["name"]).family == "transformer"
    assert spec.cell(cpu_cell.bench(), cpu_cell.MAMBA_CELL["name"]).family == "mamba1"


def test_transformer_draws_as_weights_does():
    a = dict(_leaves(TRANSFORMER.program_params(QWEN_CPU, 2**31 + 21, "cpu")))
    b = dict(_leaves(weights.program_params(QWEN_CPU, 2**31 + 21, "cpu")))
    assert a.keys() == b.keys() and ("blocks", "moe", "wg") in a
    for path, t in a.items():
        assert t.dtype == b[path].dtype and torch.equal(t, b[path]), path


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_transformer_logits_are_the_references(quant):
    m = dict(QWEN_CPU, dtype="float32")
    seqs, rows = [[3, 1, 4, 1, 5, 9, 2, 6], [5, 3, 5]], [[0, 6, 7], [2]]
    got = TRANSFORMER.logits(m, 2**31 + 22, seqs, rows, "cpu", quant=quant)
    want = reference.logits(m, 2**31 + 22, seqs, rows, "cpu", quant=quant)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("m", [QWEN, PD], ids=["qwen3_moe", "internlm2"])
def test_transformer_counts_are_counts_at_published_widths(m):
    routed = [8] * m["num_layers"] if m.get("num_experts") else None
    contexts = [100, 37, 512]
    assert TRANSFORMER.decode_step(m, contexts, routed) == counts.decode_step(m, contexts, routed)
    assert TRANSFORMER.prefill_chunk_flops(m, 64, 61) == counts.prefill_chunk_flops(m, 64, 61)


def _bench_naming(tmp_path, family) -> dict:
    cfg = spec.read_json(spec.ROOT / cpu_cell.MAMBA_CONFIG["file"])
    cfg["family"] = family
    (tmp_path / "bad.json").write_text(json.dumps(cfg))
    b = cpu_cell.bench()
    for c in b["configs"]:
        if c["name"] == cpu_cell.MAMBA_CONFIG["name"]:
            c["file"] = "bad.json"
    return b


@pytest.mark.parametrize("family", ["no_such_family", "bad family", 7])
def test_a_family_with_no_module_is_refused(tmp_path, family):
    bench = _bench_naming(tmp_path, family)
    with pytest.raises(spec.SpecError):
        spec.cell(bench, cpu_cell.MAMBA_CELL["name"], root=tmp_path)


def test_a_new_family_is_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "omnibench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(here / "families" / "mamba1.py", here / "families" / "demo_family.py")
    monkeypatch.setattr(spec, "HERE", here)
    cell = spec.cell(_bench_naming(tmp_path, "demo_family"), cpu_cell.MAMBA_CELL["name"],
                     root=tmp_path)
    assert cell.family == "demo_family"
    assert callable(spec.load_module("families", "demo_family").logits)


# ---- mamba1 -----------------------------------------------------------------

def test_mamba1_lays_out_the_ports_ssm_tree():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer
    cfg = ModelConfig(**MAMBA)
    want = dict(_leaves(transformer.init_params(cfg, torch.Generator().manual_seed(0))))
    got = dict(_leaves(MAMBA1.program_params(MAMBA, 2**31 + 23, "cpu")))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert (t.shape, t.dtype) == (want[path].shape, want[path].dtype), path


def test_mamba1_layers_are_drawn_again_the_same():
    p = MAMBA1.program_params(MAMBA, 77, "cpu")
    again = weights.draw(MAMBA1.layer_shapes(MAMBA), 77, 1, "cpu")
    for path, t in _leaves(again):
        stacked = p["mamba"]
        for k in path:
            stacked = stacked[k]
        assert torch.equal(stacked[1], t), path
    assert not torch.equal(p["mamba"]["in_proj"][0], again["in_proj"])


SMOKE = dict(num_layers=2, d_model=32, vocab_size=10, ssm_state=4, ssm_expand=2, ssm_conv=4,
             dtype="bfloat16")


def test_mamba1_counts_by_hand():
    # d 32, d_inner 64, n 4, conv 4, dt rank 2: products 32x128 + 64x10 + 2x64 + 64x32
    assert MAMBA1.dims(SMOKE) == (32, 64, 4, 4, 2)
    per_layer_token = 2 * (4096 + 640 + 128 + 2048) + 2 * 4 * 64 + 7 * 64 * 4
    assert MAMBA1.prefill_chunk_flops(SMOKE, 5, 3) == 3 * 2 * per_layer_token
    flops, nbytes = MAMBA1.decode_step(SMOKE, [9, 200])
    assert flops == 2 * (2 * per_layer_token + 2 * 32 * 10)
    # a layer's weights: bf16 ln 32, products 6912, conv 256 + 64; f32 dt_bias, A_log, D
    layer = (32 + 6912 + 256 + 64) * 2 + (64 + 256 + 64) * 4
    state = 2 * 2 * (64 * 4 * 4 + 3 * 64 * 2)         # h f32 and conv bf16, read and written
    assert nbytes == 2 * layer + 320 * 2 + 32 * 2 + 2 * (32 * 2 + state + 10 * 2)
    assert MAMBA1.decode_step(SMOKE, [1, 5000]) == (flops, nbytes)
    with pytest.raises(ValueError):
        MAMBA1.decode_step(SMOKE, [9], routed_experts=[1, 1])


def test_the_mamba1_control_is_coarser_than_its_reference():
    m = dict(MAMBA, dtype="float32")
    seq = list(range(1, 40))
    full = MAMBA1.logits(m, 5, [seq], [list(range(39))], "cpu")[0]
    low = MAMBA1.logits(m, 5, [seq], [list(range(39))], "cpu", quant="fp8")[0]
    err = (full - low).abs().max().item()
    assert 1e-3 < err < 0.5 * full.abs().max().item()


@pytest.fixture(scope="module")
def mamba_runs():
    """An untraced and a traced CPU run of the mamba1 cell, each with what
    it measured and what it logged."""
    out = {}
    for trace in (0, 1):
        seen, lines = {}, []
        real_report = harness.report

        def keep(measured):
            seen["measured"] = measured
            real_report(measured)

        with mock.patch.object(harness, "report", keep), \
                mock.patch.object(harness, "log", lines.append):
            res = cpu_cell.run(cpu_cell.MAMBA_CELL["name"], seed=3000000031, trace=trace)
        out[trace] = (res, seen["measured"], lines)
    return out


def test_a_run_without_a_page_pool_prints_its_metrics_and_verdict(mamba_runs):
    res, measured, lines = mamba_runs[0]
    assert res["correct"], res["compared"]
    assert {"setup_s", "output_tok_per_s"} <= set(res["metrics"])
    assert all(math.isfinite(v["value"]) and v["value"] > 0 for v in res["metrics"].values())
    assert {"logit_gap", "logit_gap_mean", "short_answers"} <= set(res["compared"])
    assert measured.kv_held == {"ar": None}
    assert any(line.startswith("kv held by ar: no page pool") for line in lines)


def test_readers_of_the_runners_spans_read_nothing_without_a_pool(mamba_runs):
    res, measured, _ = mamba_runs[1]
    assert res["correct"], res["compared"]
    assert not [s for s in measured.spans if s.kind in ("decode", "prefill_chunk")]
    printed = set(res["metrics"])
    for name in ("engine.decode_rows_per_step", "model.decode_step_ms",
                 "mfu.decode_step_program", "paged_attention_roofline", "mfu.prefill_step"):
        assert name not in printed, name
    # the program's own spans read as in any run
    assert {"engine.step_ms", "engine.syncs_per_step", "model.decode_host_ms"} <= printed
