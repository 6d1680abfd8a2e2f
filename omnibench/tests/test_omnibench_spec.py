"""BENCHMARK.json keeps the contract's rules, and its files are found by name."""
import json
import pathlib
import re
import shutil

import pytest

import cpu_cell
from omnibench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_validates():
    spec.validate(BENCH)


def test_names_units_and_text_fields():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and all(NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"])
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_files_under_paths_are_named_from_name_characters():
    root = spec.ROOT
    for p in BENCH["paths"]:
        for f in (root / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(f.relative_to(root))), f


@pytest.mark.parametrize("bench", [BENCH, cpu_cell.bench()], ids=["benchmark", "with_pd"])
def test_every_cell_resolves_with_its_metrics_and_limits(bench):
    spec.validate(bench)
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        spec.load_module("graphs", cell.config["graph"])
        fam = spec.family(cell.family)
        for fn in ("program_params", "logits", "decode_step", "prefill_chunk_flops"):
            assert callable(getattr(fam, fn)), (cell.family, fn)
        assert {"logit_gap", "logit_gap_mean"} & set(cell.limits)


def test_a_new_cell_is_found_by_name_without_editing_a_file(tmp_path, monkeypatch):
    here = tmp_path / "omnibench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "traffic" / "burst_demo.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 2.0, "pre_s": 1.0,
         "prompt": {"dist": "uniform", "min": 8, "max": 16},
         "output": {"dist": "uniform", "min": 4, "max": 8}}))
    (here / "metrics" / "demo.count").with_suffix(".count.py").write_text(
        "def read(measured):\n    return 7.0\n")
    (here / "limits" / "pd_internlm2.burst_demo.json").write_text('{"logit_gap": 1.0}')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(cpu_cell.PD_CONFIG))
    bench["workloads"].append({"name": "pd_internlm2.burst_demo", "config": "internlm2_1_8b_pd",
                               "traffic": "burst_demo", "chips": 1, "why": "a demo"})
    bench["per_layer"].append({"name": "demo.count", "unit": "n", "better": "lower",
                               "source": "program_counter", "layer": "device",
                               "moves": "output_tok_per_s"})
    bench["end_to_end"][1]["workloads"].append("pd_internlm2.burst_demo")
    monkeypatch.setattr(spec, "HERE", here)
    spec.validate(bench)
    cell = spec.cell(bench, "pd_internlm2.burst_demo")
    assert cell.traffic["rate_per_s"] == 2.0
    assert "demo.count" in {m["name"] for m in cell.per_layer}
    assert spec.load_module("metrics", "demo.count").read(None) == 7.0


def test_unknown_workload_is_refused():
    with pytest.raises(spec.SpecError):
        spec.cell(BENCH, "no_such.cell")


def test_config_files_hold_the_published_widths():
    pd = spec.read_json(spec.ROOT / "omnibench/configs/internlm2_1_8b_pd.json")["model"]
    assert (pd["num_layers"], pd["d_model"], pd["num_heads"], pd["num_kv_heads"],
            pd["head_dim"], pd["d_ff"], pd["vocab_size"]) == (24, 2048, 16, 8, 128, 8192, 92544)
    moe = spec.read_json(spec.ROOT / "omnibench/configs/qwen3_moe_30b_a3b.json")["model"]
    assert (moe["num_layers"], moe["d_model"], moe["num_heads"], moe["num_kv_heads"],
            moe["head_dim"], moe["d_ff"], moe["vocab_size"], moe["num_experts"],
            moe["experts_per_token"]) == (48, 2048, 32, 4, 128, 768, 151936, 128, 8)
    assert pathlib.Path(spec.ROOT / "omnibench/configs").is_dir()
