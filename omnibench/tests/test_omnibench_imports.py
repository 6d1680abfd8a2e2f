"""Nothing the harness loads is JAX or the JAX package, by whole top-level
names, and the references load nothing of the program either."""
import json
import pathlib
import subprocess
import sys

from omnibench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import cpu_cell
res = cpu_cell.run("pd_internlm2.chat_backlog", seconds=1.0, check_modules=True)
print(json.dumps({{"correct": res["correct"], "modules": sorted(sys.modules)}}))
"""

RUN_REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
from omnibench.reference import model
m = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
         vocab_size=64, rope_theta=10000.0, rmsnorm_eps=1e-6, dtype="float32")
model.logits(m, 3, [[1, 2, 3]], [[0, 1, 2]], "cpu")
from omnibench import spec
spec.family("mamba1").logits(dict(num_layers=1, d_model=32, vocab_size=64, rmsnorm_eps=1e-6,
                                  ssm_state=4, ssm_expand=2, ssm_conv=4, dtype="float32"),
                             3, [[1, 2, 3]], [[0, 1, 2]], "cpu")
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=600)
    return out.stdout.strip().splitlines()[-1]


def _tops(names) -> set:
    return {n.split(".")[0] for n in names}


def test_a_run_loads_no_jax_and_no_jax_package():
    res = json.loads(_modules(RUN_TINY.format(root=str(ROOT), src=str(ROOT / "src"),
                                              tests=str(ROOT / "omnibench" / "tests"))))
    assert res["correct"]
    tops = _tops(res["modules"])
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_references_load_nothing_of_the_program():
    tops = _tops(json.loads(_modules(RUN_REFERENCE.format(root=str(ROOT)))))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra_probe", object())
    assert not [n for n in harness.forbidden_modules() if n.startswith("repro_")]
    monkeypatch.setitem(sys.modules, "repro.probe_for_test", object())
    assert "repro" in harness.forbidden_modules()
