"""Small sizes at which the tests drive whole runs on the CPU."""
import time
from unittest import mock

from omnibench import harness, spec

MODEL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512)
MOE = dict(num_experts=4, experts_per_token=2, d_ff=32)
SERVE = dict(max_batch=4, max_seq=256)
OPEN = dict(loop="open", rate_per_s=3.0, schedule_seed=1, pre_s=1.0, grace_s=30.0,
            prompt=dict(dist="lognormal", mean=48, sigma=0.7, min=8, max=120),
            output=dict(dist="uniform", min=4, max=12))
#: the PD configuration and its closed-loop cell, kept under omnibench/ for a
#: later BENCHMARK.json (its runs on the card spread too widely for any bound:
#: PERF.md); the tests drive them as if BENCHMARK.json named them
PD_CONFIG = {"name": "internlm2_1_8b_pd", "source": "https://arxiv.org/abs/2403.17297",
             "file": "omnibench/configs/internlm2_1_8b_pd.json", "reduced": [],
             "why": "dense GQA at published width and depth, served as the port's two-stage "
                    "PD graph with the KV hop over the shm connector"}
PD_CELL = {"name": "pd_internlm2.chat_backlog", "config": "internlm2_1_8b_pd",
           "traffic": "lmsys_backlog32", "chips": 1,
           "why": "closed loop of 32 clients, LMSYS-Chat-1M lengths: decode at 32 rows "
                  "beside prefill and the PD KV hop"}
PD_PER_LAYER = [
    {"name": "router.queue_p90_ms", "unit": "ms", "better": "lower", "source": "program_counter",
     "layer": "router and stage workers (core/orchestrator.py, core/worker.py)"},
    {"name": "connector.kv_hop_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "connector (connector/shm.py) with PagedRunner.extract_kv and inject_kv"},
    {"name": "mfu.prefill_step", "unit": "%", "better": "higher", "source": "program_span",
     "layer": "model step, prefill (engine/runner.py, models/*)"}]
#: a tiny configuration of the ``mamba1`` family (its file beside this
#: one), served by the port's ``StateRunner``, which keeps no page pool;
#: the tests drive it as the PD cell is driven, at its own sizes
MAMBA_CONFIG = {"name": "mamba1_tiny", "source": "https://arxiv.org/abs/2312.00752",
                "file": "omnibench/tests/mamba1_tiny.json", "reduced": [],
                "why": "attention-free Mamba1 blocks, the recurrent state per slot"}
MAMBA_CELL = {"name": "mamba1_tiny.backlog", "config": "mamba1_tiny",
              "traffic": "alpaca_backlog16", "chips": 1,
              "why": "closed loop at a CPU test's size: the state runner's prefill and decode"}
_load = spec.load_benchmark


def bench() -> dict:
    """BENCHMARK.json with the PD and the mamba1 configurations and cells added."""
    b = _load()
    if PD_CELL["name"] not in {w["name"] for w in b["workloads"]}:
        b["configs"] += [dict(PD_CONFIG), dict(MAMBA_CONFIG)]
        b["workloads"] += [dict(PD_CELL), dict(MAMBA_CELL)]
        for m in b["end_to_end"] + b["per_layer"]:
            if m["name"] == "output_tok_per_s" or m.get("moves") == "output_tok_per_s":
                m["workloads"] += [PD_CELL["name"], MAMBA_CELL["name"]]
        b["per_layer"] += [dict(m, moves="output_tok_per_s", workloads=[PD_CELL["name"]])
                           for m in PD_PER_LAYER]
    return b


CLOSED = dict(loop="closed", clients=4, prompt=dict(dist="uniform", min=8, max=40),
              output=dict(dist="uniform", min=6, max=16))


def run(workload: str, seed: int = 2147483649, seconds: float = 2.0, trace: int = 0,
        check_modules: bool = False, loop: str = ""):
    """One run of ``workload`` on the CPU at small sizes: the result line's
    object.  The traffic keeps the cell's loop unless ``loop`` names the
    other.  Other tests of the process may have loaded the JAX package,
    so the run's own look at the loaded modules is off unless asked for."""
    moe = workload.startswith("moe")
    # the mamba1 configuration is already at a CPU test's size
    model = {} if workload == MAMBA_CELL["name"] else dict(MODEL, **(MOE if moe else {}))
    loop = loop or spec.cell(bench(), workload).traffic["loop"]
    traffic = OPEN if loop == "open" else CLOSED
    args = harness.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    with mock.patch.object(spec, "load_benchmark", bench):
        return harness.run_once(args, time.perf_counter(), device="cpu", model_override=model,
                                serve_override=SERVE, traffic_override=traffic,
                                require_card=False, check_modules=check_modules)
