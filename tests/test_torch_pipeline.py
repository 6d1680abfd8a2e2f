"""The qwen_omni pipeline served by the port's threaded Orchestrator
against the JAX package's, with the JAX weights carried across, greedy
sampling and the shm connector on the Thinker -> Talker edge.

Thinker and Talker tokens must be identical.  Vocoder latents are
compared by chunk count, index and shape only: which jobs share a DiT
batch depends on thread timing, and the batch shares one noise draw (the
vocoder's values are held at module level in test_torch_models.py).
Also: the connectors' payload flattening, and the serving CLI on the CPU.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.pipelines import build_qwen_omni as jbuild
from repro.core.orchestrator import Orchestrator as JOrch
from repro.core.request import Request as JReq
from repro.engine.sampling import SamplingParams as JSP
from repro_torch.configs.pipelines import build_qwen_omni as tbuild
from repro_torch.connector import tree
from repro_torch.connector.mooncake import make_connector
from repro_torch.convert import params_from_numpy
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.core.request import Request as TReq
from repro_torch.core.worker import ReplicaSet
from repro_torch.engine.sampling import SamplingParams as TSP

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_batch=4, thinker_tokens=6, talker_tokens=18, stream_chunk=6, dit_steps=2,
          prefix_cache=True, seed=0)


def _tap_talker(graph):
    """Record the Talker's streamed token chunks in each request's data."""
    for edge in graph.edges:
        if (edge.src, edge.dst) == ("talker", "vocoder"):
            inner = edge.transfer

            def tapped(data, payload, inner=inner):
                data.setdefault("talker_chunks", []).append(
                    [int(t) for t in payload["tokens"]])
                return inner(data, payload)
            edge.transfer = tapped


def _load(dst, src) -> None:
    """Copy a numpy tree of the JAX package into the port's tensors, in
    place (the engines hold views of these tensors)."""
    if isinstance(dst, dict):
        for k in dst:
            _load(dst[k], src[k])
    else:
        dst.copy_(params_from_numpy(src))


def _serve(build, orch_cls, req_cls, sp_cls, prompts, weights_from=None, **kw):
    graph, engines, bundle = build(**KW, **kw)
    if weights_from is not None:             # carry the JAX weights across
        jeng, jbundle = weights_from
        for name in ("thinker_params", "talker_params"):
            _load(bundle[name], jax.tree.map(np.asarray, jbundle[name]))
        _load(bundle["dit_params"], jax.tree.map(np.asarray, jeng["vocoder"].params))
        bundle["codec_embed"][...] = np.asarray(jbundle["codec_embed"])
    for name in ("thinker", "talker"):
        engines[name].default_sampling = sp_cls(
            max_new_tokens=bundle[f"{name}_tokens"], temperature=0.0)
    _tap_talker(graph)
    orch = orch_cls(graph, engines)
    orch.start()
    reqs = [req_cls(inputs={"tokens": p}) for p in prompts]
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=120.0)
    assert all(r.completion_time is not None and not r.failed for r in reqs)
    return reqs, graph, engines, bundle


def test_qwen_omni_greedy_tokens_match_jax():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 200, size=int(n)).astype(np.int32)
               for n in rng.integers(6, 24, size=5)]
    prompts.append(prompts[0].copy())          # a repeat: prefix-cache hit
    jreqs, _, jeng, jbundle = _serve(jbuild, JOrch, JReq, JSP, prompts)
    treqs, _, teng, _ = _serve(tbuild, TOrch, TReq, TSP, prompts, device="cpu",
                               weights_from=(jeng, jbundle))
    for j, t in zip(jreqs, treqs):
        assert t.data["thinker_tokens"].tolist() == j.data["thinker_tokens"].tolist()
        np.testing.assert_allclose(t.data["thinker_hidden"], j.data["thinker_hidden"],
                                   rtol=1e-4, atol=1e-4)
        assert t.data["talker_chunks"] == j.data["talker_chunks"]
        jc = sorted(j.outputs["vocoder"], key=lambda p: p["chunk_index"])
        tc = sorted(t.outputs["vocoder"], key=lambda p: p["chunk_index"])
        assert [p["chunk_index"] for p in tc] == [p["chunk_index"] for p in jc] == [0, 1, 2]
        for a, b in zip(tc, jc):
            assert a["latent"].shape == b["latent"].shape == (12, 32)
            assert np.isfinite(a["latent"]).all()
    assert teng["thinker"].prefix_stats == jeng["thinker"].prefix_stats


def test_builder_draws_its_own_weights_deterministically():
    _, e1, _ = tbuild(**KW, device="cpu")
    _, e2, _ = tbuild(**KW, device="cpu")
    for name in ("thinker", "talker"):
        a, b = e1[name].runner.params, e2[name].runner.params
        assert torch.equal(a["embed"], b["embed"])
        assert torch.equal(a["blocks"]["mlp"]["wg"], b["blocks"]["mlp"]["wg"])
    assert torch.equal(e1["vocoder"].params["in_proj"], e2["vocoder"].params["in_proj"])


def test_process_isolation_is_refused_clearly():
    """A process stage rebuilds its engine in a spawned child: without a
    picklable engine_spec there is nothing to rebuild from."""
    with pytest.raises(ValueError, match="isolation='process' needs an engine_spec"):
        ReplicaSet("talker", [], lambda *_: None, isolation="process")


# ---------------------------------------------------------------------------
# connectors: payload flattening
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [
    {"tokens": np.arange(4, dtype=np.int32), "hidden": None},
    {"b": [1, (2.5, "x")], "a": {"z": np.ones((2, 3), np.float32), "y": None}},
    [None, (), {}],
    np.zeros(3),
])
def test_tree_round_trip(payload):
    leaves, td = tree.flatten(payload)
    assert all(leaf is not None for leaf in leaves)
    out = tree.unflatten(td, leaves)
    assert _same(out, payload)


def test_tree_orders_dict_keys_like_jax():
    payload = {"b": 1, "a": 2, "c": {"y": 3, "x": 4}}
    assert tree.leaves(payload) == jax.tree.leaves(payload)
    with_none = {"tokens": np.arange(3), "hidden": None}
    assert len(tree.leaves(with_none)) == len(jax.tree.leaves(with_none)) == 1


@pytest.mark.parametrize("kind", ["shm", "mooncake", "inline"])
def test_connector_round_trips_talker_payload(kind):
    conn = make_connector(kind)
    payload = {"tokens": np.arange(16, dtype=np.int32), "hidden": None}
    conn.send("k", payload)
    try:
        out = conn.recv("k", timeout=5.0)
    finally:
        conn.release("k")
    assert out["hidden"] is None
    np.testing.assert_array_equal(out["tokens"], payload["tokens"])


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_serve_cli_on_cpu():
    r = _cli("--pipeline", "qwen_omni", "--device", "cpu", "--requests", "2")
    assert r.returncode == 0, r.stderr
    assert "completed 2/2 requests" in r.stdout


@pytest.mark.parametrize("args", [
    ("--pipeline", "pd", "--isolation", "decode=process"),
    ("--pipeline", "qwen3_omni"),
])
def test_serve_cli_other_pipelines_on_cpu(args):
    r = _cli(*args, "--device", "cpu", "--requests", "2")
    assert r.returncode == 0, r.stderr
    assert "completed 2/2 requests" in r.stdout
    if "--isolation" in args:
        assert "replicas: {'prefill': 1, 'decode': 1}" in r.stdout


def test_serve_cli_refuses_missing_card():
    """The default device is cuda; without a card the launcher stops."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _cli("--pipeline", "qwen_omni", "--requests", "1")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
