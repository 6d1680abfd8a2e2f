"""The port's five examples (``examples/*_torch.py``) against the JAX
examples, on the CPU in f32, at the examples' own settings.

Each JAX example is loaded from its file and run through its ``main``,
unchanged; its side is captured by patching the loaded module's globals:
a recording ``Orchestrator`` subclass (it keeps the submitted requests,
taps every edge's payload into the request's data and makes the named AR
stages greedy), wrapped builders that keep the bundle, and for training
a ``jax.jit`` that keeps each step's loss and a checkpoint path under
pytest's ``tmp_path``.  The port's example then runs through its own
``main`` with ``--device cpu`` and the JAX weights carried across
(``convert.params_from_numpy``), the same recording subclass patched in.

Held: greedy tokens equal to JAX's at every AR stage; the planner's
hidden states within 1e-5; DiT outputs by count, shape and finiteness (a
DiT batch shares one noise draw, so their values depend on thread timing;
the DiT's values are held at module level in test_torch_models.py);
train losses within 1e-4 relative at every step; the printed lines the
JAX example's once their numbers are masked.
"""
import dataclasses
import functools
import importlib.util
import pathlib
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.baselines import monolithic as jmono
from repro.configs import base as jbase
from repro.core.orchestrator import Orchestrator as JOrch
from repro.engine.sampling import SamplingParams as JSP
from repro.train import checkpoint as jckpt
from repro_torch.baselines import monolithic as tmono
from repro_torch.configs import base as tbase
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.engine.sampling import SamplingParams as TSP

torch.set_num_threads(1)
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
HIDDEN_TOL = 1e-5
LOSS_RTOL = 1e-4


def _module(name: str) -> types.ModuleType:
    """A fresh module from ``examples/<name>.py`` (examples/ is no package)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _recording(base, sp_cls, greedy=()):
    """``base`` that keeps each instance and its submitted requests, taps
    every edge's payload (tokens, hidden) into ``data["taps"][src]`` and
    makes the ``greedy`` stages' default sampling greedy."""
    class Recording(base):
        made = []

        def __init__(self, graph, engines, *a, **kw):
            for name in greedy:
                n = engines[name].default_sampling.max_new_tokens
                engines[name].default_sampling = sp_cls(max_new_tokens=n, temperature=0.0)
            for edge in graph.edges:
                def tapped(data, payload, inner=edge.transfer, src=edge.src):
                    hidden = payload.get("hidden")
                    data.setdefault("taps", {}).setdefault(src, []).append(
                        {"tokens": [int(t) for t in payload["tokens"]],
                         "hidden": None if hidden is None else np.asarray(hidden)})
                    return inner(data, payload)
                edge.transfer = tapped
            super().__init__(graph, engines, *a, **kw)
            self.submitted = []
            Recording.made.append(self)

        def submit(self, request):
            self.submitted.append(request)
            super().submit(request)
    return Recording


def _keep(fn, store: dict, key: str):
    """``fn`` that also keeps its return value in ``store[key]``."""
    def kept(*a, **kw):
        store[key] = fn(*a, **kw)
        return store[key]
    return kept


def _main(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [str(mod.__file__), *argv])
    mod.main()
    return capsys.readouterr().out


def _shape(text: str) -> list:
    """Printed lines with numbers masked and blanks dropped."""
    return [re.sub(r"\s+", "", re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line))
            for line in text.strip().splitlines()]


def _run_port(mod, argv, monkeypatch, capsys, **run_kw):
    got = {}
    monkeypatch.setattr(mod, "run", _keep(functools.partial(mod.run, **run_kw), got, "out"))
    text = _main(mod, argv, monkeypatch, capsys)
    return got["out"], text


def _taps(req, src):
    return req.data["taps"][src]


# ---------------------------------------------------------------------------
# quickstart: planner (hidden states) -> writer over the shm connector
# ---------------------------------------------------------------------------

def test_quickstart_matches_jax(monkeypatch, capsys):
    jmod, tmod = _module("quickstart"), _module("quickstart_torch")
    jrec, trec = _recording(JOrch, JSP, ("writer",)), _recording(TOrch, TSP, ("writer",))
    monkeypatch.setattr(jmod, "Orchestrator", jrec)
    monkeypatch.setattr(tmod, "Orchestrator", trec)
    jtext = _main(jmod, [], monkeypatch, capsys)
    (jorch,) = jrec.made
    weights = {n: _np(jorch.engines[n].runner.params) for n in ("planner", "writer")}
    out, ttext = _run_port(tmod, ["--device", "cpu"], monkeypatch, capsys, weights=weights)
    (torch_orch,) = trec.made
    assert len(torch_orch.submitted) == len(jorch.submitted) == 4
    for t, j in zip(torch_orch.submitted, jorch.submitted):
        (tp,), (jp,) = _taps(t, "planner"), _taps(j, "planner")
        assert tp["tokens"] == jp["tokens"] and len(tp["tokens"]) == 8
        assert tp["hidden"].shape == jp["hidden"].shape
        np.testing.assert_allclose(tp["hidden"], jp["hidden"], rtol=HIDDEN_TOL, atol=HIDDEN_TOL)
        tw, jw = (list(r.outputs["writer"][0]["tokens"]) for r in (t, j))
        assert tw == jw and len(tw) == 16
    assert [r.req_id for r in out["requests"]] == [r.req_id for r in torch_orch.submitted]
    assert out["connector_stats"] == {k: (s.calls, s.bytes)
                                      for k, s in jorch.connector_stats().items()}
    assert out["connector_stats"]["shm"][0] == 4
    assert _shape(ttext) == _shape(jtext)


# ---------------------------------------------------------------------------
# image_generation: AR -> DiT with TeaCache reuse
# ---------------------------------------------------------------------------

def test_image_generation_matches_jax(monkeypatch, capsys):
    jmod, tmod = _module("image_generation"), _module("image_generation_torch")
    jrec = _recording(JOrch, JSP, ("glm_image_llm",))
    trec = _recording(TOrch, TSP, ("glm_image_llm",))
    built = {}
    monkeypatch.setattr(jmod, "build_ar_dit", _keep(jmod.build_ar_dit, built, "jax"))
    monkeypatch.setattr(jmod, "Orchestrator", jrec)
    monkeypatch.setattr(tmod, "Orchestrator", trec)
    jtext = _main(jmod, [], monkeypatch, capsys)
    _, jengines, jbundle = built["jax"]
    weights = {"llm_params": _np(jbundle["llm_params"]),
               "vq_embed": np.asarray(jbundle["vq_embed"]),
               "dit_params": _np(jengines["glm_image_dit"].params)}
    _, ttext = _run_port(tmod, ["--device", "cpu"], monkeypatch, capsys, weights=weights)
    (jorch,), (torch_orch,) = jrec.made, trec.made
    assert len(torch_orch.submitted) == len(jorch.submitted) == 4
    for t, j in zip(torch_orch.submitted, jorch.submitted):
        (tt,), (jt,) = _taps(t, "glm_image_llm"), _taps(j, "glm_image_llm")
        assert tt["tokens"] == jt["tokens"] and len(tt["tokens"]) == 16
        for r in (t, j):
            (img,) = r.outputs["glm_image_dit"]
            assert np.asarray(img["latent"]).shape == (64, 32)
            assert np.isfinite(img["latent"]).all()
    assert _shape(ttext) == _shape(jtext)


# ---------------------------------------------------------------------------
# omni_serving: Thinker -> Talker -> DiT vocoder, then the monolithic baseline
# ---------------------------------------------------------------------------

def _greedy_jax(logits, temperature, top_k, key):
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def _greedy_torch(logits, temperature, top_k, gen=None):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def test_omni_serving_matches_jax(monkeypatch, capsys):
    jmod, tmod = _module("omni_serving"), _module("omni_serving_torch")
    stages = ("thinker", "talker")
    jrec, trec = _recording(JOrch, JSP, stages), _recording(TOrch, TSP, stages)
    built, mono = {}, {}

    class JMono(jmono.MonolithicQwenOmni):
        def __init__(self, bundle, vocoder, **kw):
            super().__init__(bundle, vocoder, **kw)
            mono["vocoder"] = vocoder[1]

        def run(self, requests):
            mono["results"] = super().run(requests)
            return mono["results"]
    monkeypatch.setattr(jmono, "sample_tokens", _greedy_jax)
    monkeypatch.setattr(tmono, "sample_tokens", _greedy_torch)
    monkeypatch.setattr(jmod, "build_qwen_omni", _keep(jmod.build_qwen_omni, built, "jax"))
    monkeypatch.setattr(jmod, "MonolithicQwenOmni", JMono)
    monkeypatch.setattr(jmod, "Orchestrator", jrec)
    monkeypatch.setattr(tmod, "Orchestrator", trec)
    jtext = _main(jmod, ["--requests", "4"], monkeypatch, capsys)
    _, jengines, jbundle = built["jax"]
    weights = {"thinker_params": _np(jbundle["thinker_params"]),
               "talker_params": _np(jbundle["talker_params"]),
               "codec_embed": np.asarray(jbundle["codec_embed"]),
               "dit_params": _np(jengines["vocoder"].params),
               "vocoder": _np(mono["vocoder"])}
    out, ttext = _run_port(tmod, ["--requests", "4", "--device", "cpu"], monkeypatch, capsys,
                           weights=weights)
    (jorch,), (torch_orch,) = jrec.made, trec.made
    # the warm-up request, then the 4 timed ones
    assert len(torch_orch.submitted) == len(jorch.submitted) == 5
    for t, j in zip(torch_orch.submitted, jorch.submitted):
        for src in stages:
            assert [p["tokens"] for p in _taps(t, src)] == [p["tokens"] for p in _taps(j, src)]
        assert len(_taps(t, "thinker")[0]["tokens"]) == 10
        for r in (t, j):
            chunks = r.outputs["vocoder"]
            assert sorted(c["chunk_index"] for c in chunks) == [0, 1, 2, 3, 4]
            assert sum(np.asarray(c["latent"]).shape[0] for c in chunks) == 80
            assert all(np.isfinite(c["latent"]).all() for c in chunks)
    # the baseline: the pipeline's greedy text, and the JAX baseline's codec
    # tokens (its Talker is fed the text's embeddings, not the Thinker's
    # hidden states, in both packages, so its codec differs from the
    # pipeline's by design)
    assert len(out["monolithic"]) == len(mono["results"]) == 4
    for t, m, jm in zip(out["requests"], out["monolithic"], mono["results"]):
        assert m["text"].tolist() == _taps(t, "thinker")[0]["tokens"]
        np.testing.assert_array_equal(m["text"], jm["text"])
        np.testing.assert_array_equal(m["codec"], jm["codec"])
        assert m["codec"].shape == (40,) and np.isfinite(m["wave"]).all()
    assert out["jct"] > 0 and out["jct_monolithic"] > 0
    assert _shape(ttext) == _shape(jtext)


# ---------------------------------------------------------------------------
# process_isolation: PD with the decode stage as two spawned replicas
# ---------------------------------------------------------------------------

def test_process_isolation_matches_jax_and_the_all_thread_run(monkeypatch, capsys):
    jmod, tmod = _module("process_isolation"), _module("process_isolation_torch")
    jrec, built = _recording(JOrch, JSP), {}
    monkeypatch.setattr(jmod, "build_pd_disaggregated",
                        _keep(jmod.build_pd_disaggregated, built, "jax"))
    monkeypatch.setattr(jmod, "Orchestrator", jrec)
    jtext = _main(jmod, [], monkeypatch, capsys)
    weights = _np(built["jax"][2]["params"])
    threads = tmod.run("cpu", weights, spawn=False)
    out, ttext = _run_port(tmod, ["--device", "cpu"], monkeypatch, capsys, weights=weights)
    (jorch,) = jrec.made

    def tokens(reqs):
        return [[int(x) for x in r.outputs["decode"][0]["tokens"]] for r in reqs]
    got = tokens(out["requests"])
    assert got == tokens(jorch.submitted) == tokens(threads["requests"])
    assert [len(t) for t in got] == [8] * 4
    m = out["decode"]
    assert (m["finished"], m["n_replicas"], m["replica_failures"]) == (4, 2, 0)
    assert [c["device"] for c in out["children"]] == ["cpu", "cpu"]
    assert sum(c["consumed"] for c in out["children"]) == 4
    assert threads["children"] == [] and threads["decode"]["n_replicas"] == 1
    assert ttext.strip().splitlines()[-1] == \
        "decode: finished=4 n_replicas=2 replica_failures=0"
    assert sorted(_shape(ttext)) == sorted(_shape(jtext))


# ---------------------------------------------------------------------------
# train_tiny: AdamW steps, then a checkpoint round trip
# ---------------------------------------------------------------------------

def test_train_tiny_matches_jax_and_its_checkpoint_loads_in_jax(monkeypatch, capsys, tmp_path):
    jmod, tmod = _module("train_tiny"), _module("train_tiny_torch")
    kept = {"losses": []}

    def jit(fn):
        step = jax.jit(fn)

        def recorded(*a):
            out = step(*a)
            kept["losses"].append(float(out[2]["loss"]))
            return out
        return recorded

    def save(path, params, opt, step):
        kept["jax"] = (params, opt)
        jckpt.save(str(tmp_path / "jax.npz"), params, opt, step=step)

    def f32(arch, smoke=False):
        return jbase.get_config(arch, smoke=smoke).replace(dtype="float32")

    def init_opt_state(params, inner=jmod.init_opt_state):
        kept["weights"] = _np(params)
        return inner(params)
    monkeypatch.setattr(jmod, "jax", types.SimpleNamespace(jit=jit, random=jax.random))
    monkeypatch.setattr(jmod, "get_config", f32)
    monkeypatch.setattr(jmod, "init_opt_state", init_opt_state)
    monkeypatch.setattr(jmod, "checkpoint", types.SimpleNamespace(
        save=save, load=lambda path, p, o: jckpt.load(str(tmp_path / "jax.npz"), p, o)))
    argv = ["--steps", "10"]
    jtext = _main(jmod, argv, monkeypatch, capsys)
    cfg = tbase.get_config("internlm2_1_8b", smoke=True).replace(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(f32("internlm2_1_8b", smoke=True))
    ckpt = str(tmp_path / "torch.npz")
    out, ttext = _run_port(tmod, [*argv, "--device", "cpu"], monkeypatch, capsys,
                           weights=kept["weights"], cfg=cfg, ckpt=ckpt)
    assert len(out["losses"]) == len(kept["losses"]) == 10
    np.testing.assert_allclose(out["losses"], kept["losses"], rtol=LOSS_RTOL, atol=0)
    assert out["losses"][-1] < out["losses"][0]
    # the restore is bit for bit, and the port's file loads in the JAX package
    jparams, jopt = kept["jax"]
    restored, _ = out["restored"]
    assert out["restored_step"] == 10
    got, _, step = jckpt.load(ckpt, jparams, jopt)
    assert step == 10
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(out["params"])[0]:
        np.testing.assert_array_equal(np.asarray(flat[path]), leaf.numpy())
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(out["params"])):
        assert torch.equal(a, b)
    assert _shape(ttext) == _shape(jtext)
