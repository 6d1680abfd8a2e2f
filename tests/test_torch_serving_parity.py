"""Serving behaviours of the port held against the JAX package's, each
scenario run through both packages on the CPU at a tiny size with greedy
sampling (``default_sampling`` at temperature 0 on both packages'
engines) and the JAX weights carried across:

  - the PD hop's bf16 KV: the port ships the pool's 16-bit pattern with a
    dtype tag, bit for bit the JAX package's ``ml_dtypes`` bf16, and its
    round trip through ``inject_kv`` is exact;
  - preemption under page pressure (flat and radix prefix indexes);
  - ``TransferTimeout`` attribution (key and edge);
  - ``round_robin`` and ``affinity`` routing over real engines;
  - the online Poisson front end (``serve_online``);
  - the ``Orchestrator`` legacy-kwargs ``DeprecationWarning`` shim.
"""
import argparse
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.connector.base import TransferHandle as JHandle
from repro.connector.base import TransferTimeout as JTimeout
from repro.connector.mooncake import make_connector as jmake_connector
from repro.connector.shm import SharedMemoryConnector as JShm
from repro.core import orchestrator as jorch
from repro.core.config import ServeConfig as JServeConfig
from repro.core.graph import StageGraph as JGraph
from repro.core.request import Request as JReq
from repro.core.stage import StageSpec as JSpec
from repro.core.worker import StageInput as JInput
from repro.engine import ar_engine as jar
from repro.engine import runner as jrun
from repro.engine.kv_cache import PagedKVConfig as JKV
from repro.engine.sampling import SamplingParams as JSP
from repro.engine.stub_engine import make_stub as jmake_stub
from repro.launch import serve as jserve
from repro.models import transformer as jT
from repro_torch.configs.pipelines import build_pd_disaggregated, tiny_lm
from repro_torch.connector.base import TransferHandle as THandle
from repro_torch.connector.base import TransferTimeout as TTimeout
from repro_torch.connector.mooncake import make_connector as tmake_connector
from repro_torch.connector.shm import SharedMemoryConnector as TShm
from repro_torch.convert import params_from_numpy
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.core.graph import StageGraph as TGraph
from repro_torch.core.request import Request as TReq
from repro_torch.core.stage import StageSpec as TSpec
from repro_torch.core.worker import StageInput as TInput
from repro_torch.engine import ar_engine as tar
from repro_torch.engine import runner as trun
from repro_torch.engine.kv_cache import PagedKVConfig as TKV
from repro_torch.engine.sampling import SamplingParams as TSP
from repro_torch.engine.stub_engine import make_stub as tmake_stub
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tT

torch.set_num_threads(1)

JAX = dict(ar=jar, KV=JKV, SP=JSP, Graph=JGraph, Spec=JSpec, Req=JReq, orch=jorch,
           Config=JServeConfig, Input=JInput, Shm=JShm, Handle=JHandle, Timeout=JTimeout,
           stub=jmake_stub, serve=jserve, connector=jmake_connector)
PORT = dict(ar=tar, KV=TKV, SP=TSP, Graph=TGraph, Spec=TSpec, Req=TReq, orch=torch_orch,
            Config=TServeConfig, Input=TInput, Shm=TShm, Handle=THandle, Timeout=TTimeout,
            stub=tmake_stub, serve=tserve, connector=tmake_connector)


def _lm(dtype="float32", seed=5):
    cfg = tiny_lm("t", vocab=256).replace(dtype=dtype)
    jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    jp = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    return {id(JAX): (jcfg, jp), id(PORT): (cfg, params_from_numpy(jax.tree.map(np.asarray,
                                                                                 jp)))}


def _engine(pkg, models, name="eng", **kw):
    cfg, params = models[id(pkg)]
    kv = kw.pop("kv", dict(num_pages=64, page_size=8, max_pages_per_seq=16))
    n_new = kw.pop("n_new", 8)
    return pkg["ar"].AREngine(name, cfg, params, kv=pkg["KV"](**kv),
                              default_sampling=pkg["SP"](max_new_tokens=n_new,
                                                         temperature=0.0), **kw)


def _drain(eng, prompts):
    for i, p in enumerate(prompts):
        eng.enqueue(i, {"tokens": p}, None, {})
    out = {}
    for _ in range(3000):
        for ev in eng.step():
            if ev.kind == "finished":
                out[ev.req_id] = [int(t) for t in ev.payload["tokens"]]
        if not eng.has_work:
            break
    return out


# ---------------------------------------------------------------------------
# the PD hop: bf16 KV as its bits
# ---------------------------------------------------------------------------

KV = dict(num_pages=40, page_size=8, max_pages_per_seq=8)


def test_bf16_extract_kv_bits_equal_jax_and_round_trip_exactly():
    models = _lm("bfloat16")
    (jcfg, jp), (cfg, tp) = models[id(JAX)], models[id(PORT)]
    jr, tr = jrun.PagedRunner(jcfg, jp, JKV(**KV)), trun.PagedRunner(cfg, tp, TKV(**KV))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, size=19).astype(np.int32)
    bt = np.array([3, 7, 9, 0, 0, 0, 0, 0], np.int32)
    emb = jr.embed(prompt)
    e = np.pad(emb, ((0, 5), (0, 0)))[None]
    jr.prefill_chunk(jax.numpy.asarray(e), bt, 0, 19)
    tr.prefill_chunk(torch.from_numpy(e), bt, 0, 19)
    # the same pool bits in both packages first (a last-ulp difference of
    # a projection could flip a bf16 rounding): the JAX pool, carried over
    tr.k_pages = params_from_numpy(np.asarray(jr.k_pages))
    tr.v_pages = params_from_numpy(np.asarray(jr.v_pages))
    jk, jv = jr.extract_kv(bt, 19)
    tk, tv, tag = tr.extract_kv(bt, 19)
    assert tag == "bfloat16" and tk.dtype == np.int16 and tk.shape == jk.shape
    assert tk.nbytes == 2 * tk.size                        # half the f32 payload
    np.testing.assert_array_equal(tk.view(np.uint16), np.asarray(jk).view(np.uint16))
    np.testing.assert_array_equal(tv.view(np.uint16), np.asarray(jv).view(np.uint16))
    # the round trip: injected into other pages, the same bits come back
    before = (tr.k_pages.clone(), tr.v_pages.clone())
    dst = np.array([20, 21, 22, 0, 0, 0, 0, 0], np.int32)
    tr.inject_kv(tk, tv, dst, 19, tag)
    assert torch.equal(tr.k_pages[:, 20:23].view(torch.int16),
                       before[0][:, [3, 7, 9]].view(torch.int16))
    assert torch.equal(tr.v_pages[:, 20:23].view(torch.int16),
                       before[1][:, [3, 7, 9]].view(torch.int16))
    k2, v2, _ = tr.extract_kv(dst, 19)
    np.testing.assert_array_equal(k2, tk)
    np.testing.assert_array_equal(v2, tv)


def test_bf16_pd_hop_carries_half_the_bytes_and_the_unified_tokens():
    """A bf16 PD pipeline (thread stages, shm connector) serves the tokens
    of a unified engine on the same weights, and its connector carries
    the KV as 2-byte elements."""
    cfg = tiny_lm("pd_lm", vocab=512).replace(dtype="bfloat16")
    graph, engines, bundle = build_pd_disaggregated(cfg, max_batch=2, max_new=6,
                                                    device="cpu", seed=1)
    orch = torch_orch.Orchestrator(graph, engines)
    orch.start()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in (9, 17, 30)]
    reqs = [TReq(inputs={"tokens": p}) for p in prompts]
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=60.0)
    assert all(not r.failed for r in reqs)
    got = [[int(t) for t in r.outputs["decode"][0]["tokens"]] for r in reqs]
    unified = tar.AREngine("u", cfg, bundle["params"], kv=engines["decode"].kv, max_batch=2,
                           default_sampling=TSP(max_new_tokens=6, temperature=0.0))
    want = _drain(unified, prompts)
    assert got == [want[i] for i in range(3)]
    pages = sum(-(-len(p) // engines["prefill"].kv.page_size) for p in prompts)
    kv_bytes = 2 * cfg.num_layers * pages * engines["prefill"].kv.page_size \
        * cfg.num_kv_heads * cfg.head_dim * 2
    st = orch.connector_stats()["shm"]
    assert st.calls == 3 and kv_bytes <= st.bytes < kv_bytes + 3 * 4096
    assert engines["decode"].kv_injects == 3 and engines["decode"].kv_inject_time > 0


# ---------------------------------------------------------------------------
# preemption under page pressure
# ---------------------------------------------------------------------------

def _greedy_reference(cfg, params, prompt, n_new):
    """The port's dense-cache path, one request alone."""
    logits, cache = tT.forward_prefill(cfg, params, torch.from_numpy(prompt).long()[None], 256)
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = tT.forward_decode(cfg, params, cache, torch.tensor([[out[-1]]]),
                                          torch.tensor([pos]))
        out.append(int(torch.argmax(logits[0, 0])))
        pos += 1
    return out


@pytest.mark.parametrize("index", ["flat", "radix"])
def test_preemption_under_page_pressure_matches_jax(index):
    """test_preemption.py's setup: a pool of 12 pages of 8 holds two of
    the three 40-token prompts but not their growth over 16 tokens."""
    models = _lm()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=40).astype(np.int32) for _ in range(3)]
    res = {}
    for pkg in (JAX, PORT):
        eng = _engine(pkg, models, kv=dict(num_pages=12, page_size=8, max_pages_per_seq=12),
                      n_new=16, max_batch=3, enable_prefix_cache=True, prefix_index=index)
        eng.scheduler.enable_preemption = True
        res[id(pkg)] = (_drain(eng, prompts), eng.scheduler.preemptions, eng.prefix_stats)
    (jtok, jpre, jstats), (ttok, tpre, tstats) = res[id(JAX)], res[id(PORT)]
    assert tpre == jpre >= 1, "the scenario must preempt"
    assert ttok == jtok and len(ttok) == 3
    assert tstats == jstats
    cfg, params = models[id(PORT)]
    for i, p in enumerate(prompts):                     # and as if unpressured
        assert ttok[i] == _greedy_reference(cfg, params, p, 16)


# ---------------------------------------------------------------------------
# TransferTimeout attribution
# ---------------------------------------------------------------------------

def _blackhole(pkg):
    class Blackhole(pkg["Shm"]):
        """send() publishes nowhere: every recv waits out its timeout."""

        def send(self, key, payload):
            return pkg["Handle"](key=key, nbytes=0, t_send=time.time())
    return Blackhole()


def test_transfer_timeout_names_the_same_key_and_edge():
    errs, failed = {}, {}
    for pkg in (JAX, PORT):
        with pytest.raises(pkg["Timeout"]) as ei:
            pkg["connector"]("inline").recv("missing", timeout=0.01)
        e = ei.value.with_edge("prefill->decode")
        errs[id(pkg)] = (e.key, e.edge, e.connector, e.timeout, str(e))
        graph = pkg["Graph"]()
        graph.add_stage(pkg["Spec"]("a", "custom"))
        graph.add_stage(pkg["Spec"]("b", "custom", is_output=True))
        graph.add_edge("a", "b", lambda d, p: p, connector="shm")
        orch = pkg["orch"].Orchestrator(graph, {"a": pkg["stub"]("a"), "b": pkg["stub"]("b")},
                                        connectors={"shm": _blackhole(pkg)},
                                        config=pkg["Config"](recv_timeout=0.05))
        orch.submit(pkg["Req"](inputs={"x": 1}, req_id=7001))
        done = orch.run(timeout=30.0)
        assert len(done) == 1 and orch.worker_error is None
        failed[id(pkg)] = done[0].failed
    assert errs[id(PORT)] == errs[id(JAX)]
    assert failed[id(PORT)] == failed[id(JAX)]
    assert "a->b" in failed[id(PORT)] and "7001" in failed[id(PORT)]


# ---------------------------------------------------------------------------
# round_robin and affinity routing
# ---------------------------------------------------------------------------

class _Worker:
    def __init__(self, engine, load):
        self.engine, self._load = engine, load

    def load(self):
        return self._load


def test_routing_picks_the_same_replicas():
    """Three replicas of a prefix-caching engine per package, each warmed
    with other prompts; the two policies route a seeded sequence of
    requests (shared prefixes, fresh prompts, changing loads) alike."""
    models = _lm()
    rng = np.random.default_rng(2)
    bases = [rng.integers(0, 256, size=n).astype(np.int32) for n in (24, 33, 17)]
    picks = {}
    for pkg in (JAX, PORT):
        engines = [_engine(pkg, models, name=f"r{i}", n_new=2, enable_prefix_cache=True)
                   for i in range(3)]
        for i, eng in enumerate(engines):               # replica i holds bases[:i + 1]
            _drain(eng, bases[:i + 1])
        order = np.random.default_rng(3)
        seq = []
        for policy in ("round_robin", "affinity"):
            pol = pkg["orch"].make_routing_policy(policy)
            for step in range(12):
                loads = order.integers(0, 4, size=3)
                workers = [(rid, _Worker(e, int(ld))) for rid, (e, ld)
                           in enumerate(zip(engines, loads))]
                b = bases[int(order.integers(0, 3))]
                toks = (np.concatenate([b[:int(order.integers(8, len(b) + 1))],
                                        order.integers(0, 256, size=3).astype(np.int32)])
                        if step % 4 else order.integers(0, 256, size=12).astype(np.int32))
                item = pkg["Input"](pkg["Req"](inputs={"tokens": toks}), None,
                                    inputs={"tokens": toks})
                seq.append((policy, pol.select("s", workers, item)))
        picks[id(pkg)] = seq
    assert picks[id(PORT)] == picks[id(JAX)]
    affinity = [rid for p, rid in picks[id(PORT)] if p == "affinity"]
    assert len(set(affinity)) > 1                     # the scenario routes both ways


# ---------------------------------------------------------------------------
# the online Poisson front end
# ---------------------------------------------------------------------------

def test_serve_online_serves_the_same_trace():
    models = _lm()
    outs = {}
    for pkg in (JAX, PORT):
        graph = pkg["Graph"]()
        graph.add_stage(pkg["Spec"]("lm", "ar", is_output=True))
        eng = _engine(pkg, models, name="lm", n_new=5, max_batch=4)
        orch = pkg["orch"].Orchestrator(graph, {"lm": eng}, config=pkg["Config"].from_args(
            argparse.Namespace(backend="threaded")))
        reqs, _ = pkg["serve"].serve_online(orch, None, n_requests=7, rate_hz=80.0,
                                            max_inflight=3, seed=11, verbose=False)
        assert all(r.completion_time is not None and not r.failed for r in reqs)
        outs[id(pkg)] = [([int(t) for t in r.inputs["tokens"]],
                          [int(t) for t in r.outputs["lm"][0]["tokens"]]) for r in reqs]
    assert len(outs[id(PORT)]) == len(outs[id(JAX)]) == 7
    assert outs[id(PORT)] == outs[id(JAX)]


# ---------------------------------------------------------------------------
# the legacy kwargs shim
# ---------------------------------------------------------------------------

def test_legacy_kwargs_shim_warns_alike():
    res = {}
    for pkg in (JAX, PORT):
        graph = pkg["Graph"]()
        graph.add_stage(pkg["Spec"]("s", "custom", is_output=True))
        with pytest.warns(DeprecationWarning) as rec:
            orch = pkg["orch"].Orchestrator(
                graph, {"s": pkg["stub"]("s")},
                replicas={"s": 2},                 # noqa: DEP002 (shim test)
                routing="round_robin",             # noqa: DEP002 (shim test)
                engine_factories={"s": lambda pkg=pkg: pkg["stub"]("s")})  # noqa: DEP002
        orch.submit(pkg["Req"](inputs={"x": 1}))
        done = orch.run()
        assert len(done) == 1 and not done[0].failed
        # the same words but for the package's name
        res[id(pkg)] = ([str(w.message).replace("repro_torch.", "repro.") for w in rec
                         if w.category is DeprecationWarning],
                        orch.config.stage("s").replicas, orch.config.routing)
    assert res[id(PORT)] == res[id(JAX)]
    assert res[id(PORT)][1:] == (2, "round_robin") and res[id(PORT)][0]
