#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:
  1. device   — the card's name and power limit (nvidia-smi) and its
                compute capability, which must be (9, 0);
  2. build    — the three CUDA kernels built from
                ``src/repro_torch/kernels/csrc`` for sm_90a (one nvcc per
                source, started together), with each kernel's registers and
                spills from ``-Xptxas -v`` (a spill fails the run);
  3. kernels  — each kernel held against its plain PyTorch version on
                seeded inputs at the serving path's shapes and at full
                width (flash cases name their route, tensor-core or
                CUDA-core; paged cases their split), timed as device time
                with CUDA events fenced by a device-side sleep (``Timer``)
                beside the plain version and one PyTorch library call (a
                yardstick the port never uses); the sub-0.05 ms cases are
                also read from the profiler's kernel events;
  4. qwen_omni — the Thinker -> Talker -> DiT-vocoder pipeline served
                through the port's threaded Orchestrator: two greedy runs,
                backend "cuda" and backend "ref", whose Thinker and Talker
                tokens must be identical; then 8 requests as the CLI serves
                them with the backend forced to "cuda" (launches counted);
  5. full_width — Qwen2.5-14B at its published width served as a one-stage
                AR graph (8 requests, 32 greedy tokens each), then one
                batched decode step with backend "cuda" against "ref";
  6. ssm_full_width — Falcon-Mamba-7B at its published width and depth (64
                Mamba1 layers) served the same way through StateRunner
                (8 requests of 128-1536 tokens, 32 greedy tokens, scan
                launches counted), then one 256-token f32 prefill and one
                batched bf16 decode step with backend "cuda" against "ref";
  7. hybrid   — Zamba2-2.7B at its published width and depth (54 Mamba2
                layers, the shared attention after every sixth) served
                the same way (4 requests, 16 greedy tokens, flash launches
                counted).
Then the ``{"kernels": [...]}`` line (launch counts of the runs that use
each kernel, each counted from 0) and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before the last line.  Without a
CUDA device, or without the package next to this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# tolerances of tests/test_kernels.py: f32 2e-5, bf16 2e-2 (rtol = atol)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# logits of one full-width bf16 decode step, kernel vs plain attention:
# the two sum in different orders in f32 and round to bf16 in each of the
# 48 layers, so they are held to 5% of the logits' largest magnitude
FULL_WIDTH_LOGIT_RTOL = 5e-2
# last-position logits (and final state) of one 64-layer f32 Falcon-Mamba
# prefill, scan kernel vs plain scan: both f32, summed in other orders and
# with fused multiply-adds in the kernel, so held to 1e-3 of the largest
# magnitude
PREFILL_LOGIT_RTOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """Device time of ``fn`` alone, with CUDA events: the median over
    ``iters`` calls after warm-up.  Each call is preceded by a write of
    256 MB, so that it finds the 50 MB L2 cache cold as a layer's decode
    step does, and then by a device-side sleep (``torch.cuda._sleep``)
    three times as long as the host took to enqueue ``fn`` in warm-up,
    plus 200 us.  The start event is recorded after the sleep, so the device
    reaches it only once the call's kernels are queued behind it: the
    interval holds the device time of every kernel ``fn`` launches and
    none of the wrapper's Python.  (Where ``fn`` queues more launches than
    the device's queue holds, as the plain scans do, the interval also
    holds the host's gaps.)"""

    MAX_SLEEP_US = 500_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        self.cycles_per_us = self._calibrate()

    def _calibrate(self) -> float:
        torch = self.torch
        cycles = 20_000_000
        rate = 0.0
        for _ in range(2):                # the first call warms the sleep kernel up
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            torch.cuda._sleep(cycles)
            e.record()
            torch.cuda.synchronize()
            rate = cycles / (s.elapsed_time(e) * 1e3)
        return rate

    def __call__(self, fn, iters: int = 10, warmup: int = 3) -> float:
        torch = self.torch
        enqueue = []
        for _ in range(max(warmup, 2)):
            t = time.perf_counter()
            fn()
            enqueue.append(time.perf_counter() - t)
            torch.cuda.synchronize()
        sleep_us = min(3e6 * max(enqueue[1:]) + 200.0, self.MAX_SLEEP_US)
        cycles = int(self.cycles_per_us * sleep_us)
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def profiled(self, fn, iters: int = 20) -> float:
        """Device time per call of ``fn`` from torch.profiler's events of
        the port's kernels (``PORT_KERNELS``; the L2 flush before each
        call is left out): the cross-check of the event timer.  Each
        kernel counts at its median duration times its launches per call,
        so one slow launch does not move it."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        runs = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA and any(k in ev.name for k in PORT_KERNELS):
                runs.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        return sum(statistics.median(d) * len(d) / iters for d in runs.values()) / 1e3


# names of the port's kernels in the profiler's events
PORT_KERNELS = ("paged_attention", "flash_attention", "mamba1_scan")
# the profiler's own device events, left out of every device time
PROFILER_OVERHEAD = ("Activity Buffer Request", "Runtime Triggered Module Loading",
                     "Lazy Function Loading")


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype: str, rows=None):
    """(max_abs_err, ok) of got vs want with rtol = atol = TOL[dtype]."""
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    err = (g - w).abs()
    tol = TOL[dtype]
    ok = bool((err <= tol + tol * w.abs()).all()) and bool(g.isfinite().all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, F, timer, name, *, B, nq, nkv, hd, page, pp, dtype,
               window=0, quant=False, seed=0, profile=False):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = B * pp + 8

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q = rn(B, nq, hd).to(dt)
    if quant:
        def qz(x):
            s = x.abs().amax(-1) / 127.0 + 1e-8
            return torch.round(x / s[..., None]).to(torch.int8), s
        kp, ks = qz(rn(P, page, nkv, hd))
        vp, vs = qz(rn(P, page, nkv, hd))
    else:
        kp, vp = rn(P, page, nkv, hd).to(dt), rn(P, page, nkv, hd).to(dt)
        ks = vs = None
    bt = torch.randperm(P, generator=g, device="cuda")[:B * pp].reshape(B, pp).int()
    max_len = page * pp
    sl = torch.randint(1, max_len + 1, (B,), generator=g, device="cuda").int()
    sl[0] = 0                      # an inactive decode slot
    sl[-1] = max_len               # a full row
    kw = dict(window=window, k_scale_pages=ks, v_scale_pages=vs)
    got = pa.paged_attention(q, kp, vp, bt, sl, **kw)
    want = ref.paged_attention(q, kp, vp, bt, sl, **kw)
    split = ref.paged_attention_split(q, kp, vp, bt, sl, partition=pa.PARTITION, **kw)
    torch.cuda.synchronize()
    live = (sl > 0).nonzero()[:, 0]
    err, ok = compare(got, want, dtype, rows=live)
    err_split, ok_split = compare(got, split, dtype)
    # seq_len 0 rows: zeros (the plain version averages V there)
    ok = ok and ok_split and bool((got[sl == 0].float() == 0).all())
    plan = pa.plan(B, nq, nkv, hd, page, pp)

    def library():
        # SDPA over the pages gathered by the block table, gather included
        kk, vv = kp[bt.long()], vp[bt.long()]
        if quant:
            kk = (kk.float() * ks[bt.long()][..., None]).to(dt)
            vv = (vv.float() * vs[bt.long()][..., None]).to(dt)
        kk = kk.reshape(B, pp * page, nkv, hd).transpose(1, 2)
        vv = vv.reshape(B, pp * page, nkv, hd).transpose(1, 2)
        j = torch.arange(pp * page, device="cuda")[None, :]
        mask = j < sl[:, None]
        if window:
            mask &= j > sl[:, None] - 1 - window
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv,
                                              attn_mask=mask[:, None, None, :],
                                              enable_gqa=True)

    ms = timer(lambda: pa.paged_attention(q, kp, vp, bt, sl, **kw))
    plain_ms = timer(lambda: ref.paged_attention(q, kp, vp, bt, sl, **kw))
    library_ms = timer(library)
    profiler_ms = (timer.profiled(lambda: pa.paged_attention(q, kp, vp, bt, sl, **kw))
                   if profile else None)
    # bytes the function must move: q, out, the visible tokens' K/V (and
    # scales), the block-table entries and lengths it reads
    sl_l = sl.long()
    first = (sl_l - window).clamp(min=0) if window else torch.zeros_like(sl_l)
    toks = int((sl_l - first).sum())
    pages = int((((sl_l + page - 1) // page) - first // page).clamp(min=0).sum())
    kv_elt = 1 if quant else torch.finfo(dt).bits // 8
    q_bytes = q.numel() * q.element_size()
    nbytes = (2 * q_bytes + 2 * toks * nkv * hd * kv_elt + (8 * toks * nkv if quant else 0)
              + 4 * pages + 4 * B)
    flops = 4.0 * toks * nq * hd
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {"case": name, "B": B, "nq": nq, "nkv": nkv, "hd": hd, "page": page, "pp": pp,
            "dtype": dtype, "kv": "int8" if quant else dtype, "window": window,
            "partition": pa.PARTITION, "splits": plan.splits,
            "ctas": plan.grid[0] * plan.grid[1] * plan.grid[2],
            "kernel_launches_per_call": plan.kernel_launches,
            "max_abs_err": err, "max_abs_err_vs_split_plain": err_split, "ok": ok, "ms": ms,
            "profiler_ms": profiler_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def flash_case(torch, F, timer, name, *, B, sq, sk, nq, nkv, hd, dtype,
               causal=False, window=0, seed=0, profile=False):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, sq, nq, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((B, sk, nkv, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((B, sk, nkv, hd), generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window)
    got = fa.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ok = compare(got, want, dtype)
    qpos = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    attn_mask = None if (not causal and not window) else mask

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask,
                                              enable_gqa=True)

    ms = timer(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = timer(lambda: ref.flash_attention(q, k, v, **kw))
    library_ms = timer(library)
    profiler_ms = timer.profiled(lambda: fa.flash_attention(q, k, v, **kw)) if profile else None
    pairs = int(mask.sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    flops = 4.0 * B * nq * hd * pairs
    b_ms, b_by = bound(nbytes, flops, dtype)
    route = fa.route(dt, hd)
    return {"case": f"{name} [{route}]", "route": route, "B": B, "sq": sq, "sk": sk, "nq": nq,
            "nkv": nkv, "hd": hd, "dtype": dtype, "causal": causal, "window": window,
            "max_abs_err": err, "ok": ok, "ms": ms, "profiler_ms": profiler_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


# per (t, channel, state): dt * A, exp, * h, dt * B, * x, +, * C and the
# add into y (exp counted as one); per (t, channel): D * x and its add
SCAN_FLOPS_PER_STATE = 8
SCAN_FLOPS_PER_CHANNEL = 2
SCAN_LIBRARY = "no single PyTorch call computes a selective scan"


def mamba_case(torch, timer, name, *, Bt, S, di, n, dtype, h0, seed=0, profile=False):
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (rn(Bt, S, di) * 0.5).to(dt_)
    dt = (torch.nn.functional.softplus(rn(Bt, S, di)) * 0.1).to(dt_)
    A = -torch.exp(rn(di, n) * 0.3)
    B, C = rn(Bt, S, n).to(dt_), rn(Bt, S, n).to(dt_)
    D = 1 + 0.1 * rn(di)
    h = rn(Bt, di, n) if h0 else None
    y, hl = ms.mamba1_scan(x, dt, A, B, C, D, h)
    want_y, want_h = ref.mamba1_scan(x, dt, A, B, C, D, h)
    torch.cuda.synchronize()
    err_y, ok_y = compare(y, want_y, dtype)
    err_h, ok_h = compare(hl, want_h, "float32")
    ms_ = timer(lambda: ms.mamba1_scan(x, dt, A, B, C, D, h))
    profiler_ms = timer.profiled(lambda: ms.mamba1_scan(x, dt, A, B, C, D, h)) if profile else None
    plain_ms = timer(lambda: ref.mamba1_scan(x, dt, A, B, C, D, h), iters=3, warmup=1)
    elt = torch.finfo(dt_).bits // 8
    nbytes = (3 * Bt * S * di * elt + 2 * Bt * S * n * elt + 4 * (di * n + di)
              + 4 * Bt * di * n * (2 if h0 else 1))
    flops = Bt * S * di * (SCAN_FLOPS_PER_STATE * n + SCAN_FLOPS_PER_CHANNEL)
    b_ms, b_by = bound(nbytes, flops, "float32")     # the arithmetic is f32 for both types
    return {"case": name, "Bt": Bt, "S": S, "di": di, "n": n, "dtype": dtype, "h0": h0,
            "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y, "max_abs_err_h": err_h,
            "ok": ok_y and ok_h, "ms": ms_, "profiler_ms": profiler_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library": SCAN_LIBRARY, "bound_ms": b_ms, "bound_by": b_by}


def mamba_continuation_case(torch, *, Bt=1, S=512, di=8192, n=16, seed=5):
    """Two halves with the carried state against one whole scan (f32)."""
    from repro_torch.kernels import mamba_scan as ms
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((Bt, S, di), generator=g, device="cuda") * 0.5
    dt = torch.nn.functional.softplus(torch.randn((Bt, S, di), generator=g,
                                                  device="cuda")) * 0.1
    A = -torch.exp(torch.randn((di, n), generator=g, device="cuda") * 0.3)
    B = torch.randn((Bt, S, n), generator=g, device="cuda")
    C = torch.randn((Bt, S, n), generator=g, device="cuda")
    D = torch.ones(di, device="cuda")
    y, h = ms.mamba1_scan(x, dt, A, B, C, D)
    half = S // 2 + 1
    y1, h1 = ms.mamba1_scan(x[:, :half], dt[:, :half], A, B[:, :half], C[:, :half], D)
    y2, h2 = ms.mamba1_scan(x[:, half:], dt[:, half:], A, B[:, half:], C[:, half:], D, h1)
    torch.cuda.synchronize()
    err_y, ok_y = compare(torch.cat([y1, y2], 1), y, "float32")
    err_h, ok_h = compare(h2, h, "float32")
    return {"case": f"continuation {half}+{S - half} vs {S}", "Bt": Bt, "S": S, "di": di,
            "n": n, "dtype": "float32", "max_abs_err": max(err_y, err_h), "ok": ok_y and ok_h}


def phase_kernels(torch, F):
    timer = Timer(torch)
    paged = [
        paged_case(torch, F, timer, "qwen_omni decode (slice)", B=8, nq=4, nkv=2, hd=32,
                   page=16, pp=16, dtype="float32", profile=True),
        paged_case(torch, F, timer, "qwen2.5-14b decode bf16", B=8, nq=40, nkv=8, hd=128,
                   page=16, pp=128, dtype="bfloat16", seed=1, profile=True),
        paged_case(torch, F, timer, "qwen2.5-14b decode f32", B=8, nq=40, nkv=8, hd=128,
                   page=16, pp=128, dtype="float32", seed=2),
        paged_case(torch, F, timer, "int8 pool", B=8, nq=40, nkv=8, hd=128, page=16,
                   pp=128, dtype="bfloat16", quant=True, seed=3),
        paged_case(torch, F, timer, "window 512", B=8, nq=40, nkv=8, hd=128, page=16,
                   pp=128, dtype="bfloat16", window=512, seed=4),
    ]
    flash = [
        flash_case(torch, F, timer, "vocoder self-attn", B=8, sq=32, sk=32, nq=4, nkv=4,
                   hd=32, dtype="float32", profile=True),
        flash_case(torch, F, timer, "vocoder cross-attn", B=8, sq=32, sk=16, nq=4, nkv=4,
                   hd=32, dtype="float32", seed=1),
        flash_case(torch, F, timer, "vocoder cross-attn, last chunk", B=8, sq=16, sk=8,
                   nq=4, nkv=4, hd=32, dtype="float32", seed=2),
    ]
    s = 3
    for dtype in ("bfloat16", "float32"):
        for causal, window in ((True, 0), (False, 0), (True, 256)):
            flash.append(flash_case(
                torch, F, timer, f"full width {dtype} causal={causal} window={window}",
                B=2, sq=1000, sk=1000, nq=40, nkv=8, hd=128, dtype=dtype, causal=causal,
                window=window, seed=s))
            s += 1
    flash.append(flash_case(torch, F, timer, "cross 1000x77 bf16", B=2, sq=1000, sk=77,
                            nq=40, nkv=8, hd=128, dtype="bfloat16", seed=s))
    flash.append(flash_case(torch, F, timer, "zamba2 prefill f32 causal hd 80", B=1, sq=512,
                            sk=512, nq=32, nkv=32, hd=80, dtype="float32", causal=True,
                            seed=s + 1))
    flash.append(flash_case(torch, F, timer, "hd 64 bf16 causal", B=2, sq=1000, sk=1000,
                            nq=16, nkv=16, hd=64, dtype="bfloat16", causal=True, seed=s + 2))
    flash.append(flash_case(torch, F, timer, "zamba2 shape bf16 causal hd 80", B=1, sq=512,
                            sk=512, nq=32, nkv=32, hd=80, dtype="bfloat16", causal=True,
                            seed=s + 3))
    scan = [
        mamba_case(torch, timer, "falcon-mamba decode bf16", Bt=8, S=1, di=8192, n=16,
                   dtype="bfloat16", h0=True, profile=True),
        mamba_case(torch, timer, "falcon-mamba prefill f32 (ragged S)", Bt=1, S=1000,
                   di=8192, n=16, dtype="float32", h0=False, seed=1),
        mamba_case(torch, timer, "smoke f32", Bt=1, S=8, di=512, n=8, dtype="float32",
                   h0=False, seed=2),
        mamba_continuation_case(torch),
    ]
    return {"paged_attention": paged, "flash_attention": flash, "mamba1_scan": scan}


# ---------------------------------------------------------------------------
# phase 4: the qwen_omni pipeline
# ---------------------------------------------------------------------------

def tap_talker_tokens(graph) -> None:
    """Record the Talker's streamed token chunks in each request's data."""
    for edge in graph.edges:
        if (edge.src, edge.dst) == ("talker", "vocoder"):
            inner = edge.transfer

            def tapped(data, payload, inner=inner):
                data.setdefault("talker_chunks", []).append(
                    [int(t) for t in payload["tokens"]])
                return inner(data, payload)
            edge.transfer = tapped


def serve_qwen_omni(torch, backend: str, *, greedy: bool, n_requests: int = 8, seed=0):
    import argparse as _ap

    import numpy as np

    from repro_torch.configs.pipelines import build_qwen_omni
    from repro_torch.core.config import ServeConfig
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.request import Request
    from repro_torch.engine.sampling import SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import _make_inputs

    ops.set_backend(backend)
    graph, engines, bundle = build_qwen_omni(max_batch=8, prefix_cache=True,
                                             device="cuda", seed=seed)
    if greedy:
        for name, n in (("thinker", bundle["thinker_tokens"]),
                        ("talker", bundle["talker_tokens"])):
            engines[name].default_sampling = SamplingParams(max_new_tokens=n,
                                                            temperature=0.0)
    tap_talker_tokens(graph)
    config = ServeConfig.from_args(_ap.Namespace(backend="threaded"),
                                   engine_factories=bundle["engine_factories"],
                                   engine_specs=bundle["engine_specs"])
    orch = Orchestrator(graph, engines, config=config)
    rng = np.random.default_rng(seed)
    reqs = [Request(inputs=_make_inputs(rng)) for _ in range(n_requests)]
    t0 = time.perf_counter()
    orch.start()
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=300.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops.set_backend("auto")
    return orch, reqs, wall, bundle


def check_vocoder(reqs, talker_tokens: int, chunk: int = 16) -> int:
    import numpy as np
    n_chunks = -(-talker_tokens // chunk)
    total = 0
    for r in reqs:
        chunks = sorted(r.outputs.get("vocoder", []), key=lambda p: p["chunk_index"])
        idx = [int(p["chunk_index"]) for p in chunks]
        if idx != list(range(n_chunks)):
            fail(f"request {r.req_id}: vocoder chunk indices {idx}")
        for p in chunks:
            tc = min(chunk, talker_tokens - chunk * int(p["chunk_index"]))
            lat = np.asarray(p["latent"])
            if lat.shape != (2 * tc, 32) or not np.isfinite(lat).all():
                fail(f"request {r.req_id}: latent chunk {p['chunk_index']} has shape "
                     f"{lat.shape} (want {(2 * tc, 32)}) or non-finite values")
            total += 1
    return total


def phase_qwen_omni(torch):
    from repro_torch.core.metrics import summarize
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    # greedy parity first (it also warms the card up): the kernels against
    # their plain versions, both on the card, must give the same tokens
    streams = {}
    for backend in ("cuda", "ref"):
        _, greqs, _, _ = serve_qwen_omni(torch, backend, greedy=True)
        if any(r.failed or r.completion_time is None for r in greqs):
            fail(f"qwen_omni greedy run ({backend}) lost requests")
        streams[backend] = [(r.data["thinker_tokens"].tolist(), r.data["talker_chunks"])
                            for r in greqs]
    if streams["cuda"] != streams["ref"]:
        bad = [i for i, (a, b) in enumerate(zip(streams["cuda"], streams["ref"])) if a != b]
        fail(f"qwen_omni greedy tokens differ between cuda and ref in requests {bad}")

    # the main path as the CLI serves it (sampled tokens), launches counted
    pa.launches.reset()
    fa.launches.reset()
    orch, reqs, wall, bundle = serve_qwen_omni(torch, "cuda", greedy=False)
    launches = {"paged_attention": pa.launches.value, "flash_attention": fa.launches.value}
    done = [r for r in reqs if r.completion_time is not None and not r.failed]
    if len(done) != len(reqs):
        fail(f"qwen_omni: {len(done)}/{len(reqs)} requests completed: "
             f"{[r.failed for r in reqs if r.failed]}")
    chunks = check_vocoder(reqs, bundle["talker_tokens"])
    for k, n in launches.items():
        if n <= 0:
            fail(f"qwen_omni: kernel {k} was not launched on the main path")
    m = summarize(reqs, wall_time=wall)
    # the same run once more under the profiler: where the device time goes
    # (the share is taken over the serving wall time, the build left out)
    (_, _, pwall, _), prof = device_profile(
        torch, lambda: serve_qwen_omni(torch, "cuda", greedy=False))
    prof["serve_wall_ms"] = 1e3 * pwall
    prof["device_busy_share"] = prof["device_ms"] / prof["serve_wall_ms"]
    out = {"phase": "qwen_omni", "requests": len(reqs), "completed": len(done),
           "vocoder_chunks": chunks, "wall_s": wall, "jct_p50_s": m["jct_p50"],
           "jct_p95_s": m["jct_p95"], "ttft_p50_s": m["ttft_p50"],
           "stage_busy_s": orch.stage_busy_times(), "launches": launches,
           "launches_per_request": {k: v / len(reqs) for k, v in launches.items()},
           "profiled_rerun": prof,
           "greedy_tokens_identical": True,
           "greedy_tokens_compared": sum(len(t) + sum(len(c) for c in ch)
                                         for t, ch in streams["cuda"])}
    return out, launches


# ---------------------------------------------------------------------------
# phase 5: Qwen2.5-14B at full width
# ---------------------------------------------------------------------------

def phase_full_width(torch, n_requests=8, max_new=32, seed=0):
    import argparse as _ap

    import numpy as np

    from repro_torch.core.config import ServeConfig
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.request import Request
    from repro_torch.engine.sampling import SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import build_single_arch

    arch = "qwen2_5_14b"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    graph, engines, bundle = build_single_arch(
        arch, 8, max_new, seed, prefix_cache=True, device="cuda", smoke=False,
        max_seq=2048)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    cfg = bundle["cfg"]
    n_params = sum(t.numel() for t in _leaves(bundle["params"]))
    eng = engines[arch]
    eng.default_sampling = SamplingParams(max_new_tokens=max_new, temperature=0.0)
    runner = eng.runner

    # measurement taps: device time of prefill chunks and decode steps
    stats = {"prefill_s": 0.0, "prefill_tokens": 0, "prefill_chunks": 0,
             "decode_s": 0.0, "decode_tokens": 0, "decode_steps": 0}
    first_token = {}
    prefill, decode, sample = runner.prefill_chunk, runner.decode, eng._sample

    def timed_prefill(embeds, block_table, start, valid_len):
        t = time.perf_counter()
        out = prefill(embeds, block_table, start, valid_len)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t
        stats["prefill_tokens"] += int(valid_len)
        stats["prefill_chunks"] += 1
        return out

    def timed_decode(embeds, block_tables, positions, active):
        t = time.perf_counter()
        out = decode(embeds, block_tables, positions, active)
        torch.cuda.synchronize()
        stats["decode_s"] += time.perf_counter() - t
        stats["decode_tokens"] += int(np.asarray(active).sum())
        stats["decode_steps"] += 1
        return out

    def timed_sample(req_id, logits):     # called once per request: its first token
        tok = sample(req_id, logits)
        first_token.setdefault(req_id, time.perf_counter())
        return tok

    runner.prefill_chunk, runner.decode, eng._sample = timed_prefill, timed_decode, \
        timed_sample
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 1537, size=n_requests)
    reqs = [Request(inputs={"tokens": rng.integers(0, cfg.vocab_size, size=int(n))
                            .astype(np.int32)}) for n in lens]
    config = ServeConfig.from_args(_ap.Namespace(backend="threaded"),
                                   engine_factories=bundle["engine_factories"])
    orch = Orchestrator(graph, engines, config=config)
    ops.set_backend("cuda")
    pa.launches.reset()
    t0 = time.perf_counter()
    orch.start()
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=600.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches.value
    ops.set_backend("auto")
    runner.prefill_chunk, runner.decode, eng._sample = prefill, decode, sample
    done = [r for r in reqs if r.completion_time is not None and not r.failed]
    if len(done) != len(reqs):
        fail(f"full width: {len(done)}/{len(reqs)} requests completed")
    for r in reqs:
        toks = np.asarray(r.outputs[arch][0]["tokens"])
        if toks.shape != (max_new,):
            fail(f"full width: request {r.req_id} produced {toks.shape} tokens")
    if launches <= 0:
        fail("full width: paged attention kernel was not launched")
    ttft = sorted(first_token[r.req_id] - r.arrival_time for r in reqs)
    jct = sorted(r.jct for r in reqs)

    # one batched decode step, kernel vs plain attention, on the same pool
    logits = {}
    B = 8
    page = runner.kv.page_size
    positions = (np.asarray(lens) - 1).astype(np.int32)
    tables = np.zeros((B, runner.kv.max_pages_per_seq), np.int32)
    for s in range(B):       # fresh pages, filled by prefill of the same prompts
        tables[s, :] = s * runner.kv.max_pages_per_seq + np.arange(
            runner.kv.max_pages_per_seq)
    for s in range(B):
        n = int(lens[s])
        for c0 in range(0, n - 1, 512):
            c1 = min(c0 + 512, n - 1)
            emb = runner.embed(reqs[s].inputs["tokens"][c0:c1])
            runner.prefill_chunk(torch.as_tensor(emb, device="cuda")[None], tables[s],
                                 c0, c1 - c0)
    last = np.stack([runner.embed(reqs[s].inputs["tokens"][-1:])[0] for s in range(B)])
    embeds = torch.as_tensor(last, device="cuda").to(torch.bfloat16)[:, None]
    active = np.ones(B, bool)
    for backend in ("cuda", "ref"):
        ops.set_backend(backend)
        lg, _ = runner.decode(embeds, tables, positions, active)
        logits[backend] = lg.float()
    torch.cuda.synchronize()
    ops.set_backend("cuda")       # three decode steps, after the warm-up above
    _, busy = device_profile(torch, lambda: [runner.decode(embeds, tables, positions, active)
                                             for _ in range(3)])
    ops.set_backend("auto")
    diff = float((logits["cuda"] - logits["ref"]).abs().max())
    scale = float(logits["ref"].abs().max())
    agree = float((logits["cuda"].argmax(-1) == logits["ref"].argmax(-1)).float().mean())
    if not (diff <= FULL_WIDTH_LOGIT_RTOL * scale and torch.isfinite(logits["cuda"]).all()):
        fail(f"full width decode logits: max |cuda - ref| = {diff} > "
             f"{FULL_WIDTH_LOGIT_RTOL} x {scale}")
    return {"phase": "full_width", "arch": arch, "d_model": cfg.d_model,
            "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "layers": cfg.num_layers, "layers_published": 48, "dtype": cfg.dtype,
            "params": n_params, "init_s": t_init, "requests": len(reqs),
            "completed": len(done), "prompt_lens": [int(n) for n in lens],
            "new_tokens": max_new, "wall_s": wall,
            "prefill_tok_per_s": stats["prefill_tokens"] / stats["prefill_s"],
            "decode_tok_per_s": stats["decode_tokens"] / stats["decode_s"],
            "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
            "prefill_chunks": stats["prefill_chunks"], "decode_steps": stats["decode_steps"],
            "prefill_ms_per_chunk": 1e3 * stats["prefill_s"] / stats["prefill_chunks"],
            "decode_ms_per_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
            "decode_3_steps_profile": busy,
            "ttft_p50_s": ttft[len(ttft) // 2], "jct_p50_s": jct[len(jct) // 2],
            "jct_max_s": jct[-1], "paged_launches": launches,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_logits_max_abs_diff": diff, "decode_logits_max_abs": scale,
            "decode_logits_rtol": FULL_WIDTH_LOGIT_RTOL, "decode_argmax_agree": agree}


# ---------------------------------------------------------------------------
# phases 6 and 7: the SSM and hybrid families through StateRunner
# ---------------------------------------------------------------------------

def _free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve_state_arch(torch, arch, *, n_requests, max_new, lens_range, max_batch, max_seq,
                     counter, seed=0):
    """Serve ``arch``'s published config as a one-stage AR graph through
    the threaded Orchestrator, greedy, backend "cuda", with ``counter``
    (a kernel's launch counter) set to 0 just before and read just after.
    Returns the run's numbers and the objects the checks reuse."""
    import argparse as _ap

    import numpy as np

    from repro_torch.core.config import ServeConfig
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.request import Request
    from repro_torch.engine.sampling import SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_single_arch

    _free(torch)
    t_init = time.perf_counter()
    graph, engines, bundle = build_single_arch(arch, max_batch, max_new, seed, device="cuda",
                                               smoke=False, max_seq=max_seq)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    cfg = bundle["cfg"]
    eng = engines[arch]
    eng.default_sampling = SamplingParams(max_new_tokens=max_new, temperature=0.0)
    runner = eng.runner
    stats = {"prefill_s": 0.0, "prefill_tokens": 0, "prefills": 0,
             "decode_s": 0.0, "decode_tokens": 0, "decode_steps": 0}
    first_token = {}
    prefill, decode, sample = runner.prefill, runner.decode, eng._sample

    def timed_prefill(embeds, slot):
        t = time.perf_counter()
        out = prefill(embeds, slot)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t
        stats["prefill_tokens"] += int(embeds.shape[1])
        stats["prefills"] += 1
        return out

    def timed_decode(embeds, block_tables, positions, active):
        t = time.perf_counter()
        out = decode(embeds, block_tables, positions, active)
        torch.cuda.synchronize()
        stats["decode_s"] += time.perf_counter() - t
        stats["decode_tokens"] += int(np.asarray(active).sum())
        stats["decode_steps"] += 1
        return out

    def timed_sample(req_id, logits):     # called once per request: its first token
        tok = sample(req_id, logits)
        first_token.setdefault(req_id, time.perf_counter())
        return tok

    runner.prefill, runner.decode, eng._sample = timed_prefill, timed_decode, timed_sample
    rng = np.random.default_rng(seed)
    lens = rng.integers(lens_range[0], lens_range[1] + 1, size=n_requests)
    reqs = [Request(inputs={"tokens": rng.integers(0, cfg.vocab_size, size=int(n))
                            .astype(np.int32)}) for n in lens]
    config = ServeConfig.from_args(_ap.Namespace(backend="threaded"),
                                   engine_factories=bundle["engine_factories"])
    orch = Orchestrator(graph, engines, config=config)
    ops.set_backend("cuda")
    counter.reset()
    t0 = time.perf_counter()
    orch.start()
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=600.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.value
    ops.set_backend("auto")
    runner.prefill, runner.decode, eng._sample = prefill, decode, sample
    done = [r for r in reqs if r.completion_time is not None and not r.failed]
    if len(done) != len(reqs):
        fail(f"{arch}: {len(done)}/{len(reqs)} requests completed: "
             f"{[r.failed for r in reqs if r.failed]}")
    for r in reqs:
        toks = np.asarray(r.outputs[arch][0]["tokens"])
        if toks.shape != (max_new,):
            fail(f"{arch}: request {r.req_id} produced {toks.shape} tokens")
    if launches <= 0:
        fail(f"{arch}: the kernel was not launched on the main path")
    ttft = sorted(first_token[r.req_id] - r.arrival_time for r in reqs)
    jct = sorted(r.jct for r in reqs)
    out = {"arch": arch, "d_model": cfg.d_model, "d_inner": cfg.d_inner,
           "ssm_state": cfg.ssm_state, "ssm_version": cfg.ssm_version,
           "layers": cfg.num_layers, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in _leaves(bundle["params"])),
           "param_count_config": cfg.param_count(), "init_s": t_init,
           "requests": len(reqs), "completed": len(done),
           "prompt_lens": [int(n) for n in lens], "new_tokens": max_new, "wall_s": wall,
           "prefill_tok_per_s": stats["prefill_tokens"] / stats["prefill_s"],
           "decode_tok_per_s": stats["decode_tokens"] / stats["decode_s"],
           "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
           "prefills": stats["prefills"], "decode_steps": stats["decode_steps"],
           "prefill_ms_per_request": 1e3 * stats["prefill_s"] / stats["prefills"],
           "decode_ms_per_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
           "ttft_p50_s": ttft[len(ttft) // 2], "jct_p50_s": jct[len(jct) // 2],
           "jct_max_s": jct[-1], "launches": launches,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out, {"runner": runner, "reqs": reqs, "cfg": cfg}


def phase_ssm_full_width(torch):
    """Falcon-Mamba-7B at its published width and depth (64 layers)."""
    import numpy as np

    from repro_torch.engine.runner import _prefill_from_embeds
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops

    arch = "falcon_mamba_7b"
    out, ctx = serve_state_arch(torch, arch, n_requests=8, max_new=32, lens_range=(128, 1536),
                                max_batch=8, max_seq=2048, counter=ms.launches)
    runner, reqs, cfg = ctx["runner"], ctx["reqs"], ctx["cfg"]
    out["phase"] = "ssm_full_width"

    # the kernel against the plain scan: one prompt of 256 tokens, prefilled
    # in f32 with each backend; last-position logits and the final state
    prompt = reqs[0].inputs["tokens"][:256]
    emb = torch.as_tensor(runner.embed(prompt), device="cuda")[None]
    res = {}
    with torch.no_grad():
        for backend in ("cuda", "ref"):
            ops.set_backend(backend)
            logits, cache1 = _prefill_from_embeds(cfg, runner.params, emb, runner.kv.max_seq)
            res[backend] = (logits[0, -1].float(), cache1["ssm_h"])
    ops.set_backend("auto")
    lg_diff = float((res["cuda"][0] - res["ref"][0]).abs().max())
    lg_scale = float(res["ref"][0].abs().max())
    h_diff = float((res["cuda"][1] - res["ref"][1]).abs().max())
    h_scale = float(res["ref"][1].abs().max())
    if not (lg_diff <= PREFILL_LOGIT_RTOL * lg_scale and h_diff <= PREFILL_LOGIT_RTOL * h_scale
            and torch.isfinite(res["cuda"][0]).all()):
        fail(f"falcon-mamba prefill: |cuda - ref| logits {lg_diff} (scale {lg_scale}), "
             f"ssm_h {h_diff} (scale {h_scale}) > {PREFILL_LOGIT_RTOL} of the scale")

    # one batched 8-row decode step, kernel vs plain scan, from the same state
    B = runner.max_batch
    toks = np.array([int(r.outputs[arch][0]["tokens"][-1]) for r in reqs[:B]])
    embeds = torch.as_tensor(runner.embed(toks), device="cuda").to(torch.bfloat16)[:, None]
    positions = np.array([len(r.inputs["tokens"]) + 31 for r in reqs[:B]], np.int32)
    active = np.ones(B, bool)
    saved = {k: v.clone() for k, v in runner.cache.items()}
    dec = {}
    for backend in ("cuda", "ref"):
        for k, v in saved.items():
            runner.cache[k].copy_(v)
        ops.set_backend(backend)
        lg, _ = runner.decode(embeds, None, positions, active)
        dec[backend] = lg.float()
    torch.cuda.synchronize()
    diff = float((dec["cuda"] - dec["ref"]).abs().max())
    scale = float(dec["ref"].abs().max())
    if not (diff <= FULL_WIDTH_LOGIT_RTOL * scale and torch.isfinite(dec["cuda"]).all()):
        fail(f"falcon-mamba decode logits: max |cuda - ref| = {diff} > "
             f"{FULL_WIDTH_LOGIT_RTOL} x {scale}")
    ops.set_backend("cuda")       # three decode steps, after the warm-up above
    _, busy = device_profile(torch, lambda: [runner.decode(embeds, None, positions, active)
                                             for _ in range(3)])
    ops.set_backend("auto")
    out.update({"prefill_check_prompt_len": len(prompt),
                "prefill_logits_max_abs_diff": lg_diff, "prefill_logits_max_abs": lg_scale,
                "prefill_ssm_h_max_abs_diff": h_diff, "prefill_ssm_h_max_abs": h_scale,
                "prefill_rtol": PREFILL_LOGIT_RTOL, "decode_logits_max_abs_diff": diff,
                "decode_logits_max_abs": scale, "decode_logits_rtol": FULL_WIDTH_LOGIT_RTOL,
                "decode_argmax_agree": float((dec["cuda"].argmax(-1)
                                              == dec["ref"].argmax(-1)).float().mean()),
                "decode_3_steps_profile": busy})
    return out


def phase_hybrid(torch):
    """Zamba2-2.7B at its published width and depth: Mamba2 layers (plain
    scan, as in the JAX package) and the shared attention (flash kernel,
    hd 80) after every sixth layer."""
    from repro_torch.kernels import flash_attention as fa
    out, _ = serve_state_arch(torch, "zamba2_2_7b", n_requests=4, max_new=16,
                              lens_range=(128, 512), max_batch=4, max_seq=1024,
                              counter=fa.launches)
    out["phase"] = "hybrid"
    return out


def device_profile(torch, fn):
    """Run ``fn()`` under torch.profiler; return its result and its wall
    time, the device time of the kernels and copies it ran (device-side
    events, from every thread), their share of the wall time (the device's
    busy share) and the top kernels.  The profiler's own buffer and lazy
    loading events are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in PROFILER_OVERHEAD:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_s = sum(per.values()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    # device time of each kernel of the port, all its launches (split and
    # combine kernels of paged attention together)
    ours = {k: sum(us for n, us in per.items() if k in n) / 1e3 for k in PORT_KERNELS}
    return result, {"wall_ms": 1e3 * wall, "device_ms": 1e3 * device_s,
                    "device_busy_share": device_s / wall if device_s else None,
                    "top_device_ms": {k[:60]: us / 1e3 for k, us in top},
                    "port_kernels_device_ms": ours}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------

KERNEL_META = {
    "paged_attention": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:85"},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73"},
    "mamba1_scan": {
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:58"},
}


# a kernel's name and template arguments inside a mangled name
KERNEL_NAME = re.compile(r"((?:flash_attention|paged_attention)_[a-z]+_kernel|mamba1_scan_kernel)"
                         r"(I.*?EE)?")


def kernel_name(text: str):
    m = KERNEL_NAME.search(text)
    return "".join(g or "" for g in m.groups()) if m else None


def ptxas_entries(log: str):
    """Registers and spill bytes of each kernel in nvcc's ``-Xptxas -v``
    output, by the kernel's name and template arguments."""
    entries, cur = [], None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(.*?)'", line)
        if hit:
            cur = {"kernel": kernel_name(hit.group(1)) or hit.group(1), "registers": None,
                   "spill_bytes": 0}
            entries.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill", line)
            cur["spill_bytes"] = sum(int(n) for n in nums)
        elif cur is not None and "Used " in line:
            cur["registers"] = int(line.split("Used ")[1].split()[0])
    return entries


def ptxas_advisories(log: str):
    """ptxas's performance advisories (such as C7520, wgmma serialized),
    each with the kernel it names."""
    out = []
    for line in log.splitlines():
        if "Potential Performance Loss" in line:
            text = line.split("Potential Performance Loss:")[1].split(" in the function")[0]
            out.append({"kernel": kernel_name(line), "advisory": text.strip()})
    return out


def library_of(name: str) -> str:
    """The build name of a kernel: its source file's stem."""
    return os.path.splitext(os.path.basename(KERNEL_META[name]["source"]))[0]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port (src/repro_torch) is not next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch.nn.functional as F

    from repro_torch.kernels import build

    # the plain versions and the model's matmuls run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi, "capability": list(cap),
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": time.perf_counter() - t})
    if tuple(cap) != (9, 0):
        fail(f"compute capability {cap}, need (9, 0)")

    t = time.perf_counter()
    built = build.build(sorted({library_of(k) for k in KERNEL_META}))
    entries = {k: ptxas_entries(str(v["log"])) for k, v in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t, "flags": build.NVCC_FLAGS,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "entries": entries[k],
                          "advisories": ptxas_advisories(str(v["log"]))}
                      for k, v in built.items()}})
    spills = [e for es in entries.values() for e in es if e["spill_bytes"]]
    if spills:
        fail(f"kernels spill registers: {spills}")

    t = time.perf_counter()
    cases = phase_kernels(torch, F)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t, "cases": cases})
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    t = time.perf_counter()
    omni, launches = phase_qwen_omni(torch)
    omni["seconds"] = time.perf_counter() - t
    emit(omni)

    t = time.perf_counter()
    full = phase_full_width(torch)
    full["seconds"] = time.perf_counter() - t
    emit(full)

    t = time.perf_counter()
    ssm = phase_ssm_full_width(torch)
    ssm["seconds"] = time.perf_counter() - t
    emit(ssm)

    t = time.perf_counter()
    hybrid = phase_hybrid(torch)
    hybrid["seconds"] = time.perf_counter() - t
    emit(hybrid)

    # launches of each kernel in the runs that use it, each counted from 0
    by_run = {"paged_attention": {"qwen_omni": launches["paged_attention"],
                                  "full_width": full["paged_launches"]},
              "flash_attention": {"qwen_omni": launches["flash_attention"],
                                  "hybrid": hybrid["launches"]},
              "mamba1_scan": {"ssm_full_width": ssm["launches"]}}
    kernels = []
    for name, meta in KERNEL_META.items():
        # the first case is the shape the main path gives the kernel most
        # often: the qwen_omni slice, the vocoder, Falcon-Mamba's decode
        head = cases[name][0]
        lib = head["library_ms"]
        kernels.append({
            "name": name, "route": "cuda", **meta,
            "launches": sum(by_run[name].values()), "launches_by_run": by_run[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": lib,
            "max_err": max(c["max_abs_err"] for c in cases[name]),
            "us": head["ms"] * 1e3, "plain_us": head["plain_ms"] * 1e3,
            "library_us": lib * 1e3 if lib is not None else None,
            "cases": [{k: c[k] for k in ("case", "dtype", "max_abs_err", "ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by") if k in c}
                      for c in cases[name]]})
    print(smi, flush=True)
    emit({"kernels": kernels, "seconds_total": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
