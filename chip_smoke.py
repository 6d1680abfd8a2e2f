#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:
  1. device   — the card's name and power limit (nvidia-smi) and its
                compute capability, which must be (9, 0);
  2. build    — the five CUDA sources built from
                ``src/repro_torch/kernels/csrc`` for sm_90a (one nvcc per
                source, started together), with each kernel's registers and
                spills from ``-Xptxas -v`` (a spill, or ptxas serializing
                a kernel's wgmma, fails the run);
  3. kernels  — each kernel held against its plain PyTorch version on
                seeded inputs at the serving path's shapes and at full
                width (flash cases name their route, wgmma or mma; paged
                cases their split; scan cases their chunks, with the edges
                of a chunk and a continuation split on and off a chunk
                boundary), timed as device time
                with CUDA events fenced by a device-side sleep (``Timer``)
                beside the plain version and one PyTorch library call (a
                yardstick the port never uses); the sub-0.05 ms cases are
                also read from the profiler's kernel events; the wgmma
                forward at InternLM2's, the mma forward at HuBERT-XLarge's
                (bf16 and f32) and the smoke configs' (f32) training shapes,
                with and without lse (timed in turns, lse against the
                plain version's, the output bit for bit without it); the
                flash backward (each case names its route, wgmma or mma,
                and takes the forward's lse) against its plain FA2
                equations (dq, dk, dv) at InternLM2's and HuBERT-XLarge's
                training shapes, the smoke configs' in f32 and bf16 (small
                grids the mma route splits), a window, Zamba2's shared
                attention and ragged S, timed beside autograd of SDPA and
                split by kernel by the profiler; the f32 x bf16 product
                (``mixed_gemm``) at every prefill product of a chunk of
                Jamba2-Mini and Qwen3-30B-A3B (the MoE layers' experts
                through its grouped form) and at ragged M, K and N, beside
                the widening it replaces (plain) and cuBLAS's SGEMM over a
                weight widened beforehand (library), with each chunk's sums;
  4. qwen_omni — the Thinker -> Talker -> DiT-vocoder pipeline served
                through the port's threaded Orchestrator: two greedy runs,
                backend "cuda" and backend "ref", whose Thinker and Talker
                tokens must be identical; then 8 requests as the CLI serves
                them with the backend forced to "cuda" (launches counted);
  4a. monolithic — the paper's baseline (``baselines/monolithic.py``: one
                request at a time, prefill then batch-1 decode, then the
                DiT vocoder) on the qwen_omni bundle and phase 4's 8
                requests (flash launches counted), and one Thinker prefill
                with backend "cuda" against "ref";
  4b. pipelines — qwen3_omni (CNN vocoder), glm_image, bagel, epd and
                mimo_audio at their builders' sizes, 4 requests each
                (completion, output shapes, launches per run), and the CNN
                vocoder's latents against its plain f32 conv on the CPU;
  5. full_width — Qwen2.5-14B at its published width served as a one-stage
                AR graph (8 requests, 32 greedy tokens each; the f32
                prefill's products must launch ``mixed_gemm``), then one
                batched decode step with backend "cuda" against "ref";
  5b. pd_full_width — InternLM2-1.8B at its published width and depth
                served three ways on the same weights (8 requests of
                128-1536 tokens, 32 greedy tokens): a unified engine, PD
                disaggregation with thread stages and the shm connector
                (the prompt KV's hop held bit for bit), and the same with
                the decode stage in a spawned process (its device and
                paged launches and KV inject time read from its status);
                bf16 KV crosses as its bits (the connector's bytes held
                to half the f32 size), every stream equal across the
                three runs, one batched decode step with backend "cuda"
                against "ref";
  6. ssm_full_width — Falcon-Mamba-7B at its published width and depth (64
                Mamba1 layers) served the same way through StateRunner
                (8 requests of 128-1536 tokens, 32 greedy tokens, scan
                launches counted), then one 256-token f32 prefill and one
                batched bf16 decode step with backend "cuda" against "ref",
                and one whole-prompt prefill (the longest prompt) and three
                decode steps under the profiler;
  7. hybrid   — Zamba2-2.7B at its published width and depth (54 Mamba2
                layers, the shared attention after every sixth) served
                the same way (4 requests of 512-1000 tokens, 16 greedy
                tokens, flash launches counted; prompts prefill through
                the chunked Mamba2 scan, decode steps step by step), then
                the longest prompt prefilled in f32 through the chunked
                scan and through the step-by-step one (logits and final
                SSM state held to each other, both timed) and once more
                under the profiler;
  7b. train_full_width — InternLM2-1.8B (bf16, batch 4 x 2048 tokens)
                and HuBERT-XLarge (bf16 weights, batch 4 x 1000 f32
                frames, which make its activations f32 as jnp promotes)
                trained at their published width and depth, full remat:
                one step's loss, grad norm and per-leaf gradients with
                backend "cuda" and "ref", each against an f32 run; 4 AdamW
                steps (ms per step, tokens/s, share of the bf16 peak, peak
                memory, forward and backward kernel launches per step)
                and one profiled step (device busy share, device time by
                kind of kernel, the flash backward's share); InternLM2's
                4 steps through ``launch/train.py``'s ``main``; tiny_lm
                trained 30
                steps with falling loss; one step of each family's smoke
                config "cuda" and "ref" against f32 (the SSM's CUDA scan
                must refuse grad); a checkpoint round trip at full width
                and 2 layers, bit for bit;
  8. moe_full_width — Qwen3-30B-A3B at its published width and depth (48
                layers, 128 experts top-8) served as phase 5 serves the
                14B (dropped (token, expert) pairs per prefill chunk and
                decode step, peak memory, decode ms per step beside the
                expert weights' byte bound), then one batched decode step
                with backend "cuda" against "ref" and three profiled
                decode steps.
  9. ep_full_width — the same model with its experts split over two ranks
                that time-share the card (``models/moe_ep.py``: 64 experts
                of every layer a rank, one all-reduce over the model axis;
                gloo, since NCCL refuses two ranks on one device), held
                against the dense path on the same seeded weights: a
                prefill of 4 x 1024 tokens and 16 decode steps (logits,
                first tokens, decode argmax, layer 0's MoE output, aux and
                dropped pairs), with prefill and decode ms, the all-reduces
                per forward and their ms, flash launches and memory per
                rank;
  10. dryrun  — ``repro_torch.launch.dryrun.run_one`` for six combos on
                the 16x16 mesh, one on 2x16x16, and the pipeline dry-run's
                three stages, on meta DTensors under a fake process group
                (the card unused): every record "ok", no op placed by
                DTensor's own strategy or run on replicated operands, and
                every combo's collective bytes equal to torch 2.13's (each
                record's ops printed);
  11. examples — the five port examples (``examples/*_torch.py``)
                through their ``run`` functions at their own settings:
                every request finished, each kernel's launches counted;
                omni_serving greedy with the kernels and with their plain
                versions (tokens identical, the monolithic baseline's
                text the pipeline's); process_isolation's two spawned
                decode replicas against an all-thread run, then at
                InternLM2-1.8B's published width and depth on phase 5b's
                prompts (each child on the card with paged launches, no
                replica failure, first tokens the all-thread run's);
                train_tiny's 50 steps (the loss closing half its gap to
                ln(vocab), flash launches per layer and step, the
                checkpoint restored bit for bit).
Every JSON line is also written to ``chiprun_out/chip_smoke.jsonl``.
With ``--against TREE`` (another commit's checkout, e.g. the parent
unpacked with git archive) it runs none of the phases: it measures the
flash backward's mma cases, the mma forward and HuBERT-XLarge's training
step from TREE and from this tree in turns, one process a turn
(``run_against``).  With ``--kernel mixed_gemm`` it builds that kernel
and runs its cases of phase 3 alone.
Then the ``{"kernels": [...]}`` line (launch counts of the runs that use
each kernel, each counted from 0) and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before the last line.  Without a
CUDA device, or without the package next to this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
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
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  The mma
# flash route computes f32 as three TF32 products ("tf32x3"): its bound
# counts three times the operations at the TF32 rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3,
              "bf16x3": 989e12 / 3}
# the f32 x bf16 kernel (three bf16 parts of each activation, "bf16x3")
# against the promoted f32 product: both f32 sums in other orders, held
# to 1e-5 of the largest |y| (tests/test_torch_cuda.py's MIXED_TOL)
MIXED_TOL = 1e-5
# the forward's lse (log2 units, magnitude ~10) against the plain
# version's on the same bf16 inputs: both f32, summed in other orders
LSE_TOL = 1e-4
# logits of one full-width bf16 decode step, kernel vs plain attention:
# the two sum in different orders in f32 and round to bf16 in each of the
# 48 layers, so they are held to 5% of the logits' largest magnitude
FULL_WIDTH_LOGIT_RTOL = 5e-2
# last-position logits (and final state) of one 64-layer f32 Falcon-Mamba
# prefill, scan kernel vs plain scan: both f32, summed in other orders and
# with fused multiply-adds in the kernel, so held to 1e-3 of the largest
# magnitude
PREFILL_LOGIT_RTOL = 1e-3


# every emitted line is also written here: the kernels phase's line is too
# long to read whole from the end of the standard output
LOG_PATH = os.path.join(ROOT, "chiprun_out", "chip_smoke.jsonl")
_log = []


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _log:
        _log[0].write(line + "\n")
        _log[0].flush()


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
        return sum(self.profiled_by_kernel(fn, iters).values())

    def profiled_by_kernel(self, fn, iters: int = 20) -> dict:
        """``profiled`` per __global__ of the port's kernels: {name: device
        ms per call} (the scan's passes, paged attention's split and
        combine kernels apart)."""
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
            if ev.device_type == DeviceType.CUDA and any(
                    k in ev.name for k in PORT_KERNELS.values()):
                runs.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        by_kernel = {}
        for name, d in runs.items():
            key = kernel_name(name) or name[:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + statistics.median(d) * len(d) / iters / 1e3
        return by_kernel


# each kernel of the port by the prefix of its __global__ functions'
# names in the profiler's events (the scan's three passes are mamba1_*)
PORT_KERNELS = {"paged_attention": "paged_attention_", "flash_attention": "flash_attention_",
                "flash_attention_bwd": "flash_attention_bwd_", "mamba1_scan": "mamba1_",
                "mixed_gemm": "mixed_gemm_"}
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
    route = fa.route(dt, hd)
    # f32 runs as three TF32 products; the CUDA cores' f32 bound stands beside it
    b_ms, b_by = bound(nbytes, flops, "tf32x3" if dtype == "float32" else dtype)
    extra = {}
    if dtype == "float32":
        extra["bound_ms_f32_cuda_cores"] = bound(nbytes, flops, "float32")[0]
        err_x3, ok_x3 = compare(got, ref.flash_attention_tf32x3(q, k, v, **kw), dtype)
        extra["max_abs_err_vs_tf32x3_plain"] = err_x3
        ok = ok and ok_x3
    return {"case": f"{name} [{route}]", "route": route, "B": B, "sq": sq, "sk": sk, "nq": nq,
            "nkv": nkv, "hd": hd, "dtype": dtype, "causal": causal, "window": window,
            "max_abs_err": err, "ok": ok, "ms": ms, "profiler_ms": profiler_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            **extra}


# the backward's products per visible (query, key) pair and head_dim
# column: the recomputed S, dV, dP, dQ and dK, 2 operations each (lse comes
# from the forward on every route)
BWD_PRODUCTS = 5


def flash_bwd_case(torch, F, timer, name, *, B, S, nq, nkv, hd, dtype, causal=True,
                   window=0, seed=0, profile=True):
    """The flash backward against its plain FA2 equations on the same
    inputs and forward output, timed beside the plain version and
    autograd of SDPA's backward (a yardstick the port never uses).  It
    takes the forward's lse on every route, as training does; the time
    holds every kernel the call launches (pre-pass, main kernel,
    post-pass), and the profiler splits it by kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dt = getattr(torch, dtype)
    route = fa.bwd_route(dt, hd)
    plan = fa.bwd_plan(dt, B, S, nq, nkv, hd,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, nq, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, nkv, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, nkv, hd), generator=g, device="cuda").to(dt)
    do = torch.randn((B, S, nq, hd), generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    if lse is None:
        fail(f"flash_bwd {name}: the {route} forward gave no lse")
    bkw = dict(kw, lse=lse)
    got = fa.flash_attention_bwd(q, k, v, o, do, **bkw)
    want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    errs = {n: compare(a, b, dtype) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    mask = ref._mask(S, S, causal, window, "cuda")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    lib_kw = ({"is_causal": causal} if not window
              else {"attn_mask": mask})
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **lib_kw)
    lib_do = do.transpose(1, 2)

    def library():
        torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True)

    ms = timer(lambda: fa.flash_attention_bwd(q, k, v, o, do, **bkw))
    by_kernel = (timer.profiled_by_kernel(lambda: fa.flash_attention_bwd(q, k, v, o, do, **bkw))
                 if profile else None)
    plain_ms = timer(lambda: ref.flash_attention_bwd(q, k, v, o, do, **kw), iters=3, warmup=1)
    library_ms = timer(library)
    del lib_out
    pairs = int(mask.sum())
    # read q, k, v, o and dO once, write dq, dk and dv once
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    flops = 2.0 * BWD_PRODUCTS * B * nq * hd * pairs
    # f32 runs as three TF32 products; the CUDA cores' f32 bound stands beside it
    b_ms, b_by = bound(nbytes, flops, "tf32x3" if dtype == "float32" else dtype)
    extra = {}
    if dtype == "float32":
        extra["bound_ms_f32_cuda_cores"] = bound(nbytes, flops, "float32")[0]
    return {"case": f"{name} [{route}]", "route": route, "splits": plan.splits, "B": B, "S": S,
            "nq": nq, "nkv": nkv, "hd": hd, "dtype": dtype, "causal": causal, "window": window,
            "max_abs_err": max(e for e, _ in errs.values()),
            "max_abs_err_by_output": {n: e for n, (e, _) in errs.items()},
            "ok": all(ok for _, ok in errs.values()), "ms": ms,
            "profiler_ms_by_kernel": by_kernel, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "autograd of F.scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "tflops_per_s": flops / ms / 1e9, **extra}


def flash_lse_case(torch, F, timer, name, *, B, S, nq, nkv, hd, dtype="bfloat16",
                   causal=True, seed=0):
    """The forward with and without lse, timed in turns in one run: the
    output bit for bit the same, lse against the plain version's (f32 on
    the mma route: also against its split-TF32 arithmetic's)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dt = getattr(torch, dtype)
    route = fa.route(dt, hd)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, nq, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, nkv, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, nkv, hd), generator=g, device="cuda").to(dt)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    plain_out = fa.flash_attention(q, k, v, causal=causal)
    want_out, want_lse = ref.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    err, ok = compare(out, want_out, dtype)
    lse_err = float((lse - want_lse).abs().max())
    extra = {}
    if dtype == "float32":
        _, x3_lse = ref.flash_attention_tf32x3(q, k, v, causal=causal, return_lse=True)
        extra["lse_max_abs_err_vs_tf32x3_plain"] = float((lse - x3_lse).abs().max())
    same = bool(torch.equal(out, plain_out))
    times = {"without_lse": [], "with_lse": []}
    for key in ("without_lse", "with_lse", "with_lse", "without_lse"):
        times[key].append(timer(lambda: fa.flash_attention(
            q, k, v, causal=causal, return_lse=key == "with_lse")))
    ms, ms_lse = (statistics.mean(times[k_]) for k_ in ("without_lse", "with_lse"))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                               enable_gqa=True))
    pairs = B * (S * (S + 1) // 2 if causal else S * S)
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    flops = 4.0 * nq * hd * pairs
    b_ms, b_by = bound(nbytes, flops, "tf32x3" if dtype == "float32" else dtype)
    if dtype == "float32":
        extra["bound_ms_f32_cuda_cores"] = bound(nbytes, flops, "float32")[0]
    return {"case": f"{name} [{route}, lse]", "route": route, "B": B, "sq": S, "sk": S,
            "nq": nq, "nkv": nkv, "hd": hd, "dtype": dtype, "causal": causal, "window": 0,
            "max_abs_err": err, "lse_max_abs_err": lse_err, "out_bitwise_without_lse": same,
            "ok": ok and same and lse_err <= LSE_TOL, "ms": ms_lse, "ms_without_lse": ms,
            "ms_turns": times, "lse_over_plain_forward": ms_lse / ms,
            "plain_ms": timer(lambda: ref.flash_attention(q, k, v, causal=causal,
                                                          return_lse=True), iters=3, warmup=1),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by, **extra}


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
    plan = ms.plan(Bt, S, di, n)
    y, hl = ms.mamba1_scan(x, dt, A, B, C, D, h)
    want_y, want_h = ref.mamba1_scan(x, dt, A, B, C, D, h)
    chunked_y, chunked_h = ref.mamba1_scan_chunked(x, dt, A, B, C, D, h, chunk=plan.chunk)
    torch.cuda.synchronize()
    err_y, ok_y = compare(y, want_y, dtype)
    err_h, ok_h = compare(hl, want_h, "float32")
    err_cy, ok_cy = compare(y, chunked_y, dtype)
    err_ch, ok_ch = compare(hl, chunked_h, "float32")
    ms_ = timer(lambda: ms.mamba1_scan(x, dt, A, B, C, D, h))
    by_kernel = (timer.profiled_by_kernel(lambda: ms.mamba1_scan(x, dt, A, B, C, D, h))
                 if profile else None)
    profiler_ms = sum(by_kernel.values()) if profile else None
    plain_ms = timer(lambda: ref.mamba1_scan(x, dt, A, B, C, D, h), iters=3, warmup=1)
    elt = torch.finfo(dt_).bits // 8
    nbytes = (3 * Bt * S * di * elt + 2 * Bt * S * n * elt + 4 * (di * n + di)
              + 4 * Bt * di * n * (2 if h0 else 1))
    flops = Bt * S * di * (SCAN_FLOPS_PER_STATE * n + SCAN_FLOPS_PER_CHANNEL)
    b_ms, b_by = bound(nbytes, flops, "float32")     # the arithmetic is f32 for both types
    # what the chunk passes add to the bytes, beyond the bound's: the chunk
    # states (end and decay written, read and the start rewritten by the
    # carry, read by the rerun) and x, dt and B read again over the chunks
    # that pass 1 scans
    n4 = -(-n // 4) * 4
    whole = (plan.chunks - 1) * plan.chunk
    pass_bytes = (6 * Bt * (plan.chunks - 1) * di * n4 * 4
                  + Bt * whole * (2 * di + n) * elt)
    return {"case": f"{name} [{plan.chunks} chunk{'s' if plan.chunks > 1 else ''}]",
            "Bt": Bt, "S": S, "di": di, "n": n, "dtype": dtype, "h0": h0,
            "chunk": plan.chunk, "chunks": plan.chunks,
            "kernel_launches_per_call": plan.kernel_launches,
            "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y, "max_abs_err_h": err_h,
            "max_abs_err_vs_chunked_plain": max(err_cy, err_ch),
            "ok": ok_y and ok_h and ok_cy and ok_ch, "ms": ms_, "profiler_ms": profiler_ms,
            "profiler_ms_by_kernel": by_kernel,
            "plain_ms": plain_ms, "library_ms": None,
            "library": SCAN_LIBRARY, "bound_ms": b_ms, "bound_by": b_by,
            "bytes_the_passes_add": pass_bytes}


def mamba_continuation_case(torch, split, *, Bt=1, S=512, di=8192, n=16, seed=5):
    """Two calls with the carried state against one whole scan (f32),
    held to the f32 tolerance; whether they are also equal bit for bit is
    reported, not required (the whole scan carries its chunk states
    through the carry pass, the split through h_last)."""
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
    y1, h1 = ms.mamba1_scan(x[:, :split], dt[:, :split], A, B[:, :split], C[:, :split], D)
    y2, h2 = ms.mamba1_scan(x[:, split:], dt[:, split:], A, B[:, split:], C[:, split:], D, h1)
    torch.cuda.synchronize()
    y12 = torch.cat([y1, y2], 1)
    err_y, ok_y = compare(y12, y, "float32")
    err_h, ok_h = compare(h2, h, "float32")
    where = "on a chunk boundary" if split % ms.plan(Bt, S, di, n).chunk == 0 else "inside a chunk"
    return {"case": f"continuation {split}+{S - split} vs {S}, split {where}", "Bt": Bt,
            "S": S, "di": di, "n": n, "dtype": "float32", "max_abs_err": max(err_y, err_h),
            "bitwise_equal": bool(torch.equal(y12, y) and torch.equal(h2, h)),
            "ok": ok_y and ok_h}


MIXED_LIBRARY_GROUPED = ("three batched products of the capacity buffer against the "
                         "weights widened beforehand")


def mixed_case(torch, timer, name, *, M, K, N, seed=0):
    """The plain form at (M, K) f32 x (K, N) bf16: the kernel against the
    promoted product (plain: widen the weight, then cuBLAS's f32 SGEMM;
    library: the SGEMM alone over a weight widened beforehand)."""
    from repro_torch.kernels import mixed_gemm as mg
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda")
    w = (torch.randn((K, N), generator=g, device="cuda") / K ** 0.5).to(torch.bfloat16)
    got, want = mg.matmul(x, w), ref.mixed_matmul(x, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = err <= MIXED_TOL * float(want.abs().max()) and bool(got.isfinite().all())
    kernel_ms = timer(lambda: mg.matmul(x, w))
    plain_ms = timer(lambda: ref.mixed_matmul(x, w))
    wf = w.float()
    library_ms = timer(lambda: torch.matmul(x, wf))
    del wf
    p = mg.plan(M, K, N)
    b_ms, b_by = bound(2 * K * N + 4 * M * K + 4 * M * N, 2 * M * K * N, "bf16x3")
    return {"case": f"{name} [{p.splits} split{'s' if p.splits > 1 else ''}]", "M": M, "K": K,
            "N": N, "dtype": "float32 x bfloat16", "splits": p.splits,
            "kernel_launches_per_call": p.kernel_launches, "max_abs_err": err, "ok": ok,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def mixed_grouped_case(torch, timer, name, *, T, d, f, E, width, k, seed=0):
    """The grouped form over one MoE layer's experts (E held of ``width``,
    T tokens routed top-k at random): its two calls (gate and up, then
    down) against the capacity buffer's dispatch of widened weights
    (``models/moe.py: _buffer_pairs``), dropless; bytes: the weights of
    the held experts that kept a pair, the tokens read and the outputs
    written."""
    import torch.nn.functional as F
    from repro_torch.kernels import mixed_gemm as mg
    from repro_torch.models import moe
    g = torch.Generator(device="cuda").manual_seed(seed)
    xf = torch.randn((T, d), generator=g, device="cuda")
    topi = torch.argsort(torch.rand((T, width), generator=g, device="cuda"), dim=1)[:, :k]
    ws = [(torch.randn(shape, generator=g, device="cuda") / shape[1] ** 0.5)
          .to(torch.bfloat16) for shape in ((E, d, f), (E, d, f), (E, f, d))]
    e_flat = torch.where(topi < E, topi, E).reshape(-1)
    sort_idx = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[sort_idx]
    counts = moe.bincount(e_flat, E + 1)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device="cuda") - offsets[e_sorted]
    keep = (e_sorted < E) & (pos < T)
    tok = sort_idx // k

    def kernel():
        gg, uu = mg.grouped(xf, ws[:2], tok, offsets, counts, T)
        return mg.grouped(F.silu(gg) * uu, ws[2:], None, offsets, counts, T)[0]

    def plain():
        return moe._buffer_pairs(xf, tok, e_sorted, pos, keep, *ws, T)

    wfs = [w.float() for w in ws]

    def library():
        buf = torch.zeros((E * T + 1, d), device="cuda")
        buf[torch.where(keep, e_sorted * T + pos, E * T)] = xf[tok]
        buf = buf[:E * T].view(E, T, d)
        return torch.matmul(F.silu(torch.matmul(buf, wfs[0])) * torch.matmul(buf, wfs[1]),
                            wfs[2])

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    rows = keep.nonzero()[:, 0]
    err = float((got[rows] - want[rows]).abs().max())
    ok = err <= MIXED_TOL * float(want[rows].abs().max()) and bool(got[rows].isfinite().all())
    kernel_ms, plain_ms, library_ms = timer(kernel), timer(plain), timer(library)
    del wfs
    held = int((counts[:E] > 0).sum())
    kept = int(keep.sum())
    nbytes = held * 3 * d * f * 2 + kept * (4 * d + 2 * 4 * f + 4 * f + 4 * d)
    flops = 2 * kept * 3 * d * f
    b_ms, b_by = bound(nbytes, flops, "bf16x3")
    return {"case": name, "T": T, "d": d, "f": f, "E": E, "router_width": width, "k": k,
            "experts_with_pairs": held, "pairs_kept": kept, "dtype": "float32 x bfloat16",
            "kernel_launches_per_call": 2, "max_abs_err": err, "ok": ok, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library": MIXED_LIBRARY_GROUPED,
            "bound_ms": b_ms, "bound_by": b_by}


# every prefill product of a 64-row chunk: (name, M, K, N, times a chunk)
MIXED_PLAIN = {
    "jamba2-mini": [("in_proj", 64, 4096, 16384, 28), ("x_proj", 64, 8192, 288, 28),
                    ("dt_proj", 64, 256, 8192, 28), ("out_proj", 64, 8192, 4096, 28),
                    ("q, o", 64, 4096, 4096, 8), ("k, v", 64, 4096, 1024, 8),
                    ("mlp gate, up", 64, 4096, 14336, 32), ("mlp down", 64, 14336, 4096, 16),
                    ("head", 64, 4096, 65536, 1)],
    "qwen3-30b-a3b": [("q", 64, 2048, 4096, 48), ("k, v", 64, 2048, 512, 96),
                      ("o", 64, 4096, 2048, 48), ("head", 64, 2048, 151936, 1)],
}
# one MoE layer's experts a chunk: (name, T, d, f, E held, router width, k, layers)
MIXED_GROUPED = {
    "jamba2-mini": ("experts, 8 held of 16, top-2", 64, 4096, 14336, 8, 16, 2, 16),
    "qwen3-30b-a3b": ("experts, 128, top-8", 64, 2048, 768, 128, 128, 8, 48),
}


def mixed_cases(torch, timer):
    """The f32 x bf16 kernel at every prefill product of a chunk of the two
    benchmark configurations, a ragged M and N, and the chunk's sums: each
    product's time, bound and plain time times its count a chunk."""
    cases, chunks = [], {}
    s = 0
    for model, products in MIXED_PLAIN.items():
        rows = []
        for name, M, K, N, count in products:
            c = mixed_case(torch, timer, f"{model} {name}", M=M, K=K, N=N, seed=s)
            c["per_chunk"] = count
            rows.append(c)
            s += 1
        name, T, d, f, E, width, k, layers = MIXED_GROUPED[model]
        c = mixed_grouped_case(torch, timer, f"{model} {name}", T=T, d=d, f=f, E=E,
                               width=width, k=k, seed=s)
        c["per_chunk"] = layers
        rows.append(c)
        s += 1
        chunks[model] = {key: sum(r[key] * r["per_chunk"] for r in rows)
                         for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
        cases += rows
    for M, K, N in ((1, 4096, 65536), (19, 4096, 4096), (19, 100, 40)):
        cases.append(mixed_case(torch, timer, f"ragged M {M}, K {K}, N {N}", M=M, K=K, N=N,
                                seed=s))
        s += 1
    return cases, chunks


def phase_kernels(torch, F):
    from repro_torch.kernels import mamba_scan as ms
    timer = Timer(torch)
    paged = [
        paged_case(torch, F, timer, "qwen_omni decode (slice)", B=8, nq=4, nkv=2, hd=32,
                   page=16, pp=16, dtype="float32", profile=True),
        paged_case(torch, F, timer, "qwen2.5-14b decode bf16", B=8, nq=40, nkv=8, hd=128,
                   page=16, pp=128, dtype="bfloat16", seed=1, profile=True),
        paged_case(torch, F, timer, "internlm2-1.8b decode bf16 (pd_full_width)", B=8, nq=16,
                   nkv=8, hd=128, page=16, pp=128, dtype="bfloat16", seed=5, profile=True),
        paged_case(torch, F, timer, "qwen2.5-14b decode f32", B=8, nq=40, nkv=8, hd=128,
                   page=16, pp=128, dtype="float32", seed=2),
        paged_case(torch, F, timer, "int8 pool", B=8, nq=40, nkv=8, hd=128, page=16,
                   pp=128, dtype="bfloat16", quant=True, seed=3),
        paged_case(torch, F, timer, "window 512", B=8, nq=40, nkv=8, hd=128, page=16,
                   pp=128, dtype="bfloat16", window=512, seed=4),
        # GQA 8:1, two blocks of 4 query heads per KV head
        paged_case(torch, F, timer, "qwen3-30b-a3b decode bf16 (moe_full_width)", B=8, nq=32,
                   nkv=4, hd=128, page=16, pp=128, dtype="bfloat16", seed=6, profile=True),
    ]
    flash = [
        flash_case(torch, F, timer, "vocoder self-attn", B=8, sq=32, sk=32, nq=4, nkv=4,
                   hd=32, dtype="float32", profile=True),
        flash_case(torch, F, timer, "vocoder cross-attn", B=8, sq=32, sk=16, nq=4, nkv=4,
                   hd=32, dtype="float32", seed=1),
        flash_case(torch, F, timer, "vocoder cross-attn, last chunk", B=8, sq=16, sk=8,
                   nq=4, nkv=4, hd=32, dtype="float32", seed=2),
        # the glm_image / bagel DiT: 64 latents over themselves and over the
        # 32 AR tokens, up to 4 requests a batch in phase pipelines (full tiles)
        flash_case(torch, F, timer, "glm_image DiT self-attn", B=4, sq=64, sk=64, nq=4,
                   nkv=4, hd=32, dtype="float32", seed=20),
        flash_case(torch, F, timer, "glm_image DiT cross-attn", B=4, sq=64, sk=32, nq=4,
                   nkv=4, hd=32, dtype="float32", seed=21),
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
    flash.append(flash_case(torch, F, timer, "vocoder self-attn bf16", B=8, sq=32, sk=32, nq=4,
                            nkv=4, hd=32, dtype="bfloat16", seed=s + 4))
    flash.append(flash_case(torch, F, timer, "GQA g 5 f32 window 128, 300 rows over 1000 keys",
                            B=2, sq=300, sk=1000, nq=40, nkv=8, hd=128, dtype="float32",
                            causal=True, window=128, seed=s + 5))
    # the training forwards, with the lse their backward takes: InternLM2-1.8B
    # (wgmma), HuBERT-XLarge (mma, bf16, non-causal) and the smoke configs (mma, f32)
    flash.append(flash_lse_case(torch, F, timer, "internlm2-1.8b train forward bf16 causal",
                                B=4, S=2048, nq=16, nkv=8, hd=128, seed=s + 7))
    flash.append(flash_lse_case(torch, F, timer, "hubert-xlarge train forward bf16 non-causal",
                                B=4, S=1000, nq=16, nkv=16, hd=80, causal=False, seed=s + 8))
    flash.append(flash_lse_case(torch, F, timer, "hubert-xlarge train forward f32 non-causal",
                                B=4, S=1000, nq=16, nkv=16, hd=80, dtype="float32",
                                causal=False, seed=s + 10))
    flash.append(flash_lse_case(torch, F, timer, "smoke train forward f32 causal", B=2, S=128,
                                nq=8, nkv=4, hd=32, dtype="float32", seed=s + 9))
    # Qwen3-30B-A3B's prefill of 4 x 1024 tokens in phase ep_full_width
    flash.append(flash_case(torch, F, timer, "qwen3-30b-a3b ep prefill bf16 causal", B=4,
                            sq=1024, sk=1024, nq=32, nkv=4, hd=128, dtype="bfloat16",
                            causal=True, seed=s + 11))
    # the monolithic baseline's Thinker prefill: one request of 23 tokens
    flash.append(flash_case(torch, F, timer, "monolithic prefill f32 causal", B=1, sq=23,
                            sk=23, nq=4, nkv=2, hd=32, dtype="float32", causal=True,
                            seed=s + 6, profile=True))
    scan = [
        mamba_case(torch, timer, "falcon-mamba decode bf16", Bt=8, S=1, di=8192, n=16,
                   dtype="bfloat16", h0=True, profile=True),
        mamba_case(torch, timer, "falcon-mamba prefill f32 (ragged S)", Bt=1, S=1000,
                   di=8192, n=16, dtype="float32", h0=False, seed=1, profile=True),
        mamba_case(torch, timer, "falcon-mamba prefill f32, 256 tokens", Bt=1, S=256,
                   di=8192, n=16, dtype="float32", h0=False, seed=3),
    ]
    chunk = ms.CHUNK
    for i, S in enumerate((chunk - 1, chunk, chunk + 1)):     # the edges of one chunk
        scan.append(mamba_case(torch, timer, f"falcon-mamba prefill f32, S {S}", Bt=1, S=S,
                               di=8192, n=16, dtype="float32", h0=True, seed=4 + i))
    scan.append(mamba_case(torch, timer, "smoke f32", Bt=1, S=8, di=512, n=8, dtype="float32",
                           h0=False, seed=2))
    scan += [mamba_continuation_case(torch, 4 * chunk),
             mamba_continuation_case(torch, 4 * chunk + 1)]
    bwd = [
        # InternLM2-1.8B's training shape (phase train_full_width)
        flash_bwd_case(torch, F, timer, "internlm2-1.8b train bf16 causal", B=4, S=2048, nq=16,
                       nkv=8, hd=128, dtype="bfloat16", seed=30, profile=True),
        # the smoke configs' attention (tiny_lm and the tests train in f32)
        flash_bwd_case(torch, F, timer, "smoke f32 hd 32 causal GQA", B=2, S=128, nq=8, nkv=4,
                       hd=32, dtype="float32", seed=31),
        # Mixtral's heads under a sliding window (its SWA)
        flash_bwd_case(torch, F, timer, "mixtral heads bf16 causal window 512", B=1, S=2048,
                       nq=32, nkv=8, hd=128, dtype="bfloat16", window=512, seed=32),
        # HuBERT-XLarge's encoder: non-causal, hd 80
        flash_bwd_case(torch, F, timer, "hubert-xlarge bf16 non-causal hd 80", B=2, S=1000,
                       nq=16, nkv=16, hd=80, dtype="bfloat16", causal=False, seed=33),
        flash_bwd_case(torch, F, timer, "ragged S 1000 bf16 causal", B=1, S=1000, nq=16, nkv=8,
                       hd=128, dtype="bfloat16", seed=34),
        flash_bwd_case(torch, F, timer, "ragged S 77 f32 non-causal hd 80", B=1, S=77, nq=4,
                       nkv=2, hd=80, dtype="float32", causal=False, seed=35),
        flash_bwd_case(torch, F, timer, "hd 64 bf16 window 100 non-causal", B=2, S=300, nq=8,
                       nkv=2, hd=64, dtype="bfloat16", causal=False, window=100, seed=36),
        # the smoke configs' attention in bf16 (the families' bf16 steps)
        flash_bwd_case(torch, F, timer, "smoke bf16 hd 32 causal GQA", B=2, S=128, nq=8,
                       nkv=4, hd=32, dtype="bfloat16", seed=37),
        # Zamba2-2.7B's shared attention at a 2048-token prompt
        flash_bwd_case(torch, F, timer, "zamba2-2.7b bf16 causal hd 80", B=1, S=2048, nq=32,
                       nkv=32, hd=80, dtype="bfloat16", seed=38),
        # HuBERT-XLarge's training shape (phase train_full_width) in bf16, and
        # in f32, the type its training step runs attention in: the f32
        # frames promote every activation of the bf16 model to f32, as jnp does
        flash_bwd_case(torch, F, timer, "hubert-xlarge train bf16 non-causal hd 80", B=4,
                       S=1000, nq=16, nkv=16, hd=80, dtype="bfloat16", causal=False, seed=39),
        flash_bwd_case(torch, F, timer, "hubert-xlarge train f32 non-causal hd 80", B=4,
                       S=1000, nq=16, nkv=16, hd=80, dtype="float32", causal=False, seed=40),
    ]
    mixed, _ = mixed_cases(torch, timer)
    return {"paged_attention": paged, "flash_attention": flash, "flash_attention_bwd": bwd,
            "mamba1_scan": scan, "mixed_gemm": mixed}


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
    reqs = [Request(inputs=_make_inputs("qwen_omni", rng)) for _ in range(n_requests)]
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
# phase monolithic: the paper's baseline on the qwen_omni bundle
# ---------------------------------------------------------------------------

def phase_monolithic(torch, orchestrator_jct_p50, n_requests=8, seed=0):
    """MonolithicQwenOmni (one request at a time: prefill, batch-1 decode,
    then the DiT vocoder) on the qwen_omni bundle the CLI builds and the
    8 requests of phase qwen_omni, after one warm-up request, backend
    "cuda" with flash launches counted from 0; then one forward_prefill
    of the Thinker, kernel vs plain, on the same card."""
    import numpy as np

    from repro_torch.baselines.monolithic import MonolithicQwenOmni
    from repro_torch.configs.pipelines import build_qwen_omni
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import _make_inputs
    from repro_torch.models import transformer as T

    _, _, bundle = build_qwen_omni(max_batch=8, prefix_cache=True, device="cuda", seed=seed)
    mono = MonolithicQwenOmni(bundle, (bundle["dit_cfg"], bundle["dit_params"]),
                              dit_steps=bundle["dit_cfg"].num_steps, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = [_make_inputs("qwen_omni", rng)["tokens"] for _ in range(n_requests)]
    ops.set_backend("cuda")
    try:
        mono.run(prompts[:1])                        # warm-up, not counted
        torch.cuda.synchronize()
        fa.launches.reset()
        t0 = time.perf_counter()
        res = mono.run(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.launches.value
    finally:
        ops.set_backend("auto")
    talker_tokens = bundle["talker_tokens"]
    for i, r in enumerate(res):
        wave = np.asarray(r["wave"])
        if (r["text"].shape != (bundle["thinker_tokens"],) or r["codec"].shape
                != (talker_tokens,) or wave.shape != (1, 2 * talker_tokens, 32)
                or not np.isfinite(wave).all()):
            fail(f"monolithic: request {i}: text {r['text'].shape}, codec "
                 f"{r['codec'].shape}, wave {wave.shape} (finite: {np.isfinite(wave).all()})")
    if len(res) != n_requests:
        fail(f"monolithic: {len(res)}/{n_requests} results")
    if launches <= 0:
        fail("monolithic: the flash attention kernel was not launched")

    # one Thinker prefill (the longest prompt), kernel vs plain attention
    cfg = bundle["thinker_cfg"].replace(modality="audio_frames")
    params = bundle["thinker_params"]
    prompt = max(prompts, key=len)
    emb = params["embed"][torch.as_tensor(prompt, dtype=torch.long, device="cuda")][None]
    logits = {}
    with torch.no_grad():
        for backend in ("cuda", "ref"):
            ops.set_backend(backend)
            logits[backend] = T.forward_prefill(cfg, params, emb, mono.max_seq)[0]
    ops.set_backend("auto")
    diff = float((logits["cuda"] - logits["ref"]).abs().max())
    scale = float(logits["ref"].abs().max())
    if not (diff <= PREFILL_LOGIT_RTOL * scale and torch.isfinite(logits["cuda"]).all()):
        fail(f"monolithic prefill logits: max |cuda - ref| = {diff} > "
             f"{PREFILL_LOGIT_RTOL} x {scale}")
    jct = sorted(r["jct"] for r in res)
    keys = ("jct", "exec", "thinker_time", "talker_time", "vocoder_time")
    return {"phase": "monolithic", "requests": n_requests, "completed": len(res),
            "prompt_lens": [len(p) for p in prompts], "wall_s": wall,
            "jct_p50_s": jct[len(jct) // 2], "jct_max_s": jct[-1],
            "orchestrator_jct_p50_s": orchestrator_jct_p50,
            "per_request_s": [{k: r[k] for k in keys} for r in res],
            "flash_launches": launches, "flash_launches_per_request": launches / n_requests,
            "prefill_check_prompt_len": len(prompt),
            "prefill_logits_max_abs_diff": diff, "prefill_logits_max_abs": scale,
            "prefill_rtol": PREFILL_LOGIT_RTOL}, launches


# ---------------------------------------------------------------------------
# phase pipelines: the other pipelines at their builders' (tiny) sizes
# ---------------------------------------------------------------------------

PIPELINE_RUNS = ("qwen3_omni", "glm_image", "bagel", "epd", "mimo_audio")
# the CNN vocoder on the card against its plain f32 version on the CPU
CNN_TOL = 2e-5


def plain_cnn_vocoder(torch, cond, w1, w2):
    """The Qwen3-Omni CNN vocoder written out on the CPU in f32: two 3-tap
    "SAME" convolutions as shifted products, the tanh GELU and a 2x repeat
    in time between them.  cond (B, T, D), w (3, I, O)."""
    def conv(x, w):
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
        return xp[:, :-2] @ w[0] + xp[:, 1:-1] @ w[1] + xp[:, 2:] @ w[2]
    x = conv(cond, w1)
    x = 0.5 * x * (1.0 + torch.tanh((2.0 / torch.pi) ** 0.5 * (x + 0.044715 * x ** 3)))
    return conv(x.repeat_interleave(2, dim=1), w2)


def check_cnn_vocoder(torch, engine, w1, w2):
    """One padded batch through the served vocoder engine on the card,
    with cuDNN's global TF32 switch ON (the vocoder's convolutions are
    matmuls, which that switch does not reach), held against
    ``plain_cnn_vocoder`` at CNN_TOL."""
    import numpy as np
    g = torch.Generator().manual_seed(7)
    lens = [16, 16, 9, 16, 3, 16, 12, 16]          # Talker chunks, the last ones short
    conds = [torch.randn((n, w1.shape[1]), generator=g) for n in lens]
    batch = [{"cond": c.numpy(), "chunk_index": i} for i, c in enumerate(conds)]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        outs = engine.forward(batch)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    padded = torch.zeros((len(lens), max(lens), w1.shape[1]))
    for i, c in enumerate(conds):
        padded[i, :len(c)] = c
    want = plain_cnn_vocoder(torch, padded, w1.cpu(), w2.cpu())
    err, ok = 0.0, True
    for i, (o, n) in enumerate(zip(outs, lens)):
        got = torch.as_tensor(np.asarray(o["latent"]))
        w = want[i, :2 * n]
        ok = ok and got.shape == w.shape and bool(got.isfinite().all())
        d = (got - w).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= CNN_TOL + CNN_TOL * w.abs()).all())
    if not ok:
        fail(f"CNN vocoder latents differ from the plain f32 conv by {err} (tol {CNN_TOL})")
    return {"cnn_vocoder_rows": len(lens), "cnn_vocoder_max_abs_err": err,
            "cnn_vocoder_tol": CNN_TOL, "cnn_vocoder_cudnn_tf32_was_on": True}


def build_pipeline(name: str):
    from repro_torch.configs import pipelines as P
    if name == "qwen3_omni":
        return P.build_qwen_omni(vocoder_kind="cnn", device="cuda")
    if name in ("glm_image", "bagel"):
        return P.build_ar_dit(name, device="cuda")
    if name == "epd":
        return P.build_epd_disaggregated(device="cuda")
    return P.build_mimo_audio(device="cuda")


def pipeline_inputs(name: str, rng):
    from repro_torch.launch.serve import _make_inputs
    if name == "epd":
        return {"frames": rng.standard_normal((int(rng.integers(6, 24)), 32))
                .astype("float32")}
    return _make_inputs(name, rng)


def check_pipeline_outputs(name: str, reqs, bundle) -> None:
    import numpy as np
    if name == "qwen3_omni":
        check_vocoder(reqs, bundle["talker_tokens"])
        return
    for r in reqs:
        if name in ("glm_image", "bagel"):
            outs, key = r.outputs[f"{name}_dit"], "latent"
            shape = (bundle["image_latents"], 32)
        elif name == "epd":
            outs, key, shape = r.outputs["decode"], "tokens", (8,)   # the builder's max_new
        else:
            outs, key = r.outputs["patch_dec"], "audio"
            shape = (bundle["ar_tokens"], bundle["patch"] * 16)
        val = np.asarray(outs[0][key]) if len(outs) == 1 else None
        if val is None or val.shape != shape or not np.isfinite(val).all():
            fail(f"{name}: request {r.req_id} produced {len(outs)} outputs, "
                 f"{None if val is None else val.shape} (want one of {shape})")


def phase_pipelines(torch, n_requests=4, seed=0):
    """qwen3_omni (CNN vocoder), glm_image, bagel, epd and mimo_audio, 4
    requests each through the threaded Orchestrator with backend "cuda",
    the kernels' launches counted per run."""
    import argparse as _ap

    import numpy as np

    from repro_torch.core.config import ServeConfig
    from repro_torch.core.metrics import summarize
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.request import Request
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    runs, launches = {}, {}
    for name in PIPELINE_RUNS:
        graph, engines, bundle = build_pipeline(name)
        config = ServeConfig.from_args(_ap.Namespace(backend="threaded"),
                                       engine_factories=bundle["engine_factories"],
                                       engine_specs=bundle["engine_specs"])
        orch = Orchestrator(graph, engines, config=config)
        rng = np.random.default_rng(seed)
        reqs = [Request(inputs=pipeline_inputs(name, rng)) for _ in range(n_requests)]
        ops.set_backend("cuda")
        pa.launches.reset()
        fa.launches.reset()
        t0 = time.perf_counter()
        orch.start()
        for r in reqs:
            orch.submit(r)
        orch.run(timeout=300.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {"paged_attention": pa.launches.value, "flash_attention": fa.launches.value}
        ops.set_backend("auto")
        done = [r for r in reqs if r.completion_time is not None and not r.failed]
        if len(done) != len(reqs):
            fail(f"{name}: {len(done)}/{len(reqs)} requests completed: "
                 f"{[r.failed for r in reqs if r.failed]}")
        check_pipeline_outputs(name, reqs, bundle)
        if n["paged_attention"] <= 0:
            fail(f"{name}: the paged attention kernel was not launched")
        if name in ("glm_image", "bagel") and n["flash_attention"] <= 0:
            fail(f"{name}: the flash attention kernel (DiT) was not launched")
        m = summarize(reqs, wall_time=wall)
        runs[name] = {"requests": len(reqs), "completed": len(done), "wall_s": wall,
                      "jct_p50_s": m["jct_p50"], "launches": n,
                      "stages": sorted(graph.stages)}
        if name == "qwen3_omni":
            runs[name].update(check_cnn_vocoder(torch, engines["vocoder"], bundle["w1"],
                                                bundle["w2"]))
        launches[name] = n
    return {"phase": "pipelines", "runs": runs}, launches


# ---------------------------------------------------------------------------
# phases 5 and moe_full_width: Qwen2.5-14B and Qwen3-30B-A3B at full width
# ---------------------------------------------------------------------------

def serve_paged_full_width(torch, arch, *, prefix_cache, n_requests=8, max_new=32, seed=0,
                           drops=False):
    """``arch``'s published config as a one-stage AR graph (page 16, 2048
    tokens per sequence, max_batch 8), seeded random weights on the card,
    8 seeded prompts of 128-1536 tokens and 32 greedy tokens, backend
    "cuda" with paged launches counted from 0; taps time each prefill
    chunk and decode step (a device sync after each) and, with ``drops``,
    read the MoE layers' dropped (token, expert) pairs per call.  Then
    one batched decode step, kernel vs plain, three profiled decode steps
    and five timed alone.  Returns the run's numbers."""
    import argparse as _ap

    import numpy as np

    from repro_torch.core.config import ServeConfig
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.request import Request
    from repro_torch.engine.sampling import SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.kernels import mixed_gemm as mg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import build_single_arch
    from repro_torch.models import moe

    _free(torch)
    free_before, total = torch.cuda.mem_get_info()
    t_init = time.perf_counter()
    graph, engines, bundle = build_single_arch(
        arch, 8, max_new, seed, prefix_cache=prefix_cache, device="cuda", smoke=False,
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
             "decode_s": 0.0, "decode_tokens": 0, "decode_steps": 0,
             "prefill_drops": [], "decode_drops": []}
    first_token = {}
    prefill, decode, sample = runner.prefill_chunk, runner.decode, eng._sample
    counter = torch.zeros((), dtype=torch.long, device="cuda") if drops else None

    def dropped():
        if counter is None:
            return None
        n = int(counter)
        counter.zero_()
        return n

    def timed_prefill(embeds, block_table, start, valid_len, slot=None):
        t = time.perf_counter()
        out = prefill(embeds, block_table, start, valid_len, slot=slot)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t
        stats["prefill_tokens"] += int(valid_len)
        stats["prefill_chunks"] += 1
        stats["prefill_drops"].append(dropped())
        return out

    def timed_decode(embeds, block_tables, positions, active):
        t = time.perf_counter()
        out = decode(embeds, block_tables, positions, active)
        torch.cuda.synchronize()
        stats["decode_s"] += time.perf_counter() - t
        stats["decode_tokens"] += int(np.asarray(active).sum())
        stats["decode_steps"] += 1
        stats["decode_drops"].append(dropped())
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
    moe.drop_counter = counter
    pa.launches.reset()
    mg.launches.reset()
    t0 = time.perf_counter()
    try:
        orch.start()
        for r in reqs:
            orch.submit(r)
        orch.run(timeout=600.0)
        torch.cuda.synchronize()
    finally:
        moe.drop_counter = None
        ops.set_backend("auto")
        runner.prefill_chunk, runner.decode, eng._sample = prefill, decode, sample
    wall = time.perf_counter() - t0
    launches = pa.launches.value
    mixed_launches = mg.launches.value
    done = [r for r in reqs if r.completion_time is not None and not r.failed]
    if len(done) != len(reqs):
        fail(f"{arch}: {len(done)}/{len(reqs)} requests completed: "
             f"{[r.failed for r in reqs if r.failed]}")
    for r in reqs:
        toks = np.asarray(r.outputs[arch][0]["tokens"])
        if toks.shape != (max_new,):
            fail(f"{arch}: request {r.req_id} produced {toks.shape} tokens")
    if launches <= 0:
        fail(f"{arch}: the paged attention kernel was not launched")
    if mixed_launches <= 0:
        fail(f"{arch}: the f32 prefill's products did not go through mixed_gemm")
    ttft = sorted(first_token[r.req_id] - r.arrival_time for r in reqs)
    jct = sorted(r.jct for r in reqs)
    peak = torch.cuda.max_memory_allocated()

    check, step = decode_step_check(torch, runner, [r.inputs["tokens"] for r in reqs], arch)
    ops.set_backend("cuda")       # three decode steps, after the warm-up above
    _, busy = device_profile(torch, lambda: [step() for _ in range(3)])
    # the same step alone, outside the serving threads and the profiler
    t = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    alone_ms = 1e3 * (time.perf_counter() - t) / 5
    ops.set_backend("auto")
    out = {"arch": arch, "source": cfg.source, "d_model": cfg.d_model,
           "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "params": n_params, "param_bytes": sum(t.numel() * t.element_size()
                                                  for t in _leaves(bundle["params"])),
           "init_s": t_init, "requests": len(reqs),
           "completed": len(done), "prompt_lens": [int(n) for n in lens],
           "new_tokens": max_new, "wall_s": wall,
           "prefill_tok_per_s": stats["prefill_tokens"] / stats["prefill_s"],
           "decode_tok_per_s": stats["decode_tokens"] / stats["decode_s"],
           "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
           "prefill_chunks": stats["prefill_chunks"], "decode_steps": stats["decode_steps"],
           "prefill_ms_per_chunk": 1e3 * stats["prefill_s"] / stats["prefill_chunks"],
           "decode_ms_per_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
           "decode_3_steps_profile": busy, "decode_ms_per_step_alone": alone_ms,
           "ttft_p50_s": ttft[len(ttft) // 2], "jct_p50_s": jct[len(jct) // 2],
           "jct_p95_s": jct[min(len(jct) - 1, int(0.95 * len(jct)))],
           "jct_max_s": jct[-1], "paged_launches": launches,
           "mixed_launches": mixed_launches,
           "paged_launches_per_request": launches / len(reqs),
           "device_free_gb_before_init": free_before / 1e9, "device_total_gb": total / 1e9,
           "max_memory_allocated_gb": peak / 1e9, **check}
    if drops:
        out.update({"dropped_pairs_per_prefill_chunk": stats["prefill_drops"],
                    "dropped_pairs_per_decode_step": stats["decode_drops"]})
    return out


def phase_full_width(torch):
    out = serve_paged_full_width(torch, "qwen2_5_14b", prefix_cache=True)
    out.update({"phase": "full_width", "layers_published": 48})
    return out


# ---------------------------------------------------------------------------
# phase train_full_width: InternLM2-1.8B trained at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2_1_8b"
# four steps: the first warms the allocator up, the mean is over three
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
# HuBERT-XLarge, the audio encoder: its non-causal hd-80 attention takes
# the flash backward's mma route; 4 x 1000 frames of the seeded stream
ENCODER_ARCH = "hubert_xlarge"
ENCODER_BATCH, ENCODER_SEQ, ENCODER_STEPS = 4, 1000, 4
# gradients of one bf16 step.  Kernels and plain attention round to bf16
# at other places, and every later bf16 rounding of the model follows
# from the earlier ones, so the two bf16 runs differ as two independent
# draws of the model's bf16 error do, while each attention call agrees
# with the plain version to the bf16 rounding of its output.  So each
# leaf's gradient is held against the same model run in f32 (plain attention): the
# kernels' error at most twice the plain bf16 run's (FlashAttention's
# own test criterion), and the loss and the gradient norm to 2e-2 of the
# plain bf16 run's
GRAD_RTOL = 2e-2
GRAD_ERROR_RATIO = 2.0
# the families trained one step on the card with backend "cuda" against
# "ref" (smoke configs): dense, MoE with a sliding window, VLM, the
# non-causal audio encoder, hybrid; the SSM's CUDA scan has no backward
FAMILY_ARCHS = ("internlm2_1_8b", "mixtral_8x7b", "chameleon_34b", "hubert_xlarge",
                "zamba2_2_7b")
SSM_ARCH = "falcon_mamba_7b"


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Operations of one training step (remat per block), from the shapes:
    ``model`` is what the model needs (6 N T for the products, 12 per
    visible (query, key) pair, head and head_dim column for attention's
    two forward and four backward products), ``executed`` adds the blocks'
    recomputed forward (2 N T, 4 per pair) and the backward kernel's
    recomputed S (2 per pair; it takes lse from the forward).  Attention
    is causal but in an encoder."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + cfg.num_heads * hd * d
                 + 3 * d * cfg.d_ff)
    blocks, head = cfg.num_layers * per_layer, d * cfg.vocab_size
    tokens = batch * seq
    pairs = seq * seq if cfg.is_encoder else seq * (seq + 1) // 2
    attn = batch * cfg.num_heads * hd * pairs * cfg.num_layers
    model = 6.0 * (blocks + head) * tokens + 12.0 * attn
    executed = model + 2.0 * blocks * tokens + 6.0 * attn
    return {"model": model, "executed": executed, "matmul_params": blocks + head}


def _rel_err(got, want) -> float:
    """||got - want|| / ||want||, in f32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def attention_layers(cfg) -> int:
    if cfg.arch_type == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


def compare_grads(torch, cfg, params, x, y, what: str) -> dict:
    """One loss and gradient with backend "cuda" and with "ref" on the same
    weights and batch, and with "ref" on an f32 copy of the model: loss
    and grad norm, every leaf's error against the f32 run (the norm of
    the difference over the f32 gradient's norm), and the flash kernels'
    launches of the "cuda" run (with remat, two forward launches and one
    backward launch per attention layer)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    runs = {"cuda": (cfg, params), "ref": (cfg, params),
            "ref_f32": (cfg.replace(dtype="float32"), tree_map(lambda t: t.float(), params))}
    out = {}
    for name, (rcfg, rparams) in runs.items():
        ops.set_backend(name.split("_")[0])
        fa.launches.reset()
        fa.bwd_launches.reset()
        try:
            loss, _, grads = st.loss_and_grads(rcfg, rparams, x, y)
            torch.cuda.synchronize()
        finally:
            ops.set_backend("auto")
        out[name] = (loss, opt.global_norm(grads), dict(_named_leaves(grads)),
                     (fa.launches.value, fa.bwd_launches.value))
    del runs
    (lc, nc, gc_, launched), (lr, nr, gr, _), (_, _, g32, _) = (out[k] for k in
                                                                ("cuda", "ref", "ref_f32"))
    leaf_errs = {name: (_rel_err(gc_[name], g32[name]), _rel_err(gr[name], g32[name]))
                 for name in g32}
    res = {"loss_cuda": float(lc), "loss_ref": float(lr),
           "grad_norm_cuda": float(nc), "grad_norm_ref": float(nr),
           "loss_rel_err": abs(float(lc) - float(lr)) / abs(float(lr)),
           "grad_norm_rel_err": abs(float(nc) - float(nr)) / float(nr),
           "leaf_grad_err_vs_f32": {k: {"cuda": e[0], "ref": e[1]} for k, e in
                                    leaf_errs.items()},
           "leaf_grad_err_vs_f32_max": {"cuda": max(e[0] for e in leaf_errs.values()),
                                        "ref": max(e[1] for e in leaf_errs.values())},
           "leaf_grad_cuda_vs_ref_max": max(_rel_err(gc_[k], gr[k]) for k in gr),
           "flash_launches": launched[0], "flash_bwd_launches": launched[1]}
    bad = [k for k in ("loss_rel_err", "grad_norm_rel_err") if not res[k] <= GRAD_RTOL]
    bad += [k for k, (ec, er) in leaf_errs.items()
            if not ec <= max(GRAD_ERROR_RATIO * er, TOL[cfg.dtype])]
    n_attn = attention_layers(cfg)
    if launched != (2 * n_attn, n_attn):
        bad.append(f"launches {launched}, expected {(2 * n_attn, n_attn)}")
    if bad or not (torch.isfinite(lc) and torch.isfinite(nc)):
        fail(f"{what}: backend cuda against ref: {bad} {res}")
    return res


def run_train_launcher(torch, argv) -> dict:
    """``python -m repro_torch.launch.train`` in this process (its device
    is the default, cuda): wall time, the printed step lines, peak
    memory and the flash kernels' launches."""
    import contextlib
    import io

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch_train
    fa.launches.reset()
    fa.bwd_launches.reset()
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        launch_train.main(argv)
    torch.cuda.synchronize()
    lines = out.getvalue().splitlines()
    losses = [float(line.split("loss")[1].split()[0]) for line in lines if "loss" in line]
    if not lines or not all(math.isfinite(x) for x in losses):
        fail(f"train launcher {argv}: printed {lines}")
    return {"argv": argv, "seconds": time.perf_counter() - t, "lines": lines,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "flash_launches": fa.launches.value, "flash_bwd_launches": fa.bwd_launches.value}


def _batch(torch, stream):
    b = next(stream)
    return (torch.from_numpy(b["inputs"]).cuda(), torch.from_numpy(b["labels"]).cuda())


def train_arch_full_width(torch, arch, *, batch, seq, steps, parity=True):
    """``arch`` at its published width and depth trained through the
    port's entry points (train/step.py, as launch/train.py drives it), on
    seeded random weights and the synthetic TokenStream: with ``parity``
    one step's gradients with backend "cuda" and "ref" each against f32
    (``compare_grads``); then ``steps`` AdamW steps (the first warms up)
    and one profiled step: ms per step, tokens/s, peak memory, flash
    launches per step, device time by kind of kernel and the flash
    backward's share of it.  Returns (result, config)."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.data import TokenStream
    cfg = get_config(arch)
    _free(torch)
    free, total = torch.cuda.mem_get_info()
    # bf16 weights and grads, f32 moments, and room for the activations
    need = cfg.param_count() * (2 + 2 + 8) + 16e9
    if free < need:
        fail(f"train {arch}: {free / 1e9:.1f} GB free, need {need / 1e9:.1f} GB")
    t = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in opt.leaves(params))
    stream = TokenStream(cfg, batch, seq, seed=0)
    x, y = _batch(torch, stream)
    init_s = time.perf_counter() - t

    # (a) one step's loss and gradients, kernels against plain attention
    par = None
    if parity:
        t = time.perf_counter()
        par = compare_grads(torch, cfg, params, x, y, f"train {arch}")
        par["seconds"] = time.perf_counter() - t
        _free(torch)

    # (b) AdamW steps with the kernels, then one under the profiler: the
    # device's busy share and where its time goes
    opt_cfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=steps)
    state = opt.init_opt_state(params)
    step_fn = st.make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, fwd, bwd = [], 0, 0
    for _ in range(steps):
        x, y = _batch(torch, stream)
        torch.cuda.synchronize()
        fa.launches.reset()
        fa.bwd_launches.reset()
        t = time.perf_counter()
        params, state, m = step_fn(params, state, x, y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        fwd += fa.launches.value
        bwd += fa.bwd_launches.value
        runs.append({"ms": 1e3 * dt, "loss": float(m["loss"]), "grad_norm":
                     float(m["grad_norm"]), "lr": float(m["lr"]),
                     "flash_launches": fa.launches.value,
                     "flash_bwd_launches": fa.bwd_launches.value})
    peak = torch.cuda.max_memory_allocated()
    px, py = _batch(torch, stream)
    profile = device_profile(torch, lambda: step_fn(params, state, px, py), top_n=12)[1]
    if not all(np.isfinite([s_["loss"], s_["grad_norm"]]).all() for s_ in runs):
        fail(f"train {arch}: non-finite loss or grad norm {runs}")
    per_step = [s_["flash_launches"] for s_ in runs], [s_["flash_bwd_launches"] for s_ in runs]
    if set(per_step[0]) != {2 * cfg.num_layers} or set(per_step[1]) != {cfg.num_layers}:
        fail(f"train {arch}: flash launches per step {per_step}, expected "
             f"{2 * cfg.num_layers} forward and {cfg.num_layers} backward")
    steady_ms = statistics.mean(s_["ms"] for s_ in runs[1:])
    flops = train_flops(cfg, batch, seq)
    step_s = steady_ms / 1e3
    del state, m, params
    _free(torch)
    bwd_ms = profile["device_ms_by_category"].get("flash_attention_bwd", 0.0)
    return {"arch": arch, "source": cfg.source, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.head_dim, "params": n_params, "batch": batch, "seq": seq,
            "init_seconds": init_s, "parity": par, "steps": runs, "ms_per_step": steady_ms,
            "ms_per_step_median": statistics.median(s_["ms"] for s_ in runs[1:]),
            "tokens_per_s": batch * seq / step_s,
            "flops_model": flops["model"], "flops_executed": flops["executed"],
            "bound_ms_bf16": 1e3 * flops["executed"] / PEAK_FLOPS["bfloat16"],
            "share_of_bf16_peak_executed": flops["executed"] / step_s / PEAK_FLOPS["bfloat16"],
            "share_of_bf16_peak_model": flops["model"] / step_s / PEAK_FLOPS["bfloat16"],
            "peak_memory_bytes": peak, "free_bytes_before": free, "total_bytes": total,
            "profiled_step": profile, "flash_bwd_device_ms": bwd_ms,
            "flash_bwd_share_of_device_time": bwd_ms / profile["device_ms"],
            "flash_launches_per_step": 2 * cfg.num_layers,
            "flash_bwd_launches_per_step": cfg.num_layers,
            "launches": {"flash_attention": fwd, "flash_attention_bwd": bwd}}, cfg


def phase_train_full_width(torch):
    """InternLM2-1.8B and HuBERT-XLarge at their published width and depth
    trained through the port's entry points (``train_arch_full_width``),
    InternLM2 also through the launcher; then tiny_lm, each family's smoke
    step and a checkpoint round trip."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.configs.pipelines import tiny_lm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.train import checkpoint
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.data import TokenStream

    def batch(stream):
        return _batch(torch, stream)

    main, cfg = train_arch_full_width(torch, TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                      steps=TRAIN_STEPS)
    encoder, _ = train_arch_full_width(torch, ENCODER_ARCH, batch=ENCODER_BATCH,
                                       seq=ENCODER_SEQ, steps=ENCODER_STEPS)
    opt_cfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1)

    # (b2) the same through the entry point a user calls: the launcher
    launcher = run_train_launcher(torch, ["--arch", TRAIN_ARCH, "--full-config", "--batch",
                                          str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                                          "--steps", str(TRAIN_STEPS), "--lr", "1e-4"])
    if (launcher["flash_launches"], launcher["flash_bwd_launches"]) != (
            2 * cfg.num_layers * TRAIN_STEPS, cfg.num_layers * TRAIN_STEPS):
        fail(f"train_full_width: the launcher's flash launches {launcher}")
    _free(torch)

    # (c) tiny_lm's loss falls over 30 steps, as tests/test_train.py requires of JAX
    tcfg = tiny_lm("train_t", vocab=64)
    tparams = T.init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
    tstate = opt.init_opt_state(tparams)
    tstep = st.make_train_step(tcfg, opt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                                     total_steps=100))
    tstream = TokenStream(tcfg, 8, 32, seed=0)
    fa.launches.reset()
    fa.bwd_launches.reset()
    losses = []
    for _ in range(30):
        tx, ty = batch(tstream)
        tparams, tstate, tm = tstep(tparams, tstate, tx, ty)
        losses.append(float(tm["loss"]))
    tiny = {"losses_every_10": losses[::10] + [losses[-1]],
            "flash_launches": fa.launches.value, "flash_bwd_launches": fa.bwd_launches.value}
    if not (np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0]):
        fail(f"train_full_width: tiny_lm's loss did not fall: {losses}")
    if (tiny["flash_launches"], tiny["flash_bwd_launches"]) != (60 * tcfg.num_layers,
                                                               30 * tcfg.num_layers):
        fail(f"train_full_width: tiny_lm's flash launches {tiny}")

    # (d) one step of each family's smoke config, kernels against plain
    families = {}
    for arch in FAMILY_ARCHS:
        fcfg = get_config(arch, smoke=True)
        fparams = T.init_params(fcfg, torch.Generator(device="cuda").manual_seed(1))
        fx, fy = batch(TokenStream(fcfg, 2, 128, seed=1))
        families[arch] = compare_grads(torch, fcfg, fparams, fx, fy, f"family {arch}")
    scfg = get_config(SSM_ARCH, smoke=True)
    sparams = T.init_params(scfg, torch.Generator(device="cuda").manual_seed(1))
    sx, sy = batch(TokenStream(scfg, 2, 64, seed=1))
    try:
        st.loss_and_grads(scfg, sparams, sx, sy)
        fail("train_full_width: the SSM's CUDA scan took a gradient (it has no backward)")
    except NotImplementedError as e:
        families[SSM_ARCH] = {"refused": str(e)}

    # (e) checkpoint round trip at full width and 2 layers' depth, after one step
    ccfg = cfg.replace(num_layers=2)
    cparams = T.init_params(ccfg, torch.Generator(device="cuda").manual_seed(2))
    cstate = opt.init_opt_state(cparams)
    cparams, cstate, _ = st.make_train_step(ccfg, opt_cfg)(cparams, cstate, *batch(stream))
    path = os.path.join(ROOT, "build", "train_ckpt", "ck.npz")
    t = time.perf_counter()
    checkpoint.save(path, cparams, cstate, step=1)
    lp, ls, lstep = checkpoint.load(path, tree_map(torch.zeros_like, cparams),
                                    tree_map(torch.zeros_like, cstate))
    ck_s = time.perf_counter() - t
    ck_bytes = os.path.getsize(path)
    os.remove(path)
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
        for a, b in zip(opt.leaves({"p": cparams, "o": cstate}), opt.leaves({"p": lp, "o": ls})))
    if not (same and lstep == 1):
        fail("train_full_width: the checkpoint did not round-trip bit for bit")
    del cparams, cstate, lp, ls
    _free(torch)
    launches = {k: main["launches"][k] + encoder["launches"][k] for k in main["launches"]}
    return {"phase": "train_full_width", **main, "launches": launches,
            "encoder": encoder, "launcher": launcher, "tiny_lm": tiny, "families": families,
            "checkpoint": {"layers": 2, "bytes": ck_bytes, "seconds": ck_s, "bitwise": same}}


MOE_ARCH = "qwen3_moe_30b_a3b"


def phase_moe_full_width(torch):
    """Qwen3-30B-A3B at its published width and depth (48 layers, 128
    experts top-8), every expert run over its C slots as the reference
    formulation does: each decode step reads every expert's weights, so
    its bytes bound the step from below."""
    from repro_torch.configs.base import get_config
    cfg = get_config(MOE_ARCH)
    expert_bytes = cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff * 2
    _free(torch)
    free, _ = torch.cuda.mem_get_info()
    need = cfg.param_count() * 2 + 8 * 2048 * cfg.num_layers * 2 * cfg.num_kv_heads \
        * cfg.head_dim * 2
    if free < need:
        fail(f"moe_full_width: {free / 1e9:.1f} GB free on the card, the weights and the "
             f"KV pool need {need / 1e9:.1f} GB (an earlier phase was not released)")
    out = serve_paged_full_width(torch, MOE_ARCH, prefix_cache=False, drops=True)
    out.update({"phase": "moe_full_width", "num_experts": cfg.num_experts,
                "experts_per_token": cfg.experts_per_token,
                "expert_bytes": expert_bytes,
                "decode_bound_ms_expert_weights": 1e3 * expert_bytes / HBM_BYTES_PER_S,
                "decode_bound_ms_all_weights": 1e3 * out["param_bytes"] / HBM_BYTES_PER_S})
    if out["decode_argmax_agree"] < 0.99:
        fail(f"moe_full_width: decode argmax agreement {out['decode_argmax_agree']} < 0.99")
    return out


# ---------------------------------------------------------------------------
# phase ep_full_width: Qwen3-30B-A3B's experts split over two ranks
# ---------------------------------------------------------------------------

EP_RANKS = 2
EP_BATCH, EP_PROMPT, EP_DECODE = 4, 1024, 16
EP_MAX_SEQ = EP_PROMPT + EP_DECODE
EP_SEED = 20
EP_WARMUP = 16
# layer 0's MoE output, expert-parallel against dense, on the same bf16
# input: the same bf16 expert outputs added in other groupings (each
# rank's partial sum rounds to bf16 before the all-reduce adds the two),
# so held to the bf16 tolerance; its aux (f32, from the same counts and
# gates, summed in another order) to 1e-5 relative
EP_Y_TOL = 2e-2
EP_AUX_RTOL = 1e-5
# activations, KV cache, logits and the draw's temporaries of one rank,
# beside its weights (phase moe_full_width's peak less its weights: 4.7 GB)
EP_RANK_MARGIN = 5e9


def ep_params(torch, cfg, e_lo: int, e_hi: int, seed: int = EP_SEED) -> dict:
    """Qwen3-30B-A3B's parameters drawn on the card, holding only the
    experts [e_lo, e_hi) of every layer: the embedding, final norm and LM
    head from one generator, each layer's block from a generator of its
    own seeded by the layer (its whole expert stack, (128, 2048, 768) a
    leaf, is drawn and only the rows [e_lo, e_hi) kept), so every run
    holds the same values for the experts it has and none holds another
    run's experts."""
    from repro_torch.models import layers as L
    dev, d, V = "cuda", cfg.d_model, cfg.vocab_size
    dtype = L.torch_dtype(cfg.dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.empty((V, d), dtype=dtype, device=dev)
    for lo in range(0, V, 1 << 14):
        hi = min(lo + (1 << 14), V)
        emb[lo:hi] = torch.randn((hi - lo, d), generator=g, device=dev) * 0.02
    p = {"embed": emb, "final_ln": L.init_rmsnorm(d, dtype, dev),
         "lm_head": L._dense_init(g, (d, V), d, dtype)}
    blocks = None
    for i in range(cfg.num_layers):
        b = L.init_block(cfg, torch.Generator(device=dev).manual_seed(seed * 1000 + 1 + i))
        for k in ("wg", "wu", "wd"):
            b["moe"][k] = b["moe"][k][e_lo:e_hi]
        if blocks is None:
            blocks = L.tree_map(lambda a: torch.empty((cfg.num_layers, *a.shape), dtype=a.dtype,
                                                      device=dev), b)
        L._tree_zip(lambda dst, src: dst[i].copy_(src), blocks, b)
        del b
    p["blocks"] = blocks
    return p


def tap_first_moe(torch, store: dict):
    """Records the first ``moe_forward`` call from now on (layer 0 of a
    prefill): its output y and aux and the (token, expert) pairs it
    dropped.  Returns a function that removes the tap."""
    from repro_torch.models import moe
    orig = moe.moe_forward

    def first(cfg, p, x, routes=None):
        if "y" in store:
            return orig(cfg, p, x, routes)
        run = moe.drop_counter
        moe.drop_counter = torch.zeros((), dtype=torch.long, device=x.device)
        try:
            y, aux = orig(cfg, p, x, routes)
            store.update(x=x.float().cpu().numpy(), y=y.float().cpu().numpy(),
                         aux=float(aux), drops=int(moe.drop_counter))
            if run is not None:
                run.add_(moe.drop_counter)
        finally:
            moe.drop_counter = run
        return y, aux

    moe.moe_forward = first
    return lambda: setattr(moe, "moe_forward", orig)


def ep_forward_run(torch, cfg, params, prompts, feed):
    """The run both sides make: after a short warm-up prefill,
    ``forward_prefill`` of the prompts (timed, layer 0's MoE tapped,
    dropped pairs and flash launches counted), then
    ``EP_DECODE`` steps of ``forward_decode`` fed ``feed`` (None: each
    step's own greedy tokens).  Returns host numbers and the cache."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    tok = torch.as_tensor(prompts, device="cuda")
    with torch.no_grad():               # warm-up: libraries, kernels, allocator
        T.forward_prefill(cfg, params, tok[:, :EP_WARMUP], EP_MAX_SEQ)
    layer0 = {}
    untap = tap_first_moe(torch, layer0)
    moe.drop_counter = torch.zeros((), dtype=torch.long, device="cuda")
    fa.launches.reset()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            logits, cache = T.forward_prefill(cfg, params, tok, EP_MAX_SEQ)
            last = logits[:, -1].float()
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t)
    finally:
        untap()
    flash = fa.launches.value
    prefill_drops = int(moe.drop_counter)
    del logits
    nxt = last.argmax(-1)
    tokens, step_logits, step_ms = [nxt.cpu().numpy()], [], []
    for i in range(EP_DECODE):
        inp = nxt if feed is None else torch.as_tensor(feed[:, i], device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            lg, cache = T.forward_decode(cfg, params, cache, inp[:, None], EP_PROMPT + i)
        lg = lg[:, 0].float()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        nxt = lg.argmax(-1)
        tokens.append(nxt.cpu().numpy())
        step_logits.append(lg.cpu().numpy())
    drops = int(moe.drop_counter)
    moe.drop_counter = None
    return {"last_logits": last.cpu().numpy(), "tokens": np.stack(tokens, 1),
            "step_logits": np.stack(step_logits), "prefill_ms": prefill_ms,
            "decode_ms_per_step": statistics.median(step_ms), "flash_launches": flash,
            "prefill_drops": prefill_drops, "decode_drops": drops - prefill_drops,
            "layer0": layer0}, cache


def ep_rank(rank, world, store_path, prompts, feed, queue):
    """One expert-parallel rank on cuda:0: gloo through a FileStore, a
    (data 1, model ``world``) mesh, the experts [rank E / world, (rank + 1)
    E / world) of every layer and a replicated copy of the rest; the dense
    run's prefill and decode steps (fed its tokens) under
    ``distribution(DistContext(mesh, moe_impl="ep"))``, then one prefill
    and one decode step with every all-reduce timed.  Sends its numbers
    through ``queue``."""
    import datetime
    import traceback
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(minutes=10))
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs.base import get_config
        from repro_torch.models import moe_ep
        from repro_torch.models import transformer as T
        from repro_torch.sharding.context import DistContext, distribution
        cfg = get_config(MOE_ARCH)
        e_loc = cfg.num_experts // world
        mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = ep_params(torch, cfg, rank * e_loc, (rank + 1) * e_loc)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t
        param_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
        with distribution(DistContext(mesh=mesh, moe_impl="ep")):
            out, cache = ep_forward_run(torch, cfg, params, prompts, feed)
            moe_ep.allreduce_log = []
            with torch.no_grad():
                T.forward_prefill(cfg, params, torch.as_tensor(prompts, device="cuda"),
                                  EP_MAX_SEQ)
                prefill_log, moe_ep.allreduce_log = moe_ep.allreduce_log, []
                T.forward_decode(cfg, params, cache, torch.as_tensor(feed[:, -1:], device="cuda"),
                                 EP_MAX_SEQ - 1)
                decode_log = moe_ep.allreduce_log
            moe_ep.allreduce_log = None
        torch.cuda.synchronize()
        out.update({"rank": rank, "experts": [rank * e_loc, (rank + 1) * e_loc],
                    "draw_s": draw_s, "param_bytes": param_bytes,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "allreduce_prefill": {"count": len(prefill_log),
                                          "ms": 1e3 * sum(prefill_log)},
                    "allreduce_decode": {"count": len(decode_log), "ms": 1e3 * sum(decode_log),
                                         "ms_each": [1e3 * x for x in decode_log[:4]]}})
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()[-3000:]}))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ep_ranks(prompts, feed, timeout=900):
    """``ep_rank`` on ``EP_RANKS`` spawned processes; their numbers by
    rank.  A rank that fails or outlives ``timeout`` fails the phase, and
    every process is stopped before this returns."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=ep_rank, args=(r, EP_RANKS, os.path.join(tmp, "store"),
                                                   prompts, feed, q))
                 for r in range(EP_RANKS)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < EP_RANKS:
                try:
                    rank, out = q.get(timeout=5)
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        fail(f"ep_full_width: ranks exited {[p.exitcode for p in procs]} "
                             f"or ran past {timeout} s")
                    continue
                if "error" in out:
                    fail(f"ep_full_width: rank {rank} failed:\n{out['error']}")
                got[rank] = out
            for p in procs:
                p.join(120)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return got


def phase_ep_full_width(torch):
    """Qwen3-30B-A3B at its published width and depth, its 128 experts
    split over two ranks that time-share the card (``models/moe_ep.py``:
    each rank runs its 64 experts of every layer, one all-reduce over the
    model axis combines them), held against the dense path on the same
    weights: the dense run's prefill of 4 prompts of 1024 tokens and 16
    greedy decode steps, then the same on the two ranks (fed the dense
    run's tokens).  gloo carries the all-reduces (NCCL refuses two ranks
    on one device), CUDA tensors through host memory."""
    import numpy as np

    from repro_torch.configs.base import get_config
    cfg = get_config(MOE_ARCH)
    expert_bytes = cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff * 2
    param_bytes = cfg.param_count() * 2
    prompts = np.random.default_rng(EP_SEED).integers(
        0, cfg.vocab_size, (EP_BATCH, EP_PROMPT)).astype(np.int64)

    _free(torch)
    free, _ = torch.cuda.mem_get_info()
    if free < param_bytes + EP_RANK_MARGIN:
        fail(f"ep_full_width: {free / 1e9:.1f} GB free for the dense reference, it needs "
             f"{(param_bytes + EP_RANK_MARGIN) / 1e9:.1f} GB (an earlier phase was not released)")
    t = time.perf_counter()
    params = ep_params(torch, cfg, 0, cfg.num_experts)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t
    dense, cache = ep_forward_run(torch, cfg, params, prompts, None)
    dense.update(draw_s=draw_s, max_memory_allocated=torch.cuda.max_memory_allocated())
    del params, cache
    _free(torch)

    free, _ = torch.cuda.mem_get_info()
    rank_bytes = (param_bytes - expert_bytes) + expert_bytes // EP_RANKS
    need = EP_RANKS * (rank_bytes + EP_RANK_MARGIN)
    if free < need:
        fail(f"ep_full_width: {free / 1e9:.1f} GB free on the card, the {EP_RANKS} ranks need "
             f"{need / 1e9:.1f} GB (the dense reference was not released)")
    feed = dense["tokens"][:, :EP_DECODE]
    t = time.perf_counter()
    with GpuMemorySampler() as smi:
        ranks = spawn_ep_ranks(prompts, feed)
    ep_s = time.perf_counter() - t

    # checks: rank 0's numbers (both ranks hold the combined outputs)
    r0 = ranks[0]
    scale = float(np.abs(dense["last_logits"]).max())
    diff = float(np.abs(r0["last_logits"] - dense["last_logits"]).max())
    first_equal = bool((r0["tokens"][:, 0] == dense["tokens"][:, 0]).all())
    agree = float((r0["tokens"][:, 1:] == dense["tokens"][:, 1:]).mean())
    l0d, l0e = dense["layer0"], r0["layer0"]
    y_err = float(np.abs(l0e["y"] - l0d["y"]).max())
    y_ok = bool((np.abs(l0e["y"] - l0d["y"]) <= EP_Y_TOL + EP_Y_TOL * np.abs(l0d["y"])).all())
    aux_rel = abs(l0e["aux"] - l0d["aux"]) / abs(l0d["aux"])
    l0_drops = sum(r["layer0"]["drops"] for r in ranks.values())
    out = {"phase": "ep_full_width", "ranks": EP_RANKS, "mesh": {"data": 1, "model": EP_RANKS},
           "backend": "gloo", "batch": EP_BATCH, "prompt": EP_PROMPT, "decode_steps": EP_DECODE,
           "param_bytes": param_bytes, "expert_bytes": expert_bytes,
           "rank_param_bytes": {r: v["param_bytes"] for r, v in ranks.items()},
           "prefill_logits_max_abs_diff": diff, "prefill_logits_max_abs": scale,
           "prefill_logits_rtol": FULL_WIDTH_LOGIT_RTOL, "first_tokens_equal": first_equal,
           "prefill_top2_gap_dense": np.diff(np.sort(dense["last_logits"], -1)[:, -2:],
                                             axis=-1)[:, 0].tolist(),
           "decode_argmax_agree": agree,
           "layer0": {"y_max_abs_err": y_err, "y_tol": EP_Y_TOL,
                      "y_share_differing": float((l0e["y"] != l0d["y"]).mean()),
                      "input_max_abs_diff": float(np.abs(l0e["x"] - l0d["x"]).max()),
                      "aux_dense": l0d["aux"], "aux_ep": l0e["aux"], "aux_rel_err": aux_rel,
                      "drops_dense": l0d["drops"],
                      "drops_by_rank": {r: v["layer0"]["drops"] for r, v in ranks.items()}},
           "dense": {k: dense[k] for k in ("draw_s", "prefill_ms", "decode_ms_per_step",
                                           "flash_launches", "prefill_drops", "decode_drops",
                                           "max_memory_allocated")},
           "by_rank": {r: {k: v[k] for k in ("experts", "draw_s", "prefill_ms",
                                             "decode_ms_per_step", "flash_launches",
                                             "prefill_drops", "decode_drops",
                                             "max_memory_allocated", "allreduce_prefill",
                                             "allreduce_decode")}
                       for r, v in ranks.items()},
           "decode_logits_max_abs_diff": float(np.abs(r0["step_logits"]
                                                      - dense["step_logits"]).max()),
           "nvidia_smi_max_mib": max(smi.samples) if smi.samples else None,
           "ep_seconds": ep_s}
    failed = []
    if not (diff <= FULL_WIDTH_LOGIT_RTOL * scale and np.isfinite(r0["last_logits"]).all()):
        failed.append(f"prefill logits max |ep - dense| = {diff} > {FULL_WIDTH_LOGIT_RTOL} x "
                      f"{scale}")
    if not first_equal:
        failed.append(f"first tokens differ: {r0['tokens'][:, 0]} vs {dense['tokens'][:, 0]}")
    if agree < 0.99:
        failed.append(f"decode argmax agreement {agree} < 0.99")
    if not (y_ok and aux_rel <= EP_AUX_RTOL and l0_drops == l0d["drops"]):
        failed.append(f"layer 0's MoE: {out['layer0']}")
    if any(v["flash_launches"] != cfg.num_layers for v in ranks.values()):
        failed.append(f"flash launches per rank {[v['flash_launches'] for v in ranks.values()]}"
                      f" != {cfg.num_layers}")
    if failed:
        emit(out)
        fail("ep_full_width: " + "; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# phase dryrun: steps on meta DTensors for the production mesh
# ---------------------------------------------------------------------------

DRYRUN_COMBOS = (("qwen2_5_14b", "train_4k", "gspmd", False),
                 ("qwen3_moe_30b_a3b", "decode_32k", "ep", False),
                 ("qwen3_moe_30b_a3b", "decode_32k", "gspmd", False),
                 ("internlm2_1_8b", "prefill_32k", "gspmd", False),
                 ("falcon_mamba_7b", "decode_32k", "gspmd", False),
                 ("zamba2_2_7b", "train_4k", "gspmd", False),
                 ("qwen2_5_14b", "decode_32k", "gspmd", True))

#: collective bytes a device of every combo of ``DRYRUN_COMBOS``, as the
#: same code counts them with torch 2.13 on the CPU (``python -m
#: repro_torch.launch.dryrun``): every byte comes from the dry-run's own
#: placement rules, so no torch version may count another
DRYRUN_TORCH_2_13 = {("qwen2_5_14b", "train_4k", "gspmd", False): 5137769602224,
                     ("qwen3_moe_30b_a3b", "decode_32k", "ep", False): 80371904,
                     ("qwen3_moe_30b_a3b", "decode_32k", "gspmd", False): 433372736,
                     ("internlm2_1_8b", "prefill_32k", "gspmd", False): 45365592064,
                     ("falcon_mamba_7b", "decode_32k", "gspmd", False): 13238272,
                     ("zamba2_2_7b", "train_4k", "gspmd", False): 395692179888,
                     ("qwen2_5_14b", "decode_32k", "gspmd", True): 50279936}


def phase_dryrun(torch):
    """``repro_torch.launch.dryrun.run_one`` for ``DRYRUN_COMBOS`` on the
    16x16 mesh (one on 2x16x16) and ``dryrun_pipeline``'s three stages,
    in this process under a fake process group, on meta tensors: this
    machine's torch is the one checked; the card is not used.  Every
    record must be "ok", no op may be placed by DTensor's own strategy
    (``dtensor_ops``) or run on replicated operands, and every combo must
    count torch 2.13's bytes (``DRYRUN_TORCH_2_13``)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import dryrun_pipeline as DP
    recs = []
    for combo in DRYRUN_COMBOS:
        arch, shape, moe_impl, multi_pod = combo
        rec = D.run_one(arch, shape, multi_pod, os.path.join(ROOT, "chiprun_out", "dryrun"),
                        moe_impl=moe_impl)
        if rec["status"] != "ok":
            fail(f"dryrun: {arch} x {shape} ({moe_impl}): {rec.get('error')}\n"
                 f"{rec.get('traceback')}")
        got, want = rec["collective_bytes"].get("total", 0), DRYRUN_TORCH_2_13[combo]
        rec["collective_bytes_torch_2_13"] = want
        print(f"dryrun {arch} x {shape} {rec['mesh']} ({moe_impl}): {got} collective bytes "
              f"with torch {torch.__version__}, {want} with torch 2.13; dtensor_ops "
              f"{rec['dtensor_ops']}, replicated_ops {rec['replicated_ops']}, resharded_ops "
              f"{rec['resharded_ops']}; {rec['run_s']} s", flush=True)
        if rec["dtensor_ops"]:
            fail(f"dryrun: {arch} x {shape}: DTensor placed ops: {rec['dtensor_ops']}")
        if rec["replicated_ops"]:
            fail(f"dryrun: {arch} x {shape}: ops ran replicated: {rec['replicated_ops']}")
        if got != want:
            fail(f"dryrun: {arch} x {shape}: the collective bytes moved with torch")
        recs.append({k: v for k, v in rec.items() if k != "traceback"})
    stages = [DP.run_stage(i) for i in range(len(DP.STAGES))]
    return {"phase": "dryrun", "torch": torch.__version__, "combos": recs, "pipeline": stages}


# ---------------------------------------------------------------------------
# phase examples: the port's five examples (examples/*_torch.py) on the card
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "examples")
EXAMPLE_NAMES = ("quickstart", "image_generation", "omni_serving", "process_isolation",
                 "train_tiny")
# the examples' process isolation once more at a published width: the
# model and prompts of phase pd_full_width, two spawned decode replicas
ISOLATION_ARCH = "internlm2_1_8b"
ISOLATION_MAX_SEQ = 2048
ISOLATION_NEW = 32
TRAIN_TINY_STEPS = 50
# the example's 50 steps close at least this share of the gap between the
# first step's loss and ln(vocab), a uniform prediction's loss: what a
# random init adds above it is what falls first (the JAX example's
# 7.5072 -> 6.9930 closes 0.89 of it, the port's seeded init's 7.3496 ->
# 6.9944 0.85, both in f32 on the CPU; ln 1024 = 6.9315)
TRAIN_TINY_GAP = 0.5


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module (examples/ is no package)."""
    import importlib.util
    path = os.path.join(EXAMPLES_DIR, f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def greedy_orchestrator(stages):
    """The port's Orchestrator with the named AR stages' sampling made
    greedy and the Talker's streamed chunks kept in each request's data."""
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.engine.sampling import SamplingParams

    class Greedy(Orchestrator):
        def __init__(self, graph, engines, *a, **kw):
            for name in stages:
                n = engines[name].default_sampling.max_new_tokens
                engines[name].default_sampling = SamplingParams(max_new_tokens=n,
                                                                temperature=0.0)
            tap_talker_tokens(graph)
            super().__init__(graph, engines, *a, **kw)
    return Greedy


def check_finished(name: str, reqs, out_stage: str) -> None:
    done = [r for r in reqs if r.completion_time is not None and not r.failed
            and r.outputs.get(out_stage)]
    if len(done) != len(reqs) or not reqs:
        fail(f"examples {name}: {len(done)}/{len(reqs)} requests completed: "
             f"{[r.failed for r in reqs if r.failed]}")


def counted(torch, fn):
    """fn() with every kernel's launches counted from 0 and its wall time:
    (result, launches, seconds)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    counters = {"paged_attention": pa.launches, "flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.value for k, c in counters.items()}, time.perf_counter() - t0


def isolation_run(torch, ex, label, **kw):
    """process_isolation_torch's ``run`` on the card: its tokens, its
    decode stage's request split and each child's device and launches."""
    out, launches, seconds = counted(torch, lambda: ex.run("cuda", **kw))
    reqs = out["requests"]
    check_finished(label, reqs, "decode")
    m = out["decode"]
    children = [{"device": c.get("device"),
                 "paged_launches": c.get("kernel_launches", {}).get("paged_attention", 0),
                 "consumed": c.get("consumed"), "engine_steps": c.get("engine_steps"),
                 "busy_s": c.get("busy_time")} for c in out["children"]]
    return {"run": label, "seconds": seconds, "wall_s": out["wall"],
            "jct_s": [r.jct for r in reqs], "finished": m["finished"],
            "n_replicas": m["n_replicas"], "replica_failures": m["replica_failures"],
            "split": {str(rid): row.get("finished") for rid, row in
                      m.get("replicas", {}).items()},
            "children": children, "launches": launches}, \
        [[int(t) for t in r.outputs["decode"][0]["tokens"]] for r in reqs]


def isolation_launches(label: str, runs: dict) -> dict:
    """Each run's launches in this process, and each spawned child's own."""
    out = {f"{label}.{run}": r["launches"] for run, r in runs.items()}
    for i, c in enumerate(runs["spawned"]["children"]):
        out[f"{label}.spawned.child{i}"] = {"paged_attention": c["paged_launches"]}
    return out


def phase_examples(torch):
    """The five port examples through their entry functions on the card,
    at their own settings (omni_serving greedy, so that the pipeline's text
    and the monolithic baseline's can be held to each other), each
    kernel's launches counted per example; then process_isolation's
    function at InternLM2-1.8B's published width and depth with two
    spawned decode replicas, against the same run with every stage a
    thread."""
    import numpy as np

    from repro_torch.baselines import monolithic as mono_mod
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import leaves

    mods = {name: load_example(name) for name in EXAMPLE_NAMES}
    out, launches = {"phase": "examples"}, {}

    # quickstart: planner (hidden states) -> writer over the shm connector
    qs, launches["quickstart"], secs = counted(torch, lambda: mods["quickstart"].run("cuda"))
    check_finished("quickstart", qs["requests"], "writer")
    if any(len(r.outputs["writer"][0]["tokens"]) != 16 for r in qs["requests"]):
        fail("examples quickstart: a writer stream is not 16 tokens")
    if launches["quickstart"]["paged_attention"] <= 0:
        fail("examples quickstart: the paged kernel was not launched")
    out["quickstart"] = {"seconds": secs, "jct_s": [r.jct for r in qs["requests"]],
                         "connector_stats": qs["connector_stats"]}

    # image_generation: AR -> DiT with TeaCache reuse
    ig, launches["image_generation"], secs = counted(
        torch, lambda: mods["image_generation"].run("cuda"))
    check_finished("image_generation", ig["requests"], "glm_image_dit")
    for r in ig["requests"]:
        (img,) = r.outputs["glm_image_dit"]
        lat = np.asarray(img["latent"])
        if lat.shape != (64, 32) or not np.isfinite(lat).all():
            fail(f"examples image_generation: latent {lat.shape}, finite "
                 f"{np.isfinite(lat).all()}")
    if min(launches["image_generation"][k] for k in ("paged_attention",
                                                      "flash_attention")) <= 0:
        fail(f"examples image_generation: launches {launches['image_generation']}")
    out["image_generation"] = {"seconds": secs, "jct_s": [r.jct for r in ig["requests"]],
                               "latent_std": [float(np.asarray(r.outputs["glm_image_dit"][0][
                                   "latent"]).std()) for r in ig["requests"]]}

    # omni_serving, greedy: the kernels' run against the plain versions', and
    # the monolithic baseline's text against the pipeline's
    omni_mod = mods["omni_serving"]
    omni_mod.Orchestrator = greedy_orchestrator(("thinker", "talker"))
    sample = mono_mod.sample_tokens
    mono_mod.sample_tokens = lambda logits, t, k, gen=None: torch.argmax(
        logits, dim=-1).to(torch.int32)
    omni, streams = {}, {}
    try:
        for backend in ("cuda", "ref"):
            ops.set_backend(backend)
            res, n, secs = counted(torch, lambda: omni_mod.run(device="cuda"))
            check_finished(f"omni_serving ({backend})", res["requests"], "vocoder")
            streams[backend] = {
                "pipeline": [(r.data["thinker_tokens"].tolist(), r.data["talker_chunks"])
                             for r in res["requests"]],
                "monolithic": [(m["text"].tolist(), m["codec"].tolist())
                               for m in res["monolithic"]]}
            omni[backend] = (res, n, secs)
    finally:
        ops.set_backend("auto")
        mono_mod.sample_tokens = sample
    res, launches["omni_serving"], secs = omni["cuda"]
    for r in res["requests"]:
        chunks = r.outputs["vocoder"]
        frames = sum(np.asarray(c["latent"]).shape[0] for c in chunks)
        if len(chunks) != 5 or frames != 80:
            fail(f"examples omni_serving: {frames} frames in {len(chunks)} chunks")
    if streams["cuda"] != streams["ref"]:
        fail("examples omni_serving: greedy tokens differ between the kernels and the "
             "plain versions")
    texts = [t for t, _ in streams["cuda"]["pipeline"]]
    if [t for t, _ in streams["cuda"]["monolithic"]] != texts or len(res["monolithic"]) != 8:
        fail("examples omni_serving: the monolithic baseline's greedy text differs from "
             "the pipeline's")
    if min(launches["omni_serving"][k] for k in ("paged_attention", "flash_attention")) <= 0:
        fail(f"examples omni_serving: launches {launches['omni_serving']}")
    jct, jct_m = res["jct"], res["jct_monolithic"]
    print(f"examples omni_serving: mean JCT {jct:.3f} s disaggregated, {jct_m:.3f} s "
          f"monolithic", flush=True)
    out["omni_serving"] = {"seconds": secs, "wall_s": res["wall"], "jct_mean_s": jct,
                           "jct_monolithic_mean_s": jct_m,
                           "jct_s": [r.jct for r in res["requests"]],
                           "jct_monolithic_s": [m["jct"] for m in res["monolithic"]],
                           "stage_busy_s": res["stage_busy"],
                           "greedy_text_equal_monolithic": True,
                           "greedy_tokens_equal_plain": True}

    # process_isolation at its own settings: two spawned children on the
    # card, then every stage a thread
    ex = mods["process_isolation"]
    runs, tokens = {}, {}
    runs["spawned"], tokens["spawned"] = isolation_run(torch, ex, "process_isolation")
    runs["threads"], tokens["threads"] = isolation_run(torch, ex, "process_isolation threads",
                                                       spawn=False)
    if tokens["spawned"] != tokens["threads"]:
        fail(f"examples process_isolation: spawned {tokens['spawned']} against threads "
             f"{tokens['threads']}")
    launches.update(isolation_launches("process_isolation", runs))
    out["process_isolation"] = runs

    # the same at InternLM2-1.8B's width and depth on pd_full_width's prompts
    _free(torch)
    cfg = get_config(ISOLATION_ARCH)
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1537, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    kw = dict(cfg=cfg, prompts=prompts, max_new=ISOLATION_NEW, max_seq=ISOLATION_MAX_SEQ)
    full, ftokens = {}, {}
    with GpuMemorySampler() as sampler:
        full["spawned"], ftokens["spawned"] = isolation_run(
            torch, ex, "process_isolation full width", **kw)
    full["spawned"]["nvidia_smi_memory_used_mib_max"] = max(sampler.samples, default=None)
    _free(torch)
    full["threads"], ftokens["threads"] = isolation_run(
        torch, ex, "process_isolation full width threads", spawn=False, **kw)
    _free(torch)
    sp = full["spawned"]
    if sp["replica_failures"] or sp["n_replicas"] != 2 or sp["finished"] != len(prompts):
        fail(f"examples process_isolation full width: finished {sp['finished']}, "
             f"replicas {sp['n_replicas']}, failures {sp['replica_failures']}")
    if len(sp["children"]) != 2 or any(not str(c["device"]).startswith("cuda")
                                       or c["paged_launches"] <= 0 for c in sp["children"]):
        fail(f"examples process_isolation full width: children {sp['children']}")
    if [s[0] for s in ftokens["spawned"]] != [s[0] for s in ftokens["threads"]]:
        fail("examples process_isolation full width: first tokens differ from the "
             "all-thread run's")
    if any(len(s) != ISOLATION_NEW for v in ftokens.values() for s in v):
        fail("examples process_isolation full width: a stream is short")
    same = sum(a == b for x, y in zip(ftokens["spawned"], ftokens["threads"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in ftokens["threads"])
    print(f"examples process_isolation full width: {same}/{total} greedy tokens equal "
          f"to the all-thread run's (not held: bf16 batches differ)", flush=True)
    launches.update(isolation_launches("process_isolation_full_width", full))
    out["process_isolation_full_width"] = {
        "arch": ISOLATION_ARCH, "source": cfg.source, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "dtype": cfg.dtype, "prompt_lens": [int(n) for n in lens],
        "new_tokens": ISOLATION_NEW, "max_seq": ISOLATION_MAX_SEQ, "runs": full,
        "first_tokens_equal": True, "greedy_tokens_equal": same, "greedy_tokens": total,
        "stream_agreement": stream_agreement(ftokens["spawned"], ftokens["threads"])}

    # train_tiny: 50 AdamW steps of the smoke config, then a checkpoint round trip
    ckpt = os.path.join(ROOT, "build", "examples", "train_tiny_ck_torch.npz")
    tr, launches["train_tiny"], secs = counted(
        torch, lambda: mods["train_tiny"].run(steps=TRAIN_TINY_STEPS, device="cuda",
                                              ckpt=ckpt))
    os.remove(ckpt)
    losses, layers = tr["losses"], tr["cfg"].num_layers
    uniform = math.log(tr["cfg"].vocab_size)
    closed = (losses[0] - losses[-1]) / (losses[0] - uniform)
    if not (np.isfinite(losses).all() and closed >= TRAIN_TINY_GAP):
        fail(f"examples train_tiny: the loss closed {closed} of the gap to ln(vocab) "
             f"{uniform} (want {TRAIN_TINY_GAP}): {losses[0]} -> {losses[-1]}")
    (p2, o2), trained = tr["restored"], {"p": tr["params"], "o": tr["opt"]}
    same_bits = tr["restored_step"] == TRAIN_TINY_STEPS and all(
        a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                                           else a,
                                           b.view(torch.int16) if b.dtype == torch.bfloat16
                                           else b)
        for a, b in zip(leaves(trained), leaves({"p": p2, "o": o2})))
    if not same_bits:
        fail("examples train_tiny: the checkpoint did not restore bit for bit")
    want = (2 * layers * TRAIN_TINY_STEPS, layers * TRAIN_TINY_STEPS)
    got = (launches["train_tiny"]["flash_attention"], launches["train_tiny"]["flash_attention_bwd"])
    if got != want:
        fail(f"examples train_tiny: flash forward and backward launches {got}, want {want}")
    out["train_tiny"] = {"seconds": secs, "arch": tr["cfg"].name, "dtype": tr["cfg"].dtype,
                         "steps": TRAIN_TINY_STEPS, "first_loss": losses[0],
                         "final_loss": losses[-1], "losses_every_25": losses[24::25],
                         "gap_to_uniform_closed": closed,
                         "checkpoint_bitwise": True}
    out["launches"] = launches
    return out


def decode_step_check(torch, runner, prompts, what: str):
    """One batched decode step of a PagedRunner, kernel vs plain attention,
    on the same pool: each prompt but its last token is prefilled into
    fresh pages (chunks of 512), then every row decodes its last token
    with backend "cuda" and with "ref".  The logits are held to
    FULL_WIDTH_LOGIT_RTOL of their largest magnitude.  Returns the
    numbers and a function that runs the step again (for a profile)."""
    import numpy as np

    from repro_torch.engine.runner import embed
    from repro_torch.kernels import ops
    B = len(prompts)
    lens = [len(p) for p in prompts]
    positions = (np.asarray(lens) - 1).astype(np.int32)
    pp = runner.kv.max_pages_per_seq
    tables = np.zeros((B, pp), np.int32)
    for s in range(B):       # fresh pages, filled by prefill of the same prompts
        tables[s, :] = s * pp + np.arange(pp)
    for s in range(B):
        n = lens[s]
        for c0 in range(0, n - 1, 512):
            c1 = min(c0 + 512, n - 1)
            emb = embed(runner.params, prompts[s][c0:c1])
            runner.prefill_chunk(torch.as_tensor(emb, device=runner.device)[None],
                                 tables[s], c0, c1 - c0)
    last = np.stack([embed(runner.params, prompts[s][-1:])[0] for s in range(B)])
    embeds = torch.as_tensor(last, device=runner.device).to(torch.bfloat16)[:, None]
    active = np.ones(B, bool)
    logits = {}
    for backend in ("cuda", "ref"):
        ops.set_backend(backend)
        lg, _ = runner.decode(embeds, tables, positions, active)
        logits[backend] = lg.float()
    torch.cuda.synchronize()
    ops.set_backend("auto")
    diff = float((logits["cuda"] - logits["ref"]).abs().max())
    scale = float(logits["ref"].abs().max())
    agree = float((logits["cuda"].argmax(-1) == logits["ref"].argmax(-1)).float().mean())
    if not (diff <= FULL_WIDTH_LOGIT_RTOL * scale and torch.isfinite(logits["cuda"]).all()):
        fail(f"{what} decode logits: max |cuda - ref| = {diff} > "
             f"{FULL_WIDTH_LOGIT_RTOL} x {scale}")
    return ({"decode_logits_max_abs_diff": diff, "decode_logits_max_abs": scale,
             "decode_logits_rtol": FULL_WIDTH_LOGIT_RTOL, "decode_argmax_agree": agree},
            lambda: runner.decode(embeds, tables, positions, active))


# ---------------------------------------------------------------------------
# phase pd_full_width: InternLM2-1.8B, unified and PD-disaggregated
# ---------------------------------------------------------------------------

PD_ARCH = "internlm2_1_8b"
SHM = "/dev/shm"
# the connector's bytes over the requests' KV as f32: bf16 bits are half,
# plus the payload's small leaves and framing
KV_BYTES_LIMIT = 0.51


def shm_usage() -> dict:
    import shutil
    u = shutil.disk_usage(SHM)
    return {"path": SHM, "total_bytes": u.total, "used_bytes": u.used, "free_bytes": u.free}


def kv_payload_bytes(cfg, n_tokens: int, page: int, elt: int = 2) -> int:
    """Bytes of one request's prompt KV on the host: whole pages, K and V,
    ``elt`` bytes per element (bf16 crosses as its 16-bit pattern; 4 is
    the f32 it crossed as before)."""
    return 2 * cfg.num_layers * (-(-n_tokens // page) * page) * cfg.num_kv_heads \
        * cfg.head_dim * elt


class GpuMemorySampler:
    """nvidia-smi's memory.used of card 0, sampled every 0.25 s in a
    thread while a run serves: it counts every process on the card."""

    def __init__(self):
        import threading
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=memory.used",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True)
            if out.returncode == 0 and out.stdout.strip():
                self.samples.append(float(out.stdout.strip().splitlines()[0]))
            self._stop.wait(0.25)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


class PdTaps:
    """Measurement taps on the engines of one run: when each request's
    first token was sampled, the steps of the engine that decodes in this
    process, and the KV hop's two ends (extract on the prefill engine,
    inject on the decode engine).  A step is read off the engine's own
    ``busy_time`` and ``steps``, as a spawned child reports them, and
    counts as a decode step when it ran no prefill chunk (with the CPU
    time its thread spent in it); these taps add no device sync.
    ``verify_hop`` keeps a device copy of each request's prefill pages at
    extraction and holds the decode engine's pages
    against it, bit for bit, right after injection (one sync and one
    compare per request)."""

    def __init__(self, torch, *, sampler, stepper=None, prefill=None, inject=None,
                 verify_hop=False):
        self.torch = torch
        self.first = {}
        self.decode_s, self.decode_steps, self.decode_tokens = 0.0, 0, 0
        self.decode_cpu_s = 0.0
        self.extract_s, self.extract_n, self.extract_bytes = 0.0, 0, 0
        self.inject_s, self.inject_n = 0.0, 0
        self.hop_checked, self.hop_equal = 0, 0
        self._stash = {}
        self._undo = []
        self._prefilled, self._active = False, 0
        self._wrap(sampler, "_sample", self._sample)
        if stepper is not None:
            self._stepper = stepper
            self._wrap(stepper, "step", self._step)
            self._wrap(stepper.runner, "decode", self._decode)
            if hasattr(stepper.runner, "prefill_chunk"):
                self._wrap(stepper.runner, "prefill_chunk", self._prefill_chunk)
        if prefill is not None:
            self._wrap(prefill, "extract_kv", self._extract)
        if inject is not None:
            self._wrap(inject, "inject_kv", self._inject)
        self.verify_hop = verify_hop
        self._prefill, self._inject_runner = prefill, inject

    def _wrap(self, obj, attr, tap):
        inner = getattr(obj, attr)
        self._undo.append((obj, attr, inner))
        setattr(obj, attr, lambda *a, **kw: tap(inner, *a, **kw))

    def undo(self):
        for obj, attr, inner in reversed(self._undo):
            setattr(obj, attr, inner)

    def _sample(self, inner, req_id, logits):
        tok = inner(req_id, logits)
        self.first.setdefault(req_id, time.perf_counter())
        return tok

    def _step(self, inner):
        eng = self._stepper
        self._prefilled, self._active = False, 0
        busy, steps, cpu = eng.busy_time, eng.steps, time.thread_time()
        out = inner()
        if eng.steps > steps and not self._prefilled:
            self.decode_s += eng.busy_time - busy
            self.decode_cpu_s += time.thread_time() - cpu
            self.decode_steps += 1
            self.decode_tokens += self._active
        return out

    def _prefill_chunk(self, inner, *a, **kw):
        self._prefilled = True
        return inner(*a, **kw)

    def _decode(self, inner, embeds, tables, positions, active):
        import numpy as np
        self._active = int(np.asarray(active).sum())
        return inner(embeds, tables, positions, active)

    @staticmethod
    def _key(k_host, n_tokens):
        return int(n_tokens), k_host[0, 0, 0, :8].tobytes()

    def _pages(self, runner, block_table, n_tokens):
        import numpy as np
        n_pages = -(-int(n_tokens) // runner.kv.page_size)
        bt = self.torch.as_tensor(np.asarray(block_table[:n_pages]), dtype=self.torch.long,
                                  device=runner.device)
        return runner.k_pages[:, bt], runner.v_pages[:, bt]

    def _extract(self, inner, block_table, n_tokens):
        t = time.perf_counter()
        k, v, kv_dtype = inner(block_table, n_tokens)
        self.extract_s += time.perf_counter() - t
        self.extract_n += 1
        self.extract_bytes += k.nbytes + v.nbytes
        if self.verify_hop:
            kp, vp = self._pages(self._prefill, block_table, n_tokens)
            self._stash[self._key(k, n_tokens)] = (kp.clone(), vp.clone())
        return k, v, kv_dtype

    def _inject(self, inner, k_seed, v_seed, block_table, n_tokens, kv_dtype):
        import numpy as np
        t = time.perf_counter()
        inner(k_seed, v_seed, block_table, n_tokens, kv_dtype)
        self.torch.cuda.synchronize()
        self.inject_s += time.perf_counter() - t
        self.inject_n += 1
        if self.verify_hop:
            want = self._stash.pop(self._key(np.asarray(k_seed), n_tokens), None)
            self.hop_checked += 1
            if want is not None:
                kp, vp = self._pages(self._inject_runner, block_table, n_tokens)
                self.hop_equal += int(self.torch.equal(kp, want[0])
                                      and self.torch.equal(vp, want[1]))


def serve_pd_run(torch, label, graph, engines, make_reqs, *, out_stage, config=None, taps,
                 process_stage=None, busy_engine=None):
    """Serve ``reqs`` through one graph with the threaded Orchestrator and
    backend "cuda", paged launches counted from 0 (in this process; a
    process stage's child reports its own).  A process stage's child is
    started and waited for before the requests are submitted, so that
    its start-up stays out of the requests' times: ``make_reqs()`` builds
    the requests (which stamp their arrival) just before they are sent.
    Every run is measured the same way: the decoding engine's own busy
    time and steps (``busy_engine`` here, the child's status for a
    process stage) and nvidia-smi sampled from submission to the end."""
    from repro_torch.core.metrics import summarize, summarize_queueing
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    orch = Orchestrator(graph, engines, config=config)
    ops.set_backend("cuda")
    pa.launches.reset()
    torch.cuda.reset_peak_memory_stats()
    out = {"run": label}
    worker = None
    t_start = time.perf_counter()
    orch.start()
    if process_stage is not None:
        worker = orch._workers[process_stage].workers()[0][1]
        deadline = time.perf_counter() + worker.ready_timeout
        while not worker.wait_ready(timeout=0.5):
            if worker.failed or worker.error or time.perf_counter() > deadline:
                orch.shutdown(drain=False)
                fail(f"pd {label}: the {process_stage} child did not start "
                     f"({worker.failure_reason}): {worker.error}")
        out["child_ready_s"] = worker.ready_s
        out["child_start_to_ready_s"] = time.perf_counter() - t_start
    sampler = GpuMemorySampler().__enter__()
    reqs = make_reqs()
    t0 = time.perf_counter()
    try:
        for r in reqs:
            orch.submit(r)
        orch.run(timeout=600.0)
        torch.cuda.synchronize()
    finally:
        sampler.__exit__()
        taps.undo()
        ops.set_backend("auto")
    wall = time.perf_counter() - t0
    done = [r for r in reqs if r.completion_time is not None and not r.failed]
    if len(done) != len(reqs):
        fail(f"pd {label}: {len(done)}/{len(reqs)} requests completed: "
             f"{[r.failed for r in reqs if r.failed]}")
    streams = [[int(t) for t in r.outputs[out_stage][0]["tokens"]] for r in reqs]
    m = summarize(reqs, wall_time=wall)
    ttft = sorted(taps.first[r.req_id] - r.arrival_time for r in reqs)
    out.update({"requests": len(reqs), "completed": len(done), "wall_s": wall,
                "jct_p50_s": m["jct_p50"], "jct_p95_s": m["jct_p95"],
                "ttft_p50_s": ttft[len(ttft) // 2],
                "paged_launches": pa.launches.value,
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "nvidia_smi_memory_used_mib_max": max(sampler.samples, default=None),
                "nvidia_smi_samples": len(sampler.samples)})
    generated = sum(len(s) for s in streams) - len(reqs)    # tokens after the first
    if busy_engine is not None:
        busy_s, steps = busy_engine.busy_time, busy_engine.steps
        dec_s, dec_steps, dec_tok = taps.decode_s, taps.decode_steps, taps.decode_tokens
        # the decoding thread's own CPU time per decode step: the rest of
        # the step is waiting (for the GIL, or for the device)
        out["decode_thread_cpu_ms_per_step"] = 1e3 * taps.decode_cpu_s / max(dec_steps, 1)
    else:                    # the child: its engine runs no prefill chunk
        st = worker.status
        busy_s, steps = st["busy_time"], st["engine_steps"]
        dec_s, dec_steps, dec_tok = busy_s, steps, generated
    out.update({"engine_steps": steps, "engine_busy_s": busy_s,
                "engine_ms_per_step": 1e3 * busy_s / max(steps, 1),
                "engine_tok_per_busy_s": generated / busy_s,
                "decode_steps": dec_steps, "decode_tokens": dec_tok,
                "decode_ms_per_step": 1e3 * dec_s / max(dec_steps, 1),
                "decode_tok_per_s": dec_tok / dec_s})
    if "shm" in orch.connector_stats():
        st = orch.connector_stats()["shm"]
        q = summarize_queueing(reqs).get("decode", {})
        out.update({
            "connector": {"transfers": st.calls, "bytes": st.bytes,
                          "wall_ms": 1e3 * st.wall_time},
            "kv_bytes_per_request": taps.extract_bytes / max(taps.extract_n, 1),
            "extract_ms_per_request": 1e3 * taps.extract_s / max(taps.extract_n, 1),
            "connector_ms_per_request": 1e3 * st.wall_time / max(st.calls, 1),
            "decode_queue_delay_p50_ms": 1e3 * q.get("p50", float("nan")),
            "decode_queue_delay_p95_ms": 1e3 * q.get("p95", float("nan"))})
        # the hop from the prefill engine's pool to the decode engine's
        # admission: extraction, then the decode stage's queue delay (the
        # connector's recv and, for a process stage, the segment written
        # for the child, the control queue and the child's read)
        out["hop_to_admission_ms_p50"] = (out["extract_ms_per_request"]
                                          + out["decode_queue_delay_p50_ms"])
        out["hop_to_admission_share_of_jct_p50"] = (1e-3 * out["hop_to_admission_ms_p50"]
                                                    / m["jct_p50"])
        if taps.inject_n:
            out["inject_ms_per_request"] = 1e3 * taps.inject_s / taps.inject_n
            out["hop_ms_per_request"] = (out["extract_ms_per_request"]
                                         + out["connector_ms_per_request"]
                                         + out["inject_ms_per_request"])
            out["hop_share_of_jct_p50"] = 1e-3 * out["hop_ms_per_request"] / m["jct_p50"]
    if worker is not None:
        st = worker.status
        injects = st.get("kv_injects") or 0
        out.update({"child_kv_injects": injects,
                    "child_inject_ms_per_request": (1e3 * st["kv_inject_time"] / injects
                                                    if injects else None)})
        out.update({"child_device": st.get("device"),
                    "child_paged_launches": st.get("kernel_launches", {}).get(
                        "paged_attention", 0),
                    "child_loop_steps": st.get("steps"),
                    "replica_failures": orch.stage_metrics()[process_stage][
                        "replica_failures"]})
    return out, streams


def stream_agreement(a, b) -> dict:
    same = sum(x == y for x, y in zip(a, b))
    prefix = []
    for x, y in zip(a, b):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        prefix.append(n)
    return {"identical_streams": same, "of": len(a),
            "mean_common_prefix": sum(prefix) / len(prefix)}


def phase_pd_full_width(torch, n_requests=8, max_new=32, seed=0):
    """InternLM2-1.8B at its published width and depth served three ways
    on the same weights: a unified one-stage engine; PD disaggregation
    with thread stages and the shm connector; the same with the decode
    stage in a spawned process rebuilt from its EngineSpec."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.configs.pipelines import _kv, build_pd_disaggregated
    from repro_torch.core.config import ServeConfig, StageConfig
    from repro_torch.core.graph import StageGraph
    from repro_torch.core.request import Request
    from repro_torch.core.stage import StageSpec
    from repro_torch.engine.ar_engine import AREngine
    from repro_torch.engine.sampling import SamplingParams

    cfg = get_config(PD_ARCH)
    max_batch, max_seq = 8, 2048
    _free(torch)
    t_init = time.perf_counter()
    graph, engines, bundle = build_pd_disaggregated(
        cfg, max_batch=max_batch, max_new=max_new, temperature=0.0, connector="shm",
        seed=seed, max_seq=max_seq, device="cuda")
    params = bundle["params"]
    unified = AREngine("unified", cfg, params, kv=_kv(max_batch, max_seq), max_batch=max_batch,
                       default_sampling=SamplingParams(max_new_tokens=max_new, temperature=0.0),
                       seed=seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    page = unified.runner.kv.page_size
    rng = np.random.default_rng(seed)            # phase 5's prompt lengths
    lens = rng.integers(128, 1537, size=n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]

    # /dev/shm holds each KV payload twice at most while it crosses into
    # the child (the connector's segment and the child's); all of them
    # may be in flight at once
    shm = shm_usage()
    payloads = [kv_payload_bytes(cfg, int(n), page) for n in lens]
    need = 2 * sum(payloads)
    shm.update({"largest_payload_bytes": max(payloads), "all_payloads_bytes": sum(payloads),
                "needed_bytes": need})
    print(f"/dev/shm: {shm}", flush=True)
    if shm["free_bytes"] < need:
        fail(f"pd_full_width: /dev/shm has {shm['free_bytes']} bytes free, the process "
             f"run needs {need} (two copies of every request's KV in flight)")

    def reqs():
        return [Request(inputs={"tokens": p}) for p in prompts]

    ug = StageGraph()
    ug.add_stage(StageSpec("unified", "ar", is_output=True))
    runs, streams = {}, {}
    taps = PdTaps(torch, sampler=unified, stepper=unified)
    runs["unified"], streams["unified"] = serve_pd_run(
        torch, "unified", ug, {"unified": unified}, reqs, out_stage="unified", taps=taps,
        busy_engine=unified)
    taps = PdTaps(torch, sampler=engines["prefill"], stepper=engines["decode"],
                  prefill=engines["prefill"].runner, inject=engines["decode"].runner,
                  verify_hop=True)
    runs["pd_thread"], streams["pd_thread"] = serve_pd_run(
        torch, "pd_thread", graph, engines, reqs, out_stage="decode", taps=taps,
        busy_engine=engines["decode"])
    runs["pd_thread"]["hop_bitwise_equal"] = taps.hop_equal
    runs["pd_thread"]["hop_checked"] = taps.hop_checked
    if not taps.hop_checked == taps.hop_equal == n_requests:
        fail(f"pd_full_width: the decode engine's injected pages equal the prefill "
             f"engine's for {taps.hop_equal} of {taps.hop_checked} requests "
             f"(want {n_requests} of {n_requests})")
    config = ServeConfig(stages={"decode": StageConfig(
        isolation="process", engine_spec=bundle["engine_specs"]["decode"])})
    taps = PdTaps(torch, sampler=engines["prefill"], prefill=engines["prefill"].runner)
    runs["pd_process"], streams["pd_process"] = serve_pd_run(
        torch, "pd_process", graph, engines, reqs, out_stage="decode", config=config,
        taps=taps, process_stage="decode")
    child = runs["pd_process"]
    if not str(child["child_device"]).startswith("cuda") or child["child_paged_launches"] <= 0:
        fail(f"pd_full_width: the decode child ran on {child['child_device']} with "
             f"{child['child_paged_launches']} paged launches")
    if child["replica_failures"]:
        fail(f"pd_full_width: {child['replica_failures']} decode replica failures")

    firsts = {k: [s[0] for s in v] for k, v in streams.items()}
    if not firsts["unified"] == firsts["pd_thread"] == firsts["pd_process"]:
        fail(f"pd_full_width: first tokens differ: {firsts}")
    for k, v in streams.items():
        if any(len(s) != max_new for s in v):
            fail(f"pd_full_width {k}: streams of {[len(s) for s in v]} tokens")
    agreement = {f"{a}~{b}": stream_agreement(streams[a], streams[b])
                 for a, b in (("unified", "pd_thread"), ("pd_thread", "pd_process"),
                              ("unified", "pd_process"))}
    if any(a["identical_streams"] != n_requests for a in agreement.values()):
        fail(f"pd_full_width: the three runs' streams differ: {agreement}")
    # the hop carries bf16 KV as its bits: half the bytes of f32
    f32_bytes = sum(kv_payload_bytes(cfg, int(n), page, elt=4) for n in lens)
    for run in ("pd_thread", "pd_process"):
        got = runs[run]["connector"]["bytes"]
        if got > KV_BYTES_LIMIT * f32_bytes:
            fail(f"pd_full_width {run}: the connector carried {got} bytes, more than "
                 f"{KV_BYTES_LIMIT} x {f32_bytes} (the requests' KV as f32)")
    if child["child_inject_ms_per_request"] is None:
        fail("pd_full_width: the decode child reported no KV injection")
    check, _ = decode_step_check(torch, engines["decode"].runner, prompts, "pd_full_width")
    return {"phase": "pd_full_width", "arch": PD_ARCH, "source": cfg.source,
            "layers": cfg.num_layers, "d_model": cfg.d_model, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype,
            "params": sum(t.numel() for t in _leaves(params)), "init_s": t_init,
            "page": page, "max_seq": max_seq, "max_batch": max_batch,
            "prompt_lens": [int(n) for n in lens], "new_tokens": max_new, "shm": shm,
            "kv_bytes_as_f32": f32_bytes, "kv_bytes_limit": KV_BYTES_LIMIT * f32_bytes,
            "runs": runs, "first_tokens_equal": True, "stream_agreement": agreement,
            **check}


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

    def timed_prefill(embeds, slot, *rest):
        t = time.perf_counter()
        out = prefill(embeds, slot, *rest)
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

    from repro_torch.engine.runner import _prefill_from_embeds, embed
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
    emb = torch.as_tensor(embed(runner.params, prompt), device="cuda")[None]
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
    embeds = torch.as_tensor(embed(runner.params, toks), device="cuda").to(torch.bfloat16)[:, None]
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
    out["prefill_profile"] = profiled_prefill(torch, runner, cfg, reqs)
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
    """Zamba2-2.7B at its published width and depth: Mamba2 layers (the
    chunked scan, ``ref.mamba2_scan_chunked``, above 64 tokens, as
    ``ops.mamba2_scan`` routes it; step by step in decode) and the shared
    attention (flash kernel, hd 80) after every sixth layer.  The longest
    served prompt is prefilled once more through the chunked scan and
    once through the step-by-step ``ref.mamba2_scan`` (the JAX package's
    scan), f32 each: logits and final SSM state held to each other at
    ``PREFILL_LOGIT_RTOL`` of their scale, each prefill timed."""
    from repro_torch.engine.runner import _prefill_from_embeds, embed
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    out, ctx = serve_state_arch(torch, "zamba2_2_7b", n_requests=4, max_new=16,
                                lens_range=(512, 1000), max_batch=4, max_seq=1024,
                                counter=fa.launches)
    runner, reqs, cfg = ctx["runner"], ctx["reqs"], ctx["cfg"]
    out["phase"] = "hybrid"
    prompt = max((r.inputs["tokens"] for r in reqs), key=len)
    emb = torch.as_tensor(embed(runner.params, prompt), device="cuda")[None]
    res, chunk = {}, ops.MAMBA2_CHUNK
    ops.set_backend("cuda")
    try:
        with torch.no_grad():
            for scan, limit in (("chunked", chunk), ("step", len(prompt))):
                ops.MAMBA2_CHUNK = limit             # "step": no prompt exceeds it
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache1 = _prefill_from_embeds(cfg, runner.params, emb,
                                                      runner.kv.max_seq)
                torch.cuda.synchronize()
                res[scan] = (logits[0, -1].float(), cache1["ssm_h"], time.perf_counter() - t)
    finally:
        ops.MAMBA2_CHUNK = chunk
        ops.set_backend("auto")
    lg_diff = float((res["chunked"][0] - res["step"][0]).abs().max())
    lg_scale = float(res["step"][0].abs().max())
    h_diff = float((res["chunked"][1] - res["step"][1]).abs().max())
    h_scale = float(res["step"][1].abs().max())
    if not (lg_diff <= PREFILL_LOGIT_RTOL * lg_scale and h_diff <= PREFILL_LOGIT_RTOL * h_scale
            and torch.isfinite(res["chunked"][0]).all()):
        fail(f"zamba2 prefill: |chunked - step| logits {lg_diff} (scale {lg_scale}), "
             f"ssm_h {h_diff} (scale {h_scale}) > {PREFILL_LOGIT_RTOL} of the scale")
    out.update({"scan_check_prompt_len": len(prompt),
                "prefill_chunked_s": res["chunked"][2], "prefill_step_s": res["step"][2],
                "prefill_logits_max_abs_diff": lg_diff, "prefill_logits_max_abs": lg_scale,
                "prefill_ssm_h_max_abs_diff": h_diff, "prefill_ssm_h_max_abs": h_scale,
                "prefill_rtol": PREFILL_LOGIT_RTOL})
    out["prefill_profile"] = profiled_prefill(torch, runner, cfg, reqs)
    return out


def profiled_prefill(torch, runner, cfg, reqs):
    """The longest served prompt's whole-prompt prefill (backend "cuda",
    after the served run has warmed everything up) under the profiler:
    the prefill's device ms and the port's kernels' share of it."""
    from repro_torch.engine.runner import _prefill_from_embeds, embed
    from repro_torch.kernels import ops
    prompt = max((r.inputs["tokens"] for r in reqs), key=len)
    emb = torch.as_tensor(embed(runner.params, prompt), device="cuda")[None]
    ops.set_backend("cuda")
    with torch.no_grad():
        _, prof = device_profile(
            torch, lambda: _prefill_from_embeds(cfg, runner.params, emb, runner.kv.max_seq))
    ops.set_backend("auto")
    prof["prompt_len"] = len(prompt)
    return prof


def port_kernel_of(name: str):
    """The port's kernel a device event belongs to: the longest matching
    prefix of ``PORT_KERNELS`` (the backward's kernels are
    flash_attention_bwd_*, not the forward's)."""
    hits = [k for k, p in PORT_KERNELS.items() if p in name]
    return max(hits, key=lambda k: len(PORT_KERNELS[k])) if hits else None


def kernel_category(name: str) -> str:
    """A device event's kind: one of the port's kernels, a library matrix
    product (cuBLAS's nvjet / gemm kernels), a copy, or PyTorch's other
    kernels (elementwise and reductions)."""
    port = port_kernel_of(name)
    if port:
        return port
    low = name.lower()
    if any(k in low for k in ("nvjet", "gemm", "cutlass", "xmma")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "reduce" if "reduce_kernel" in low else "elementwise and other"


def device_profile(torch, fn, top_n: int = 6):
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
    short, by_category = {}, {}
    for name, us in per.items():     # kernels that share a 60-character prefix summed
        short[name[:60]] = short.get(name[:60], 0.0) + us
        cat = kernel_category(name)
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3
    top = sorted(short.items(), key=lambda kv: -kv[1])[:top_n]
    # device time of each kernel of the port, all its launches (split and
    # combine kernels of paged attention together)
    ours = {k: sum(us for n, us in per.items() if port_kernel_of(n) == k) / 1e3
            for k in PORT_KERNELS}
    return result, {"wall_ms": 1e3 * wall, "device_ms": 1e3 * device_s,
                    "device_busy_share": device_s / wall if device_s else None,
                    "top_device_ms": {k: us / 1e3 for k, us in top},
                    "device_ms_by_category": by_category,
                    "port_kernels_device_ms": ours}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# --against: this tree and another (a parent commit) on one card, in turns
# ---------------------------------------------------------------------------

# the backward cases of the routes the mma kernel took over (and the
# wgmma route's training shape), and the mma forward's training shapes:
# (name, shapes)
AGAINST_BWD = (
    ("internlm2-1.8b train bf16 causal", dict(B=4, S=2048, nq=16, nkv=8, hd=128,
                                              dtype="bfloat16")),
    ("smoke f32 hd 32 causal GQA", dict(B=2, S=128, nq=8, nkv=4, hd=32, dtype="float32")),
    ("ragged S 77 f32 non-causal hd 80", dict(B=1, S=77, nq=4, nkv=2, hd=80,
                                              dtype="float32", causal=False)),
    ("smoke bf16 hd 32 causal GQA", dict(B=2, S=128, nq=8, nkv=4, hd=32, dtype="bfloat16")),
    ("hubert-xlarge bf16 non-causal hd 80", dict(B=2, S=1000, nq=16, nkv=16, hd=80,
                                                 dtype="bfloat16", causal=False)),
    ("hubert-xlarge train bf16 non-causal hd 80", dict(B=4, S=1000, nq=16, nkv=16, hd=80,
                                                       dtype="bfloat16", causal=False)),
    ("hubert-xlarge train f32 non-causal hd 80", dict(B=4, S=1000, nq=16, nkv=16, hd=80,
                                                      dtype="float32", causal=False)),
    ("zamba2-2.7b bf16 causal hd 80", dict(B=1, S=2048, nq=32, nkv=32, hd=80,
                                           dtype="bfloat16")),
)
AGAINST_FWD = (
    ("hubert-xlarge forward bf16 non-causal", dict(B=4, S=1000, nq=16, nkv=16, hd=80,
                                                   dtype="bfloat16", causal=False)),
    ("hubert-xlarge forward f32 non-causal", dict(B=4, S=1000, nq=16, nkv=16, hd=80,
                                                  dtype="float32", causal=False)),
    ("smoke forward f32 causal", dict(B=2, S=128, nq=8, nkv=4, hd=32, dtype="float32")),
)


def turn_measurements(torch):
    """One tree's side of ``--against``, through the wrappers both trees
    have: each backward case (taking the forward's lse where the forward
    gives one) timed and split by kernel, with its error against the plain
    version; the mma forward without lse and with it (a digest of the
    output without lse, to hold it bit for bit across trees); and
    HuBERT-XLarge's training step (``train_arch_full_width`` without its
    gradient check)."""
    import hashlib

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    build.build(["flash_attention", "flash_attention_bwd"])
    timer = Timer(torch)

    def inputs(B, S, nq, nkv, hd, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, dtype)
        return [torch.randn(shape, generator=g, device="cuda").to(dt) for shape in
                ((B, S, nq, hd), (B, S, nkv, hd), (B, S, nkv, hd), (B, S, nq, hd))]

    bwd = {}
    for i, (name, c) in enumerate(AGAINST_BWD):
        kw = dict(causal=c.get("causal", True))
        q, k, v, do = inputs(c["B"], c["S"], c["nq"], c["nkv"], c["hd"], c["dtype"], 40 + i)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)

        def call():
            return fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)

        got = call()
        want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        errs = [compare(a, b, c["dtype"]) for a, b in zip(got, want)]
        del got, want
        bwd[name] = {"ms": timer(call), "profiler_ms_by_kernel": timer.profiled_by_kernel(call),
                     "forward_lse": lse is not None, "max_abs_err": max(e for e, _ in errs),
                     "ok": all(ok for _, ok in errs)}
    fwd = {}
    for i, (name, c) in enumerate(AGAINST_FWD):
        kw = dict(causal=c.get("causal", True))
        q, k, v, _ = inputs(c["B"], c["S"], c["nq"], c["nkv"], c["hd"], c["dtype"], 50 + i)
        out = fa.flash_attention(q, k, v, **kw)
        bits = out.view(torch.int16 if c["dtype"] == "bfloat16" else torch.int32)
        fwd[name] = {
            "ms_without_lse": timer(lambda: fa.flash_attention(q, k, v, **kw)),
            "ms_with_lse": timer(lambda: fa.flash_attention(q, k, v, return_lse=True, **kw)),
            "out_sha256": hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]}
    train, _ = train_arch_full_width(torch, ENCODER_ARCH, batch=ENCODER_BATCH,
                                     seq=ENCODER_SEQ, steps=ENCODER_STEPS, parity=False)
    keep = ("ms_per_step", "ms_per_step_median", "tokens_per_s", "peak_memory_bytes",
            "flash_bwd_device_ms", "flash_bwd_share_of_device_time")
    return {"bwd": bwd, "fwd": fwd,
            "train": {**{k: train[k] for k in keep},
                      "steps_ms": [s_["ms"] for s_ in train["steps"]],
                      "device_ms": train["profiled_step"]["device_ms"],
                      "device_ms_by_category": train["profiled_step"]["device_ms_by_category"]}}


def run_against(other: str, smi: str) -> int:
    """This tree and ``other`` (a checkout of another commit, e.g. the
    parent unpacked with git archive) measured by ``turn_measurements`` in
    turns, other, this, this, other, each turn in its own process with
    that tree's package and kernels; both trees' kernels are built first.
    Writes every turn to chiprun_out/chip_smoke_against.jsonl and prints
    the means per tree."""
    trees = {"other": os.path.abspath(other), "this": ROOT}
    for tree in trees.values():
        if not os.path.isdir(os.path.join(tree, "src", "repro_torch")):
            print(f"chip_smoke: no port under {tree}", file=sys.stderr)
            return 2
    path = os.path.join(ROOT, "chiprun_out", "chip_smoke_against.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    turns = []
    with open(path, "w") as log:
        for label in ("other", "this", "this", "other"):
            t = time.perf_counter()
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                                  os.path.join(trees[label], "src")],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                fail(f"--against: the {label} turn failed:\n{out.stderr[-4000:]}")
            res = json.loads(out.stdout.strip().splitlines()[-1])
            res.update(tree=label, path=trees[label], seconds=time.perf_counter() - t)
            log.write(json.dumps(res) + "\n")
            log.flush()
            turns.append(res)
    summary = {}
    for label in trees:
        mine = [r for r in turns if r["tree"] == label]
        summary[label] = {
            "bwd_ms": {n: statistics.mean(r["bwd"][n]["ms"] for r in mine) for n, _ in AGAINST_BWD},
            "fwd_ms_without_lse": {n: statistics.mean(r["fwd"][n]["ms_without_lse"] for r in mine)
                                   for n, _ in AGAINST_FWD},
            "train_ms_per_step": [r["train"]["ms_per_step"] for r in mine],
            "train_flash_bwd_device_ms": [r["train"]["flash_bwd_device_ms"] for r in mine]}
    same_out = {n: len({r["fwd"][n]["out_sha256"] for r in turns}) == 1 for n, _ in AGAINST_FWD}
    bad = [n for r in turns for n, c in r["bwd"].items() if not c["ok"]]
    print(smi, flush=True)
    print(json.dumps({"against": summary, "forward_out_bitwise_across_trees": same_out,
                      "bwd_cases_out_of_tolerance": bad}), flush=True)
    return 1 if bad else 0


# ---------------------------------------------------------------------------

KERNEL_META = {
    "paged_attention": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:85"},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73"},
    "flash_attention_bwd": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:55"},
    "mamba1_scan": {
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:58"},
    "mixed_gemm": {
        "source": "src/repro_torch/kernels/csrc/mixed_gemm.cu",
        "replaces": "none: XLA's f32 product of a promoted bf16 weight"},
}


# a kernel's name and template arguments inside a mangled name (ptxas) or
# a demangled one (the profiler): every __global__ of the port is
# flash_attention_*_kernel, paged_attention_*_kernel, mamba1_*_kernel or
# mixed_gemm_*kernel
KERNEL_NAME = re.compile(
    r"((?:flash_attention|paged_attention|mamba1|mixed_gemm)_[a-z_]*?kernel)(I.*?EE|<[^>]*>)?")


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
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="TREE",
                        help="instead of the phases, measure the flash backward's mma cases, "
                             "the mma forward and HuBERT-XLarge's training step from this "
                             "tree and from TREE (another commit's checkout) in turns")
    parser.add_argument("--turn", metavar="SRC", help=argparse.SUPPRESS)
    parser.add_argument("--kernel", choices=["mixed_gemm"],
                        help="instead of the phases, build this kernel and run its cases "
                             "of phase 3 alone, with each chunk's sums")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = args.turn or SRC
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the port (src/repro_torch) is not under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    # the plain versions and the model's matmuls run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.turn:
        print(json.dumps(turn_measurements(torch)), flush=True)
        return 0
    import torch.nn.functional as F
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)

    from repro_torch.kernels import build
    t_start = time.perf_counter()

    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    if args.against:
        return run_against(args.against, smi)
    _log.append(open(LOG_PATH, "w"))
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi, "capability": list(cap),
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": time.perf_counter() - t})
    if tuple(cap) != (9, 0):
        fail(f"compute capability {cap}, need (9, 0)")

    t = time.perf_counter()
    names = [args.kernel] if args.kernel else list(KERNEL_META)
    built = build.build(sorted({library_of(k) for k in names}))
    entries = {k: ptxas_entries(str(v["log"])) for k, v in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t, "flags": build.NVCC_FLAGS,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "entries": entries[k],
                          "advisories": ptxas_advisories(str(v["log"]))}
                      for k, v in built.items()}})
    spills = [e for es in entries.values() for e in es if e["spill_bytes"]]
    if spills:
        fail(f"kernels spill registers: {spills}")
    # ptxas serializing a kernel's wgmma (advisories C7520, C7512) costs
    # most of the tensor cores' rate: it fails the run like a spill
    serialized = [a for v in built.values() for a in ptxas_advisories(str(v["log"]))
                  if "wgmma" in a["advisory"].lower() or "wgmma" in str(a["kernel"])]
    if serialized:
        fail(f"ptxas serializes wgmma: {serialized}")
    if args.kernel:
        t = time.perf_counter()
        cases, chunks = mixed_cases(torch, Timer(torch))
        emit({"phase": "kernels", "seconds": time.perf_counter() - t,
              "cases": {args.kernel: cases}, "per_chunk": chunks})
        bad = [c["case"] for c in cases if not c["ok"]]
        if bad:
            fail(f"{args.kernel} disagrees with its plain version: {bad}")
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

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
    mono, mono_launches = phase_monolithic(torch, omni["jct_p50_s"])
    mono["seconds"] = time.perf_counter() - t
    emit(mono)

    t = time.perf_counter()
    pipes, pipe_launches = phase_pipelines(torch)
    pipes["seconds"] = time.perf_counter() - t
    emit(pipes)

    t = time.perf_counter()
    full = phase_full_width(torch)
    full["seconds"] = time.perf_counter() - t
    emit(full)

    t = time.perf_counter()
    pd = phase_pd_full_width(torch)
    pd["seconds"] = time.perf_counter() - t
    emit(pd)

    t = time.perf_counter()
    ssm = phase_ssm_full_width(torch)
    ssm["seconds"] = time.perf_counter() - t
    emit(ssm)

    t = time.perf_counter()
    hybrid = phase_hybrid(torch)
    hybrid["seconds"] = time.perf_counter() - t
    emit(hybrid)

    t = time.perf_counter()
    train = phase_train_full_width(torch)
    train["seconds"] = time.perf_counter() - t
    emit(train)

    t = time.perf_counter()
    moe = phase_moe_full_width(torch)
    moe["seconds"] = time.perf_counter() - t
    emit(moe)

    t = time.perf_counter()
    ep = phase_ep_full_width(torch)
    ep["seconds"] = time.perf_counter() - t
    emit(ep)

    t = time.perf_counter()
    dry = phase_dryrun(torch)
    dry["seconds"] = time.perf_counter() - t
    emit(dry)

    t = time.perf_counter()
    examples = phase_examples(torch)
    examples["seconds"] = time.perf_counter() - t
    emit(examples)

    # launches of each kernel in the runs that use it, each counted from 0
    # (the decode child of pd_full_width counts its own and reports them)
    by_run = {"paged_attention": {"qwen_omni": launches["paged_attention"],
                                  "full_width": full["paged_launches"],
                                  "moe_full_width": moe["paged_launches"]},
              "flash_attention": {"qwen_omni": launches["flash_attention"],
                                  "monolithic": mono_launches,
                                  "hybrid": hybrid["launches"],
                                  "train_full_width": train["launches"]["flash_attention"],
                                  "train_full_width.launcher":
                                      train["launcher"]["flash_launches"],
                                  "ep_full_width.dense": ep["dense"]["flash_launches"],
                                  **{f"ep_full_width.rank{r}": v["flash_launches"]
                                     for r, v in ep["by_rank"].items()}},
              "flash_attention_bwd": {
                  "train_full_width": train["launches"]["flash_attention_bwd"],
                  "train_full_width.launcher": train["launcher"]["flash_bwd_launches"],
                  "train_full_width.tiny_lm": train["tiny_lm"]["flash_bwd_launches"]},
              "mamba1_scan": {"ssm_full_width": ssm["launches"]},
              "mixed_gemm": {"full_width": full["mixed_launches"],
                             "moe_full_width": moe["mixed_launches"]}}
    for name, n in pipe_launches.items():
        for k in ("paged_attention", "flash_attention"):
            if n[k]:
                by_run[k][f"pipelines.{name}"] = n[k]
    for run, r in pd["runs"].items():
        by_run["paged_attention"][f"pd_full_width.{run}"] = r["paged_launches"]
    by_run["paged_attention"]["pd_full_width.pd_process.child"] = \
        pd["runs"]["pd_process"]["child_paged_launches"]
    # the examples: each run's launches in this process, and each spawned
    # decode child's own
    for run, n in examples["launches"].items():
        for k, v in n.items():
            if v:
                by_run[k][f"examples.{run}"] = v
    kernels = []
    for name, meta in KERNEL_META.items():
        # the first case is the shape the main path gives the kernel most
        # often: the qwen_omni slice, the vocoder, InternLM2's training
        # shape, Falcon-Mamba's decode
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
