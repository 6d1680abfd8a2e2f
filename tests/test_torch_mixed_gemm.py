"""The f32 x bf16 product that reads bf16 weights in place
(``kernels/mixed_gemm.py``), on the CPU: which products the layers hand
to it (none on the CPU, under autograd or with bf16 activations), what
each product notes on the running step phase, the launch plan from
shapes alone, the MoE layer's grouped path against its capacity-buffer
dispatch and a prefill chunk through both (the wrapper runs the plain
versions on CPU tensors, so these hold the Python around the kernel),
and the benchmark's reader of the share.  The kernel itself is held to
the plain versions on the card (``tests/test_torch_cuda.py``).

Tolerances: the grouped path and the capacity buffer compute the same
f32 products over other row blocks, so they differ only in how the
CPU's matmul blocks its sums; they are held to 1e-5 of the largest
output."""
import pathlib
import sys
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:           # the benchmark's readers live at the root
    sys.path.insert(0, str(REPO))

from omnibench import spec  # noqa: E402
from repro_torch.configs import jamba2_mini, qwen3_moe_30b_a3b  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVConfig  # noqa: E402
from repro_torch.engine.runner import PagedRunner  # noqa: E402
from repro_torch.kernels import mixed_gemm, ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen).to(torch.bfloat16)


@pytest.fixture
def no_kernel(monkeypatch):
    """Any call into the wrapper fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the product went to mixed_gemm")
    monkeypatch.setattr(mixed_gemm, "matmul", refuse)
    monkeypatch.setattr(mixed_gemm, "grouped", refuse)
    monkeypatch.setattr(moe, "_grouped_pairs", refuse)


# ---- which products go through the kernel ----------------------------------

def _case(kind):
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(5, 64, generator=gen), _bf16(gen, 64, 96)
    if kind == "bf16 activations":
        x = x.to(torch.bfloat16)
    elif kind == "f32 weights":
        w = w.float()
    elif kind == "activations need grad":
        x.requires_grad_(True)
    elif kind == "weight needs grad":
        w.requires_grad_(True)
    elif kind == "N not a multiple of 8":
        w = w[:, :92]
    elif kind == "K not a multiple of 4":
        x, w = x[:, :62], w[:62]
    elif kind == "transposed weight":
        w = _bf16(gen, 96, 64).t()
    elif kind == "row stride not a multiple of 8":
        w = _bf16(gen, 64, 100)[:, :96]
    return x, w


@pytest.mark.parametrize("kind,taken", [
    ("f32 x bf16", True), ("bf16 activations", False), ("f32 weights", False),
    ("activations need grad", False), ("weight needs grad", False),
    ("N not a multiple of 8", False), ("K not a multiple of 4", False),
    ("transposed weight", False), ("row stride not a multiple of 8", False)])
def test_the_kernel_takes_f32_activations_against_bf16_weights_alone(kind, taken):
    x, w = _case(kind)
    assert mixed_gemm._operands(x, w) is taken
    assert mixed_gemm.takes(x, w) is False           # CPU tensors never
    with torch.no_grad():                            # a gradient is not wanted here
        assert mixed_gemm._operands(x, w) is (taken or "grad" in kind)


def test_the_ref_backend_keeps_the_widening(monkeypatch):
    x, w = _case("f32 x bf16")
    monkeypatch.setattr(ops, "_BACKEND", "ref")
    assert not mixed_gemm._operands(x, w)


def test_the_layers_keep_the_promoted_product_on_the_cpu(no_kernel):
    gen = torch.Generator().manual_seed(1)
    x, w = torch.randn(2, 7, 64, generator=gen), _bf16(gen, 64, 96)
    assert torch.equal(L.matmul(x, w), torch.matmul(x, w.float()))
    xg = x.clone().requires_grad_(True)
    L.matmul(xg, w).sum().backward()                 # autograd through the widening
    assert torch.allclose(xg.grad, w.float().sum(1).expand_as(x))
    xb = x.to(torch.bfloat16)
    y = L.matmul(xb, w)
    assert y.dtype == torch.bfloat16 and torch.equal(y, torch.matmul(xb, w))


@pytest.mark.parametrize("grad", [False, True])
def test_experts_keep_the_capacity_buffer_on_the_cpu(no_kernel, grad):
    xf, topw, topi, wg, wu, wd = _routes(seed=2)
    xf.requires_grad_(grad)
    y, counts = moe.experts(xf, topw, topi, wg, wu, wd, 0, 12)
    assert y.shape == xf.shape and int(counts.sum()) == int((topi < wg.shape[0]).sum())
    if grad:
        y.sum().backward()
        assert xf.grad is not None


# ---- the grouped MoE path against the capacity buffer ----------------------

def _routes(seed, T=24, k=2, E=6, d=64, f=48, width=8, lo=0, skip=()):
    """Tokens routed top-k over a router of ``width`` experts, of which E
    from ``lo`` are held; experts in ``skip`` get no pair."""
    gen = torch.Generator().manual_seed(seed)
    xf = torch.randn(T, d, generator=gen)
    allowed = torch.tensor([e for e in range(width) if e - lo not in skip])
    scores = torch.rand(T, len(allowed), generator=gen)
    topi = allowed[torch.argsort(scores, dim=1)[:, :k]]
    topw = torch.softmax(torch.rand(T, k, generator=gen), -1)
    return (xf, topw, topi, _bf16(gen, E, d, f) / 8, _bf16(gen, E, d, f) / 8,
            _bf16(gen, E, f, d) / 8)


@pytest.mark.parametrize("C", [24, 5, 8])
@pytest.mark.parametrize("lo,skip", [(0, ()), (2, (1, 3)), (0, (0, 5))])
def test_the_grouped_pairs_match_the_capacity_buffer(monkeypatch, C, lo, skip):
    """Dropless (C = T) and finite capacities that drop pairs, held experts
    at an offset of the router (pairs of experts held elsewhere), experts
    without pairs: the same y, counts and dropped pairs."""
    xf, topw, topi, wg, wu, wd = _routes(seed=3, lo=lo, skip=skip)
    runs = []
    for grouped in (False, True):
        if grouped:
            monkeypatch.setattr(mixed_gemm, "takes", mixed_gemm._operands)
        monkeypatch.setattr(moe, "drop_counter", torch.zeros((), dtype=torch.long))
        y, counts = moe.experts(xf, topw, topi, wg, wu, wd, lo, C)
        runs.append((y, counts, int(moe.drop_counter)))
    (y0, c0, d0), (y1, c1, d1) = runs
    assert torch.equal(c0, c1) and d0 == d1 == int((c0 - C).clamp(min=0).sum())
    assert float((y1 - y0).abs().max()) <= 1e-5 * float(y0.abs().max())


def test_the_plain_grouped_version_leaves_unkept_rows_zero():
    gen = torch.Generator().manual_seed(4)
    x, w = torch.randn(6, 16, generator=gen), _bf16(gen, 2, 16, 8)
    offsets, counts = torch.tensor([0, 4]), torch.tensor([4, 2])
    a_rows = torch.tensor([5, 0, 2, 2, 1, 3], dtype=torch.int32)
    (y,) = mixed_gemm.grouped(x, (w,), a_rows, offsets, counts, 3)
    assert torch.equal(y[3], torch.zeros(8))              # past expert 0's capacity
    for j, e in [(0, 0), (1, 0), (2, 0), (4, 1), (5, 1)]:
        assert torch.allclose(y[j], x[a_rows[j]] @ w[e].float())


# ---- what each product notes ------------------------------------------------

def _noted(fn):
    step = metrics.StepTrace("t", metrics.StepTotals(), first="engine.prefill")
    try:
        fn()
    finally:
        step.phase(None)
        step.finish()
    return step._closed[0][4]


@pytest.mark.parametrize("through_kernel", [False, True])
def test_each_product_notes_its_weight_bytes_on_the_running_phase(monkeypatch, through_kernel):
    if through_kernel:
        monkeypatch.setattr(mixed_gemm, "takes", mixed_gemm._operands)
    key = "mixed_weight_bytes" if through_kernel else "widened_weight_bytes"
    gen = torch.Generator().manual_seed(5)
    x, w = torch.randn(3, 64, generator=gen), _bf16(gen, 64, 96)
    assert _noted(lambda: L.matmul(x, w)) == {key: 2 * 64 * 96}
    xf, topw, topi, wg, wu, wd = _routes(seed=6)
    nbytes = 2 * (wg.numel() + wu.numel() + wd.numel())
    assert _noted(lambda: moe.experts(xf, topw, topi, wg, wu, wd, 0, 24)) == {key: nbytes}
    assert _noted(lambda: L.matmul(x.to(torch.bfloat16), w)) == {}
    assert _noted(lambda: L.matmul(x, w.float())) == {}
    L.matmul(x, w)                                        # outside a step: nothing to note


# ---- a prefill chunk through the grouped path --------------------------------

def _jamba_shaped():
    """Two layers of Jamba's kinds (Mamba1 + dense MLP, attention + MoE) at
    widths every product of which the kernel takes (x_proj 8 + 2 x 16)."""
    return jamba2_mini.CONFIG.replace(
        name="jamba-shaped", num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=96, vocab_size=256, num_experts=4, router_experts=8,
        attn_layer_period=2, attn_layer_offset=1, capacity_factor=1e9)


def _qwen_shaped():
    return qwen3_moe_30b_a3b.SMOKE_CONFIG.replace(capacity_factor=1e9)


@pytest.mark.parametrize("make", [_qwen_shaped, _jamba_shaped])
def test_a_prefill_chunk_through_the_kernel_path_matches_the_widening(monkeypatch, make):
    cfg = make()
    params = T.init_params(cfg, torch.Generator().manual_seed(7))
    kv = PagedKVConfig(num_pages=16, page_size=8, max_pages_per_seq=8)
    embeds = torch.randn(1, 16, cfg.d_model, generator=torch.Generator().manual_seed(8))
    table = np.arange(1, 9, dtype=np.int32)
    out, notes = [], []
    for through_kernel in (False, True):
        if through_kernel:
            monkeypatch.setattr(mixed_gemm, "takes", mixed_gemm._operands)
        runner = PagedRunner(cfg, params, kv, max_batch=2)
        got = {}
        notes.append(_noted(lambda: got.update(
            r=runner.prefill_chunk(embeds, table, 0, 13, slot=1))))
        out.append(got["r"][0])
    assert float((out[1] - out[0]).abs().max()) <= 1e-5 * float(out[0].abs().max())
    widened, mixed = notes
    assert set(widened) <= {"widened_weight_bytes", "mamba_resets"}
    assert mixed["mixed_weight_bytes"] == widened["widened_weight_bytes"]
    assert "widened_weight_bytes" not in mixed             # every product took the kernel


# ---- the launch plan ----------------------------------------------------------

# (rows, K, N, groups, rows a group takes at most, weights): every prefill
# product of the two configurations at a chunk of 64 rows
PRODUCTS = {
    "jamba in_proj": (64, 4096, 16384, 1, None, 1), "jamba x_proj": (64, 8192, 288, 1, None, 1),
    "jamba dt_proj": (64, 256, 8192, 1, None, 1), "jamba out_proj": (64, 8192, 4096, 1, None, 1),
    "jamba q/o": (64, 4096, 4096, 1, None, 1), "jamba k/v": (64, 4096, 1024, 1, None, 1),
    "jamba mlp up": (64, 4096, 14336, 1, None, 1), "jamba mlp down": (64, 14336, 4096, 1, None, 1),
    "jamba head": (64, 4096, 65536, 1, None, 1),
    "jamba experts gate+up": (128, 4096, 14336, 8, 64, 2),
    "jamba experts down": (128, 14336, 4096, 8, 64, 1),
    "qwen q": (64, 2048, 4096, 1, None, 1), "qwen k/v": (64, 2048, 512, 1, None, 1),
    "qwen o": (64, 4096, 2048, 1, None, 1), "qwen head": (64, 2048, 151936, 1, None, 1),
    "qwen experts gate+up": (512, 2048, 768, 128, 64, 2),
    "qwen experts down": (512, 768, 2048, 128, 64, 1),
    "ragged": (19, 100, 40, 1, None, 1), "one row": (1, 4096, 65536, 1, None, 1),
    "long prompt": (1000, 2560, 2048, 1, None, 1),
}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_the_plan_covers_k_and_fills_the_card(name):
    rows, k, n, groups, group_rows, weights = PRODUCTS[name]
    p = mixed_gemm.plan(rows, k, n, groups, group_rows, weights)
    steps = -(-k // mixed_gemm.DEPTH)
    per = -(-steps // p.splits)
    assert (p.splits - 1) * per < steps <= p.splits * per     # every split streams a stage
    assert p.splits == 1 or per >= mixed_gemm.MIN_STEPS
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    # a block for every SM, unless K has no more splits of MIN_STEPS stages
    # to give; a split only where the column tiles leave SMs idle
    assert blocks >= mixed_gemm.SMS or per < 2 * mixed_gemm.MIN_STEPS
    assert p.splits == 1 or blocks // p.splits < mixed_gemm.SMS
    assert p.grid == (-(-n // mixed_gemm.COLS), groups * p.mblocks, weights * p.splits)
    assert p.mblocks * mixed_gemm.ROWS >= min(group_rows or rows, rows)
    assert p.grid[1] <= 65535 and p.grid[2] <= 65535
    assert p.scratch_floats == (weights * p.splits * rows * n if p.splits > 1 else 0)
    assert p.kernel_launches == (2 if p.splits > 1 else 1)


# ---- the benchmark's reader -----------------------------------------------------

def _prefill(t0, engine="ar", **counts):
    return metrics.Span("engine.prefill", engine, t0, t0 + 0.05, 0, counts=counts)


def test_the_reader_gives_the_share_read_in_place(monkeypatch):
    read = spec.load_module("metrics", "model.prefill_mixed_share").read
    measured = SimpleNamespace(records=[SimpleNamespace(stage="ar")], profile=None,
                               in_window=lambda t: 10.0 <= t < 20.0)
    outside = [_prefill(5.0, widened_weight_bytes=9e9),          # before the window
               _prefill(12.0, engine="other", widened_weight_bytes=9e9)]
    monkeypatch.setattr(metrics, "spans", deque(
        [_prefill(11.0, mixed_weight_bytes=3e9), _prefill(13.0, mixed_weight_bytes=1e9)]
        + outside))
    assert read(measured) == pytest.approx(100.0)
    monkeypatch.setattr(metrics, "spans", deque(
        [_prefill(11.0, mixed_weight_bytes=3e9, widened_weight_bytes=1e9)] + outside))
    assert read(measured) == pytest.approx(75.0)
    monkeypatch.setattr(metrics, "spans", deque([_prefill(11.0, prefill_tokens=40)] + outside))
    assert read(measured) is None                            # a program that notes neither
    monkeypatch.delattr(metrics, "spans")
    assert read(measured) is None                            # a program without the tracer


def test_the_plain_version_is_the_promoted_product():
    gen = torch.Generator().manual_seed(9)
    x, w = torch.randn(4, 32, generator=gen), _bf16(gen, 32, 16)
    assert torch.equal(ref.mixed_matmul(x, w), x @ w.float())
