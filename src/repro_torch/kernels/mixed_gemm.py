"""f32 activations x bf16 weights, the weights read in place: wrapper
around ``csrc/mixed_gemm.cu``.

Replaces no Pallas kernel (XLA computes this product in the JAX
package): it is the product of an f32 prefill chunk against a bf16
model's weights, which ``models/layers.py: matmul`` (plain form) and
``models/moe.py: experts`` (grouped over the kept (token, expert) pairs)
hand to it.  The CUDA source's header says what bounds it and how its
design answers that; ``plan`` chooses the split over K from the shapes
alone, so no call reads the device from the host (the grouped form's
offsets and counts stay on the device).  ``takes`` says whether a
product goes through the kernel: f32 activations against bf16 weights,
both plain CUDA tensors, no gradient wanted, the backend not "ref", and
shapes and strides the kernel reads.  On a CPU tensor the functions run
the plain versions (``ref.mixed_matmul``, ``ref.mixed_grouped``).
``launches`` counts wrapper calls.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ops, ref

#: wrapper calls that launched the CUDA kernels since the last reset
launches = build.LaunchCounter()

ROWS = 64            # rows a block computes
COLS = 256           # weight columns a block streams
DEPTH = 32           # K-rows a stage
MIN_STEPS = 8        # stages a split streams at least
SMS = 132            # the card's SMs, one block each


@dataclass(frozen=True)
class GemmPlan:
    mblocks: int            # blocks of 64 rows a group takes at most
    splits: int             # splits over K
    grid: tuple             # of the main kernel: (column tiles, groups x mblocks, weights x splits)
    scratch_floats: int     # partial sums (weights, splits, rows, N); 0 with one split
    kernel_launches: int    # 2 with a split over K (the reduction), else 1


@functools.lru_cache(maxsize=256)
def plan(rows: int, k: int, n: int, groups: int = 1, group_rows: int | None = None,
         weights: int = 1) -> GemmPlan:
    """The launch plan of a call whose y has ``rows`` rows, each of the
    ``groups`` groups at most ``group_rows`` of them (all, by default),
    from its shapes alone."""
    mblocks = -(-(rows if group_rows is None else min(group_rows, rows)) // ROWS)
    tiles = -(-n // COLS)
    blocks = tiles * groups * mblocks * weights
    steps = -(-k // DEPTH)
    # fewer blocks than SMs: split K towards two blocks an SM
    splits = 1 if blocks >= SMS else max(1, min(-(-2 * SMS // blocks), steps // MIN_STEPS))
    splits = -(-steps // -(-steps // splits))           # no split left without a stage
    return GemmPlan(mblocks=mblocks, splits=splits,
                    grid=(tiles, groups * mblocks, weights * splits),
                    scratch_floats=weights * splits * rows * n if splits > 1 else 0,
                    kernel_launches=2 if splits > 1 else 1)


def _plain_tensor(t: torch.Tensor) -> bool:
    return type(t) in (torch.Tensor, torch.nn.Parameter)


def takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a product of activations ``x`` and weight ``w`` ((K, N), or
    (G, K, N) for the grouped form) goes through the kernel."""
    return x.is_cuda and w.is_cuda and _operands(x, w)


def _operands(x: torch.Tensor, w: torch.Tensor) -> bool:
    """``takes`` on any device: the types, the gradient, the backend and
    the weight's shape and layout."""
    return (x.dtype == torch.float32 and w.dtype == torch.bfloat16
            and _plain_tensor(x) and _plain_tensor(w)
            and ops.get_backend() != "ref" and not ops._needs_grad(x, w)
            and w.shape[-2] % 4 == 0 and w.shape[-1] % 8 == 0 and w.stride(-1) == 1
            and all(s % 8 == 0 for s in w.stride()[:-1]) and w.data_ptr() % 16 == 0)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as rows the kernel reads: unit column stride, a row stride and
    base that allow 16-byte copies."""
    if x.stride(-1) == 1 and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)   # a fresh, aligned copy


def _launch(x, ws, ys, a_rows, offsets, counts, capacity, p: GemmPlan, rows, k, n, groups):
    part = (torch.empty(p.scratch_floats, dtype=torch.float32, device=x.device)
            if p.scratch_floats else None)
    w1 = ws[1].data_ptr() if len(ws) > 1 else None
    y1 = ys[1].data_ptr() if len(ys) > 1 else None
    lib = build.load("mixed_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mixed_gemm_launch(
            x.data_ptr(), x.stride(0), a_rows.data_ptr() if a_rows is not None else None,
            ws[0].data_ptr(), w1, ws[0].stride(0) if groups > 1 else 0, ws[0].stride(-2),
            ys[0].data_ptr(), y1, n, part.data_ptr() if part is not None else None,
            offsets.data_ptr() if offsets is not None else None,
            counts.data_ptr() if counts is not None else None, int(capacity),
            rows, k, n, groups, p.mblocks, p.splits, stream)
    build.check(rc, "mixed_gemm")
    launches.add()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32 @ w (K, N) bf16 in f32 arithmetic (``takes`` must
    hold on the card).  Returns (..., N) f32."""
    if not x.is_cuda:
        return ref.mixed_matmul(x, w)
    k, n = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"mixed_gemm.matmul: x {tuple(x.shape)} against w {tuple(w.shape)}")
    x2 = _rows(x.reshape(-1, k))
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m:
        _launch(x2, [w], [y], None, None, None, 0, plan(m, k, n), m, k, n, 1)
    return y.reshape(*x.shape[:-1], n)


def grouped(x: torch.Tensor, ws, a_rows: torch.Tensor | None, offsets: torch.Tensor,
            counts: torch.Tensor, capacity: int) -> list:
    """The grouped form over one or two weights ``ws`` of one shape (G, K,
    N) bf16: for each, y (rows, N) f32 whose row j, for the first
    min(counts[e], capacity) rows j from offsets[e] of group e, is
    x[a_rows[j]] @ w[e] (x[j] when ``a_rows`` is None); rows = len(a_rows),
    or x's rows.  offsets and counts are (G,) int64 on the device, read
    there.  The kernel leaves the other rows of y as they were allocated
    (the plain version zeros them): the caller masks them."""
    rows = a_rows.shape[0] if a_rows is not None else x.shape[0]
    if not x.is_cuda:
        return ref.mixed_grouped(x, ws, a_rows, offsets, counts, capacity, rows)
    if len(ws) not in (1, 2) or any(w.shape != ws[0].shape or w.stride() != ws[0].stride()
                                    for w in ws):
        raise ValueError("mixed_gemm.grouped: one or two weights of one shape and layout")
    groups, k, n = ws[0].shape
    if x.shape[-1] != k:
        raise ValueError(f"mixed_gemm.grouped: x {tuple(x.shape)} against w {tuple(ws[0].shape)}")
    if offsets.dtype != torch.int64 or counts.dtype != torch.int64 \
            or offsets.shape[0] < groups or counts.shape[0] < groups:
        raise ValueError("mixed_gemm.grouped: offsets and counts are (G,) int64")
    x2 = _rows(x)
    ys = [torch.empty((rows, n), dtype=torch.float32, device=x.device) for _ in ws]
    if rows:
        a = a_rows.to(torch.int32).contiguous() if a_rows is not None else None
        p = plan(rows, k, n, groups, capacity, len(ws))
        _launch(x2, ws, ys, a, offsets.contiguous(), counts.contiguous(), capacity, p,
                rows, k, n, groups)
    return ys
