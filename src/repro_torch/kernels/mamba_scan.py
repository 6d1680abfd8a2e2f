"""Mamba1 selective scan: wrapper around ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py:
mamba1_scan``.  The CUDA source's header says what bounds it on the card
and how its design answers that: the sequence is cut into chunks that
run in parallel (three passes: chunk states, carry, rerun), or one pass
when S fits in one chunk, as at decode.  ``plan`` chooses from the shapes
alone, so the wrapper never reads a device value on the host; the chunk
states live in a scratch tensor from the caching allocator.  Unlike the
Pallas version it takes any sequence length S >= 1 (the Pallas kernel
asserts that its sequence block divides S), and it reads x, dt, B and C
through their (batch, sequence) strides, so the column slices the model
passes are not copied.  On a CUDA tensor this wrapper launches the
kernels (or raises); on a CPU tensor it runs the plain version,
``ref.mamba1_scan``.  ``ref.mamba1_scan_chunked`` computes in the chunked
kernels' order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref

#: wrapper calls that launched the CUDA kernels since the last reset
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16
CHUNK = 64          # steps per chunk; a multiple of the kernels' 64-step tiles
MAX_CHUNKS = 32     # longer sequences get wider chunks, keeping the carry pass short
CHANNELS = 32       # channels per CTA (four lanes of four states each)
STEP_ROWS = 4       # batch rows per CTA of the one-step (S = 1) kernel


@dataclass(frozen=True)
class ScanPlan:
    chunk: int              # steps per chunk
    chunks: int
    grid: tuple             # of the last launch: (channel blocks, chunks, batch), or
                            # (channel blocks, row blocks, 1) for the one-step kernel
    scratch_floats: int     # chunk end states and decays (0 for one chunk)
    kernel_launches: int    # 3 passes, or 1 when S <= chunk


def plan(bt: int, s: int, di: int, n: int) -> ScanPlan:
    """The launch plan of one call, from its shapes alone."""
    chunk = CHUNK * max(1, -(-s // (CHUNK * MAX_CHUNKS)))
    chunks = -(-s // chunk)
    n4 = -(-n // 4) * 4
    blocks = -(-di // CHANNELS)
    grid = (blocks, -(-bt // STEP_ROWS), 1) if s == 1 else (blocks, chunks, bt)
    return ScanPlan(chunk=chunk, chunks=chunks, grid=grid,
                    scratch_floats=2 * bt * (chunks - 1) * di * n4,
                    kernel_launches=3 if chunks > 1 else 1)


def mamba1_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None):
    """x, dt: (Bt, S, di) and B, C: (Bt, S, n), all f32 or all bf16; A:
    (di, n), D: (di,) and h0: (Bt, di, n) or None (zeros), f32.  Returns
    (y (Bt, S, di) in x.dtype, h_last (Bt, di, n) f32)."""
    if not x.is_cuda:
        return ref.mamba1_scan(x, dt, A, B, C, D, h0)
    bt, s, di = x.shape
    n = A.shape[-1]
    f32 = [A, D] + ([h0] if h0 is not None else [])
    if any(t.device != x.device for t in [dt, B, C, *f32]):
        raise ValueError("mamba1_scan: all tensors must be on x's device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise ValueError(f"mamba1_scan: dtypes {x.dtype}/{dt.dtype}/{B.dtype}/{C.dtype}; "
                         f"x, dt, B and C must be all f32 or all bf16")
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("mamba1_scan: A, D and h0 must be f32")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"mamba1_scan: state size {n} not in 1..{MAX_STATE}")
    if (dt.shape != x.shape or A.shape != (di, n) or B.shape != (bt, s, n)
            or C.shape != B.shape or D.shape != (di,)
            or (h0 is not None and h0.shape != (bt, di, n)) or s < 1):
        raise ValueError(f"mamba1_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B.shape)} C {tuple(C.shape)} "
                         f"D {tuple(D.shape)} do not match")
    # only the last dimension has to be contiguous; the rest is read through strides
    x, dt, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, dt, B, C))
    A, D = A.contiguous(), D.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    p = plan(bt, s, di, n)
    y = torch.empty((bt, s, di), dtype=x.dtype, device=x.device)
    h_last = torch.empty((bt, di, n), dtype=torch.float32, device=x.device)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32, device=x.device)
               if p.scratch_floats else None)
    lib = build.load("mamba_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mamba1_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            h_last.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            bt, s, di, n, p.chunk, *x.stride()[:2], *dt.stride()[:2],
            *B.stride()[:2], *C.stride()[:2], _DTYPES[x.dtype], stream)
    build.check(rc, "mamba_scan")
    launches.add()
    return y, h_last
