"""Mamba1 selective scan: wrapper around ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py:
mamba1_scan``.  The CUDA kernel's header says what bounds it on the card
and how its design answers that.  Unlike the Pallas version it takes any
sequence length S >= 1 (the Pallas kernel asserts that its sequence block
divides S), and it reads x, dt, B and C through their (batch, sequence)
strides, so the column slices the model passes are not copied.  On a
CUDA tensor this wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.mamba1_scan``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16


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
    y = torch.empty((bt, s, di), dtype=x.dtype, device=x.device)
    h_last = torch.empty((bt, di, n), dtype=torch.float32, device=x.device)
    lib = build.load("mamba_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mamba1_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            h_last.data_ptr(), bt, s, di, n, *x.stride()[:2], *dt.stride()[:2],
            *B.stride()[:2], *C.stride()[:2], _DTYPES[x.dtype], stream)
    build.check(rc, "mamba_scan")
    launches.add()
    return y, h_last
