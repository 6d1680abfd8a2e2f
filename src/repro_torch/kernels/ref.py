"""Plain PyTorch versions of the attention kernels and the Mamba scans.

They compute what the CUDA kernels compute, in the most direct way, and
are the numerically trusted side of every comparison: the CPU tests hold
them against the JAX package's oracles, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  On a CPU tensor the kernel
wrappers run these functions; on the card nothing on the serving path
uses them unless the backend is set to ``"ref"`` (``mamba2_scan`` is the
exception: it has no kernel in either package).

Attention uses grouped (GQA) einsums: K/V are never repeated to
``num_heads``.  Masked scores take the finite ``-2**30``, so a row with
every key masked averages V instead of giving NaN.  The scans run a
sequential loop over S in f32, as the JAX oracles' ``lax.scan`` does.
"""
from __future__ import annotations

import torch

_NEG_INF = -2.0 ** 30  # large-negative instead of -inf: keeps fully-masked rows finite


def _group(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """(B,S,nq,hd) -> (B,S,nkv,g,hd)."""
    b, s, nq, hd = q.shape
    return q.reshape(b, s, nkv, nq // nkv, hd)


def _attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """qg (B,S,nkv,g,hd) f32 pre-scaled; k, v (B,T,nkv,hd); mask
    broadcastable to (B,nkv,g,S,T). Returns (B,S,nkv,g,hd) f32."""
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", probs, v.float())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Full-sequence attention.

    q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd); nq % nkv == 0.
    Query i sits at position i + Sk - Sq (ends aligned).  window > 0 =>
    key j visible to query position p iff p - window < j (plus causality
    j <= p).
    """
    b, sq, nq, hd = q.shape
    nkv, sk = k.shape[2], k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    qg = _group(q, nkv).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    out = _attend(qg, k, v, mask)
    return out.reshape(b, sq, nq, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0, scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     key_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token decode attention against a dense per-request KV cache.

    q: (B, 1, nq, hd); caches: (B, S, nkv, hd); pos: (B,) index of the
    current token (the cache already holds it).  k_scale/v_scale: optional
    (B, S, nkv) dequant scales of int8 caches.  key_positions: optional
    (B, S) absolute position of every cache column (ring-buffer SWA
    caches); defaults to arange(S).
    """
    b, _, nq, hd = q.shape
    nkv, s = k_cache.shape[2], k_cache.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
    if v_scale is not None:
        vf = vf * v_scale.float()[..., None]
    qg = _group(q, nkv).float() * scale
    if key_positions is not None:
        j = key_positions
    else:
        j = torch.arange(s, device=q.device)[None, :].expand(b, s)
    mask = (j <= pos[:, None]) & (j >= 0)
    if window > 0:
        mask &= j > (pos[:, None] - window)
    out = _attend(qg, kf, vf, mask[:, None, None, None, :])
    return out.reshape(b, 1, nq, hd).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, *, window: int = 0,
                    scale: float | None = None,
                    k_scale_pages: torch.Tensor | None = None,
                    v_scale_pages: torch.Tensor | None = None) -> torch.Tensor:
    """Decode attention over a block-paged KV cache (vLLM PagedAttention).

    q: (B, nq, hd), one query token per sequence.
    k_pages/v_pages: (num_pages, page_size, nkv, hd), the global page pool.
    block_tables: (B, pages_per_seq) int32 page ids (padded arbitrarily).
    seq_lens: (B,) int32, valid tokens including the current one.
    k/v_scale_pages: optional (num_pages, page_size, nkv) dequant scales
    of int8 page pools.  A row with seq_len 0 averages V over all its
    gathered tokens.
    """
    b, nq, hd = q.shape
    _, page, nkv, _ = k_pages.shape
    scale = scale if scale is not None else hd ** -0.5
    bt = block_tables.long()
    k = k_pages[bt].float()                       # (B, pp, page, nkv, hd)
    v = v_pages[bt].float()
    if k_scale_pages is not None:
        k = k * k_scale_pages[bt].float()[..., None]
    if v_scale_pages is not None:
        v = v * v_scale_pages[bt].float()[..., None]
    pp = bt.shape[1]
    k = k.reshape(b, pp * page, nkv, hd)
    v = v.reshape(b, pp * page, nkv, hd)
    qg = q.reshape(b, 1, nkv, nq // nkv, hd).float() * scale
    j = torch.arange(pp * page, device=q.device)[None, :]
    sl = seq_lens.long()[:, None]
    mask = j < sl
    if window > 0:
        mask &= j > (sl - 1 - window)
    out = _attend(qg, k, v, mask[:, None, None, None, :])
    return out.reshape(b, nq, hd).to(q.dtype)


def paged_attention_split(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          seq_lens: torch.Tensor, *, partition: int, window: int = 0,
                          scale: float | None = None,
                          k_scale_pages: torch.Tensor | None = None,
                          v_scale_pages: torch.Tensor | None = None) -> torch.Tensor:
    """``paged_attention`` computed the way the split CUDA kernel does.

    The tokens of each row are cut into partitions of ``partition``
    tokens (a partition may start mid-page).  Each partition's visible
    tokens give a partial (max m, sum l, unnormalised output acc); a
    partition without one gives l = 0 and is left out; the partials are
    merged in order by rescaling to their common max.  A row with no
    visible token (seq_len 0) gives zeros, as the kernel does, where
    ``paged_attention`` averages V.  Used by the tests and chip_smoke,
    never by the serving path.
    """
    b, nq, hd = q.shape
    _, page, nkv, _ = k_pages.shape
    scale = scale if scale is not None else hd ** -0.5
    bt = block_tables.long()
    k = k_pages[bt].float()                       # (B, pp, page, nkv, hd)
    v = v_pages[bt].float()
    if k_scale_pages is not None:
        k = k * k_scale_pages[bt].float()[..., None]
    if v_scale_pages is not None:
        v = v * v_scale_pages[bt].float()[..., None]
    t = bt.shape[1] * page
    splits = -(-t // partition)
    pad = splits * partition - t
    k = torch.nn.functional.pad(k.reshape(b, t, nkv, hd), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v.reshape(b, t, nkv, hd), (0, 0, 0, 0, 0, pad))
    qg = q.reshape(b, nkv, nq // nkv, hd).float() * scale
    s = torch.einsum("bkgh,btkh->bkgt", qg, k)
    j = torch.arange(splits * partition, device=q.device)[None, :]
    last = seq_lens.long().clamp(max=t)[:, None]
    visible = j < last
    if window > 0:
        visible &= j > last - 1 - window
    visible = visible[:, None, None, :]
    s = torch.where(visible, s, float("-inf")).reshape(b, nkv, -1, splits, partition)
    visible = visible.reshape(b, 1, 1, splits, partition)
    m = s.amax(-1)                                               # (B, nkv, g, splits)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.where(visible, torch.exp(s - m_safe[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    acc = torch.einsum("bkgsp,bspkh->bkgsh", p, v.reshape(b, splits, partition, nkv, hd))
    used = l > 0
    mm = torch.where(used, m, float("-inf")).amax(-1, keepdim=True)
    mm = torch.where(torch.isinf(mm), torch.zeros_like(mm), mm)
    w = torch.where(used, torch.exp(m - mm), torch.zeros_like(m))
    total = (w * l).sum(-1)
    out = (w[..., None] * acc).sum(-2)
    out = torch.where(total[..., None] > 0, out / total.clamp(min=1e-30)[..., None],
                      torch.zeros_like(out))
    return out.reshape(b, nq, hd).to(q.dtype)


def chunk_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                    q_start, *, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Chunked-prefill attention: C query tokens at absolute positions
    [q_start, q_start+C) attend over a gathered KV history.

    q: (B, C, nq, hd); k_all/v_all: (B, T, nkv, hd) with keys valid on
    [0, q_start + C) (causality masks the rest). q_start: (B,) or scalar.
    """
    b, c, nq, hd = q.shape
    nkv, t = k_all.shape[2], k_all.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    qg = _group(q, nkv).float() * scale
    qs = torch.as_tensor(q_start, device=q.device).long().expand(b)
    qpos = qs[:, None, None] + torch.arange(c, device=q.device)[None, :, None]
    kpos = torch.arange(t, device=q.device)[None, None, :]
    mask = kpos <= qpos                                        # (B, C, T)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    out = _attend(qg, k_all, v_all, mask[:, None, None])
    return out.reshape(b, c, nq, hd).to(q.dtype)


# ----------------------------------------------------------------------------
# Mamba selective scans
# ----------------------------------------------------------------------------

def mamba1_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None):
    """Mamba1 selective scan.

    x, dt: (Bt, S, di); A: (di, n); B, C: (Bt, S, n); D: (di,).
    h0: optional initial state (Bt, di, n).  Per step
    h <- exp(dt A) h + dt B x and y = h . C + D x.  Returns (y (Bt, S, di)
    in x.dtype, h_last (Bt, di, n) f32).
    """
    bt, _, di = x.shape
    n = A.shape[1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    h = (torch.zeros((bt, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(x.shape[1]):
        dtt = dtf[:, t, :, None]                                  # (Bt, di, 1)
        dA = torch.exp(dtt * Af[None])                            # (Bt, di, n)
        dBx = dtt * Bf[:, t, None, :] * xf[:, t, :, None]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, 1) + xf * D.float()[None, None]
    return y.to(x.dtype), h


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None):
    """Mamba2 (SSD) scan with scalar-per-head A.

    x: (Bt, S, nh, hp); dt: (Bt, S, nh); A, D: (nh,); B, C: (Bt, S, n).
    Returns (y (Bt, S, nh, hp) in x.dtype, h_last (Bt, nh, hp, n) f32).
    """
    bt, _, nh, hp = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    h = (torch.zeros((bt, nh, hp, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(x.shape[1]):
        dtt = dtf[:, t]                                           # (Bt, nh)
        dA = torch.exp(dtt * Af[None])
        dBx = (dtt[..., None, None] * xf[:, t, ..., None]) * Bf[:, t, None, None, :]
        h = dA[..., None, None] * h + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, 1) + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h
