"""Plain PyTorch versions of the attention kernels, the Mamba scans and
the f32 x bf16 product.

They compute what the CUDA kernels compute, in the most direct way, and
are the numerically trusted side of every comparison: the CPU tests hold
them against the JAX package's oracles, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  On a CPU tensor the kernel
wrappers run these functions; on the card nothing on the serving or
training path uses them unless the backend is set to ``"ref"``
(``mamba2_scan`` is the exception: it has no kernel in either package,
and ``ops.mamba2_scan`` runs ``mamba2_scan_chunked`` above 64 steps).
``flash_attention_bwd`` is the plain version of the attention backward
kernel; the CPU's training path differentiates ``flash_attention`` with
autograd instead.

Attention uses grouped (GQA) einsums: K/V are never repeated to
``num_heads``.  Masked scores take the finite ``-2**30``, so a row with
every key masked averages V instead of giving NaN.  The scans run a
sequential loop over S in f32, as the JAX oracles' ``lax.scan`` does;
the ``*_chunked`` forms compute the same scans by chunks.
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


_LOG2E = 1.4426950408889634  # log2(e): lse is kept in log2 units, as the kernels keep it


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, return_lse: bool = False):
    """Full-sequence attention.

    q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd); nq % nkv == 0.
    Query i sits at position i + Sk - Sq (ends aligned).  window > 0 =>
    key j visible to query position p iff p - window < j (plus causality
    j <= p).  With ``return_lse`` returns (out, lse): lse (B, nq, Sq) f32
    is each row's logsumexp of the scaled, masked scores in log2 units
    (logsumexp / ln 2), the unit the CUDA kernels write and read.
    """
    b, sq, nq, hd = q.shape
    nkv, sk = k.shape[2], k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    qg = _group(q, nkv).float() * scale
    mask = _mask(sq, sk, causal, window, q.device)
    if not return_lse:
        out = _attend(qg, k, v, mask)
        return out.reshape(b, sq, nq, hd).to(q.dtype)
    s = torch.where(mask, torch.einsum("bskgh,btkh->bkgst", qg, k.float()), _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                              # (B,nkv,g,Sq)
    out = torch.einsum("bkgst,btkh->bskgh", torch.exp(s - lse[..., None]), v.float())
    return (out.reshape(b, sq, nq, hd).to(q.dtype),
            (lse * _LOG2E).reshape(b, nq, sq))


def _mask(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) visibility: query i at position i + Sk - Sq sees key j iff
    (not causal or j <= position) and (window == 0 or j > position - window)."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: float | None = None,
                        lse: torch.Tensor | None = None):
    """Gradient of ``flash_attention`` written out as FlashAttention-2's
    backward equations in f32 (not autograd): recompute S = scale Q K^T
    (masked to -2**30) and, unless ``lse`` is given (the forward's, (B,
    nq, Sq) f32 in log2 units), its row logsumexp; P = exp(S - lse),
    D = rowsum(dO * O), dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
    dQ = scale dS K, dK = scale dS^T Q.  dK and dV sum over each group's
    query heads (GQA).

    q, o, do: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd); ``o`` is the
    forward's output.  Returns (dq, dk, dv) in the types of q, k and v.
    """
    b, sq, nq, hd = q.shape
    nkv, sk = k.shape[2], k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    qg = _group(q, nkv).float()                                   # (B,S,nkv,g,hd)
    dog = _group(do, nkv).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgh,btkh->bkgst", qg * scale, kf)         # (B,nkv,g,Sq,Sk)
    s = torch.where(_mask(sq, sk, causal, window, q.device), s, _NEG_INF)
    if lse is None:
        lse_nat = torch.logsumexp(s, dim=-1, keepdim=True)
    else:
        lse_nat = lse.float().reshape(b, nkv, nq // nkv, sq, 1) / _LOG2E
    p = torch.exp(s - lse_nat)
    d = (dog * _group(o, nkv).float()).sum(-1)                    # (B,Sq,nkv,g)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    return dq.reshape(b, sq, nq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                              block_q: int = 64, block_k: int = 128, causal: bool = True,
                              window: int = 0, scale: float | None = None,
                              tf32x3: bool = False):
    """``flash_attention_bwd`` computed the way the CUDA kernels tile it
    (Sq == Sk): the wgmma route and the mma route (``flash_attention.
    BWD_TILES`` gives each route's tiles).  For each tile of ``block_k``
    keys and each kv head: every query head of the group and every tile
    of ``block_q`` rows that sees a key of the tile (the kernel's range:
    from the tile holding the first key when causal, up to the last row
    the window lets see the last key).  Per (key tile, query tile): S^T =
    K Q^T, P^T = exp2(S^T scale log2(e) - lse) set to 0 where hidden or
    past S (every tile masked, where the kernel masks only those it does
    not see whole: the same values), dP^T = V dO^T, dS^T = P^T (dP^T -
    D); P^T and dS^T are rounded to the input type before they enter dV
    += P^T dO, dK += dS^T Q and dQ += dS K, which the kernel sums in f32
    over key tiles.  With ``tf32x3`` (the mma route's f32 arithmetic) each
    of the five products is three TF32 products of split operands
    (``_einsum_tf32x3``), as the kernel's m16n8k8 TF32 tensor cores form
    it.  ``lse`` is the forward's (B, nq, S) f32 in log2 units.  Used by
    the tests, never by the training path.
    """
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scale = scale if scale is not None else hd ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    d = (dof * o.float()).sum(-1)                                 # (B,S,nq)
    lse2 = lse.float()                                            # (B,nq,S)
    dq = torch.zeros((b, s, nq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, s, nkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    rnd = (lambda t: t.to(q.dtype).float()) if q.dtype != torch.float32 else (lambda t: t)
    mm = _einsum_tf32x3 if tf32x3 else torch.einsum
    n_qt = -(-s // block_q)
    for c0 in range(0, s, block_k):
        c1 = min(c0 + block_k, s)
        t_begin = c0 // block_q if causal else 0
        i_end = min(s, c1 - 1 + window) if window > 0 else s
        t_end = min(n_qt, -(-i_end // block_q))
        kt, vt = kf[:, c0:c1], vf[:, c0:c1]                      # (B,Tk,nkv,hd)
        for hh in range(g):
            heads = torch.arange(nkv, device=q.device) * g + hh  # this member of each group
            for t in range(t_begin, t_end):
                i0, i1 = t * block_q, min(t * block_q + block_q, s)
                qt = qf[:, i0:i1, heads]                          # (B,Tq,nkv,hd)
                dot = dof[:, i0:i1, heads]
                st = mm("bjkh,bikh->bkji", kt, qt)      # (B,nkv,Tk,Tq)
                lt = lse2[:, heads, i0:i1][:, :, None, :]         # (B,nkv,1,Tq)
                vis = _mask(s, s, causal, window, q.device)[i0:i1, c0:c1].T  # (Tk,Tq)
                p = torch.where(vis, torch.exp2(st * (scale * _LOG2E) - lt), 0.0)
                dpt = mm("bjkh,bikh->bkji", vt, dot)
                dst = p * (dpt - d[:, i0:i1, heads].permute(0, 2, 1)[:, :, None, :])
                p, dst = rnd(p), rnd(dst)
                dv[:, c0:c1] += mm("bkji,bikh->bjkh", p, dot)
                dk[:, c0:c1] += mm("bkji,bikh->bjkh", dst, qt)
                dq[:, i0:i1, heads] += mm("bkji,bjkh->bikh", dst, kt)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits of the
    magnitude are rounded off."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _einsum_tf32x3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product through split TF32 products: a = a_hi + a_lo with both
    parts rounded to TF32, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
    (each TF32 product is exact in f32; the sums are f32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def flash_attention_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, window: int = 0,
                           scale: float | None = None, return_lse: bool = False):
    """``flash_attention`` in f32 with the arithmetic of the CUDA mma
    kernel's f32 path: S = (scale q) k^T and O = P V each as three TF32
    tensor-core products of split operands, P = exp(S - rowmax)
    unnormalised in f32, O divided by the f32 row sum at the end; with
    ``return_lse`` also (rowmax + log(row sum)) in log2 units, as the
    kernel's kLse epilogue writes it.  Used by the tests and chip_smoke to
    hold that arithmetic to the f32 tolerance, never by the serving
    path."""
    b, sq, nq, hd = q.shape
    nkv, sk = k.shape[2], k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    qg = _group(q, nkv).float() * scale
    s = _einsum_tf32x3("bskgh,btkh->bkgst", qg, k.float())
    s = torch.where(_mask(sq, sk, causal, window, q.device), s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    out = _einsum_tf32x3("bkgst,btkh->bskgh", p, v.float())
    out = out / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    out = out.reshape(b, sq, nq, hd).to(q.dtype)
    if not return_lse:
        return out
    return out, ((m[..., 0] + torch.log(p.sum(-1))) * _LOG2E).reshape(b, nq, sq)


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
# f32 activations x bf16 weights
# ----------------------------------------------------------------------------

def mixed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32 @ w (K, N) bf16 in f32: the weight widened, as
    ``jnp`` promotes it.  Returns (..., N) f32."""
    return torch.matmul(x, w.float())


def mixed_grouped(x: torch.Tensor, ws, a_rows: torch.Tensor | None, offsets: torch.Tensor,
                  counts: torch.Tensor, capacity: int, rows: int) -> list:
    """For each weight w (G, K, N) bf16 of ``ws``, y (rows, N) f32 whose
    row j, for the first min(counts[e], capacity) rows j from offsets[e]
    of each group e, is x[a_rows[j]] @ w[e] (x[j] when ``a_rows`` is
    None) in f32; the other rows are zeros."""
    outs = [torch.zeros((rows, w.shape[-1]), dtype=torch.float32, device=x.device) for w in ws]
    groups = ws[0].shape[0]
    for e, (o, c) in enumerate(zip(offsets[:groups].tolist(), counts[:groups].tolist())):
        j = torch.arange(o, o + min(c, capacity), device=x.device)
        src = x[a_rows[j].long() if a_rows is not None else j].float()
        for y, w in zip(outs, ws):
            y[j] = src @ w[e].float()
    return outs


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


def mamba1_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                        h0: torch.Tensor | None = None, chunk: int = 64):
    """``mamba1_scan`` computed the way the chunked CUDA kernel does.

    S is cut into chunks of ``chunk`` steps.  Pass 1 scans each chunk
    from a zero state and keeps its end state and its decay, the running
    product of the per-step factors exp(dt A) (the kernel skips the last
    chunk, whose end is never used).  Pass 2 carries
    the true start state across the chunks in order: start[0] = h0 (or
    zeros), start[c + 1] = decay[c] start[c] + end[c].  Pass 3 reruns
    every chunk from its start state and gives y and, from the last
    chunk, h_last.  The last chunk is padded with dt = 0 steps, which
    leave the state and the decay unchanged exactly.  Used by the tests
    and chip_smoke, never by the serving path.
    """
    bt, s, di = x.shape
    n = A.shape[1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):      # (Bt, S, m) f32 -> (Bt, nc, chunk, m), zero-padded
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.reshape(bt, nc, chunk, t.shape[-1])

    xf, dtf, Bf, Cf = chunks(x), chunks(dt), chunks(B), chunks(C)
    Af = A.float()
    h = torch.zeros((bt, nc, di, n), dtype=torch.float32, device=x.device)
    decay = torch.ones_like(h)
    for t in range(chunk):                                        # pass 1
        dtt = dtf[:, :, t, :, None]                               # (Bt, nc, di, 1)
        dA = torch.exp(dtt * Af)
        decay = decay * dA
        h = dA * h + dtt * Bf[:, :, t, None, :] * xf[:, :, t, :, None]
    start = (torch.zeros((bt, di, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    starts = [start]
    for c in range(nc - 1):                                       # pass 2
        start = decay[:, c] * start + h[:, c]
        starts.append(start)
    h = torch.stack(starts, 1)
    ys = []
    for t in range(chunk):                                        # pass 3
        dtt = dtf[:, :, t, :, None]
        h = torch.exp(dtt * Af) * h + dtt * Bf[:, :, t, None, :] * xf[:, :, t, :, None]
        ys.append(torch.einsum("bcdn,bcn->bcd", h, Cf[:, :, t]))
    y = torch.stack(ys, 2).reshape(bt, nc * chunk, di)[:, :s] + x.float() * D.float()
    return y.to(x.dtype), h[:, -1]


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


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i
    (0 on the diagonal), -inf above it.  Summed along each column, not as
    a difference of two running sums, so no long sum is subtracted from
    another; -inf is set before any ``exp``, whose gradient is then 0."""
    t = a.shape[-1]
    ones = torch.ones((t, t), dtype=torch.bool, device=a.device)
    strict, lower = torch.tril(ones, -1), torch.tril(ones)
    rows = a[..., :, None].expand(*a.shape, t)                # rows[i, j] = a[i]
    sums = torch.cumsum(torch.where(strict, rows, 0.0), dim=-2)
    return torch.where(lower, sums, float("-inf"))


def mamba2_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                        h0: torch.Tensor | None = None, chunk: int = 64):
    """``mamba2_scan`` by chunks of ``chunk`` steps, in the state-space
    duality form (Mamba2, arXiv:2405.21060 sec. 6): the same function as
    the step-by-step scan, summed in another order, in f32.

    S is padded to whole chunks with zero steps (a = dt A = 0 keeps the
    state, dt x = 0 adds nothing).  Per head a = dt A <= 0.  Inside a
    chunk, y_t gets sum_{s<=t} exp(a_{s+1} + ... + a_t) (C_t . B_s) dt_s x_s
    as two batched products over a (chunk x chunk) decay matrix; each
    chunk's own end state is sum_s exp(a_{s+1} + ... + a_end) dt_s x_s B_s.
    The states at the chunks' starts come from one product over an
    (nc + 1) x (nc + 1) decay matrix of the chunks' summed a (a segment
    sum, with h0 as chunk -1), and y_t gets exp(a_1 + ... + a_t) C_t .
    start, then x D.  The last start is h_last: exact for a ragged S,
    the padded steps changing nothing.  Shapes and returns as
    ``mamba2_scan``.
    """
    bt, s, nh, hp = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):      # (Bt, S, ...) f32 -> (Bt, nc, chunk, ...), zero-padded
        t = t.float()
        if pad:
            t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bt, nc, chunk, *t.shape[2:])

    xf, dtf, Bf, Cf = chunks(x), chunks(dt), chunks(B), chunks(C)
    a = (dtf * A.float()).transpose(2, 3)                     # (Bt, nc, nh, chunk)
    u = dtf[..., None] * xf                                   # (Bt, nc, chunk, nh, hp)
    # inside each chunk
    decay = torch.exp(_segsum(a))                             # (Bt, nc, nh, t, s)
    scores = torch.einsum("bctn,bcsn->bcts", Cf, Bf)          # shared by the heads
    y = torch.einsum("bchts,bcshp->bcthp", decay * scores[:, :, None], u)
    # each chunk's end state from a zero start
    csum = torch.cumsum(a, dim=-1)                            # (Bt, nc, nh, chunk)
    to_end = torch.exp(csum[..., -1:] - csum).transpose(2, 3)  # <= 1: csum only falls
    ends = torch.einsum("bcshp,bcsn->bchpn", to_end[..., None] * u, Bf)
    # the start of every chunk, and the final state: one segment sum over
    # the chunks, h0 standing as the chunk before the first
    first = (torch.zeros((bt, 1, nh, hp, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float()[:, None])
    states = torch.cat([first, ends], dim=1)                  # (Bt, nc + 1, nh, hp, n)
    totals = csum[..., -1].transpose(1, 2)                    # (Bt, nh, nc)
    totals = torch.cat([torch.zeros_like(totals[..., :1]), totals], dim=-1)
    across = torch.exp(_segsum(totals))                       # (Bt, nh, nc + 1, nc + 1)
    starts = torch.einsum("bhcj,bjhpn->bchpn", across, states)
    y_in = torch.einsum("bctn,bchpn->bcthp", Cf, starts[:, :nc])
    y = y + y_in * torch.exp(csum).transpose(2, 3)[..., None]
    y = y.reshape(bt, nc * chunk, nh, hp)[:, :s] + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), starts[:, nc]
