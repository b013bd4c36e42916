"""Grouped-query attention: one-token decode and chunked prefill
(``repro.models.attention``).

Layouts follow the reference: q proj ``[d, nh, hd]``, k/v ``[d, nkv, hd]``,
o proj ``[nh, hd, d]``; caches ``[B, S, nkv, hd]`` or page pools
``[P, ps, nkv, hd]`` with ``[B, nblk]`` block tables; int8 caches carry f32
scales ``[B, S, nkv]`` (``[P, ps, nkv]`` paged) beside them.  Unlike the
reference's functional updates, the cache writes here are **in place**: a
copy of every layer's cache per step has no place on the card.  The
functions still return the (same) cache tensors so callers read like the
reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_int8,
    paged_decode_attention,
)
from repro_torch.models.common import Params, apply_rope, dense_init

NEG_INF = -2.0e38  # the reference's dense-path mask constant (attention.py:24)


def init_attention(cfg, gen, dtype, device) -> Params:
    d, nh, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, nh, hd), fan_in=d, dtype=dtype, device=device),
        "wk": dense_init(gen, (d, nkv, hd), fan_in=d, dtype=dtype, device=device),
        "wv": dense_init(gen, (d, nkv, hd), fan_in=d, dtype=dtype, device=device),
        "wo": dense_init(gen, (nh, hd, d), fan_in=nh * hd, dtype=dtype, device=device),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dnh->bsnh") as one matmul."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bsnh,nhd->bsd")."""
    n, h, d = wo.shape
    return o.reshape(*o.shape[:-2], n * h) @ wo.reshape(n * h, d)


def _attend(
    q: torch.Tensor,  # [b, sq, n_kv, g, hd]
    k: torch.Tensor,  # [b, sk, n_kv, hd]
    v: torch.Tensor,
    mask: torch.Tensor,  # broadcastable to [b, n_kv, g, sq, sk], True = keep
    logit_cap: Optional[float],
) -> torch.Tensor:
    """Explicit f32-score softmax attention, so numbers follow the reference
    (``attention.py:61``) rather than a fused library kernel."""
    hd = q.shape[-1]
    scores = torch.einsum("bsngh,btnh->bngst", q.float(), k.float()) * (hd**-0.5)
    if logit_cap is not None:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v)
    b, sq, n_kv, g, _ = out.shape
    return out.reshape(b, sq, n_kv * g, hd)


def quantize_kv(x: torch.Tensor):
    """int8 absmax quantisation over head_dim (``attention.py:322``):
    ``[..., hd] -> (int8 [..., hd], f32 scale [...])``.  A true division and
    ``torch.round`` (half to even), as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def attention_decode(
    params: Params,
    x: torch.Tensor,  # [b, 1, d]
    cache_k: torch.Tensor,  # [b, S, nkv, hd], or pages [P, ps, nkv, hd] (paged)
    cache_v: torch.Tensor,
    cache_index: torch.Tensor,  # [b] per-slot positions
    cfg,
    k_scale: Optional[torch.Tensor] = None,  # [b, S, nkv] or [P, ps, nkv] (int8 caches only)
    v_scale: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,  # [b, nblk] int32 (paged)
):
    """One-token decode (``attention.py:334``, per-slot vector index).  The
    new K/V row is written in place at each slot's position (into page
    ``bt[b, pos // ps]`` when paged; quantised with its scale when the cache
    is int8), then the slot attends rows ``<= pos``.

    On the card the read is a flash-decode kernel over ``lengths = pos + 1``
    (the dense mask ``idx <= pos``): K1 for paged pools, K4 for a contiguous
    cache, K5 for a contiguous int8 cache.  Paged int8 pools, and every
    layout on the CPU, gather (paged), dequantise (int8) and attend densely
    as the reference does (``attention.py:425-441``); the JAX package has no
    page-indirect int8 kernel.  Returns ``(out [b, 1, d], cache_k, cache_v)``,
    plus ``(k_scale, v_scale)`` when the cache is int8."""
    b = x.shape[0]
    paged = block_tables is not None
    quant = cache_k.dtype == torch.int8
    if paged:
        ps = cache_k.shape[1]
        S = block_tables.shape[1] * ps
    else:
        S = cache_k.shape[1]
    nkv = cfg.num_kv_heads
    pos = cache_index.long().reshape(b, 1)
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if quant:
        k, ks_w = quantize_kv(k)
        v, vs_w = quantize_kv(v)
    if paged:
        rows = (block_tables[torch.arange(b, device=x.device), pos[:, 0] // ps].long(), pos[:, 0] % ps)
    else:
        rows = (torch.arange(b, device=x.device), pos[:, 0])
    cache_k[rows] = k[:, 0].to(cache_k.dtype)
    cache_v[rows] = v[:, 0].to(cache_v.dtype)
    if quant:
        k_scale[rows] = ks_w[:, 0]
        v_scale[rows] = vs_w[:, 0]
    if x.device.type == "cuda" and not (paged and quant):
        lengths = (pos[:, 0] + 1).to(torch.int32)
        cap = float(cfg.attn_logit_softcap or 0.0)
        q1 = q[:, 0].contiguous()
        if paged:
            out = paged_decode_attention(q1, cache_k, cache_v, block_tables, lengths, logit_cap=cap)
        elif quant:
            out = decode_attention_int8(q1, cache_k, cache_v, k_scale, v_scale, lengths, logit_cap=cap)
        else:
            out = decode_attention(q1, cache_k, cache_v, lengths, logit_cap=cap)
        out = out[:, None]
    else:
        k_r, v_r, ks_r, vs_r = cache_k, cache_v, k_scale, v_scale
        if paged:
            bt = block_tables.long()
            k_r, v_r = (t[bt].reshape(b, S, *t.shape[2:]) for t in (k_r, v_r))
            if quant:
                ks_r, vs_r = (t[bt].reshape(b, S, *t.shape[2:]) for t in (ks_r, vs_r))
        if quant:
            k_r = dequantize_kv(k_r, ks_r, x.dtype)
            v_r = dequantize_kv(v_r, vs_r, x.dtype)
        mask = torch.arange(S, device=x.device)[None, :] <= pos  # [b, S]
        qg = q.reshape(b, 1, nkv, q.shape[2] // nkv, q.shape[3])
        out = _attend(qg, k_r, v_r, mask[:, None, None, None, :], cfg.attn_logit_softcap)
    y = _out_proj(out, params["wo"])
    if quant:
        return y, cache_k, cache_v, k_scale, v_scale
    return y, cache_k, cache_v


def attention_full(
    params: Params,
    x: torch.Tensor,  # [b, s, d]
    cfg,
    positions: Optional[torch.Tensor] = None,  # [s]
    return_kv: bool = False,
):
    """Causal self-attention over a whole sequence (``attention.py:121``, the
    whole-prompt prefill), full context.  Returns ``out [b, s, d]``, and the
    post-rope ``(k, v)`` ``[b, s, nkv, hd]`` (cache-ready) with
    ``return_kv``.  The reference attends in 256-row query blocks past 2048
    tokens; that is a memory bound, not another function."""
    b, s, _ = x.shape
    nkv = cfg.num_kv_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.use_rope:
        q = apply_rope(q, positions.expand(b, s), cfg.rope_theta)
        k = apply_rope(k, positions.expand(b, s), cfg.rope_theta)
    idx = torch.arange(s, device=x.device)
    mask = idx[None, :] <= idx[:, None]  # [s, s] causal
    qg = q.reshape(b, s, nkv, q.shape[2] // nkv, q.shape[3])
    out = _attend(qg, k, v, mask[None, None, None], cfg.attn_logit_softcap)
    y = _out_proj(out, params["wo"])
    return (y, (k, v)) if return_kv else y


def attention_prefill_chunk(
    params: Params,
    x: torch.Tensor,  # [b, c, d], one prompt chunk (zero-padded rows with ``lengths``)
    cache_k: torch.Tensor,  # [b, S, nkv, hd]
    cache_v: torch.Tensor,
    start,  # int: the chunk's first absolute position; or [b] tensor, one per row
    cfg,
    k_scale: Optional[torch.Tensor] = None,  # [b, S, nkv] (int8 caches only)
    v_scale: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,  # [b] valid tokens per row (vector start)
):
    """Chunked prefill, full-context branches (``attention.py:174``).

    Scalar ``start`` (``attention.py:302-315``): the chunk's K/V land in
    place at rows ``[start, start + c)`` -- clamped to ``S - c`` as
    ``dynamic_update_slice`` does -- and the chunk's queries attend causally
    over the cache.

    Vector ``start`` (``[b]``, with ``lengths``; batched multi-prompt
    prefill, ``attention.py:282-301``): row ``i`` writes its
    ``lengths[i]`` tokens at ``[start[i], start[i] + lengths[i])``; padding
    columns (and rows past the cache) are dropped, and padded query rows are
    fully masked, so each valid row computes what the scalar path would.

    An int8 cache takes the chunk quantised once, with its scales, and is
    attended dequantised, so the chunk's own keys go through the same round
    trip later reads see.  Returns ``(out [b, c, d], cache_k, cache_v)``,
    plus ``(k_scale, v_scale)`` when the cache is int8."""
    b, c, _ = x.shape
    S = cache_k.shape[1]
    nkv = cfg.num_kv_heads
    quant = cache_k.dtype == torch.int8
    vec = torch.is_tensor(start) and start.dim() == 1
    if vec and lengths is None:
        raise ValueError("vector-start chunks require per-row lengths")
    cols = torch.arange(c, device=x.device)
    # [c] absolute positions (scalar start) or [b, c] (vector start)
    pos = start.long()[:, None] + cols[None, :] if vec else start + cols
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.use_rope:
        q = apply_rope(q, pos.expand(b, c), cfg.rope_theta)
        k = apply_rope(k, pos.expand(b, c), cfg.rope_theta)
    if quant:
        k, ks_q = quantize_kv(k)
        v, vs_q = quantize_kv(v)
    if vec:
        valid = cols[None, :] < lengths.long()[:, None]  # [b, c]
        write = valid & (pos < S)
        rows = (torch.arange(b, device=x.device)[:, None].expand(b, c)[write], pos[write])
        cache_k[rows] = k[write].to(cache_k.dtype)
        cache_v[rows] = v[write].to(cache_v.dtype)
        if quant:
            k_scale[rows] = ks_q[write]
            v_scale[rows] = vs_q[write]
        # [b, c, S]: causal per row, padded query rows fully masked
        mask = ((torch.arange(S, device=x.device)[None, None, :] <= pos[:, :, None])
                & valid[:, :, None])[:, None, None]
    else:
        s0 = min(max(int(start), 0), S - c)
        if quant:
            k_scale[:, s0 : s0 + c] = ks_q
            v_scale[:, s0 : s0 + c] = vs_q
        cache_k[:, s0 : s0 + c] = k.to(cache_k.dtype)
        cache_v[:, s0 : s0 + c] = v.to(cache_v.dtype)
        mask = (torch.arange(S, device=x.device)[None, :] <= pos[:, None])[None, None, None]  # [c, S]
    if quant:
        k_att = dequantize_kv(cache_k, k_scale, x.dtype)
        v_att = dequantize_kv(cache_v, v_scale, x.dtype)
    else:
        k_att, v_att = cache_k, cache_v
    qg = q.reshape(b, c, nkv, q.shape[2] // nkv, q.shape[3])
    out = _attend(qg, k_att, v_att, mask, cfg.attn_logit_softcap)
    y = _out_proj(out, params["wo"])
    if quant:
        return y, cache_k, cache_v, k_scale, v_scale
    return y, cache_k, cache_v
