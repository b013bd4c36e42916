"""Grouped-query attention: one-token decode, chunked and whole-sequence
prefill, the encoder's bidirectional attention and cross attention
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
from repro_torch.models.common import Params, apply_rope, checkpointed, dense_init, is_dtensor

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
    window: Optional[int] = None,  # sliding window: the cache is a rolling buffer
    k_scale: Optional[torch.Tensor] = None,  # [b, S, nkv] or [P, ps, nkv] (int8 caches only)
    v_scale: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,  # [b, nblk] int32 (paged)
):
    """One-token decode (``attention.py:334``, per-slot vector index).  The
    new K/V row is written in place at each slot's position (into page
    ``bt[b, pos // ps]`` when paged; at row ``pos % S`` of a rolling
    window buffer of ``S`` rows; quantised with its scale when the cache is
    int8), then the slot attends rows ``<= pos`` (every row of a rolling
    buffer once it has wrapped: it then holds exactly the window's keys, and
    softmax does not depend on their order).  A paged cache has no window.

    On the card the read is a flash-decode kernel over ``lengths = min(pos
    + 1, S)`` (the dense mask ``idx <= pos``): K1 for paged pools, K4 for a
    contiguous cache or window buffer, K5 for a contiguous int8 one.  Paged int8 pools, and every
    layout on the CPU, gather (paged), dequantise (int8) and attend densely
    as the reference does (``attention.py:425-441``); the JAX package has no
    page-indirect int8 kernel.  Returns ``(out [b, 1, d], cache_k, cache_v)``,
    plus ``(k_scale, v_scale)`` when the cache is int8."""
    if is_dtensor(x):
        from repro_torch.models import spmd

        return spmd.attention_decode(params, x, cache_k, cache_v, cache_index, cfg, window, k_scale, v_scale)
    b = x.shape[0]
    paged = block_tables is not None
    quant = cache_k.dtype == torch.int8
    if paged:
        if window is not None:
            raise ValueError("paged KV caches do not support rolling windows")
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
        rows = (torch.arange(b, device=x.device), pos[:, 0] % S if window is not None else pos[:, 0])
    cache_k[rows] = k[:, 0].to(cache_k.dtype)
    cache_v[rows] = v[:, 0].to(cache_v.dtype)
    if quant:
        k_scale[rows] = ks_w[:, 0]
        v_scale[rows] = vs_w[:, 0]
    if x.device.type == "cuda" and not (paged and quant):
        lengths = torch.clamp_max(pos[:, 0] + 1, S).to(torch.int32)
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


CHUNK_THRESHOLD = 2048  # the reference's query-chunked path above this length (attention.py:84)
Q_CHUNK = 256


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int], causal: bool = True) -> torch.Tensor:
    """``[sq, sk]``: key ``k`` is visible from query ``q`` (causal unless
    ``causal`` is false, and inside the window when there is one)."""
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    else:
        mask = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool, device=q_pos.device)
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def attention_full(
    params: Params,
    x: torch.Tensor,  # [b, s, d]
    cfg,
    positions: Optional[torch.Tensor] = None,  # [s]
    window: Optional[int] = None,  # sliding window (dense_local layers)
    causal: bool = True,  # False: every query sees every key (the encoder)
    return_kv: bool = False,
):
    """Self-attention over a whole sequence (``attention.py:121``, the
    whole-prompt prefill and the encoder), causal unless ``causal`` is false,
    within ``window`` keys when one is given.
    Returns ``out [b, s, d]``, and the post-rope ``(k, v)`` ``[b, s, nkv,
    hd]`` (cache-ready) with ``return_kv``.  Past 2048 tokens (a multiple of
    256) the queries attend in blocks of 256 rows, as the reference's
    ``_attend_qchunked`` does: each block's scores alone are live, and every
    row's softmax is the unchunked one's."""
    if is_dtensor(x):
        from repro_torch.models import spmd

        return spmd.attention_full(params, x, cfg, positions, window, causal, return_kv)
    q, k, v = full_qkv(params, x, cfg, positions)
    out = full_attend(q, k, v, cfg, window, causal)
    y = _out_proj(out, params["wo"])
    return (y, (k, v)) if return_kv else y


def full_qkv(params: Params, x: torch.Tensor, cfg, positions: Optional[torch.Tensor] = None):
    """The post-rope ``q [b, s, nh, hd]``, ``k`` and ``v [b, s, nkv, hd]`` of
    :func:`attention_full` (heads as many as the weights hold)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.use_rope:
        q = apply_rope(q, positions.expand(b, s), cfg.rope_theta)
        k = apply_rope(k, positions.expand(b, s), cfg.rope_theta)
    return q, k, v


def full_attend(q, k, v, cfg, window: Optional[int] = None, causal: bool = True) -> torch.Tensor:
    """:func:`attention_full`'s attention of ``q`` over ``k``/``v``, ``[b, s,
    nh, hd]``: each KV head serves ``nh / nkv`` query heads (``nkv`` from
    ``k``'s shape), query-chunked past 2048 tokens."""
    b, s, nkv = k.shape[0], q.shape[1], k.shape[2]
    qg = q.reshape(b, s, nkv, q.shape[2] // nkv, q.shape[3])
    idx = torch.arange(s, device=q.device)
    if s > CHUNK_THRESHOLD and s % Q_CHUNK == 0:
        # under autograd each block's scores are recomputed in backward: the
        # sequence's float32 probabilities would otherwise all be kept
        cap = cfg.attn_logit_softcap
        return torch.cat([
            checkpointed(lambda qb, k, v, m: _attend(qb, k, v, m, cap), qg[:, lo : lo + Q_CHUNK], k, v,
                         _causal_mask(idx[lo : lo + Q_CHUNK], idx, window, causal)[None, None, None])
            for lo in range(0, s, Q_CHUNK)
        ], dim=1)
    return _attend(qg, k, v, _causal_mask(idx, idx, window, causal)[None, None, None], cfg.attn_logit_softcap)


def attention_cross(
    params: Params,
    x: torch.Tensor,  # [b, sq, d]
    kv_src: torch.Tensor,  # [b, sk, d], the encoder's output
    cfg,
) -> torch.Tensor:
    """Encoder-decoder cross attention (``attention.py:157``): K/V projected
    from ``kv_src`` on every call, no positions on them, no mask.  Plain
    PyTorch on every device, as the reference has no kernel for it."""
    if is_dtensor(x):
        from repro_torch.models import spmd

        return spmd.attention_cross(params, x, kv_src, cfg)
    nkv = cfg.num_kv_heads
    q = _project(x, params["wq"])
    k = _project(kv_src, params["wk"])
    v = _project(kv_src, params["wv"])
    b, sq, nh, hd = q.shape
    mask = torch.ones((1, 1, 1, sq, kv_src.shape[1]), dtype=torch.bool, device=x.device)
    out = _attend(q.reshape(b, sq, nkv, nh // nkv, hd), k, v, mask, cfg.attn_logit_softcap)
    return _out_proj(out, params["wo"])


def attention_prefill_chunk(
    params: Params,
    x: torch.Tensor,  # [b, c, d], one prompt chunk (zero-padded rows with ``lengths``)
    cache_k: torch.Tensor,  # [b, S, nkv, hd]
    cache_v: torch.Tensor,
    start,  # int: the chunk's first absolute position; or [b] tensor, one per row
    cfg,
    window: Optional[int] = None,  # sliding window: the cache is a rolling buffer
    k_scale: Optional[torch.Tensor] = None,  # [b, S, nkv] (int8 caches only)
    v_scale: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,  # [b] valid tokens per row (vector start)
):
    """Chunked prefill (``attention.py:174``).

    ``window`` (scalar ``start`` only; ``attention.py:256-281``): the cache
    is a rolling buffer of ``S`` rows, row ``r`` holding the key of absolute
    position ``r + S * floor((start - 1 - r) / S)``, the newest before the
    chunk (negative: never written).  The chunk's queries attend those rows
    and the chunk's own keys as a separate segment, each within the window
    and causally; only then are the chunk's keys written, at rows ``pos %
    S`` (written first, a chunk key could overwrite one an earlier query of
    the same chunk still needs).  A chunk may not be longer than the
    buffer.

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
    if vec and window is not None:
        raise ValueError("vector-start chunks require full-context layers")
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
    if window is not None:
        return _prefill_chunk_window(params, x, q, k, v, cache_k, cache_v, int(start), pos, window, cfg,
                                     k_scale, v_scale, (ks_q, vs_q) if quant else None)
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


def _prefill_chunk_window(params, x, q, k, v, cache_k, cache_v, start: int, pos, window: int, cfg,
                          k_scale, v_scale, chunk_scales):
    """The window branch of :func:`attention_prefill_chunk`; ``k``/``v`` are
    the chunk's post-rope keys (int8 with ``chunk_scales`` when the cache is
    int8: then the chunk attends its own keys through the round trip later
    reads see)."""
    b, c, _ = x.shape
    S = cache_k.shape[1]
    nkv = cfg.num_kv_heads
    if c > S:
        raise ValueError(f"chunk ({c}) must not exceed the window ({S})")
    idx = torch.arange(S, device=x.device)
    abs_pos = idx + S * torch.div(start - 1 - idx, S, rounding_mode="floor")  # [S] key position of each row
    cache_mask = (abs_pos[None, :] >= 0) & _causal_mask(pos, abs_pos, window)  # [c, S]
    mask = torch.cat([cache_mask, _causal_mask(pos, pos, window)], dim=1)  # [c, S + c]
    if chunk_scales is not None:
        k_prev = dequantize_kv(cache_k, k_scale, x.dtype)
        v_prev = dequantize_kv(cache_v, v_scale, x.dtype)
        k_own = dequantize_kv(k, chunk_scales[0], x.dtype)
        v_own = dequantize_kv(v, chunk_scales[1], x.dtype)
    else:
        k_prev, v_prev, k_own, v_own = cache_k, cache_v, k, v
    qg = q.reshape(b, c, nkv, q.shape[2] // nkv, q.shape[3])
    out = _attend(qg, torch.cat([k_prev, k_own.to(k_prev.dtype)], dim=1),
                  torch.cat([v_prev, v_own.to(v_prev.dtype)], dim=1), mask[None, None, None], cfg.attn_logit_softcap)
    rows = pos % S
    cache_k[:, rows] = k.to(cache_k.dtype)
    cache_v[:, rows] = v.to(cache_v.dtype)
    y = _out_proj(out, params["wo"])
    if chunk_scales is None:
        return y, cache_k, cache_v
    k_scale[:, rows] = chunk_scales[0]
    v_scale[:, rows] = chunk_scales[1]
    return y, cache_k, cache_v, k_scale, v_scale
