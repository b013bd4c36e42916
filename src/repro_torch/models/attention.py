"""Grouped-query attention: one-token decode and chunked prefill
(``repro.models.attention``).

Layouts follow the reference: q proj ``[d, nh, hd]``, k/v ``[d, nkv, hd]``,
o proj ``[nh, hd, d]``; caches ``[B, S, nkv, hd]`` or page pools
``[P, ps, nkv, hd]`` with ``[B, nblk]`` block tables.  Unlike the
reference's functional updates, the cache writes here are **in place**: a
copy of every layer's cache per step has no place on the card.  The
functions still return the (same) cache tensors so callers read like the
reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import paged_decode_attention
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


def attention_decode(
    params: Params,
    x: torch.Tensor,  # [b, 1, d]
    cache_k: torch.Tensor,  # [b, S, nkv, hd], or pages [P, ps, nkv, hd] (paged)
    cache_v: torch.Tensor,
    cache_index: torch.Tensor,  # [b] per-slot positions
    cfg,
    block_tables: Optional[torch.Tensor] = None,  # [b, nblk] int32 (paged)
):
    """One-token decode (``attention.py:334``, per-slot vector index).  The
    new K/V row is written in place at each slot's position (into page
    ``bt[b, pos // ps]`` when paged), then the slot attends rows ``<= pos``.
    Returns ``(out [b, 1, d], cache_k, cache_v)``."""
    b = x.shape[0]
    paged = block_tables is not None
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
    bidx = torch.arange(b, device=x.device)
    if paged:
        pg = block_tables[bidx, pos[:, 0] // ps].long()
        off = pos[:, 0] % ps
        cache_k[pg, off] = k[:, 0].to(cache_k.dtype)
        cache_v[pg, off] = v[:, 0].to(cache_v.dtype)
    else:
        cache_k[bidx, pos[:, 0]] = k[:, 0].to(cache_k.dtype)
        cache_v[bidx, pos[:, 0]] = v[:, 0].to(cache_v.dtype)
    if paged and x.device.type == "cuda":
        # page-indirect flash decode on the card (the reference's
        # paged_decode_backend picks its kernel on the accelerator and the
        # gather below elsewhere): the kernel reads the block tables and
        # streams each slot's live pages, never building the gathered view
        lengths = (pos[:, 0] + 1).to(torch.int32)
        out = paged_decode_attention(
            q[:, 0].contiguous(), cache_k, cache_v, block_tables, lengths,
            logit_cap=float(cfg.attn_logit_softcap or 0.0),
        )[:, None]
    else:
        if paged:
            bt = block_tables.long()
            k_r = cache_k[bt].reshape(b, S, *cache_k.shape[2:])
            v_r = cache_v[bt].reshape(b, S, *cache_v.shape[2:])
        else:
            k_r, v_r = cache_k, cache_v
        mask = torch.arange(S, device=x.device)[None, :] <= pos  # [b, S]
        qg = q.reshape(b, 1, nkv, q.shape[2] // nkv, q.shape[3])
        out = _attend(qg, k_r, v_r, mask[:, None, None, None, :], cfg.attn_logit_softcap)
    y = _out_proj(out, params["wo"])
    return y, cache_k, cache_v


def attention_prefill_chunk(
    params: Params,
    x: torch.Tensor,  # [b, c, d], one prompt chunk
    cache_k: torch.Tensor,  # [b, S, nkv, hd]
    cache_v: torch.Tensor,
    start: int,  # absolute position of the chunk's first token
    cfg,
):
    """Chunked prefill, scalar-start full-context branch
    (``attention.py:302-315``): the chunk's K/V land in place at rows
    ``[start, start + c)`` -- clamped to ``S - c`` as
    ``dynamic_update_slice`` does -- and the chunk's queries attend causally
    over the cache.  Returns ``(out [b, c, d], cache_k, cache_v)``."""
    b, c, _ = x.shape
    S = cache_k.shape[1]
    nkv = cfg.num_kv_heads
    pos = start + torch.arange(c, device=x.device)
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.use_rope:
        q = apply_rope(q, pos.expand(b, c), cfg.rope_theta)
        k = apply_rope(k, pos.expand(b, c), cfg.rope_theta)
    s0 = min(max(int(start), 0), S - c)
    cache_k[:, s0 : s0 + c] = k.to(cache_k.dtype)
    cache_v[:, s0 : s0 + c] = v.to(cache_v.dtype)
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]  # [c, S]
    qg = q.reshape(b, c, nkv, q.shape[2] // nkv, q.shape[3])
    out = _attend(qg, cache_k, cache_v, mask[None, None, None], cfg.attn_logit_softcap)
    return _out_proj(out, params["wo"]), cache_k, cache_v
