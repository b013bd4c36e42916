"""The layers over DTensors: the port's counterpart of GSPMD partitioning the
reference's jitted steps (``repro.launch.steps``).

The reference jits a whole step with ``NamedSharding``s on its weights and
inputs and lets XLA partition every op.  Here the sharded steps hand the
model DTensors (weights placed by ``sharding.rules.param_pspecs``, inputs by
``input_pspecs``), and each layer whose inputs are DTensors comes here
(``models.common.is_dtensor``): it runs as one ``local_map`` region over its
local shards, with explicit collectives inside, and returns DTensors.
Between regions only elementwise ops, norms and residual adds run on the
DTensors themselves.

Every activation leaves a region as the *activation layout*: batch over the
data axes (when the batch divides them), replicated over ``model``.  Inside:

* embedding: vocab-parallel (rows outside the rank's vocab slice masked,
  then an all-reduce over ``model``) when the table is split over vocab;
* attention: head-parallel (each rank its query heads and their KV heads,
  the output projection's partial sums all-reduced) when ``wq`` and ``wo``
  are split by head (a rank whose query heads straddle KV groups attends
  one KV head per query head); otherwise every weight is gathered and each
  ``model`` rank computes all heads.  One-token decode writes the new row into the cache shard in
  place; a cache split over its sequence axis (context parallelism) is
  attended shard by shard and the partial softmaxes merged with
  all-reduces (max, then sums), as a split-KV kernel merges its ranges;
* dense FFN: column-parallel up/gate, row-parallel down, all-reduced;
* Mamba blocks: weights and states gathered, each rank runs the block
  whole (the states' shards are written back in place);
* the tied head: vocab-parallel logits; the cross entropy's log-sum-exp and
  gold logit all-reduced over ``model``, the greedy token by an all-gather
  of each rank's best;
* MoE: ``models.moe_ep.moe_layer_ep`` (expert parallelism).

Collectives are ``torch.distributed._functional_collectives`` (fake tensors
trace them, a dispatch mode records them); gradients cross them through
:class:`Reduce` (all-reduce forward, identity backward) and :class:`Copy`
(identity forward, all-reduce backward), Megatron's pair, so a layer's
gradient equals the single-device layer's.  A group of one rank (the card's
1 x 1 mesh) runs no collective.  Where the port gathers and GSPMD would not
(the non-head-parallel attention, Mamba), ROADMAP.md lists it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod

MODEL = "model"
DP_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# mesh axes, placements and collectives
# ---------------------------------------------------------------------------


def _dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis)) if axis in mesh.mesh_dim_names else 1


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in mesh.mesh_dim_names)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_reduce(t: torch.Tensor, op: str, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``op`` ("sum" or "max") over each of ``axes`` in turn."""
    for a in axes:
        if axis_size(mesh, a) > 1:
            t = _wait(funcol.all_reduce(t, op, (mesh, _dim(mesh, a))))
    return t


# ``all_gather_single`` (torch >= 2.13) replaces ``all_gather_tensor``
_ALL_GATHER = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor


def all_gather(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return t
    return _wait(_ALL_GATHER(t.contiguous(), dim, (mesh, _dim(mesh, axis))))


class Reduce(torch.autograd.Function):
    """All-reduce (sum) over ``axes`` forward, identity backward: the combine
    of ranks that each hold a part of the result."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce(t, "sum", mesh, axes).view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class Copy(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a replicated input that
    each rank uses for its own part of the result."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.mesh, ctx.axes), None, None


class Mean(torch.autograd.Function):
    """All-reduce mean over ``axes`` forward (a sum over the ranks, then a
    division); the gradient of each rank's term is the output's over the
    rank count."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        n = 1
        for a in axes:
            n *= axis_size(mesh, a)
        ctx.n = n
        return all_reduce(t, "sum", mesh, axes) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def replicated(mesh) -> list:
    return [Replicate() for _ in mesh.mesh_dim_names]


def with_model(placements, mesh, p) -> list:
    out = list(placements)
    out[_dim(mesh, MODEL)] = p
    return out


def batch_sharded(t) -> bool:
    """Whether ``t``'s leading (batch) dimension is split over the data axes."""
    mesh = t.device_mesh
    return any(isinstance(t.placements[_dim(mesh, a)], Shard) and t.placements[_dim(mesh, a)].dim == 0
               for a in dp_axes(mesh))


def act_placements(mesh, sharded: bool, dim: int = 0) -> list:
    """The activation layout: dimension ``dim`` (the batch) over the data
    axes when ``sharded``, everything else replicated.  (Placements are
    lists: ``local_map`` reads a tuple as one placement list per output.)"""
    dp = dp_axes(mesh)
    return [Shard(dim) if (a in dp and sharded) else Replicate() for a in mesh.mesh_dim_names]


def weight_grad_placements(placements, mesh, sharded: bool, model_partial: bool = False) -> list:
    """The gradient layout of a weight a region reads with ``placements``:
    a partial sum over the data axes when the batch is split there (each
    rank saw its own tokens), and over ``model`` when ``model_partial``
    (each rank used its own part of a gathered weight)."""
    dp = dp_axes(mesh)
    out = []
    for a, p in zip(mesh.mesh_dim_names, placements):
        if a in dp and sharded:
            out.append(Partial())
        elif a == MODEL and model_partial:
            out.append(Partial())
        else:
            out.append(p)
    return out


def sharded_dim(t, axis: str = MODEL) -> Optional[int]:
    """The tensor dimension ``t`` splits over ``axis``, or None."""
    p = t.placements[_dim(t.device_mesh, axis)]
    return p.dim if isinstance(p, Shard) else None


def as_dtensor(t, mesh, placements, own_storage: bool = False):
    """``t`` if it is a DTensor; else the DTensor of which ``t`` is the
    global value (every rank holds the same ``t``): each rank keeps its part
    as a view of ``t`` (no copy where the part is contiguous, so a one-rank
    mesh shares ``t``'s storage), or a copy of it with ``own_storage`` (so
    memory counts see the part alone).  Each mesh dim that shards a tensor
    dim narrows it to the rank's coordinate, in mesh order: a dim split over
    several axes is split major first, as ``PartitionSpec`` tuples split it."""
    if hasattr(t, "placements"):
        return t
    local, coord = t, mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not divide over {n} ranks")
            step = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[i] * step, step)
    local = local.clone() if own_storage else local.contiguous()
    return DTensor.from_local(local, mesh, list(placements), run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def region(body, mesh, out_placements, in_placements, in_grad_placements=None):
    """``local_map`` of ``body``; an input without a gradient placement (None
    in ``in_grad_placements``) takes its input placement."""
    if in_grad_placements is not None:
        in_grad_placements = tuple(i if g is None else g for i, g in zip(in_placements, in_grad_placements))
    return local_map(body, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh, redistribute_inputs=True)


# ---------------------------------------------------------------------------
# embedding and the tied head
# ---------------------------------------------------------------------------


def embed_lookup(embed, tokens):
    """``embed[tokens]``, vocab-parallel when the table is split over vocab."""
    mesh = embed.device_mesh
    tokens = as_dtensor(tokens, mesh, replicated(mesh))
    bs = batch_sharded(tokens)
    vocab = sharded_dim(embed) == 0
    e_pl = with_model(replicated(mesh), mesh, Shard(0) if vocab else Replicate())
    r = axis_rank(mesh, MODEL)

    def body(e, tok):
        if not vocab:
            return e[tok.long()]
        n = e.shape[0]
        idx = tok.long() - r * n
        own = (idx >= 0) & (idx < n)
        return Reduce.apply(e[idx.clamp(0, n - 1)] * own[..., None].to(e.dtype), mesh, (MODEL,))

    return region(body, mesh, act_placements(mesh, bs), (e_pl, act_placements(mesh, bs)),
                  (weight_grad_placements(e_pl, mesh, bs), None))(embed, tokens)


def lm_logits(x, embed):
    """``x @ embed.T``: ``[..., V]`` split over vocab when the table is."""
    mesh = x.device_mesh
    bs = batch_sharded(x)
    vocab = sharded_dim(embed) == 0
    e_pl = with_model(replicated(mesh), mesh, Shard(0) if vocab else Replicate())
    out_pl = with_model(act_placements(mesh, bs), mesh, Shard(x.ndim - 1) if vocab else Replicate())

    def body(xl, e):
        if vocab:
            xl = Copy.apply(xl, mesh, (MODEL,))
        return xl @ e.T

    return region(body, mesh, out_pl, (act_placements(mesh, bs), e_pl),
                  (None, weight_grad_placements(e_pl, mesh, bs)))(x, embed)


def xent_terms(logits, labels):
    """``logsumexp(logits) - logits[label]`` per position, vocab-parallel:
    the max and the exponentials' sum all-reduced over ``model``, the gold
    logit taken by the rank that holds it."""
    mesh = logits.device_mesh
    labels = as_dtensor(labels, mesh, replicated(mesh))
    bs = batch_sharded(logits)
    vocab = sharded_dim(logits) == logits.ndim - 1
    r = axis_rank(mesh, MODEL)

    def body(lg, lab):
        if not vocab:
            gold = torch.gather(lg, -1, lab.long()[..., None])[..., 0]
            return torch.logsumexp(lg, dim=-1) - gold
        n = lg.shape[-1]
        mx = all_reduce(lg.detach().amax(dim=-1), "max", mesh, (MODEL,))
        se = Reduce.apply((lg - mx[..., None]).exp().sum(dim=-1), mesh, (MODEL,))
        idx = lab.long() - r * n
        own = (idx >= 0) & (idx < n)
        gold = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0] * own.to(lg.dtype)
        return torch.log(se) + mx - Reduce.apply(gold, mesh, (MODEL,))

    in_pl = with_model(act_placements(mesh, bs), mesh, Shard(logits.ndim - 1) if vocab else Replicate())
    return region(body, mesh, act_placements(mesh, bs), (in_pl, act_placements(mesh, bs)))(logits, labels)


def argmax(logits):
    """The greedy token ``[b]`` int32 of ``logits [b, V]`` (the first of
    equal maxima, as ``torch.argmax``): each rank's best over its vocab
    slice, all-gathered over ``model``."""
    mesh = logits.device_mesh
    bs = batch_sharded(logits)
    vocab = sharded_dim(logits) == 1
    r = axis_rank(mesh, MODEL)

    def body(lg):
        i = lg.argmax(dim=-1)
        if vocab:
            v = torch.gather(lg, -1, i[:, None])[:, 0]
            all_v = all_gather(v[None], 0, mesh, MODEL)
            all_i = all_gather((i + r * lg.shape[-1])[None], 0, mesh, MODEL)
            i = torch.gather(all_i, 0, all_v.argmax(dim=0)[None])[0]
        return i.to(torch.int32)

    in_pl = with_model(act_placements(mesh, bs), mesh, Shard(1) if vocab else Replicate())
    return region(body, mesh, act_placements(mesh, bs), (in_pl,))(logits)


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------


def ffn(params, x, activation: str):
    """Column-parallel up/gate, row-parallel down (all-reduced) when the
    weights are split that way; else every rank runs the whole FFN."""
    mesh = x.device_mesh
    bs = batch_sharded(x)
    names = [k for k in ("w_up", "w_down", "w_gate") if k in params]
    ws = [as_dtensor(params[k], mesh, replicated(mesh)) for k in names]
    tp = all(sharded_dim(w) == (0 if k == "w_down" else 1) for k, w in zip(names, ws))
    w_pls = [with_model(replicated(mesh), mesh, w.placements[_dim(mesh, MODEL)] if tp else Replicate())
             for w in ws]

    def body(xl, *wl):
        p = dict(zip(names, wl))
        if not tp:
            return ffn_mod.ffn(p, xl, activation)
        y = ffn_mod.ffn(p, Copy.apply(xl, mesh, (MODEL,)), activation)
        return Reduce.apply(y, mesh, (MODEL,))

    grads = (None,) + tuple(weight_grad_placements(p, mesh, bs) for p in w_pls)
    return region(body, mesh, act_placements(mesh, bs), (act_placements(mesh, bs), *w_pls), grads)(x, *ws)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_ATTN = ("wq", "wk", "wv", "wo")


def _attn_plan(params, mesh):
    """``(weights as DTensors, head-parallel?, KV heads split?)``."""
    ws = {k: as_dtensor(params[k], mesh, replicated(mesh)) for k in _ATTN}
    kv_split = sharded_dim(ws["wk"]) == 1 and sharded_dim(ws["wv"]) == 1
    heads = sharded_dim(ws["wq"]) == 1 and sharded_dim(ws["wo"]) == 0
    return ws, heads, kv_split


def _attn_in(ws, mesh, heads: bool, kv_split: bool, bs: bool):
    """The weights' region placements and gradient placements."""
    pls, grads = [], []
    for k in _ATTN:
        own = heads and (k in ("wq", "wo") or kv_split)
        pl = with_model(replicated(mesh), mesh, ws[k].placements[_dim(mesh, MODEL)] if own else Replicate())
        pls.append(pl)
        # head-parallel ranks each read their KV heads' slice of a gathered wk / wv
        grads.append(weight_grad_placements(pl, mesh, bs, model_partial=heads and not own))
    return pls, grads


def _local_kv(k: torch.Tensor, v: torch.Tensor, nh: int, n: int, r: int):
    """The KV heads rank ``r``'s query heads attend (query heads split ``n``
    ways, grouped KV-major): a slice of whole groups where the rank's heads
    line up with them, else one KV head per query head."""
    nkv = k.shape[2]
    G, nh_loc = nh // nkv, nh // n
    if nh_loc % G == 0 or G % nh_loc == 0:
        lo, hi = (r * nh_loc) // G, ((r + 1) * nh_loc - 1) // G + 1
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.div(torch.arange(r * nh_loc, (r + 1) * nh_loc, device=k.device), G, rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def attention_full(params, x, cfg, positions, window, causal, return_kv):
    mesh = x.device_mesh
    bs = batch_sharded(x)
    ws, heads, kv_split = _attn_plan(params, mesh)
    w_pls, w_grads = _attn_in(ws, mesh, heads, kv_split, bs)
    n, r = axis_size(mesh, MODEL), axis_rank(mesh, MODEL)
    nh = ws["wq"].shape[1]

    def body(xl, wq, wk, wv, wo):
        p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
        if not heads:
            y, (k, v) = attn_mod.attention_full(p, xl, cfg, positions, window, causal, return_kv=True)
            return y, k, v
        q, k, v = attn_mod.full_qkv(p, Copy.apply(xl, mesh, (MODEL,)), cfg, positions)
        ka, va = (k, v) if kv_split else _local_kv(k, v, nh, n, r)
        out = attn_mod.full_attend(q, ka, va, cfg, window, causal)
        return Reduce.apply(attn_mod._out_proj(out, wo), mesh, (MODEL,)), k, v

    act = act_placements(mesh, bs)
    kv_pl = with_model(act, mesh, Shard(2) if heads and kv_split else Replicate())
    y, k, v = region(body, mesh, (act, kv_pl, kv_pl), (act, *w_pls), (None, *w_grads))(x, *(ws[k] for k in _ATTN))
    return (y, (k, v)) if return_kv else y


def attention_cross(params, x, kv_src, cfg):
    """Cross attention over ``kv_src`` (the encoder's output), head-parallel
    as :func:`attention_full` is."""
    mesh = x.device_mesh
    bs = batch_sharded(x)
    ws, heads, kv_split = _attn_plan(params, mesh)
    w_pls, w_grads = _attn_in(ws, mesh, heads, kv_split, bs)
    n, r = axis_size(mesh, MODEL), axis_rank(mesh, MODEL)
    nh = ws["wq"].shape[1]

    def body(xl, src, wq, wk, wv, wo):
        p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
        if not heads:
            return attn_mod.attention_cross(p, xl, src, cfg)
        q = attn_mod._project(Copy.apply(xl, mesh, (MODEL,)), wq)
        src = Copy.apply(src, mesh, (MODEL,))
        k, v = attn_mod._project(src, wk), attn_mod._project(src, wv)
        if not kv_split:
            k, v = _local_kv(k, v, nh, n, r)
        b, sq, nh_loc, hd = q.shape
        mask = torch.ones((1, 1, 1, sq, src.shape[1]), dtype=torch.bool, device=q.device)
        out = attn_mod._attend(q.reshape(b, sq, k.shape[2], nh_loc // k.shape[2], hd), k, v, mask,
                               cfg.attn_logit_softcap)
        return Reduce.apply(attn_mod._out_proj(out, wo), mesh, (MODEL,))

    act = act_placements(mesh, bs)
    return region(body, mesh, act, (act, act, *w_pls), (None, None, *w_grads))(x, kv_src, *(ws[k] for k in _ATTN))


def attention_decode(params, x, cache_k, cache_v, cache_index, cfg, window, k_scale, v_scale):
    """One-token decode over one layer's cache shard (written in place).
    Head-parallel when the cache is split by KV head; otherwise every rank
    attends all heads over its rows and, where the cache's sequence axis is
    split, the ranks' partial softmaxes merge.  Without such a split the
    single-device :func:`attention.attention_decode` runs on the local
    shard (on the card: K4, or K5 for an int8 cache)."""
    mesh = x.device_mesh
    bs = batch_sharded(x)
    names = list(mesh.mesh_dim_names)
    ws, heads, kv_split = _attn_plan(params, mesh)
    heads = heads and kv_split and cache_k.placements[_dim(mesh, MODEL)] == Shard(2)
    w_pls, _ = _attn_in(ws, mesh, heads, kv_split, bs)
    seq_axes = [a for a in names if cache_k.placements[_dim(mesh, a)] == Shard(1)]
    act = act_placements(mesh, bs)
    pos = as_dtensor(torch.as_tensor(cache_index).reshape(-1), mesh, replicated(mesh))
    quant = k_scale is not None
    caches = [cache_k, cache_v] + ([k_scale, v_scale] if quant else [])
    c_pls = [list(c.placements) for c in caches]
    # this rank's first row of the cache: its linear index over the sequence
    # axes (major first) times the rows a shard holds
    lin = 0
    for a in seq_axes:
        lin = lin * axis_size(mesh, a) + axis_rank(mesh, a)

    def body(xl, wq, wk, wv, wo, pl, kc, vc, *scales):
        p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
        ks, vs = scales if quant else (None, None)
        if seq_axes:
            return _decode_split_seq(p, xl, kc, vc, ks, vs, pl, cfg, window, mesh, seq_axes, lin)
        lcfg = dataclasses.replace(cfg, num_heads=wq.shape[1], num_kv_heads=kc.shape[2])
        y = attn_mod.attention_decode(p, xl, kc, vc, pl, lcfg, window=window, k_scale=ks, v_scale=vs)[0]
        return all_reduce(y, "sum", mesh, (MODEL,)) if heads else y

    y = region(body, mesh, act, (act, *w_pls, act_placements(mesh, bs), *c_pls))(
        x, *(ws[k] for k in _ATTN), pos, *caches)
    return (y, cache_k, cache_v, k_scale, v_scale) if quant else (y, cache_k, cache_v)


def _decode_split_seq(p, x, kc, vc, ks, vs, pos, cfg, window, mesh, seq_axes, lin):
    """One-token decode over a cache whose rows are split over ``seq_axes``:
    the new row lands on the rank that holds it, each rank attends its rows
    (f32 partials ``m``, ``l``, ``acc``), and all-reduces merge them."""
    b = x.shape[0]
    S_loc = kc.shape[1]
    n_seq = 1
    for a in seq_axes:
        n_seq *= axis_size(mesh, a)
    nkv, hd = kc.shape[2], kc.shape[3]
    pos = pos.long()
    q = attn_mod._project(x, p["wq"])
    k = attn_mod._project(x, p["wk"])
    v = attn_mod._project(x, p["wv"])
    if cfg.use_rope:
        q = attn_mod.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = attn_mod.apply_rope(k, pos[:, None], cfg.rope_theta)
    new = [k[:, 0], v[:, 0]]
    if ks is not None:
        (k8, k_s), (v8, v_s) = attn_mod.quantize_kv(k[:, 0]), attn_mod.quantize_kv(v[:, 0])
        new = [k8, v8, k_s, v_s]
    row = pos % (S_loc * n_seq) if window is not None else pos
    local = row - lin * S_loc
    own = (local >= 0) & (local < S_loc)
    at = (torch.arange(b, device=x.device), local.clamp(0, S_loc - 1))
    for c, val in zip((kc, vc, ks, vs), new):
        keep = own.reshape(b, *([1] * (val.dim() - 1)))
        c[at] = torch.where(keep, val.to(c.dtype), c[at])
    k_r, v_r = kc, vc
    if ks is not None:
        k_r = attn_mod.dequantize_kv(kc, ks, x.dtype)
        v_r = attn_mod.dequantize_kv(vc, vs, x.dtype)
    nh = q.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd).float()
    s = torch.einsum("bngh,bsnh->bngs", qg, k_r.float()) * (hd**-0.5)
    if cfg.attn_logit_softcap is not None:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    rows = lin * S_loc + torch.arange(S_loc, device=x.device)
    live = (rows[None, :] <= pos[:, None])[:, None, None, :]
    s = torch.where(live, s, attn_mod.NEG_INF)
    m = all_reduce(s.amax(dim=-1), "max", mesh, seq_axes)
    e = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l_sum = all_reduce(e.sum(dim=-1), "sum", mesh, seq_axes)
    acc = all_reduce(torch.einsum("bngs,bsnh->bngh", e, v_r.float()), "sum", mesh, seq_axes)
    out = (acc / l_sum[..., None]).reshape(b, 1, nh, hd).to(x.dtype)
    return attn_mod._out_proj(out, p["wo"])


def assemble_cache(full, rows: int, place):
    """Prefill's cache stack ``[n, b, rows, nkv, hd]`` from a layer stack of
    keys ``full`` (``place(buf, full)`` writes them), shard by shard."""
    mesh = full.device_mesh
    pl = list(full.placements)

    def body(fl):
        buf = torch.zeros((fl.shape[0], fl.shape[1], rows, *fl.shape[3:]), dtype=fl.dtype, device=fl.device)
        place(buf, fl)
        return buf

    return region(body, mesh, pl, (pl,))(full)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def _mamba_weights(p, mesh, bs):
    names = sorted(p)
    ws = [as_dtensor(p[k], mesh, replicated(mesh)) for k in names]
    pls = [replicated(mesh)] * len(ws)
    return names, ws, pls, [weight_grad_placements(pl, mesh, bs) for pl in pls]


def mamba_seq(p, u, cfg):
    """Every rank runs the whole block over its batch rows."""
    mesh = u.device_mesh
    bs = batch_sharded(u)
    names, ws, pls, grads = _mamba_weights(p, mesh, bs)
    act = act_placements(mesh, bs)

    def body(ul, *wl):
        return ssm_mod.mamba_seq(dict(zip(names, wl)), ul, cfg)

    return region(body, mesh, (act, act, act), (act, *pls), (None, *grads))(u, *ws)


def mamba_step(p, u, conv_state, ssm_state, cfg):
    """One token: the states' shards gathered over ``model``, the block run
    whole, each rank's shard of the new states written back in place."""
    mesh = u.device_mesh
    bs = batch_sharded(u)
    names, ws, pls, _ = _mamba_weights(p, mesh, bs)
    act = act_placements(mesh, bs)
    states = (conv_state, ssm_state)
    dims = [sharded_dim(s) for s in states]

    def body(ul, cs, ss, *wl):
        full = [s if d is None else all_gather(s, d, mesh, MODEL) for s, d in zip((cs, ss), dims)]
        y, c_new, s_new = ssm_mod.mamba_step(dict(zip(names, wl)), ul, full[0], full[1], cfg)
        for s, new, d in zip((cs, ss), (c_new, s_new), dims):
            if d is not None:
                new = new.chunk(axis_size(mesh, MODEL), dim=d)[axis_rank(mesh, MODEL)]
            s.copy_(new)
        return y

    y = region(body, mesh, act, (act, *(list(s.placements) for s in states), *pls))(u, *states, *ws)
    return y, conv_state, ssm_state
