"""Mixture-of-Experts layer: routing, the scheduler hook, dispatch and
shared experts (``repro.models.moe``).

Three dispatch paths with one semantics (``DISPATCH_FNS``):

* ``grouped`` (the serving path): tokens are packed into capacity blocks by
  a stable argsort over bucket ids plus segment offsets.  With a replica
  layout, a single-active-replica scheduler (AEBS, random) rewrites expert
  ids to replica slots and the slots then collapse back to logical experts,
  so one grouped FFN runs over the ``[E, d, f]`` weights; a per-item
  scheduler (token hash) keeps slot buckets, read slot-indirectly.  On the
  card that FFN is the K3 kernel over the *activated* buckets only
  (``active = counts > 0``); on the CPU the layer keeps the reference's
  backend choice so parity tests follow its rounding;
* ``einsum`` (:func:`capacity_dispatch_ffn`) and ``scatter``
  (:func:`scatter_dispatch_ffn`): the reference's one-hot oracles, plain
  PyTorch on every device (the reference runs them outside any Pallas
  kernel); with a layout they copy each slot's weights
  (:func:`gather_slot_weights`), the cost the grouped path avoids;
* ``ep``: expert parallelism over a mesh (:mod:`repro_torch.models.moe_ep`),
  whose per-rank bodies are ``scatter`` and ``grouped``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.expert_ffn.ops import expert_ffn_einsum, expert_ffn_grouped
from repro_torch.models.common import Params, dense_init
from repro_torch.models.ffn import ffn, init_ffn


def init_moe(cfg, gen, dtype, device) -> Params:
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    params: Params = {
        "router": dense_init(gen, (d, E), fan_in=d, dtype=torch.float32, device=device),
        "w_gate": dense_init(gen, (E, d, f), fan_in=d, dtype=dtype, device=device),
        "w_up": dense_init(gen, (E, d, f), fan_in=d, dtype=dtype, device=device),
        "w_down": dense_init(gen, (E, f, d), fan_in=f, dtype=dtype, device=device),
    }
    if cfg.num_shared_experts:
        params["shared"] = init_ffn(d, cfg.num_shared_experts * f, "swiglu", gen, dtype, device)
    return params


def route(router_w: torch.Tensor, x2d: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 softmax, top-k, renormalise.  Returns (gates [T,k] f32, eids [T,k]
    int32, probs [T,E] f32)."""
    logits = x2d.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, eids.to(torch.int32), probs


def load_balance_loss(probs: torch.Tensor, eids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-transformer auxiliary loss ``E * sum_e f_e * P_e``
    (``moe.py:84``): ``f_e`` the share of tokens routed to expert ``e`` (top-k
    picks summed over k), ``P_e`` its mean router probability; the gradient
    flows through ``probs`` alone."""
    onehot = _one_hot(eids.reshape(-1), num_experts, torch.float32).reshape(*eids.shape, num_experts)
    frac_tokens = onehot.sum(dim=1).mean(dim=0)  # [E]
    return num_experts * (frac_tokens * probs.mean(dim=0)).sum()


def sort_dispatch_plan(
    flat_ids: torch.Tensor,  # [I] bucket id per item (may be -1 / invalid)
    num_buckets: int,
    capacity: int,
    item_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Stable-argsort token permutation (``moe.py:173``): ``pos`` (arrival
    position within the bucket), ``keep``, ``counts`` [B], ``src`` [B, cap]
    (item feeding each capacity row) and ``row_valid`` [B, cap]."""
    dev = flat_ids.device
    I = flat_ids.shape[0]
    flat = flat_ids.long()
    valid = (flat >= 0) & (flat < num_buckets)
    if item_mask is not None:
        valid = valid & item_mask
    ids = torch.where(valid, flat, num_buckets)  # invalid -> sentinel bucket
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    offsets = torch.searchsorted(sorted_ids, torch.arange(num_buckets + 1, device=dev))
    counts = offsets[1:] - offsets[:-1]
    pos_sorted = torch.arange(I, device=dev) - offsets[sorted_ids.clamp(0, num_buckets)]
    pos = torch.empty(I, dtype=torch.long, device=dev)
    pos[order] = pos_sorted
    keep = valid & (pos < capacity)
    cap_idx = torch.arange(capacity, device=dev)
    rows = offsets[:-1, None] + cap_idx[None, :]
    row_valid = cap_idx[None, :] < counts[:, None]
    src = order[rows.clamp(0, max(I - 1, 0))]
    return {
        "pos": pos.to(torch.int32),
        "keep": keep,
        "counts": counts.to(torch.int32),
        "src": src.to(torch.int32),
        "row_valid": row_valid,
    }


def gather_slot_weights(params: Params, slot_to_expert: torch.Tensor) -> Params:
    """Per-slot expert weights copied from the logical ones
    (``moe.py:105``); an empty slot (-1) takes expert 0's and receives no
    token."""
    idx = slot_to_expert.long().clamp(min=0)
    return {k: params[k][idx] for k in ("w_gate", "w_up", "w_down")}


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx.long()[:, None] == torch.arange(n, device=idx.device)[None, :]).to(dtype)


def _positions_in_bucket(flat_ids: torch.Tensor, num_buckets: int,
                         item_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Arrival order of each item within its bucket, ``[I]``, by one-hot
    cumsum (``moe.py:161``); -1 for an item in no bucket."""
    oh = _one_hot(flat_ids, num_buckets, torch.long)
    if item_mask is not None:
        oh = oh * item_mask[:, None].long()
    return (torch.cumsum(oh, dim=0) * oh).sum(dim=-1) - 1


def _keep(pos, capacity, item_mask):
    keep = (pos >= 0) & (pos < capacity)
    return keep & item_mask if item_mask is not None else keep


def capacity_dispatch_ffn(
    x2d: torch.Tensor,  # [T, d]
    bucket_ids: torch.Tensor,  # [T, k]
    gates: torch.Tensor,  # [T, k] in x's dtype
    num_buckets: int,
    capacity: int,
    weights: Params,  # stacked [num_buckets, ...]
    item_mask: Optional[torch.Tensor] = None,  # [T*k] bool
) -> torch.Tensor:
    """Einsum / one-hot dispatch, the oracle path (``moe.py:211``)."""
    T, k = bucket_ids.shape
    dt = x2d.dtype
    flat = bucket_ids.reshape(-1)
    x_rep = torch.repeat_interleave(x2d, k, dim=0)  # item i = (t, j), i = t*k + j
    pos = _positions_in_bucket(flat, num_buckets, item_mask)
    keep = _keep(pos, capacity, item_mask)
    pos_c = torch.where(keep, pos, capacity)  # a zero one-hot row: dropped
    disp = torch.einsum("ie,ic->iec", _one_hot(flat, num_buckets, dt), _one_hot(pos_c, capacity, dt))
    xin = torch.einsum("iec,id->ecd", disp, x_rep)
    out = expert_ffn_einsum(weights, xin)
    y_items = torch.einsum("iec,ecd->id", disp, out)
    gflat = (gates.reshape(-1) * keep).to(dt)
    return (y_items * gflat[:, None]).reshape(T, k, -1).sum(dim=1)


def scatter_dispatch_ffn(
    x2d: torch.Tensor,
    bucket_ids: torch.Tensor,
    gates: torch.Tensor,
    num_buckets: int,
    capacity: int,
    weights: Params,
    item_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scatter / gather dispatch (``moe.py:242``), the same semantics."""
    T, k = bucket_ids.shape
    d = x2d.shape[-1]
    dt = x2d.dtype
    flat = bucket_ids.reshape(-1).long()
    x_rep = torch.repeat_interleave(x2d, k, dim=0)
    pos = _positions_in_bucket(flat, num_buckets, item_mask)
    keep = _keep(pos, capacity, item_mask)
    pos_c = torch.where(keep, pos, capacity)  # row `capacity`: the dump row
    bkt_c = torch.where(keep, flat, 0)
    buf = torch.zeros((num_buckets, capacity + 1, d), dtype=dt, device=x2d.device)
    buf.index_put_((bkt_c, pos_c), torch.where(keep[:, None], x_rep, 0).to(dt), accumulate=True)
    out = expert_ffn_einsum(weights, buf[:, :capacity])
    y_items = out[bkt_c, pos_c.clamp(max=capacity - 1)]
    gflat = (gates.reshape(-1) * keep).to(dt)
    return (y_items * gflat[:, None]).reshape(T, k, -1).sum(dim=1)


def grouped_dispatch_items(
    x2d: torch.Tensor,  # [T, d]
    bucket_ids: torch.Tensor,  # [T, k]
    num_buckets: int,
    capacity: int,
    weights: Params,  # stacked [B, ...] (map None) or logical [E, ...] (map given)
    slot_to_expert: Optional[torch.Tensor] = None,  # [B] int32, -1 empty
    item_mask: Optional[torch.Tensor] = None,  # [T*k] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped dispatch up to the per-item expert outputs (``moe.py:271``);
    items outside ``item_mask`` (another expert-parallel rank's) take no
    capacity row.  Returns ``(y_items [T*k, d], keep [T*k])``; rows with
    ``keep == False`` are arbitrary and must be gated to zero."""
    k = bucket_ids.shape[1]
    dt = x2d.dtype
    flat = bucket_ids.reshape(-1)
    plan = sort_dispatch_plan(flat, num_buckets, capacity, item_mask)
    xin = torch.where(plan["row_valid"][..., None], x2d[plan["src"].long() // k], 0).to(dt)
    active = plan["counts"] > 0
    if slot_to_expert is not None:
        active = active & (slot_to_expert >= 0)
    if slot_to_expert is None and x2d.device.type == "cpu":
        # buckets are experts: one batched einsum, as the reference's CPU path
        out = torch.where(active[:, None, None], expert_ffn_einsum(weights, xin), 0).to(dt)
    else:
        s2e = slot_to_expert
        if s2e is None:
            s2e = torch.arange(num_buckets, dtype=torch.int32, device=x2d.device)
        out = expert_ffn_grouped(
            xin, weights["w_gate"], weights["w_up"], weights["w_down"], s2e, active
        )
    keep = plan["keep"]
    pos = plan["pos"].long()
    y_items = out[torch.where(keep, flat.long(), 0), pos.clamp(max=capacity - 1)]
    return y_items, keep


def grouped_dispatch_ffn(
    x2d: torch.Tensor,
    bucket_ids: torch.Tensor,
    gates: torch.Tensor,  # [T, k] in x's dtype
    num_buckets: int,
    capacity: int,
    weights: Params,
    slot_to_expert: Optional[torch.Tensor] = None,
    item_mask: Optional[torch.Tensor] = None,  # [T*k] bool
) -> torch.Tensor:
    """Sort-based grouped dispatch then the gate-weighted top-k combine."""
    T, k = bucket_ids.shape
    dt = x2d.dtype
    y_items, keep = grouped_dispatch_items(
        x2d, bucket_ids, num_buckets, capacity, weights, slot_to_expert=slot_to_expert, item_mask=item_mask
    )
    gflat = (gates.reshape(-1) * keep).to(dt)
    return (y_items * gflat[:, None]).reshape(T, k, -1).sum(dim=1)


def default_capacity(num_tokens: int, top_k: int, num_buckets: int, factor: float) -> int:
    cap = math.ceil(num_tokens * top_k * factor / max(1, num_buckets))
    return max(4, int(cap))


def scheduler_is_single_replica(scheduler) -> bool:
    return bool(getattr(scheduler, "single_active_replica", False))


DISPATCH_FNS = {
    "einsum": capacity_dispatch_ffn,
    "scatter": scatter_dispatch_ffn,
    "grouped": grouped_dispatch_ffn,
}


def check_dispatch(dispatch: str) -> None:
    """Raise for an unknown dispatch path (``"ep"`` is expert parallelism,
    :func:`repro_torch.models.moe_ep.moe_layer_ep`)."""
    if dispatch != "ep" and dispatch not in DISPATCH_FNS:
        raise ValueError(f"unknown dispatch {dispatch!r}; choose from {sorted(DISPATCH_FNS) + ['ep']}")


def moe_layer(
    params: Params,
    x: torch.Tensor,  # [b, s, d]
    cfg,
    *,
    dispatch: str = "grouped",  # grouped | einsum | scatter | ep
    layout_tables: Optional[Dict[str, torch.Tensor]] = None,
    slot_to_expert: Optional[torch.Tensor] = None,  # flat [S_total] int32
    num_instances: int = 0,
    scheduler=None,
    capacity: Optional[int] = None,
    with_aux: bool = False,
    ep_ctx: Optional[Dict] = None,  # mesh / dp_axes / model_axis / mode for dispatch="ep"
):
    """Route + (optional scheduling) + dispatch + shared experts
    (``moe.py:403``).  The port's default dispatch is ``grouped``, the
    reference's serving path (the reference defaults ad-hoc calls to its
    einsum oracle; training asks for it, ``model.loss_fn``).  ``"ep"`` runs
    :func:`repro_torch.models.moe_ep.moe_layer_ep` with ``ep_ctx`` (its
    mesh, axes, mode and body), as the reference does (``moe.py:427``);
    without a mesh that call raises ``TypeError``, as the reference's does.
    ``with_aux`` adds the :func:`load_balance_loss` ``lb_loss`` and the
    scheduler's ``load`` and ``a_max``."""
    check_dispatch(dispatch)
    if dispatch == "ep":
        from repro_torch.models import moe_ep

        return moe_ep.moe_layer_ep(
            params, x, cfg, scheduler=scheduler, layout_tables=layout_tables, slot_to_expert=slot_to_expert,
            num_instances=num_instances, with_aux=with_aux, **(ep_ctx or {}),
        )
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, eids, probs = route(params["router"], x2d, cfg.top_k)
    weights = {k: params[k] for k in ("w_gate", "w_up", "w_down")}

    aux: Dict[str, torch.Tensor] = {}
    bucket_map = None
    if layout_tables is not None and scheduler is not None:
        slot_ids, load, _ = scheduler(eids, layout_tables, num_instances)
        num_buckets = int(slot_to_expert.shape[0])
        # capacity is a per-slot budget, computed before the collapse
        cap = capacity or default_capacity(b * s, cfg.top_k, num_buckets, cfg.capacity_factor)
        if with_aux:
            aux["load"] = load
            aux["a_max"] = load.max()
        if dispatch == "grouped" and scheduler_is_single_replica(scheduler):
            # <= 1 activated replica per expert: slots collapse to experts
            bucket_ids = torch.where(
                slot_ids >= 0, slot_to_expert[slot_ids.long().clamp(min=0)], -1
            )
            num_buckets = cfg.num_experts
        elif dispatch == "grouped":
            bucket_ids = slot_ids
            bucket_map = slot_to_expert  # weights read slot-indirectly
        else:
            bucket_ids = slot_ids
            weights = gather_slot_weights(params, slot_to_expert)
    else:
        bucket_ids = eids
        num_buckets = cfg.num_experts
        cap = capacity or default_capacity(b * s, cfg.top_k, num_buckets, cfg.capacity_factor)
    slot_kw = {} if bucket_map is None else {"slot_to_expert": bucket_map}
    y2d = DISPATCH_FNS[dispatch](x2d, bucket_ids, gates.to(x.dtype), num_buckets, cap, weights, **slot_kw)
    if "shared" in params:
        y2d = y2d + ffn(params["shared"], x2d, "swiglu")
    y = y2d.reshape(b, s, d)
    if with_aux:
        aux["lb_loss"] = load_balance_loss(probs, eids, cfg.num_experts)
        return y, aux
    return y
