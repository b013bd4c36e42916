"""Mixture-of-Experts layer: routing, AEBS hook, sort-based grouped dispatch
and shared experts (``repro.models.moe``, grouped dispatch only).

Tokens are packed into capacity blocks by a stable argsort over bucket ids
plus segment offsets.  With a replica layout, a single-active-replica
scheduler (AEBS) rewrites expert ids to replica slots and the slots then
collapse back to logical experts, so one grouped FFN runs over the ``[E, d,
f]`` weights.  On the card that FFN is the K3 kernel over the *activated*
experts only (``active = counts > 0``); on the CPU the layer keeps the
reference's backend choice so parity tests follow its rounding.
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


def grouped_dispatch_items(
    x2d: torch.Tensor,  # [T, d]
    bucket_ids: torch.Tensor,  # [T, k]
    num_buckets: int,
    capacity: int,
    weights: Params,  # stacked [B, ...] (map None) or logical [E, ...] (map given)
    slot_to_expert: Optional[torch.Tensor] = None,  # [B] int32, -1 empty
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped dispatch up to the per-item expert outputs (``moe.py:271``).
    Returns ``(y_items [T*k, d], keep [T*k])``; rows with ``keep == False``
    are arbitrary and must be gated to zero."""
    k = bucket_ids.shape[1]
    dt = x2d.dtype
    flat = bucket_ids.reshape(-1)
    plan = sort_dispatch_plan(flat, num_buckets, capacity)
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
) -> torch.Tensor:
    """Sort-based grouped dispatch then the gate-weighted top-k combine."""
    T, k = bucket_ids.shape
    dt = x2d.dtype
    y_items, keep = grouped_dispatch_items(
        x2d, bucket_ids, num_buckets, capacity, weights, slot_to_expert=slot_to_expert
    )
    gflat = (gates.reshape(-1) * keep).to(dt)
    return (y_items * gflat[:, None]).reshape(T, k, -1).sum(dim=1)


def default_capacity(num_tokens: int, top_k: int, num_buckets: int, factor: float) -> int:
    cap = math.ceil(num_tokens * top_k * factor / max(1, num_buckets))
    return max(4, int(cap))


def scheduler_is_single_replica(scheduler) -> bool:
    return bool(getattr(scheduler, "single_active_replica", False))


def moe_layer(
    params: Params,
    x: torch.Tensor,  # [b, s, d]
    cfg,
    *,
    layout_tables: Optional[Dict[str, torch.Tensor]] = None,
    slot_to_expert: Optional[torch.Tensor] = None,  # flat [S_total] int32
    num_instances: int = 0,
    scheduler=None,
    capacity: Optional[int] = None,
    with_aux: bool = False,
):
    """Route + (optional scheduling) + grouped dispatch + shared experts
    (``moe.py:403`` with ``dispatch="grouped"``; the reference's einsum and
    scatter oracles and expert parallelism are not ported).  ``with_aux``
    adds the scheduler's ``load`` and ``a_max``."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, eids, _ = route(params["router"], x2d, cfg.top_k)
    logical_weights = {k: params[k] for k in ("w_gate", "w_up", "w_down")}

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
        if scheduler_is_single_replica(scheduler):
            # <= 1 activated replica per expert: slots collapse to experts
            bucket_ids = torch.where(
                slot_ids >= 0, slot_to_expert[slot_ids.long().clamp(min=0)], -1
            )
            num_buckets = cfg.num_experts
        else:
            bucket_ids = slot_ids
            bucket_map = slot_to_expert  # weights read slot-indirectly
    else:
        bucket_ids = eids
        num_buckets = cfg.num_experts
        cap = capacity or default_capacity(b * s, cfg.top_k, num_buckets, cfg.capacity_factor)
    y2d = grouped_dispatch_ffn(
        x2d, bucket_ids, gates.to(x.dtype), num_buckets, cap, logical_weights,
        slot_to_expert=bucket_map,
    )
    if "shared" in params:
        y2d = y2d + ffn(params["shared"], x2d, "swiglu")
    y = y2d.reshape(b, s, d)
    return (y, aux) if with_aux else y
