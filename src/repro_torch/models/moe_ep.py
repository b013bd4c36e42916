"""Expert-parallel MoE layer (``repro.models.moe_ep``): the production
dispatch path, as one ``local_map`` region over the mesh, the image of the
reference's ``shard_map``.

Janus's disaggregated data plane on the SPMD mesh:

* activations enter **replicated over the model axis**, the SPMD image of
  EGate ("send complete activations to the MoE side and gate there");
* each model-axis rank is one **MoE instance**: it runs gating and the
  deterministic scheduler on the same inputs as every other rank, then
  computes only the buckets (experts or replica slots) it hosts, the items
  of other ranks masked out of its dispatch;
* the combine is an all-reduce over the model axis.

Modes: ``logical`` (buckets are logical experts, padded to a multiple of
the model axis and block-partitioned over it: training and the monolithic
baseline) and ``scheduled`` (buckets are replica slots, each token's
experts rewritten to slots by the scheduler: the Janus serving path).
Bodies: ``scatter`` (the capacity scatter/gather) and ``grouped`` (the
sort-based dispatch; pinned slot weights are read through the identity map,
unpinned ones slot-indirectly through the rank's slice of
``slot_to_expert``, never copied per step; on the card the grouped body is
K3 over the rank's buckets).

Gradients cross the region's collectives through ``spmd.Copy`` (the
replicated ``x`` and router, all-reduced backward) and ``spmd.Reduce`` (the
combine, identity backward), so the layer's gradient is the single-device
layer's.  ``with_aux`` gives ``lb_loss`` (computed on model rank 0 alone and
summed, so it counts once, then averaged over the data axes) and the
scheduler's ``load`` (max over the data axes: the slowest instance).  The
shared expert runs outside the region, as a dense FFN over the same ``x``.

``params``, ``x`` and the tables may be plain tensors (each rank holding the
same global values) or DTensors; the output is a DTensor in the activation
layout.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models import spmd
from repro_torch.models.ffn import ffn
from repro_torch.models.moe import (
    grouped_dispatch_ffn,
    load_balance_loss,
    route,
    scatter_dispatch_ffn,
)


def _pad_experts(w: torch.Tensor, e_pad: int) -> torch.Tensor:
    if w.shape[0] == e_pad:
        return w
    return F.pad(w, (0, 0) * (w.dim() - 1) + (0, e_pad - w.shape[0]))


def moe_layer_ep(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [b, s, d]
    cfg,
    *,
    mesh,
    dp_axes,
    model_axis: str,
    mode: str = "logical",  # logical | scheduled
    dispatch: str = "scatter",  # scatter | grouped (the per-rank body)
    fsdp: bool = False,  # weights d-split over the data axes arrive gathered
    scheduler: Optional[Callable] = None,
    layout_tables: Optional[Dict[str, torch.Tensor]] = None,
    slot_to_expert: Optional[torch.Tensor] = None,  # flat [S_total]
    num_instances: int = 0,
    capacity_factor: float = 2.0,
    with_aux: bool = False,
):
    """The expert-parallel layer (``moe_ep.py:72``); ``fsdp`` is accepted for
    the reference's signature: the region reads every expert weight
    gathered over the data axes, whatever its placement."""
    b, s, d = x.shape
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    n_model = sizes[model_axis]
    dp_axes = tuple(a for a in dp_axes if a in sizes)
    n_dp = 1
    for a in dp_axes:
        n_dp *= sizes[a]
    batch_sharded = (b % n_dp) == 0 and n_dp > 1
    E, top_k = cfg.num_experts, cfg.top_k
    grouped = dispatch == "grouped"
    rep = spmd.replicated(mesh)
    r = mesh.get_local_rank(model_axis)

    slot_indirect = False  # grouped + unpinned: logical weights + s2e slices
    gather_slots = False  # scatter + unpinned: each rank copies its slots' weights
    if mode == "scheduled":
        assert slot_to_expert is not None and scheduler is not None
        total_slots = int(slot_to_expert.shape[0])
        assert total_slots % n_model == 0, (total_slots, n_model)
        if params["w_gate"].shape[0] == total_slots:
            pass  # replica weights pinned at deployment (launch.steps.materialize_slot_params)
        elif grouped:
            slot_indirect = True
        else:
            gather_slots = True
        buckets = total_slots
    else:
        buckets = ((E + n_model - 1) // n_model) * n_model  # padded logical experts
    buckets_local = buckets // n_model
    t_loc = (b // n_dp if batch_sharded else b) * s
    capacity = max(4, int(t_loc * top_k * capacity_factor / buckets))

    # expert weights: split over the model axis on the bucket axis where the
    # buckets are the leading axis as stored; otherwise gathered and sliced
    # inside (each rank then holds a partial gradient over the model axis)
    w_names = ("w_gate", "w_up", "w_down")
    weights = [spmd.as_dtensor(params[k], mesh, rep) for k in w_names]
    split = (mode == "scheduled" and not (slot_indirect or gather_slots)) or (
        mode == "logical" and E % n_model == 0)
    split = split and all(spmd.sharded_dim(w, model_axis) == 0 for w in weights)
    w_pl = spmd.with_model(rep, mesh, Shard(0) if split else Replicate())
    act = spmd.act_placements(mesh, batch_sharded)
    x = spmd.as_dtensor(x, mesh, act)
    router = spmd.as_dtensor(params["router"], mesh, rep)
    tables = []
    if mode == "scheduled":
        tables = [layout_tables["expert_hosts"], layout_tables["replica_counts"], layout_tables["slot_of"]]
    s2e = slot_to_expert.to(torch.int32) if slot_to_expert is not None else None

    def body(xl, router_w, wg, wu, wd):
        bl = xl.shape[0]
        x2d = spmd.Copy.apply(xl.reshape(bl * s, d), mesh, (model_axis,))
        gates, eids, probs = route(spmd.Copy.apply(router_w, mesh, (model_axis,)), x2d, top_k)
        w_local = {"w_gate": wg, "w_up": wu, "w_down": wd}
        lo = r * buckets_local
        if not split:
            if mode == "logical":
                w_local = {k: _pad_experts(w, buckets)[lo : lo + buckets_local] for k, w in w_local.items()}
            elif gather_slots:
                idx = s2e[lo : lo + buckets_local].long().clamp(min=0)
                w_local = {k: w[idx] for k, w in w_local.items()}
            elif not slot_indirect:  # pinned slot weights, held whole
                w_local = {k: w[lo : lo + buckets_local] for k, w in w_local.items()}
        if mode == "scheduled":
            t = dict(zip(("expert_hosts", "replica_counts", "slot_of"), tables))
            bucket_ids, load, _ = scheduler(eids, t, num_instances)
        else:
            bucket_ids, load = eids, None
        owner = torch.div(bucket_ids, buckets_local, rounding_mode="floor")
        local_slot = bucket_ids % buckets_local
        is_local = (owner == r).reshape(-1)
        if grouped:
            if slot_indirect:
                s2e_local = s2e[lo : lo + buckets_local]
            elif mode == "scheduled":
                # pinned slot-stacked weights: the identity map
                s2e_local = torch.arange(buckets_local, dtype=torch.int32, device=x2d.device)
            else:
                s2e_local = None  # buckets are (padded) logical experts
            y = grouped_dispatch_ffn(x2d, local_slot, gates.to(x2d.dtype), buckets_local, capacity, w_local,
                                     slot_to_expert=s2e_local, item_mask=is_local)
        else:
            y = scatter_dispatch_ffn(x2d, local_slot, gates.to(x2d.dtype), buckets_local, capacity, w_local,
                                     item_mask=is_local)
        y = spmd.Reduce.apply(y, mesh, (model_axis,)).reshape(bl, s, d)
        lb = load_balance_loss(probs, eids, E) * float(r == 0)
        lb = spmd.Reduce.apply(lb, mesh, (model_axis,))
        if batch_sharded:
            lb = spmd.Mean.apply(lb, mesh, dp_axes)
        if load is None:
            load = torch.zeros(n_model, dtype=torch.int32, device=x2d.device)
        elif batch_sharded:
            # straggler semantics: the layer ends with its slowest (data shard, instance)
            load = spmd.all_reduce(load, "max", mesh, dp_axes)
        return y, lb, load

    w_grad = spmd.weight_grad_placements(w_pl, mesh, batch_sharded, model_partial=not split)
    r_grad = spmd.weight_grad_placements(rep, mesh, batch_sharded)
    y, lb, load = spmd.region(body, mesh, (act, rep, rep), (act, rep, w_pl, w_pl, w_pl),
                              (None, r_grad, w_grad, w_grad, w_grad))(x, router, *weights)

    if "shared" in params:
        # the shared expert stays on the "attention side" (data-parallel)
        y = y + ffn(params["shared"], x, "swiglu")
    if with_aux:
        aux = {"lb_loss": lb}
        if mode == "scheduled":
            aux["load"] = load
        return y, aux
    return y
