"""Activation-aware replica allocation and placement (Janus §3.5, Appendix
B; ``repro.core.placement``): replica counts by per-replica load, then
Algorithm 3's greedy min-max co-activation placement with bounded swaps."""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.amax import coactivation_matrix


def allocate_replicas(activation_counts: np.ndarray, num_instances: int, capacity: int) -> np.ndarray:
    """Replica count R(e): one seat per expert, then the redundant slots go to
    the expert with the largest per-replica load c(e)/R(e), R(e) <= n_e."""
    E = len(activation_counts)
    total_slots = num_instances * capacity
    if total_slots < E:
        raise ValueError(f"{total_slots} slots cannot seat {E} experts")
    R = np.ones(E, np.int64)
    c = np.asarray(activation_counts, np.float64) + 1e-9
    heap = [(-c[e] / 1.0, e) for e in range(E)]
    heapq.heapify(heap)
    extra = total_slots - E
    while extra > 0 and heap:
        _, e = heapq.heappop(heap)
        if R[e] >= num_instances:
            continue
        R[e] += 1
        extra -= 1
        if R[e] < num_instances:
            heapq.heappush(heap, (-c[e] / R[e], e))
    return R


def place_replicas(
    replica_counts: np.ndarray,
    coactivation: np.ndarray,
    num_instances: int,
    capacity: int,
    loads: Optional[np.ndarray] = None,
) -> ReplicaLayout:
    """Algorithm 3: replicas in descending load order, each to the feasible
    instance with the least added co-activation; a bounded swap when no
    instance has a free slot without a copy of the expert."""
    E = len(replica_counts)
    n_e, C = num_instances, capacity
    if replica_counts.sum() > n_e * C:
        raise ValueError("more replicas than slots")
    if loads is None:
        loads = np.ones(E, np.float64)
    replicas = []
    for e in range(E):
        per = loads[e] / max(1, replica_counts[e])
        replicas += [(per, e)] * int(replica_counts[e])
    replicas.sort(key=lambda t: -t[0])

    placed = [[] for _ in range(n_e)]
    slots_free = [C] * n_e
    has = np.zeros((E, n_e), bool)

    def coact_penalty(e: int, g: int) -> float:
        return float(sum(coactivation[e, j] for j in placed[g]))

    for _, e in replicas:
        feas = [g for g in range(n_e) if slots_free[g] > 0 and not has[e, g]]
        if feas:
            g_star = min(feas, key=lambda g: (coact_penalty(e, g), g))
            placed[g_star].append(e)
            slots_free[g_star] -= 1
            has[e, g_star] = True
            continue
        best = None  # (delta, g, j, h)
        for g in range(n_e):
            if has[e, g]:
                continue
            for j in placed[g]:
                for h in range(n_e):
                    if slots_free[h] <= 0 or has[j, h] or h == g:
                        continue
                    delta = (
                        coact_penalty(e, g)
                        - coactivation[e, j]
                        - sum(coactivation[j, jj] for jj in placed[g] if jj != j)
                        + coact_penalty(j, h)
                    )
                    if best is None or delta < best[0]:
                        best = (delta, g, j, h)
        if best is None:
            raise RuntimeError("infeasible placement (capacity exhausted)")
        _, g, j, h = best
        placed[g].remove(j)
        has[j, g] = False
        placed[g].append(e)
        has[e, g] = True
        placed[h].append(j)
        slots_free[h] -= 1
        has[j, h] = True

    stx = -np.ones((n_e, C), np.int32)
    for g in range(n_e):
        for c_i, e in enumerate(placed[g]):
            stx[g, c_i] = e
    return ReplicaLayout.build(stx, E)


def build_layout(trace: np.ndarray, num_experts: int, num_instances: int, capacity: int) -> ReplicaLayout:
    """Counts + co-activation from a routing trace -> allocate -> place."""
    counts = np.bincount(trace.reshape(-1), minlength=num_experts).astype(np.float64)
    R = allocate_replicas(counts, num_instances, capacity)
    A = coactivation_matrix(trace, num_experts)
    return place_replicas(R, A, num_instances, capacity, loads=counts)


def layout_for_survivors(
    num_experts: int,
    n_surviving: int,
    capacity: Optional[int] = None,
    trace: Optional[np.ndarray] = None,
) -> ReplicaLayout:
    """Re-plan expert placement after a permanent MoE-device loss: seat every
    expert on the ``n_surviving`` instances (ceil capacity, at least
    ``capacity``, one slot of headroom when exactly full), activation-aware
    from a routing ``trace`` or round-robin without one.  Every expert keeps
    a seat, so expert semantics (and token streams) are unchanged."""
    if n_surviving < 1:
        raise ValueError("MoE pool lost its last device — degrade to mono instead")
    C = -(-num_experts // n_surviving)
    if capacity is not None:
        C = max(C, capacity)
    if n_surviving * C == num_experts:
        C += 1
    if trace is not None:
        return build_layout(trace, num_experts, n_surviving, C)
    return ReplicaLayout.round_robin(num_experts, n_surviving, C)


def instance_coactivation_load(layout: ReplicaLayout, coactivation: np.ndarray) -> np.ndarray:
    """I(g) of Eq. 6: the co-activation mass among the distinct experts each
    instance hosts (``placement.py:170``)."""
    out = np.zeros(layout.num_instances)
    for g in range(layout.num_instances):
        hosted = layout.slot_to_expert[g]
        hosted = np.unique(hosted[hosted >= 0])
        s = 0.0
        for i in range(len(hosted)):
            for j in range(i + 1, len(hosted)):
                s += coactivation[hosted[i], hosted[j]]
        out[g] = s
    return out
