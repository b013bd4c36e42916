"""Activated-Expert-Balanced Scheduling (Janus §3.4, Algorithm 1): replica
layout tables and the plain scheduler (``repro.core.aebs``).

:func:`aebs_assign` is the plain PyTorch version the CUDA kernel
(``repro_torch.kernels.aebs``) is held against; :func:`aebs_numpy` is the
host-side copy.  All share one semantics:

  1. collect the activated logical experts (ids < 0 are padding);
  2. single-replica experts go to their only host;
  3. replicated experts go to the least-loaded host, ties to the lowest
     replica index, in ascending expert order;
  4. rewrite each routed id to the chosen global slot.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ReplicaLayout:
    """Expert replicas on MoE instances; slot (g, c) is global slot g*C + c."""

    num_experts: int
    num_instances: int
    capacity: int
    slot_to_expert: np.ndarray  # [n_e, C] int32, -1 = empty
    expert_hosts: np.ndarray  # [E, R_max] int32 instance ids, -1 padded
    replica_counts: np.ndarray  # [E] int32
    slot_of: np.ndarray  # [E, n_e] int32 global slot of e's replica on g, -1

    @staticmethod
    def build(slot_to_expert: np.ndarray, num_experts: int) -> "ReplicaLayout":
        slot_to_expert = np.asarray(slot_to_expert, np.int32)
        n_e, C = slot_to_expert.shape
        counts = np.zeros(num_experts, np.int32)
        slot_of = -np.ones((num_experts, n_e), np.int32)
        for g in range(n_e):
            for c in range(C):
                e = slot_to_expert[g, c]
                if e >= 0 and slot_of[e, g] < 0:  # first replica of e on g wins
                    slot_of[e, g] = g * C + c
                    counts[e] += 1
        r_max = max(1, int(counts.max(initial=1)))
        hosts = -np.ones((num_experts, r_max), np.int32)
        for e in range(num_experts):
            gs = np.nonzero(slot_of[e] >= 0)[0]
            hosts[e, : len(gs)] = gs
        return ReplicaLayout(
            num_experts=num_experts,
            num_instances=n_e,
            capacity=C,
            slot_to_expert=slot_to_expert,
            expert_hosts=hosts,
            replica_counts=counts,
            slot_of=slot_of,
        )

    @staticmethod
    def round_robin(num_experts: int, num_instances: int, capacity: int) -> "ReplicaLayout":
        """Default layout: experts 0..E-1 dealt round-robin, leftover slots
        replicate the first experts (``aebs.py:91``)."""
        total = num_instances * capacity
        seq = [e % num_experts for e in range(total)]
        # order='F': slot (g, c) = c * n_e + g, experts striped across instances
        stx = np.array(seq, np.int32).reshape(num_instances, capacity, order="F")
        return ReplicaLayout.build(stx, num_experts)

    def device_tables(self, device) -> Dict[str, torch.Tensor]:
        return {
            "expert_hosts": torch.as_tensor(self.expert_hosts, dtype=torch.int32, device=device),
            "replica_counts": torch.as_tensor(self.replica_counts, dtype=torch.int32, device=device),
            "slot_of": torch.as_tensor(self.slot_of, dtype=torch.int32, device=device),
        }

    @property
    def total_slots(self) -> int:
        return self.num_instances * self.capacity


def activated_mask(eids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Step 1 of the workflow: the union of the selected expert ids, ``[E]``
    bool (``aebs.py:118``); padding ids (-1) select nothing."""
    flat = eids.reshape(-1).long()
    valid = (flat >= 0) & (flat < num_experts)
    act = torch.zeros(num_experts + 1, dtype=torch.bool, device=eids.device)
    act[torch.where(valid, flat, num_experts)] = True
    return act[:num_experts]


def amax_of(load: torch.Tensor) -> torch.Tensor:
    """a_max: the most activated experts on one instance."""
    return load.max()


def aebs_assign(
    eids: torch.Tensor,  # [T, k] logical expert ids, -1 = padding
    tables: Dict[str, torch.Tensor],
    num_instances: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 1, plain version.  Returns ``(slot_ids [T, k], load [n_e],
    act_rep [E])`` as int32 on ``eids``' device.  The greedy passes run on the
    host (they are a dependent chain over E experts)."""
    hosts = tables["expert_hosts"]
    E = hosts.shape[0]
    act_l = activated_mask(eids, E).tolist()
    counts_l = tables["replica_counts"].tolist()
    hosts_l = hosts.tolist()
    slot_l = tables["slot_of"].tolist()
    load = [0] * num_instances
    rep = [-1] * E
    for want_multi in (False, True):
        for e in range(E):
            c = counts_l[e]
            if not act_l[e] or c < 1 or (c > 1) != want_multi:
                continue
            hs = [g for g in hosts_l[e] if g >= 0]
            g = min(hs, key=lambda h: load[h])  # first minimum = lowest replica index
            rep[e] = slot_l[e][g]
            load[g] += 1
    act_rep = torch.tensor(rep, dtype=torch.int32, device=eids.device)
    load_t = torch.tensor(load, dtype=torch.int32, device=eids.device)
    return rewrite_slots(eids, act_rep), load_t, act_rep


def rewrite_slots(eids: torch.Tensor, act_rep: torch.Tensor) -> torch.Tensor:
    """Step 4: ``slot_ids = act_rep[eids]``, keeping -1 for padding."""
    E = act_rep.shape[0]
    ev = eids.long()
    ok = (ev >= 0) & (ev < E)
    return torch.where(ok, act_rep[ev.clamp(0, E - 1)], -1).to(torch.int32)


# AEBS activates exactly one replica per activated expert, which lets grouped
# dispatch collapse replica slots back to logical experts.
aebs_assign.single_active_replica = True


def aebs_numpy(eids: np.ndarray, layout: ReplicaLayout) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host implementation of Algorithm 1 (``aebs.py:188``)."""
    E, n_e = layout.num_experts, layout.num_instances
    act = np.zeros(E, bool)
    act[np.asarray(eids).reshape(-1)] = True
    load = np.zeros(n_e, np.int64)
    act_rep = -np.ones(E, np.int64)
    activated = np.nonzero(act)[0]
    singles = [e for e in activated if layout.replica_counts[e] == 1]
    multis = [e for e in activated if layout.replica_counts[e] > 1]
    for e in singles:
        g = int(layout.expert_hosts[e, 0])
        act_rep[e] = layout.slot_of[e, g]
        load[g] += 1
    for e in multis:
        hs = layout.expert_hosts[e]
        hs = hs[hs >= 0]
        g = int(hs[np.argmin(load[hs])])
        act_rep[e] = layout.slot_of[e, g]
        load[g] += 1
    slot_ids = act_rep[np.asarray(eids)]
    return slot_ids, load, act_rep
