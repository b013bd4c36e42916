"""K2 AEBS scheduling: CUDA kernel wrappers with the ``aebs_assign`` contract.

``aebs_schedule`` runs the two kernels of ``csrc/aebs.cu`` for CUDA tensors
-- :func:`aebs_collect_greedy` (bitmap + greedy passes) then
:func:`aebs_rewrite` -- and the plain :func:`repro_torch.core.aebs
.aebs_assign` for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.aebs import aebs_assign, rewrite_slots
from repro_torch.kernels import cuda

MAX_EXPERTS = 512
MAX_SMEM = 48 * 1024
_GREEDY_ARGS = [cuda.PTR, cuda.INT, cuda.PTR, cuda.PTR, cuda.PTR] + [cuda.INT] * 3 + [
    cuda.PTR, cuda.PTR, cuda.INT, cuda.PTR,
]
_REWRITE_ARGS = [cuda.PTR, cuda.INT, cuda.PTR, cuda.INT, cuda.PTR, cuda.INT, cuda.PTR]


def _check_eids(eids: torch.Tensor, what: str) -> None:
    if eids.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {eids.device}")
    if eids.dtype != torch.int32:
        raise TypeError(f"{what}: eids must be int32, got {eids.dtype}")


def aebs_collect_greedy(
    eids: torch.Tensor,  # [T, k] int32 logical expert ids (-1 = padding)
    tables: Dict[str, torch.Tensor],  # ReplicaLayout.device_tables()
    num_instances: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2a: activation bitmap + both greedy passes -> ``(load [n_e], act_rep [E])``."""
    if eids.device.type == "cpu":
        _, load, act_rep = aebs_assign(eids, tables, num_instances)
        return load, act_rep
    _check_eids(eids, "aebs_collect_greedy")
    hosts = tables["expert_hosts"]
    counts = tables["replica_counts"]
    slot_of = tables["slot_of"]
    E, R = hosts.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"aebs_collect_greedy: {E} experts exceed the kernel's limit of {MAX_EXPERTS}")
    if counts.shape != (E,) or slot_of.shape != (E, num_instances):
        raise ValueError("aebs_collect_greedy: replica tables disagree on E or n_e")
    for name, t in (("expert_hosts", hosts), ("replica_counts", counts), ("slot_of", slot_of)):
        if t.dtype != torch.int32:
            raise TypeError(f"aebs_collect_greedy: {name} must be int32, got {t.dtype}")
    cuda.check_tensors(
        {"eids": eids, "expert_hosts": hosts, "replica_counts": counts, "slot_of": slot_of},
        eids.device,
    )
    if (2 * E + E * R + num_instances) * 4 > MAX_SMEM:
        raise ValueError(f"aebs_collect_greedy: tables E={E}, R={R} exceed shared memory")
    act_rep = torch.empty(E, dtype=torch.int32, device=eids.device)
    load = torch.empty(num_instances, dtype=torch.int32, device=eids.device)
    fn = cuda.function("aebs", "aebs_collect_greedy", _GREEDY_ARGS)
    err = fn(
        eids.data_ptr(), eids.numel(), hosts.data_ptr(), counts.data_ptr(), slot_of.data_ptr(),
        E, R, num_instances, act_rep.data_ptr(), load.data_ptr(), eids.device.index,
        cuda.stream_of(eids),
    )
    cuda.check("aebs", err, "aebs_collect_greedy")
    cuda.count("aebs_collect_greedy")
    return load, act_rep


def aebs_rewrite(eids: torch.Tensor, act_rep: torch.Tensor) -> torch.Tensor:
    """K2b: ``slot_ids = act_rep[eids]``, keeping -1 for padding."""
    if eids.device.type == "cpu":
        return rewrite_slots(eids, act_rep)
    _check_eids(eids, "aebs_rewrite")
    if act_rep.dtype != torch.int32 or act_rep.dim() != 1:
        raise TypeError("aebs_rewrite: act_rep must be a 1-d int32 tensor")
    cuda.check_tensors({"eids": eids, "act_rep": act_rep}, eids.device)
    slot_ids = torch.empty_like(eids)
    fn = cuda.function("aebs", "aebs_rewrite", _REWRITE_ARGS)
    err = fn(eids.data_ptr(), eids.numel(), act_rep.data_ptr(), act_rep.shape[0],
             slot_ids.data_ptr(), eids.device.index, cuda.stream_of(eids))
    cuda.check("aebs", err, "aebs_rewrite")
    cuda.count("aebs_rewrite")
    return slot_ids


def aebs_schedule(
    eids: torch.Tensor,
    tables: Dict[str, torch.Tensor],
    num_instances: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 1: ``(slot_ids [T, k], load [n_e], act_rep [E])``, int32."""
    if eids.device.type == "cpu":
        return aebs_assign(eids, tables, num_instances)
    load, act_rep = aebs_collect_greedy(eids, tables, num_instances)
    return aebs_rewrite(eids, act_rep), load, act_rep


# same Algorithm-1 contract as aebs_assign: one replica per activated expert
aebs_schedule.single_active_replica = True
