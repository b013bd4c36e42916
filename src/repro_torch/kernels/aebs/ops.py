"""K2 AEBS scheduling: the CUDA kernel's wrapper with the ``aebs_assign`` contract.

``aebs_schedule`` runs the one kernel of ``csrc/aebs.cu`` (bitmap, both
greedy passes and the rewrite, one launch) for CUDA tensors and the plain
:func:`repro_torch.core.aebs.aebs_assign` for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.aebs import aebs_assign
from repro_torch.kernels import cuda

MAX_EXPERTS = 512
MAX_SMEM = 232448  # an H100 block's opt-in shared memory
MAX_BLOCKS = 8  # a portable thread block cluster
# items one block takes: 8192 in registers and the rest read again for the
# rewrite; above, a cluster of MAX_BLOCKS blocks, whose fixed cost on the
# H100 (~1.5 us) is then below what one block takes for the rest (the
# measured crossover, PERF.md §6)
CLUSTER_ITEMS = 12288
_ARGS = [cuda.PTR, cuda.INT, cuda.PTR, cuda.PTR, cuda.PTR] + [cuda.INT] * 4 + [
    cuda.PTR, cuda.PTR, cuda.PTR, cuda.INT, cuda.PTR,
]


def cluster_blocks(n_items: int) -> int:
    """The launch's cluster size: one block up to ``CLUSTER_ITEMS`` items."""
    return 1 if n_items <= CLUSTER_ITEMS else MAX_BLOCKS


def aebs_schedule(
    eids: torch.Tensor,  # [T, k] int32 logical expert ids (-1 = padding)
    tables: Dict[str, torch.Tensor],  # ReplicaLayout.device_tables()
    num_instances: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 1: ``(slot_ids [T, k], load [n_e], act_rep [E])``, int32."""
    if eids.device.type == "cpu":
        return aebs_assign(eids, tables, num_instances)
    if eids.device.type != "cuda":
        raise ValueError(f"aebs_schedule: unsupported device {eids.device}")
    hosts = tables["expert_hosts"]
    counts = tables["replica_counts"]
    slot_of = tables["slot_of"]
    E, R = hosts.shape
    n_e = num_instances
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"aebs_schedule: {E} experts, the kernel takes 1 to {MAX_EXPERTS}")
    if R > n_e or counts.shape != (E,) or slot_of.shape != (E, n_e):
        raise ValueError("aebs_schedule: replica tables disagree on E, R <= n_e or n_e")
    for name, t in (("eids", eids), ("expert_hosts", hosts), ("replica_counts", counts),
                    ("slot_of", slot_of)):
        if t.dtype != torch.int32:
            raise TypeError(f"aebs_schedule: {name} must be int32, got {t.dtype}")
    cuda.check_tensors(
        {"eids": eids, "expert_hosts": hosts, "replica_counts": counts, "slot_of": slot_of},
        eids.device,
    )
    # csrc/aebs.cu smem_bytes: five [E] tables, hosts, slot_of, the loads,
    # and where the chain keeps its loads in registers (8 <= n_e <= 32) its
    # [E, n_e] 16-bit keys
    kbits = (E * n_e + 1) // 2 if 8 <= n_e <= 32 else 0
    if (4 * E + E * R + E * n_e + n_e + kbits) * 4 > MAX_SMEM:
        raise ValueError(f"aebs_schedule: tables E={E}, R={R}, n_e={n_e} exceed shared memory")
    n_items = eids.numel()
    slot_ids = torch.empty_like(eids)
    act_rep = torch.empty(E, dtype=torch.int32, device=eids.device)
    load = torch.empty(n_e, dtype=torch.int32, device=eids.device)
    fn = cuda.function("aebs", "aebs_schedule", _ARGS)
    err = fn(
        eids.data_ptr(), n_items, hosts.data_ptr(), counts.data_ptr(), slot_of.data_ptr(),
        E, R, n_e, cluster_blocks(n_items), slot_ids.data_ptr(), act_rep.data_ptr(), load.data_ptr(),
        eids.device.index, cuda.stream_of(eids),
    )
    cuda.check("aebs", err, "aebs_schedule")
    cuda.count("aebs_schedule")
    return slot_ids, load, act_rep


# same Algorithm-1 contract as aebs_assign: one replica per activated expert
aebs_schedule.single_active_replica = True
