"""Disaggregated cluster abstraction, Janus §3.1/§3.2 (``repro.core.disagg``
over ``torch.device``).

The devices a caller hands over are split into ``n_a`` attention devices
and ``n_e`` MoE devices (plus ``n_p`` prefill devices).  Attention instances
each hold a full attention-stack replica and a contiguous *batch shard* of
the in-flight KV caches; MoE instances run their expert replica slots.
Every layer performs a real hand-off whose pattern -- case-1 direct
node-to-node vs case-2 pairing + multicast -- is chosen per step by
:func:`repro_torch.core.comm.adaptive_two_phase` and realised by
:func:`plan_exchange`.  Pools carry a ``node_size`` so the two-phase
schedule has a fabric hierarchy (fast intra-node / slow inter-node) to
exploit; on one card the pools alias one device, the transfers are copies on
it, and the schedule (message count, per-fabric bytes) is the real one.

:func:`reconfigure` produces the incremental-deployment object (§3.5) that
the executor actuates by re-lowering only the affected pool.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.aebs import ReplicaLayout


@dataclasses.dataclass
class DisaggConfig:
    """A (n_p, n_a, n_e) deployment with its expert layout and comm scheme.

    ``n_prefill`` is the third sub-cluster: devices dedicated to chunked
    prompt prefill (0 = prefill runs on the decode device)."""

    n_attn: int
    n_moe: int
    layout: ReplicaLayout
    comm_scheme: str = "2pc"  # 2pc | 1pc
    gate_side: str = "moe"  # moe (EGate) | attn (AGate)
    n_prefill: int = 0

    @property
    def total_instances(self) -> int:
        return self.n_prefill + self.n_attn + self.n_moe

    def describe(self) -> str:
        p = f"{self.n_prefill}P" if self.n_prefill else ""
        return f"{p}{self.n_attn}A{self.n_moe}E"


@dataclasses.dataclass
class DevicePools:
    """The device sub-clusters plus their fabric hierarchy.

    ``node_size`` is the number of consecutive devices sharing the fast
    fabric (an NVLink node); the two-phase exchange aggregates within a node
    before crossing node boundaries.  ``prefill_devices`` may be empty."""

    attn_devices: List[torch.device]
    moe_devices: List[torch.device]
    node_size: int = 1
    prefill_devices: List[torch.device] = dataclasses.field(default_factory=list)

    @staticmethod
    def split(
        n_attn: int,
        n_moe: int,
        devices: Sequence[torch.device],
        node_size: int = 1,
        allow_reuse: bool = False,
        n_prefill: int = 0,
    ) -> "DevicePools":
        """Split ``devices`` into the three pools.

        Anchoring invariant: attention devices are taken from the *front* of
        the list, MoE devices from the *back*, and prefill devices from the
        tail of the middle gap (immediately ahead of the MoE pool).  Resizing
        the attention pool therefore never relocates prefill or MoE devices,
        and resizing the prefill pool never relocates either decode pool.

        ``allow_reuse=True`` maps pools onto too-few devices round-robin: the
        single-card mode, where every pool aliases the one device (the
        transfer schedule still runs; the moves are copies on the card)."""
        devs = list(devices)
        total = n_attn + n_moe + n_prefill
        if len(devs) < total:
            if not allow_reuse:
                raise ValueError(
                    f"need {total} devices, have {len(devs)} "
                    "(allow_reuse=True aliases the pools onto the devices given)"
                )
            devs = [devs[i % len(devs)] for i in range(total)]
        n = len(devs)
        return DevicePools(
            devs[:n_attn],
            devs[n - n_moe :],
            node_size,
            devs[n - n_moe - n_prefill : n - n_moe],
        )

    # -- fabric hierarchy ----------------------------------------------------
    def _groups(self, devs: List[torch.device]) -> List[List[torch.device]]:
        ns = max(1, self.node_size)
        return [devs[i : i + ns] for i in range(0, len(devs), ns)]

    @property
    def attn_nodes(self) -> List[List[torch.device]]:
        return self._groups(self.attn_devices)

    @property
    def moe_nodes(self) -> List[List[torch.device]]:
        return self._groups(self.moe_devices)


@dataclasses.dataclass(frozen=True)
class TransferStep:
    """One explicit device-to-device move in a realised exchange pattern.

    ``src``/``dst`` are ``(pool, index)`` addresses -- ``("attn", i)`` or
    ``("moe", g)`` -- rather than devices, so the schedule stays well-defined
    when pools alias one device.  ``chunk`` indexes the payload chunk being
    moved; ``fabric`` prices it for telemetry."""

    src: Tuple[str, int]
    dst: Tuple[str, int]
    chunk: int
    fabric: str  # "fast" | "slow"
    phase: int = 2  # 1 = intra-node shard aggregation, 2 = cross-pool move


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One payload chunk of a realised exchange: row-split ``sub``/``n_subs``
    of the payload aggregated from attention devices ``members`` on
    ``members[0]``, the node leader (``n_subs == 1``: the whole node payload).
    Case-2 subdivides so every pair link carries ~total/pairs bytes, as
    :func:`repro_torch.core.comm.two_phase_case2` assumes."""

    members: Tuple[int, ...]
    sub: int = 0
    n_subs: int = 1


def plan_exchange(pools: DevicePools, regime: str) -> Tuple[List[Chunk], List[TransferStep]]:
    """Realise the adaptive two-phase pattern as explicit per-node steps
    (``disagg.py:178``).  Returns ``(chunks, steps)``: the payload chunks in
    batch row order and the ordered move schedule that lands every chunk on
    every MoE device:

    * phase 1 (both cases): shard -> node-leader aggregation (fast);
    * case-1: each node's chunk goes leader -> leader to every MoE node
      (slow), then leader -> local devices (fast);
    * case-2: the payload is split across ``pairs = max(attn_nodes,
      moe_nodes)`` chunks; chunk ``p`` goes to MoE node ``p % moe_nodes``
      (slow, one message per pair), then MoE nodes redistribute chunks
      amongst themselves and multicast locally (fast)."""
    ns = max(1, pools.node_size)
    n_attn, n_moe = len(pools.attn_devices), len(pools.moe_devices)
    a_nodes = [tuple(range(i, min(i + ns, n_attn))) for i in range(0, n_attn, ns)]
    m_nodes = [list(range(i, min(i + ns, n_moe))) for i in range(0, n_moe, ns)]

    pairs = max(len(a_nodes), len(m_nodes))
    subs = -(-pairs // len(a_nodes)) if regime == "case2" else 1

    chunks: List[Chunk] = []
    steps: List[TransferStep] = []
    for node in a_nodes:
        first_cid = len(chunks)
        for s in range(subs):
            chunks.append(Chunk(node, s, subs))
        for i in node[1:]:
            steps.append(TransferStep(("attn", i), ("attn", node[0]), first_cid, "fast", phase=1))

    if regime == "case1":
        for cid, ch in enumerate(chunks):
            leader = ch.members[0]
            for mnode in m_nodes:
                steps.append(TransferStep(("attn", leader), ("moe", mnode[0]), cid, "slow"))
                for g in mnode[1:]:
                    steps.append(TransferStep(("moe", mnode[0]), ("moe", g), cid, "fast"))
    elif regime == "case2":
        dst_leader = {}
        for cid, ch in enumerate(chunks):
            mnode = m_nodes[cid % len(m_nodes)]
            steps.append(TransferStep(("attn", ch.members[0]), ("moe", mnode[0]), cid, "slow"))
            dst_leader[cid] = mnode[0]
        for mnode in m_nodes:
            for cid in range(len(chunks)):
                holder = dst_leader[cid]
                if holder != mnode[0]:
                    steps.append(TransferStep(("moe", holder), ("moe", mnode[0]), cid, "fast"))
                for g in mnode[1:]:
                    steps.append(TransferStep(("moe", mnode[0]), ("moe", g), cid, "fast"))
    else:
        raise ValueError(regime)
    return chunks, steps


def reconfigure(
    cfg_from: DisaggConfig,
    n_attn: int,
    n_moe: int,
    layout: ReplicaLayout,
    n_prefill: Optional[int] = None,
) -> DisaggConfig:
    """Incremental reconfiguration (§3.5): a new deployment object, which
    ``DisaggExecutor.reconfigure`` actuates by re-lowering only the pool
    whose count changed."""
    return dataclasses.replace(
        cfg_from,
        n_attn=n_attn,
        n_moe=n_moe,
        layout=layout,
        n_prefill=cfg_from.n_prefill if n_prefill is None else n_prefill,
    )
