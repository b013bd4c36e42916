"""Adaptive two-phase communication, Janus §3.3: the analytic cost model
(``repro.core.comm``, numpy and ``math`` only, copied so the port imports
nothing of the reference).

Instead of O(m x n) small cross-node transfers between m attention instances
and n MoE instances, activations are first aggregated over the *fast
intra-node* fabric (NVLink), then sent as few large transfers over the *slow
inter-node* fabric (IB/RDMA).  Two regimes:

  Case-1  aggregated payloads go directly to each destination node;
  Case-2  one-to-one node pairing + local multicast at the destination.

The disaggregated executor picks the cheaper regime per step with
:func:`adaptive_two_phase`; the SLO scaler and the Fig. 12 ablation read the
same model.  Costs use the classic alpha-beta model: per-message latency
alpha plus bytes/bandwidth.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # FLOP/s (bf16)
    hbm_bw: float  # bytes/s
    fast_bw: float  # intra-node / intra-pod bytes/s (per device)
    slow_bw: float  # inter-node / cross-pod bytes/s (per device)
    alpha_fast: float  # per-message latency on the fast fabric (s)
    alpha_slow: float  # per-message latency on the slow fabric (s)
    mem_bytes: float  # device memory
    devices_per_node: int  # instances sharing the fast fabric
    kernel_launch: float = 5e-6  # dispatch constant (c_a / c_e floor)


# TPU v5e (target hardware of this repro; ICI ~50 GB/s/link, ~3 links usable)
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    fast_bw=3 * 50e9,
    slow_bw=25e9,  # cross-pod DCN per device (conservative)
    alpha_fast=1e-6,
    alpha_slow=10e-6,
    mem_bytes=16e9,
    devices_per_node=4,  # v5e host = 4 chips on shared ICI neighbourhood
)

# H100 DGX (the paper's testbed — used to sanity-check paper-scale numbers)
H100 = HardwareSpec(
    name="h100",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    fast_bw=900e9,  # NVLink
    slow_bw=50e9,  # 400 Gbps IB
    alpha_fast=3e-6,
    alpha_slow=8e-6,
    mem_bytes=80e9,
    devices_per_node=8,
)


@dataclasses.dataclass(frozen=True)
class CommConfig:
    n_attn: int  # m attention instances
    n_moe: int  # n MoE instances
    bytes_per_token: int  # activation payload per token (d_model × dtype)
    batch: int  # tokens in flight per layer step
    hw: HardwareSpec = TPU_V5E

    @property
    def attn_nodes(self) -> int:
        return max(1, math.ceil(self.n_attn / self.hw.devices_per_node))

    @property
    def moe_nodes(self) -> int:
        return max(1, math.ceil(self.n_moe / self.hw.devices_per_node))

    @property
    def total_bytes(self) -> float:
        """Full (ungated) activations, attention→MoE (EGate semantics)."""
        return float(self.batch) * self.bytes_per_token


def one_phase_cost(c: CommConfig) -> float:
    """Strawman: every attention instance sends to every MoE instance.

    m×n messages of (B/m)·bytes each; messages serialise per NIC (per source
    instance: n sends) and every transfer crosses the slow fabric.
    """
    # EGate sends full activations to every MoE instance, so each source puts
    # its activation block on the wire once per destination.
    per_src_msgs = c.n_moe
    bytes_on_wire_per_src = (c.total_bytes / c.n_attn) * c.n_moe
    return per_src_msgs * c.hw.alpha_slow + bytes_on_wire_per_src / c.hw.slow_bw


def two_phase_case1(c: CommConfig) -> float:
    """Phase 1: intra-node aggregation; Phase 2: each attention node sends the
    aggregated payload directly to each MoE node."""
    intra = c.hw.alpha_fast * math.ceil(math.log2(max(2, c.hw.devices_per_node))) + (
        c.total_bytes / c.attn_nodes
    ) / c.hw.fast_bw
    per_node_payload = c.total_bytes / c.attn_nodes
    inter = c.moe_nodes * c.hw.alpha_slow + (per_node_payload * c.moe_nodes) / c.hw.slow_bw
    return intra + inter


def two_phase_case2(c: CommConfig) -> float:
    """Phase 1: intra-node aggregation; Phase 2: one-to-one node pairing, then
    intra-node multicast at the destination."""
    intra = c.hw.alpha_fast * math.ceil(math.log2(max(2, c.hw.devices_per_node))) + (
        c.total_bytes / c.attn_nodes
    ) / c.hw.fast_bw
    pairs = max(c.attn_nodes, c.moe_nodes)
    # each pair carries the *global* payload split across pairs, then fans out
    inter = c.hw.alpha_slow + (c.total_bytes / pairs) / c.hw.slow_bw
    multicast = c.hw.alpha_fast + (c.total_bytes / c.moe_nodes) / c.hw.fast_bw
    return intra + inter + multicast


def adaptive_two_phase(c: CommConfig) -> Tuple[float, str]:
    """Janus regime selection: pick the cheaper of case-1 / case-2."""
    t1, t2 = two_phase_case1(c), two_phase_case2(c)
    return (t1, "case1") if t1 <= t2 else (t2, "case2")


def agate_cost(c: CommConfig, top_k: int, num_experts: int) -> float:
    """Attention-side gating baseline (MegaScale): only routed activations are
    sent, but with per-expert packing + metadata, each source talks to every
    MoE instance hosting an activated expert → many small messages."""
    # expected distinct destination instances per source ≈ n_moe (top-k spreads)
    frac = min(1.0, top_k / max(1, num_experts) * num_experts / c.n_moe)
    dests = max(1.0, c.n_moe * min(1.0, frac))
    routed_bytes = c.total_bytes * top_k / max(1, num_experts) * (num_experts / c.n_moe)
    meta_bytes = c.batch * 8  # routing metadata per token
    per_src_msgs = dests
    t = per_src_msgs * c.hw.alpha_slow + (routed_bytes + meta_bytes) / c.hw.slow_bw
    return t


def layer_comm_time(
    n_attn: int,
    n_moe: int,
    batch: int,
    d_model: int,
    hw: HardwareSpec = TPU_V5E,
    dtype_bytes: int = 2,
    scheme: str = "2pc",
    top_k: int = 8,
    num_experts: int = 64,
) -> float:
    """Round-trip (dispatch + combine) communication time for one MoE layer."""
    c = CommConfig(n_attn, n_moe, d_model * dtype_bytes, batch, hw)
    if scheme == "2pc":
        t, _ = adaptive_two_phase(c)
    elif scheme == "1pc":
        t = one_phase_cost(c)
    elif scheme == "agate":
        t = agate_cost(c, top_k, num_experts)
    else:
        raise ValueError(scheme)
    return 2.0 * t  # dispatch + combine
