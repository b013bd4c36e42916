"""Baseline expert schedulers (Janus §5.1; ``repro.core.baselines``), the
foils AEBS is measured against:

* :func:`random_assign` — MegaScale-Infer / EPLB style: a uniformly random
  replica per activated expert (one replica each, so grouped dispatch still
  collapses replica slots to logical experts);
* :func:`token_hash_assign` — token balancing: item i of expert e takes
  replica ``i mod R(e)``, which evens out token counts per instance but not
  the distinct activated experts (§2.2's foil); it may activate several
  replicas of one expert, so dispatch reads weights slot-indirectly.

Both have :func:`repro_torch.core.aebs.aebs_assign`'s signature and return
``(slot_ids [T, k], load [n_e], act_rep [E])`` as int32 on ``eids``' device;
:func:`random_numpy` and :func:`token_hash_numpy` are the host twins.

The reference draws the random replica choice from JAX's PRNG,
``jax.random.uniform(PRNGKey(0), (E,))`` on every call when no key is given.
:func:`default_uniform` reproduces that draw bit for bit in numpy
(Threefry-2x32 in JAX's partitionable counter mode), once per E on the host;
:func:`random_assign` takes any other ``[E]`` draw as ``u``.

The module also holds the system scaling policies the cluster simulator
(``serving/simulator.py``, Fig. 11) sets against Janus's
:class:`~repro_torch.core.scaling.SLOScaler`, each returning a
:class:`PolicyDecision` from ``decide(scaler, demand, slo)``:

* :class:`MonolithicPolicy` — SGLang style: whole-model replicas in
  power-of-two GPU tiers, none below the model's memory floor;
* :class:`CoupledPolicy` — MegaScale-Infer style: the most balanced plan
  (attention against MoE time) that meets the SLO;
* :class:`FixedUnitPolicy` — xDeepServe style: fixed units of GPUs, split
  evenly.

They are host code over the scaler's performance model, with the
reference's loops and tie-breaks in the same order, so the decisions equal
the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aebs import ReplicaLayout, activated_mask

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of ``jax.random``, over
    uint32 counter words ``(x0, x1)``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


_UNIFORM: Dict[int, np.ndarray] = {}
_UNIFORM_DEV: Dict[Tuple[int, str], torch.Tensor] = {}


def default_uniform(n: int) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(0), (n,))`` as float32, bit
    for bit: 32 random bits of element i are ``hi ^ lo`` of the cipher over
    the counter ``(0, i)``, and their top 23 bits fill a float in [1, 2)
    from which 1 is taken.  Drawn once per ``n`` and cached."""
    if n not in _UNIFORM:
        with np.errstate(over="ignore"):
            hi, lo = threefry2x32((0, 0), np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
        bits = (hi ^ lo) >> np.uint32(9) | np.uint32(0x3F800000)
        _UNIFORM[n] = bits.view(np.float32) - np.float32(1.0)
    return _UNIFORM[n]


def _default_uniform_on(n: int, device: torch.device) -> torch.Tensor:
    """:func:`default_uniform` uploaded to ``device`` once."""
    key = (n, str(device))
    if key not in _UNIFORM_DEV:
        _UNIFORM_DEV[key] = torch.from_numpy(default_uniform(n)).to(device)
    return _UNIFORM_DEV[key]


def random_assign(
    eids: torch.Tensor,  # [T, k] logical expert ids
    tables: Dict[str, torch.Tensor],
    num_instances: int,
    u: Optional[torch.Tensor] = None,  # [E] uniform draw; None: the reference's PRNGKey(0) draw
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A uniformly random replica per activated expert (``baselines.py:38``):
    expert e takes host ``floor(u[e] * R(e))`` of its hosts."""
    hosts = tables["expert_hosts"]  # [E, R]
    counts = tables["replica_counts"]
    slot_of = tables["slot_of"]
    E = hosts.shape[0]
    dev = eids.device
    if u is None:
        u = _default_uniform_on(E, dev)
    sel = torch.floor(u * counts.float()).to(torch.int64)
    sel = torch.minimum(sel.clamp(min=0), (counts.long() - 1).clamp(min=0))
    g = torch.gather(hosts.long(), 1, sel[:, None])[:, 0]  # [E]
    act_rep = slot_of[torch.arange(E, device=dev), g.clamp(min=0)].to(torch.int32)
    slot_ids = act_rep[eids.long()]
    act = activated_mask(eids, E).to(torch.int32)
    load = torch.zeros(num_instances, dtype=torch.int32, device=dev).index_add_(0, g.clamp(min=0), act)
    return slot_ids, load, act_rep


# one replica per activated expert (chosen at random): collapse-eligible
random_assign.single_active_replica = True


def token_hash_assign(
    eids: torch.Tensor,  # [T, k]
    tables: Dict[str, torch.Tensor],
    num_instances: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token balancing (``baselines.py:66``): item i of expert e takes
    replica ``i mod R(e)``; ``load`` counts the distinct (expert, instance)
    activations per instance, and ``act_rep`` is all -1 (no single replica
    per expert)."""
    hosts = tables["expert_hosts"]
    counts = tables["replica_counts"]
    slot_of = tables["slot_of"]
    E = hosts.shape[0]
    T, k = eids.shape
    dev = eids.device
    flat = eids.reshape(-1).long()
    item = torch.arange(T * k, device=dev)
    sel = item % counts.long()[flat].clamp(min=1)
    g = hosts.long()[flat, sel]
    slot_ids = slot_of[flat, g.clamp(min=0)].reshape(T, k).to(torch.int32)
    pair = flat * num_instances + g
    pair_mask = torch.zeros(E * num_instances, dtype=torch.bool, device=dev)
    pair_mask[pair] = True
    load = pair_mask.reshape(E, num_instances).sum(dim=0).to(torch.int32)
    return slot_ids, load, torch.full((E,), -1, dtype=torch.int32, device=dev)


def random_numpy(eids: np.ndarray, layout: ReplicaLayout, rng: np.random.Generator):
    """Host twin of :func:`random_assign` drawing from ``rng``
    (``baselines.py:107``)."""
    E, n_e = layout.num_experts, layout.num_instances
    act = np.zeros(E, bool)
    act[np.asarray(eids).reshape(-1)] = True
    act_rep = -np.ones(E, np.int64)
    load = np.zeros(n_e, np.int64)
    for e in np.nonzero(act)[0]:
        hs = layout.expert_hosts[e]
        hs = hs[hs >= 0]
        g = int(rng.choice(hs))
        act_rep[e] = layout.slot_of[e, g]
        load[g] += 1
    return act_rep[np.asarray(eids)], load, act_rep


def token_hash_numpy(eids: np.ndarray, layout: ReplicaLayout):
    """Host twin of :func:`token_hash_assign` (``baselines.py:122``)."""
    eids = np.asarray(eids)
    T, k = eids.shape
    flat = eids.reshape(-1)
    item = np.arange(T * k)
    counts = np.maximum(layout.replica_counts[flat], 1)
    sel = item % counts
    g = layout.expert_hosts[flat, sel]
    slots = layout.slot_of[flat, np.maximum(g, 0)]
    load = np.zeros(layout.num_instances, np.int64)
    for gg in range(layout.num_instances):
        load[gg] = len(np.unique(flat[g == gg]))
    return slots.reshape(T, k), load, None


# ---------------------------------------------------------------------------
# System scaling policies (cluster simulator; ``baselines.py:143``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PolicyDecision:
    n_a: int
    n_e: int
    total_gpus: int
    feasible: bool


class MonolithicPolicy:
    """SGLang-style: whole-model replicas in power-of-two GPU tiers.

    A monolithic deployment must *fit the whole model* on its tier (the
    paper's motivating example: DeepSeek-V3 needs >= 16 H100s just to load),
    so tiers below the model's memory floor are infeasible."""

    def __init__(self, tier_sizes=(8, 16, 32, 64, 128)):
        self.tiers = tier_sizes

    def min_tier(self, scaler) -> int:
        cfg = scaler.model.cfg
        model_bytes = cfg.total_params() * cfg.bytes_per_param()
        floor = model_bytes / (0.6 * scaler.model.hw.mem_bytes)  # 40% for KV/act
        for t in self.tiers:
            if t >= floor:
                return t
        return self.tiers[-1]

    def decide(self, scaler, demand: float, slo: float) -> PolicyDecision:
        lo = self.min_tier(scaler)
        for total in self.tiers:
            if total < lo:
                continue
            # attention and MoE share the tier's GPUs; TPOT is evaluated on a
            # balanced split of the tier
            n_e = max(scaler.n_e_min, total // 2)
            n_a = total - n_e
            if n_a < 1:
                continue
            r = scaler.evaluate(demand, slo, n_a, n_e)
            if r is not None and r.tpot <= slo:
                return PolicyDecision(n_a, n_e, n_a + n_e, True)
        t = self.tiers[-1]
        n_e = max(scaler.n_e_min, t // 2)
        return PolicyDecision(max(1, t - n_e), n_e, t, False)


class CoupledPolicy:
    """MegaScale-Infer-style: restrict plans to those balancing attention-side
    and MoE-side times (for pipelined execution).  Among SLO-feasible plans it
    picks the *most balanced* (then fewest GPUs), which typically costs more
    GPUs than Janus's unconstrained min-GPU search; when no balanced feasible
    plan exists the balanced-but-violating plan with the lowest TPOT is used
    (the Fig. 8 SLO-violation regime)."""

    def __init__(self, tol: float = 0.3):
        self.tol = tol

    def _imbalance(self, r) -> float:
        return abs(r.t_attn - r.t_moe) / max(r.t_attn, r.t_moe, 1e-12)

    def decide(self, scaler, demand: float, slo: float) -> PolicyDecision:
        balanced_feasible = []
        feasible = []
        violating = []
        for n_a in range(1, scaler.n_max + 1):
            for n_e in range(scaler.n_e_min, scaler.n_max + 1):
                r = scaler.evaluate(demand, slo, n_a, n_e)
                if r is None:
                    continue
                imb = self._imbalance(r)
                if r.tpot <= slo:
                    feasible.append((imb, n_a + n_e, r))
                    if imb <= self.tol:
                        balanced_feasible.append((n_a + n_e, imb, r))
                elif imb <= self.tol:
                    violating.append((r.tpot, n_a + n_e, r))
        if balanced_feasible:
            _, _, r = min(balanced_feasible, key=lambda t: (t[0], t[1]))
            return PolicyDecision(r.n_a, r.n_e, r.n_a + r.n_e, True)
        if feasible:
            _, _, r = min(feasible, key=lambda t: (t[0], t[1]))  # most balanced
            return PolicyDecision(r.n_a, r.n_e, r.n_a + r.n_e, True)
        if violating:
            _, _, r = min(violating, key=lambda t: (t[0], t[1]))
            return PolicyDecision(r.n_a, r.n_e, r.n_a + r.n_e, False)
        return PolicyDecision(scaler.n_max, scaler.n_max, 2 * scaler.n_max, False)


class FixedUnitPolicy:
    """xDeepServe-style: scale in fixed units of ``unit`` GPUs, split evenly."""

    def __init__(self, unit: int = 4):
        self.unit = unit

    def decide(self, scaler, demand: float, slo: float) -> PolicyDecision:
        total = self.unit
        while total <= 2 * scaler.n_max:
            n_e = max(scaler.n_e_min, total // 2)
            n_a = total - n_e
            if n_a < 1:
                total += self.unit
                continue
            r = scaler.evaluate(demand, slo, n_a, n_e)
            if r is not None and r.tpot <= slo:
                return PolicyDecision(n_a, n_e, n_a + n_e, True)
            total += self.unit
        return PolicyDecision(scaler.n_max, scaler.n_max, 2 * scaler.n_max, False)
