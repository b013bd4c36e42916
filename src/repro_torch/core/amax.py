"""a_max estimation, Janus §3.5 and Appendix A (``repro.core.amax``, numpy
only): the most distinct activated experts on any MoE instance,
``a_max(n_e, B)``.

* :func:`amax_bound`: the closed-form balls-into-bins bound (Eq. 4-5),
  one-sided (it never under-predicts);
* :class:`MonteCarloAmax`: the estimator used at decision time, which replays
  B-token samples of a recent routing trace through the scheduler and the
  replica layout;
* synthetic routing traces (uniform and Zipf-skewed top-k) and the
  co-activation statistics :func:`repro_torch.core.placement.build_layout`
  plans from.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.aebs import ReplicaLayout, aebs_numpy


def expected_instance_load(probs_on_g: np.ndarray, batch: int) -> float:
    """E[a_g] <= sum over e in P(g) of [1 - (1 - p_e)^B]   (Eq. 4)."""
    return float(np.sum(1.0 - np.power(1.0 - probs_on_g, batch)))


def amax_bound(
    n_e: int,
    batch: int,
    num_experts: int,
    top_k: int,
    capacity: int,
    probs: Optional[np.ndarray] = None,
    layout: Optional[ReplicaLayout] = None,
) -> float:
    """Eq. 5: a_max <= ceil(min(C, a + sqrt(2 a ln n_e)) + 1), where a
    maximises Eq. 4 over the layout's instances given per-expert
    probabilities, or is the symmetric p_e = K/E case without a layout."""
    if probs is None:
        probs = np.full(num_experts, top_k / num_experts)
    probs = np.minimum(probs, 1.0)
    if layout is not None:
        a_bar = 0.0
        for g in range(layout.num_instances):
            hosted = layout.slot_to_expert[g]
            hosted = np.unique(hosted[hosted >= 0])
            a_bar = max(a_bar, expected_instance_load(probs[hosted], batch))
    else:
        per_inst = math.ceil(num_experts / n_e)
        a_bar = per_inst * (1.0 - (1.0 - top_k / num_experts) ** batch)
    bound = min(capacity, a_bar + math.sqrt(2.0 * a_bar * max(math.log(n_e), 0.0)))
    return math.ceil(bound + 1.0)


def make_routing_trace(
    num_tokens: int,
    num_experts: int,
    top_k: int,
    skew: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Per-token top-k expert ids, [num_tokens, top_k] int32.  ``skew = 0`` is
    uniform routing; ``skew > 0`` Zipf-like popularity with hot experts at
    random ids."""
    rng = np.random.default_rng(seed)
    if skew <= 0:
        w = np.ones(num_experts)
    else:
        w = 1.0 / np.power(np.arange(1, num_experts + 1), skew)
        w = rng.permutation(w)
    p = w / w.sum()
    out = np.empty((num_tokens, top_k), np.int32)
    for t in range(num_tokens):
        out[t] = rng.choice(num_experts, size=top_k, replace=False, p=p)
    return out


def trace_expert_probs(trace: np.ndarray, num_experts: int) -> np.ndarray:
    """Per-token activation probability p_e estimated from a trace."""
    counts = np.bincount(trace.reshape(-1), minlength=num_experts).astype(np.float64)
    return counts / max(1, trace.shape[0])


def coactivation_matrix(trace: np.ndarray, num_experts: int) -> np.ndarray:
    """a(e, e'): co-activation frequency within a token (Appendix B)."""
    A = np.zeros((num_experts, num_experts), np.float64)
    for row in trace:
        for i in range(len(row)):
            for j in range(i + 1, len(row)):
                A[row[i], row[j]] += 1
                A[row[j], row[i]] += 1
    return A / max(1, trace.shape[0])


SchedulerNumpy = Callable[[np.ndarray, ReplicaLayout], Tuple[np.ndarray, np.ndarray, object]]


@dataclasses.dataclass
class MonteCarloAmax:
    """a_max(n_e, B) estimated by replaying B-token samples of the trace
    through the scheduler and the layout (Janus §3.5), cached per layout and
    batch."""

    trace: np.ndarray  # [N, k] recent routing decisions
    num_experts: int
    trials: int = 16
    seed: int = 0
    scheduler: SchedulerNumpy = staticmethod(lambda e, l: aebs_numpy(e, l))

    def __post_init__(self):
        self._cache: Dict[Tuple[int, int, int, int], float] = {}

    def estimate(self, layout: ReplicaLayout, batch: int) -> float:
        key = (layout.num_instances, layout.capacity, batch, hash(layout.slot_to_expert.tobytes()))
        if key in self._cache:
            return self._cache[key]
        rng = np.random.default_rng(self.seed + batch)
        n = self.trace.shape[0]
        vals = []
        for _ in range(self.trials):
            idx = rng.integers(0, n, size=min(batch, n))
            _, load, _ = self.scheduler(self.trace[idx], layout)
            vals.append(int(np.max(load)))
        est = float(np.mean(vals))
        self._cache[key] = est
        return est
