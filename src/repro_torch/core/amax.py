"""Synthetic routing traces and co-activation statistics (``repro.core.amax``),
the inputs :func:`repro_torch.core.placement.build_layout` plans from."""

from __future__ import annotations

import numpy as np


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


def coactivation_matrix(trace: np.ndarray, num_experts: int) -> np.ndarray:
    """a(e, e'): co-activation frequency within a token (Appendix B)."""
    A = np.zeros((num_experts, num_experts), np.float64)
    for row in trace:
        for i in range(len(row)):
            for j in range(i + 1, len(row)):
                A[row[i], row[j]] += 1
                A[row[j], row[i]] += 1
    return A / max(1, trace.shape[0])
