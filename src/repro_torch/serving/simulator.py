"""Trace-driven cluster simulator (Fig. 11; ``repro.serving.simulator``),
the paper's method for the 24-hour scaling study: "we evaluate scaling
behavior through trace-driven simulation using the measured performance of
various systems".

Given a rate profile (15-minute windows), each policy picks a configuration
per window using the shared performance model
(:class:`~repro_torch.core.scaling.PerfModel`); the simulator accumulates
GPU-hours and SLO attainment.  Janus is the
:class:`~repro_torch.core.scaling.SLOScaler` (Algorithm 2); the baselines
are ``core/baselines.py``'s policies under the reference's names:
``sglang`` (:class:`MonolithicPolicy`), ``megascale``
(:class:`CoupledPolicy`) and ``xdeepserve`` (:class:`FixedUnitPolicy`).
It is numpy on the host and needs no card; every record equals the
reference's (the same float64 arithmetic in the same order).  Its times
are analytic, from the model's ``HardwareSpec`` constants.

Two demand paths, one workload:

* ``run_janus``/``run_policy``/``compare`` take a rate profile plus either a
  ``tokens_per_req`` scalar or a :class:`WorkloadSpec`; with a spec, the
  per-request token demand is measured through the *same* sampler
  ``sample_requests`` uses (``expected_tokens_per_request``), so the
  analytic simulator and the replayed engine see one distribution;
* ``replay`` takes a concrete request list (e.g. ``TraceSpec.build()``) and
  bins the requests' actual arrivals and sampled output lengths into
  windows: the identical workload the engine serves, pushed through every
  scaling policy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.baselines import (
    CoupledPolicy,
    FixedUnitPolicy,
    MonolithicPolicy,
    PolicyDecision,
)
from repro_torch.core.scaling import PerfModel, SLOScaler
from repro_torch.serving.request import Request, WorkloadSpec, expected_tokens_per_request


@dataclasses.dataclass
class WindowRecord:
    t: float
    demand: float
    n_a: int
    n_e: int
    total_gpus: int
    tpot: float
    slo_ok: bool


@dataclasses.dataclass
class SimResult:
    records: List[WindowRecord]

    @property
    def gpu_hours(self) -> float:
        if not self.records:
            return 0.0
        dt_h = np.diff([r.t for r in self.records] + [2 * self.records[-1].t - self.records[-2].t]).mean() / 3600.0
        return float(sum(r.total_gpus for r in self.records) * dt_h)

    @property
    def slo_attainment(self) -> float:
        if not self.records:
            return 0.0
        return float(np.mean([r.slo_ok for r in self.records]))

    @property
    def mean_gpus(self) -> float:
        if not self.records:
            return 0.0
        return float(np.mean([r.total_gpus for r in self.records]))

    @property
    def slo_per_device(self) -> float:
        """SLO attainment per occupied device — the fig9 framing: a policy
        that attains the SLO with fewer devices scores higher than one that
        buys attainment with idle capacity."""
        return self.slo_attainment / max(self.mean_gpus, 1e-9)


class ClusterSimulator:
    """Replays a rate profile (or a concrete request list) through scaling
    policies."""

    def __init__(self, model: PerfModel, slo: float, n_max: int = 32):
        self.model = model
        self.slo = slo
        self.n_max = n_max

    # -- demand resolution ---------------------------------------------------
    def _tokens_per_req(
        self, tokens_per_req: Optional[float], spec: Optional[WorkloadSpec]
    ) -> float:
        if tokens_per_req is not None:
            return float(tokens_per_req)
        if spec is None:
            raise ValueError("pass tokens_per_req or a WorkloadSpec (spec=)")
        return expected_tokens_per_request(spec)

    # -- window engines ------------------------------------------------------
    def _run_windows(self, policy, window_starts, lams) -> SimResult:
        """One policy over per-window token demand ``lams`` (tokens/s).
        ``policy=None`` is the Janus SLOScaler (Algorithm 2); anything else
        is a baseline with a ``decide`` method."""
        scaler = SLOScaler(self.model, n_max=self.n_max)
        recs = []
        for t, lam in zip(window_starts, lams):
            if policy is None:
                best = scaler.scale(lam, self.slo)
                if best is None:
                    n_a = n_e = self.n_max
                    ev = self.model.tpot(1.0, n_a, n_e)
                    recs.append(
                        WindowRecord(t, lam, n_a, n_e, n_a + n_e, ev.tpot, False)
                    )
                else:
                    recs.append(
                        WindowRecord(
                            t, lam, best.n_a, best.n_e, best.n_a + best.n_e,
                            best.tpot, best.tpot <= self.slo,
                        )
                    )
            else:
                d: PolicyDecision = policy.decide(scaler, lam, self.slo)
                ev = scaler.evaluate(lam, self.slo, d.n_a, d.n_e)
                tpot = ev.tpot if ev is not None else float("inf")
                recs.append(
                    WindowRecord(
                        t, lam, d.n_a, d.n_e, d.total_gpus, tpot,
                        d.feasible and tpot <= self.slo,
                    )
                )
        return SimResult(recs)

    # -- rate-profile API ----------------------------------------------------
    def run_janus(
        self,
        window_starts,
        rates,
        tokens_per_req: Optional[float] = None,
        spec: Optional[WorkloadSpec] = None,
    ) -> SimResult:
        tpr = self._tokens_per_req(tokens_per_req, spec)
        return self._run_windows(None, window_starts, np.asarray(rates) * tpr)

    def run_policy(
        self,
        policy,
        window_starts,
        rates,
        tokens_per_req: Optional[float] = None,
        spec: Optional[WorkloadSpec] = None,
    ) -> SimResult:
        tpr = self._tokens_per_req(tokens_per_req, spec)
        return self._run_windows(policy, window_starts, np.asarray(rates) * tpr)

    def compare(
        self,
        window_starts,
        rates,
        tokens_per_req: Optional[float] = None,
        spec: Optional[WorkloadSpec] = None,
    ) -> Dict[str, SimResult]:
        tpr = self._tokens_per_req(tokens_per_req, spec)
        lams = np.asarray(rates) * tpr
        return {
            "janus": self._run_windows(None, window_starts, lams),
            "sglang": self._run_windows(MonolithicPolicy(), window_starts, lams),
            "megascale": self._run_windows(CoupledPolicy(), window_starts, lams),
            "xdeepserve": self._run_windows(FixedUnitPolicy(), window_starts, lams),
        }

    # -- request-replay API --------------------------------------------------
    @staticmethod
    def window_demand(
        requests: Sequence[Request], window_s: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Bin a concrete request list into ``window_s``-second windows of
        token demand (tokens/s): each request contributes its *sampled*
        output length to its arrival window — no re-sampling, no drift from
        what the engine actually serves."""
        if not requests:
            return np.array([]), np.array([])
        t_end = max(r.arrival for r in requests)
        n = max(1, int(np.ceil((t_end + 1e-9) / window_s)))
        starts = np.arange(n) * window_s
        toks = np.zeros(n)
        for r in requests:
            toks[min(n - 1, int(r.arrival // window_s))] += r.output_len
        return starts, toks / window_s

    def replay(
        self, requests: Sequence[Request], window_s: float = 60.0
    ) -> Dict[str, SimResult]:
        """Replay a request list (e.g. ``TraceSpec.build()`` — the same list
        the engine serves) through every scaling policy."""
        starts, lams = self.window_demand(requests, window_s)
        return {
            "janus": self._run_windows(None, starts, lams),
            "sglang": self._run_windows(MonolithicPolicy(), starts, lams),
            "megascale": self._run_windows(CoupledPolicy(), starts, lams),
            "xdeepserve": self._run_windows(FixedUnitPolicy(), starts, lams),
        }
