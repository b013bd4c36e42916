"""Arrival processes and the trace-replay workload file
(``repro.serving.trace``), numpy only.

Generators: Poisson, BurstGPT-like bursty arrivals, and the diurnal
production trace shapes of the paper's Fig. 4 / Fig. 11.

Workload file: :class:`TraceSpec`, a JSON-serialisable multi-tenant trace
(per-tenant request class, arrival process, priority, TTFT/TPOT SLOs) whose
``build()`` yields one merged request list for the ``ServingEngine`` on
either executor.  The JSON of either package loads in the other, and
``build()`` draws the reference's requests exactly."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request, WorkloadSpec, sample_requests


def poisson_arrivals(rate: float, duration: float, seed: int = 0) -> np.ndarray:
    """Constant-rate Poisson arrivals over [0, duration) (seconds)."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(rate * duration)
    return np.sort(rng.uniform(0, duration, size=n))


def bursty_arrivals(
    mean_rate: float,
    duration: float,
    burstiness: float = 2.0,
    epoch: float = 10.0,
    seed: int = 0,
) -> np.ndarray:
    """BurstGPT-style doubly-stochastic arrivals: the rate itself follows a
    Gamma process over ``epoch``-second windows (CV² ≈ burstiness)."""
    rng = np.random.default_rng(seed)
    times = []
    t = 0.0
    shape = 1.0 / max(1e-6, burstiness)
    while t < duration:
        lam = rng.gamma(shape, mean_rate / shape)
        n = rng.poisson(lam * epoch)
        times.append(rng.uniform(t, t + epoch, size=n))
        t += epoch
    return np.sort(np.concatenate(times)) if times else np.array([])


def diurnal_rate_profile(
    hours: float = 24.0,
    step_minutes: float = 15.0,
    mean_rate: float = 100.0,
    peak_over_mean: float = 2.5,
    burst_peak_over_mean: float = 7.5,
    n_bursts: int = 3,
    seed: int = 0,
    period_hours: float = 24.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(window start times [s], per-window mean rates) — the Fig. 4 shape:
    diurnal sinusoid plus sporadic bursts reaching ~7.5× the mean.  Set
    ``period_hours = hours`` to compress one full day into a short trace
    window (what :class:`TraceSpec` does for diurnal tenants)."""
    rng = np.random.default_rng(seed)
    n = int(hours * 60 / step_minutes)
    t = np.arange(n) * step_minutes * 60.0
    phase = 2 * np.pi * (t / 3600.0 % period_hours) / period_hours
    base = 1.0 + (peak_over_mean - 1.0) * 0.5 * (1 - np.cos(phase))
    rates = base / base.mean() * mean_rate
    for _ in range(n_bursts):
        i = rng.integers(n // 8, n)
        width = max(1, int(rng.integers(1, 4)))
        rates[i : i + width] *= burst_peak_over_mean / peak_over_mean
    return t, rates


def arrivals_from_profile(
    window_starts: np.ndarray, rates: np.ndarray, seed: int = 0
) -> np.ndarray:
    """Poisson arrivals following a piecewise-constant rate profile."""
    rng = np.random.default_rng(seed)
    dt = window_starts[1] - window_starts[0] if len(window_starts) > 1 else 60.0
    times = []
    for t0, lam in zip(window_starts, rates):
        n = rng.poisson(lam * dt)
        times.append(rng.uniform(t0, t0 + dt, size=n))
    return np.sort(np.concatenate(times)) if times else np.array([])


# ---------------------------------------------------------------------------
# Multi-tenant trace spec (the workload file)
# ---------------------------------------------------------------------------

# Request-class length presets (WorkloadSpec overrides win over these):
# chat = short interactive turns, long-context = document-QA/RAG prompts,
# batch-offline = throughput jobs with long generations and no latency needs.
CLASS_PRESETS: Dict[str, Dict[str, float]] = {
    "chat": dict(mean_input=16.0, mean_output=48.0, max_input=64, max_output=128),
    "long-context": dict(
        mean_input=512.0, mean_output=64.0, max_input=4096, max_output=256
    ),
    "batch-offline": dict(
        mean_input=32.0, mean_output=256.0, max_input=128, max_output=1024
    ),
}

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass
class TenantSpec:
    """One tenant's slice of a trace: request class, arrival process, and the
    scheduling contract (priority + SLOs) its requests carry."""

    name: str
    klass: str = "chat"  # chat | long-context | batch-offline
    rate: float = 1.0  # mean requests/s over the trace
    arrival: str = "poisson"  # poisson | bursty | diurnal
    burstiness: float = 2.0  # bursty: CV² of the Gamma-modulated rate
    epoch: float = 10.0  # bursty: rate-modulation window (s)
    priority: int = 0  # higher preempts lower under sched="priority"
    ttft_slo: Optional[float] = None  # s, arrival → first token
    tpot_slo: Optional[float] = None  # s, p99 inter-token gap
    deadline: Optional[float] = None  # s after arrival; lapsed → rejected
    workload: Dict = field(default_factory=dict)  # WorkloadSpec overrides
    seed: Optional[int] = None  # None → derived from TraceSpec.seed

    def workload_spec(self, vocab_size: int, seed: int) -> WorkloadSpec:
        if self.klass not in CLASS_PRESETS:
            raise ValueError(
                f"unknown request class {self.klass!r}; choose from "
                f"{sorted(CLASS_PRESETS)}"
            )
        kw = dict(CLASS_PRESETS[self.klass])
        kw.update(self.workload)
        kw.setdefault("vocab_size", vocab_size)
        kw["seed"] = seed
        return WorkloadSpec(**kw)

    def arrivals(self, duration: float, seed: int) -> np.ndarray:
        if self.arrival == "poisson":
            arr = poisson_arrivals(self.rate, duration, seed=seed)
        elif self.arrival == "bursty":
            arr = bursty_arrivals(
                self.rate,
                duration,
                burstiness=self.burstiness,
                epoch=min(self.epoch, duration),
                seed=seed,
            )
        elif self.arrival == "diurnal":
            # compress one full synthetic day into the trace window so short
            # traces still sweep trough → peak → trough
            hours = duration / 3600.0
            t, rates = diurnal_rate_profile(
                hours=hours,
                step_minutes=duration / 60.0 / 96.0,  # 96 windows per trace
                mean_rate=self.rate,
                seed=seed,
                period_hours=hours,
            )
            arr = arrivals_from_profile(t, rates, seed=seed)
        else:
            raise ValueError(
                f"unknown arrival process {self.arrival!r}; choose from "
                f"{ARRIVAL_PROCESSES}"
            )
        return arr[arr < duration]


@dataclasses.dataclass
class TraceSpec:
    """A complete replayable workload: duration, seed, and tenant mix.

    ``to_json``/``from_json`` make it a file format; ``build()``
    deterministically expands it into one merged, arrival-sorted request
    list."""

    duration: float = 60.0
    seed: int = 0
    tenants: List[TenantSpec] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "duration": self.duration,
                "seed": self.seed,
                "tenants": [dataclasses.asdict(t) for t in self.tenants],
            },
            indent=2,
        )

    @staticmethod
    def from_json(text: str) -> "TraceSpec":
        d = json.loads(text)
        return TraceSpec(
            duration=float(d.get("duration", 60.0)),
            seed=int(d.get("seed", 0)),
            tenants=[TenantSpec(**t) for t in d.get("tenants", [])],
        )

    def build(
        self, vocab_size: int = 32_000, with_prompts: bool = False
    ) -> List[Request]:
        """Expand the spec into one merged request list: per-tenant arrivals
        and lengths, stamped with the tenant's priority/SLOs/deadline, merged
        by arrival time, rids re-assigned globally (rid seeds the synthetic
        prompt when prompts are generated lazily, so the re-assignment must
        happen before any replay)."""
        merged: List[Request] = []
        for i, t in enumerate(self.tenants):
            seed = t.seed if t.seed is not None else self.seed * 1009 + i
            arr = t.arrivals(self.duration, seed)
            spec = t.workload_spec(vocab_size, seed)
            reqs = sample_requests(spec, arr, with_prompts=with_prompts)
            for r in reqs:
                r.tenant = t.name
                r.klass = t.klass
                r.priority = t.priority
                r.ttft_slo = t.ttft_slo
                r.tpot_slo = t.tpot_slo
                if t.deadline is not None:
                    r.deadline = r.arrival + t.deadline
            merged.extend(reqs)
        # deterministic merge: arrival, then tenant name breaks exact ties
        merged.sort(key=lambda r: (r.arrival, r.tenant, r.rid))
        for i, r in enumerate(merged):
            r.rid = i
        return merged
