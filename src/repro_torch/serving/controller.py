"""Autoscaling controller (``repro.serving.controller``): demand estimation
and SLO-aware scaling, actuated on a live disaggregated engine.

:class:`AutoScaler` wraps :class:`repro_torch.core.scaling.SLOScaler` with a
sliding-window demand estimator.  Expert placement is re-derived from the
recent routing trace when the MoE pool changes (§3.5 "expert placement").
:meth:`AutoScaler.actuate` applies a decision to a
``ServingEngine(executor="disagg")`` through ``engine.reconfigure``: the
prefill, attention and MoE pool counts move independently mid-run, only the
pools that changed are rebuilt, and in-flight KV caches are kept.

The prefill pool scales on its own signal: prompt tokens/s over the window
(:meth:`AutoScaler.observe`'s ``input_tokens``) over the per-device prefill
rate ``prefill_tok_rate``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.placement import build_layout
from repro_torch.core.scaling import EvalResult, PerfModel, SLOScaler


@dataclasses.dataclass
class ScalingEvent:
    t: float
    demand: float
    n_a: int
    n_e: int
    tpot: float
    feasible: bool
    n_p: Optional[int] = None  # prefill pool decision (None = not scaled)


class AutoScaler:
    def __init__(
        self,
        model: PerfModel,
        slo: float,
        n_max: int = 16,
        window: float = 300.0,
        hysteresis: float = 0.1,  # stored, read by nothing: the reference's only use is a no-op branch
        prefill_tok_rate: float = 0.0,  # prompt tokens/s one prefill device sustains
        n_prefill_max: Optional[int] = None,
        kv_pressure_threshold: float = 0.9,  # paged-pool occupancy that forces +1 attn
        objective: str = "min_devices",  # min_devices | slo_per_device
        demand_samples_k: int = 6,  # sub-windows scored by slo_per_device
    ):
        self.scaler = SLOScaler(model, n_max=n_max)
        self.slo = slo
        self.window = window
        self.hysteresis = hysteresis
        self.prefill_tok_rate = prefill_tok_rate
        self.n_prefill_max = n_prefill_max if n_prefill_max is not None else n_max
        self.kv_pressure_threshold = kv_pressure_threshold
        if objective not in ("min_devices", "slo_per_device"):
            raise ValueError(
                f"unknown objective {objective!r}; choose min_devices or slo_per_device"
            )
        self.objective = objective
        self.demand_samples_k = demand_samples_k
        self._arrivals: List[float] = []
        self._tokens: List[float] = []
        self._input_tokens: List[float] = []
        self._accepted: List[float] = []  # per-observation accepted tokens/step
        self._kv_obs: List[tuple] = []  # (t, paged-pool occupancy) samples
        # engine-sampled rates (read by actuate from metrics()): speculative
        # acceptance, the fallback discount for observations without their
        # own, and the prompt share the prefix cache served
        self._spec_accept_rate = 0.0
        self._prefix_saved_frac = 0.0
        self.current: Optional[EvalResult] = None
        self.events: List[ScalingEvent] = []
        self.device_losses: List[tuple] = []  # (t, pool) permanent losses seen

    # -- fault feedback --------------------------------------------------------
    def on_device_loss(self, pool: str, now: float) -> None:
        """A permanent device loss caps the search: decode pools cap the
        (n_a, n_e) bound, prefill its own."""
        if pool == "prefill":
            self.n_prefill_max = max(1, self.n_prefill_max - 1)
        else:
            self.scaler.n_max = max(1, self.scaler.n_max - 1)
        self.device_losses.append((now, pool))

    def attach(self, engine) -> None:
        """Subscribe to the engine's fault events (``engine.fault_listeners``),
        so lost capacity feeds the next decision."""
        engine.fault_listeners.append(lambda fault, t: self.on_device_loss(fault.pool, t))

    # -- demand estimation ---------------------------------------------------
    def observe(
        self,
        t: float,
        tokens: float,
        input_tokens: float = 0.0,
        kv_occupancy: float = 0.0,
        saved_input_tokens: float = 0.0,
        accepted_per_step: float = 0.0,
    ) -> None:
        """Log one arrival: ``tokens`` drives decode scaling, ``input_tokens``
        less ``saved_input_tokens`` (a prefix-cache hit) the prefill pool,
        ``kv_occupancy`` (paged pool fill, 0..1) memory pressure;
        ``accepted_per_step`` (speculative decode, >= 1) discounts the
        request's decode-step demand."""
        self._arrivals.append(t)
        self._tokens.append(tokens)
        self._input_tokens.append(max(0.0, input_tokens - saved_input_tokens))
        self._accepted.append(float(accepted_per_step))
        if kv_occupancy > 0.0:
            self._kv_obs.append((t, float(kv_occupancy)))

    def _step_demand(self, tokens: float, accepted: float) -> float:
        """Tokens over the acceptance rate (its own, else the engine's, else
        1), clamped to >= 1: a verify step emits at least one token."""
        eff = accepted if accepted > 0 else self._spec_accept_rate
        return tokens / max(1.0, eff)

    def demand(self, now: float) -> float:
        lo = now - self.window
        tok = sum(
            self._step_demand(tk, acc)
            for t, tk, acc in zip(self._arrivals, self._tokens, self._accepted)
            if t >= lo
        )
        return tok / self.window

    def prefill_demand(self, now: float) -> float:
        """Prompt tokens/s over the sliding window."""
        lo = now - self.window
        tok = sum(tk for t, tk in zip(self._arrivals, self._input_tokens) if t >= lo)
        return tok / self.window

    def kv_pressure(self, now: float) -> float:
        """Worst paged-KV occupancy seen in the window (0.0 without samples)."""
        lo = now - self.window
        occ = [o for t, o in self._kv_obs if t >= lo]
        return max(occ) if occ else 0.0

    def demand_samples(self, now: float) -> List[float]:
        """Per-sub-window demand (tokens/s) over the window: the burstiness
        the mean hides, which ``slo_per_device`` scores candidates against."""
        k = max(1, self.demand_samples_k)
        lo = now - self.window
        sub = self.window / k
        buckets = [0.0] * k
        for t, tok, acc in zip(self._arrivals, self._tokens, self._accepted):
            if t >= lo:
                buckets[min(k - 1, max(0, int((t - lo) / sub)))] += self._step_demand(tok, acc)
        return [b / sub for b in buckets]

    def decide_prefill(self, now: float, demand: Optional[float] = None) -> Optional[int]:
        """Prefill devices enough to keep prompt-token demand under the
        per-device rate, independently of the decode pools; None when no
        rate is set (prefill scaling off)."""
        if self.prefill_tok_rate <= 0:
            return None
        lam_in = demand if demand is not None else self.prefill_demand(now)
        # the prompt share a warm prefix cache serves never reaches the pool
        lam_in *= max(0.0, 1.0 - self._prefix_saved_frac)
        if lam_in <= 0:
            return 1  # one warm device keeps admission pipelined
        n_p = int(np.ceil(lam_in / self.prefill_tok_rate))
        return max(1, min(n_p, self.n_prefill_max))

    # -- decision -------------------------------------------------------------
    def _decide_slo_per_device(self, lam: float, samples: List[float]) -> Optional[EvalResult]:
        """Score each (n_a, n_e) by the share of demand samples it holds
        feasibly over its device count; the stored result is evaluated at
        the mean demand (else the heaviest feasible sample)."""
        live = [s for s in samples if s > 0]
        if not live:
            return self.scaler.scale(lam, self.slo)
        best: Optional[EvalResult] = None
        best_score = 0.0
        for n_a in range(1, self.scaler.n_max + 1):
            for n_e in range(self.scaler.n_e_min, self.scaler.n_max + 1):
                evs = [self.scaler.evaluate(s, self.slo, n_a, n_e) for s in live]
                att = float(np.mean([e is not None and e.feasible for e in evs]))
                if att <= 0.0:
                    continue
                score = att / (n_a + n_e)
                if score > best_score + 1e-12:
                    ev = self.scaler.evaluate(lam, self.slo, n_a, n_e)
                    if ev is None:
                        ev = next(e for e in evs if e is not None)
                    best, best_score = ev, score
        return best

    def decide(self, now: float, demand: Optional[float] = None) -> EvalResult:
        lam = demand if demand is not None else self.demand(now)
        if self.objective == "slo_per_device":
            best = self._decide_slo_per_device(lam, self.demand_samples(now))
        else:
            best = self.scaler.scale(lam, self.slo)
        if best is None:
            # infeasible: run at the largest configuration
            best = self.scaler.model.tpot(1.0, self.scaler.n_max, self.scaler.n_max)
            best.feasible = False
        # a near-full paged pool makes attention KV-bound even when latency
        # looks fine: add one attention device before admission stalls
        if best.feasible and self.kv_pressure(now) >= self.kv_pressure_threshold:
            best = dataclasses.replace(best, n_a=min(best.n_a + 1, self.scaler.n_max))
        self.current = best
        self.events.append(ScalingEvent(now, lam, best.n_a, best.n_e, best.tpot, best.feasible))
        return best

    def replan_layout(self, trace: np.ndarray, n_e: int):
        cfg = self.scaler.model.cfg
        return build_layout(trace, cfg.num_experts, n_e, self.scaler.model.C)

    # -- actuation --------------------------------------------------------------
    def actuate(self, engine, now: float, trace: Optional[np.ndarray] = None) -> EvalResult:
        """Decide and apply: reconfigure the engine's pools to the decision,
        replanning expert placement from ``trace`` when the MoE pool changes.
        A disagg engine is required (checked before any state changes)."""
        cur = getattr(engine, "disagg", None)
        if cur is None:
            raise ValueError(
                "actuate requires ServingEngine(executor='disagg'); "
                "use decide() for advisory-only scaling"
            )
        m = engine.metrics()
        pages = m.get("kv_pages")
        if pages is not None:
            self._kv_obs.append((now, float(pages.get("occupancy", 0.0))))
        prefix = m.get("prefix_cache")
        if prefix is not None:
            self._prefix_saved_frac = float(prefix.get("saved_frac", 0.0))
        spec = m.get("spec")
        if spec is not None:
            self._spec_accept_rate = float(spec.get("accepted_per_step", 0.0))
        best = self.decide(now)
        # prefill devices pay off only under pipelined admission
        n_p = self.decide_prefill(now) if getattr(engine, "admission", None) == "pipelined" else None
        if self.events:
            self.events[-1] = dataclasses.replace(self.events[-1], n_p=n_p)
        changed_e = best.n_e != len(cur.pools.moe_devices)
        layout = self.replan_layout(trace, best.n_e) if trace is not None and changed_e else None
        engine.reconfigure(n_attn=best.n_a, n_moe=best.n_e, layout=layout, n_prefill=n_p)
        return best
