"""Fine-grained, SLO-aware resource scaling, Janus §3.5 (Eq. 1-3, Alg. 2)
(``repro.core.scaling``, numpy and ``math`` only).

Performance model (Eq. 1):
    TPOT = sum over layers of [T_attn + T_moe + T_comm]
    T_attn = max(c_a, alpha b + c_kv b S_ctx)    (roofline plateau + growth)
    T_moe  = beta a_max(n_e, B) + c_e            (linear in activated experts)
    T_comm = the adaptive two-phase cost model (:mod:`repro_torch.core.comm`)

Coefficients are derived from the model config and a hardware spec;
:meth:`PerfModel.calibrate` takes measured overrides.  The output is the
model's prediction for that spec, not a measurement.

Steady-state batch (Eq. 2, Little's law): B* = lambda TPOT(B*), solved by a
bounded monotone bisection.  The scaler (Algorithm 2) enumerates (n_a, n_e),
prunes infeasible candidates and returns the SLO-feasible configuration with
the fewest devices, beside the whole evaluated search space.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import comm as comm_mod
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.amax import MonteCarloAmax, amax_bound
from repro_torch.core.comm import TPU_V5E, HardwareSpec


@dataclasses.dataclass
class LayerCoeffs:
    """Per-layer coefficients of Eq. 1 (seconds)."""

    c_a: float  # attention memory-bound plateau
    alpha: float  # attention compute per token
    c_kv: float  # KV-cache read per token per context unit
    beta: float  # MoE time per distinct activated expert
    c_e: float  # MoE constant (launch + shared expert)
    t_ffn: float  # dense-FFN time (non-MoE layers), weight-read bound

    @staticmethod
    def from_config(cfg, hw: HardwareSpec = TPU_V5E) -> "LayerCoeffs":
        bp = cfg.bytes_per_param()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nh, nkv = max(1, cfg.num_heads), max(1, cfg.num_kv_heads)
        attn_params = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        c_a = attn_params * bp / hw.hbm_bw + hw.kernel_launch
        alpha = 2.0 * attn_params / hw.peak_flops
        c_kv = 2.0 * nkv * hd * bp / hw.hbm_bw
        if cfg.has_moe:
            expert_bytes = 3 * d * cfg.d_ff_expert * bp
            beta = expert_bytes / hw.hbm_bw
            c_e = hw.kernel_launch + cfg.num_shared_experts * expert_bytes / hw.hbm_bw
            t_ffn = 0.0
        else:
            beta = 0.0
            c_e = 0.0
            glu = 3 if cfg.ffn_activation in ("swiglu", "geglu") else 2
            t_ffn = (glu * d * cfg.d_ff * bp) / hw.hbm_bw + hw.kernel_launch
        return LayerCoeffs(c_a, alpha, c_kv, beta, c_e, t_ffn)


@dataclasses.dataclass
class EvalResult:
    n_a: int
    n_e: int
    batch: float
    tpot: float
    t_attn: float
    t_moe: float
    t_comm: float
    a_max: float
    tpg: float  # tokens/s per device
    feasible: bool


class PerfModel:
    def __init__(
        self,
        cfg,
        hw: HardwareSpec = TPU_V5E,
        amax_estimator: Optional[MonteCarloAmax] = None,
        slots_per_instance: Optional[int] = None,
        layout_fn: Optional[Callable[[int], ReplicaLayout]] = None,
        s_ctx: float = 1024.0,
    ):
        self.cfg = cfg
        self.hw = hw
        self.coeffs = LayerCoeffs.from_config(cfg, hw)
        self.s_ctx = s_ctx
        self.amax_est = amax_estimator
        if slots_per_instance is None and cfg.has_moe:
            expert_bytes = 3 * cfg.d_model * cfg.d_ff_expert * cfg.bytes_per_param()
            budget = 0.7 * hw.mem_bytes / max(1, cfg.num_layers)
            slots_per_instance = max(1, int(budget // expert_bytes))
        self.C = slots_per_instance or 1
        self._layout_cache: Dict[int, ReplicaLayout] = {}
        self._layout_fn = layout_fn

    def calibrate(self, **measured: float) -> None:
        """Override analytic coefficients with measured values."""
        for k, v in measured.items():
            if not hasattr(self.coeffs, k):
                raise KeyError(k)
            setattr(self.coeffs, k, v)

    def layout_for(self, n_e: int) -> ReplicaLayout:
        if n_e not in self._layout_cache:
            if self._layout_fn is not None:
                self._layout_cache[n_e] = self._layout_fn(n_e)
            else:
                self._layout_cache[n_e] = ReplicaLayout.round_robin(self.cfg.num_experts, n_e, self.C)
        return self._layout_cache[n_e]

    # -- Eq. 1 terms ----------------------------------------------------------
    def amax(self, n_e: int, batch: float) -> float:
        if not self.cfg.has_moe:
            return 1.0
        b = max(1, int(round(batch)))
        if self.amax_est is not None:
            return self.amax_est.estimate(self.layout_for(n_e), b)
        return amax_bound(n_e, b, self.cfg.num_experts, self.cfg.top_k, self.C)

    def t_attn(self, local_batch: float) -> float:
        c = self.coeffs
        return max(c.c_a, c.alpha * local_batch + c.c_kv * local_batch * self.s_ctx)

    def t_moe(self, n_e: int, batch: float) -> Tuple[float, float]:
        c = self.coeffs
        if not self.cfg.has_moe:
            return c.t_ffn, 1.0
        a = self.amax(n_e, batch)
        return c.beta * a + c.c_e, a

    def t_comm(self, n_a: int, n_e: int, batch: float, scheme: str = "2pc") -> float:
        if not self.cfg.has_moe:
            return 0.0
        return comm_mod.layer_comm_time(
            n_a, n_e, max(1, int(round(batch))), self.cfg.d_model, self.hw,
            self.cfg.bytes_per_param(), scheme=scheme, top_k=self.cfg.top_k,
            num_experts=self.cfg.num_experts,
        )

    def tpot(self, batch: float, n_a: int, n_e: int, scheme: str = "2pc") -> EvalResult:
        L = self.cfg.num_layers
        ta = self.t_attn(batch / n_a)
        tm, a = self.t_moe(n_e, batch)
        tc = self.t_comm(n_a, n_e, batch, scheme)
        tpot = L * (ta + tm + tc)
        tpg = batch / tpot / (n_a + n_e) if tpot > 0 else 0.0
        return EvalResult(n_a, n_e, batch, tpot, L * ta, L * tm, L * tc, a, tpg, True)

    # -- memory feasibility ----------------------------------------------------
    def _attn_side_bytes(self) -> float:
        pc = self.cfg.param_counts()
        return (pc["attn"] + pc["embed"] + pc["norm"] + pc["ffn"] + pc["ssm"]) * self.cfg.bytes_per_param()

    def attn_memory(self, local_batch: float, s_ctx: Optional[float] = None) -> float:
        cfg = self.cfg
        s = s_ctx if s_ctx is not None else self.s_ctx
        kv = cfg.kv_bytes_per_token() * local_batch * s
        act = local_batch * cfg.d_model * cfg.bytes_per_param() * 64  # buffers
        return self._attn_side_bytes() + kv + act

    def max_local_batch(self) -> float:
        cfg = self.cfg
        free = self.hw.mem_bytes * 0.9 - self._attn_side_bytes()
        if free <= 0:
            return 0.0
        per_tok = cfg.kv_bytes_per_token() * self.s_ctx + cfg.d_model * cfg.bytes_per_param() * 64
        return free / per_tok


def solve_batch(
    model: PerfModel, demand: float, n_a: int, n_e: int, b_max: float, scheme: str = "2pc"
) -> Optional[float]:
    """Solve B = lambda TPOT(B) on [1, b_max] (Eq. 2); None if infeasible."""

    def f(B: float) -> float:
        return B - demand * model.tpot(B, n_a, n_e, scheme).tpot

    if b_max < 1:
        return None
    if f(1.0) >= 0:
        return 1.0  # too light a load to form a larger steady batch
    if f(b_max) < 0:
        return None  # even the largest memory-feasible batch cannot keep up
    lo, hi = 1.0, b_max
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if f(mid) < 0:
            lo = mid
        else:
            hi = mid
    return hi


class SLOScaler:
    """Algorithm 2: the fewest devices n_a + n_e whose steady state meets
    the TPOT SLO (ties to the higher tokens/s per device)."""

    def __init__(self, model: PerfModel, n_max: int = 16, scheme: str = "2pc"):
        self.model = model
        self.n_max = n_max
        self.scheme = scheme
        cfg = model.cfg
        self.n_e_min = max(1, math.ceil(cfg.num_experts / model.C)) if cfg.has_moe else 1
        self.search_log: List[EvalResult] = []

    def evaluate(self, demand: float, slo: float, n_a: int, n_e: int) -> Optional[EvalResult]:
        b_max = self.model.max_local_batch() * n_a
        B = solve_batch(self.model, demand, n_a, n_e, b_max, self.scheme)
        if B is None:
            return None
        r = self.model.tpot(B, n_a, n_e, self.scheme)
        r.feasible = r.tpot <= slo and self.model.attn_memory(B / n_a) <= 0.9 * self.model.hw.mem_bytes
        return r

    def scale(self, demand: float, slo: float) -> Optional[EvalResult]:
        self.search_log = []
        best: Optional[EvalResult] = None
        for n_a in range(1, self.n_max + 1):
            for n_e in range(self.n_e_min, self.n_max + 1):
                r = self.evaluate(demand, slo, n_a, n_e)
                if r is None:
                    continue
                self.search_log.append(r)
                if not r.feasible:
                    continue
                if best is None or (r.n_a + r.n_e) < (best.n_a + best.n_e) or (
                    (r.n_a + r.n_e) == (best.n_a + best.n_e) and r.tpg > best.tpg
                ):
                    best = r
        return best
