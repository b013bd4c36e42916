"""Fault injection, health monitoring and recovery for disaggregated serving
(``repro.serving.faults``, numpy only, copied so the port imports nothing of
the reference).

Independently managed sub-clusters mean independent failure domains: at
fleet scale a lost device, a hung cross-pool exchange, or a failed prefill
chunk is a steady-state event, not an exception.  This module gives the
engine a *typed* fault model instead of an opaque backend error:

* :class:`FaultSpec` / :class:`FaultPlan` — an injectable, seeded,
  step-scheduled description of what fails and when (device loss in any of
  the three pools, exchange timeout/delay, prefill-chunk failure; transient
  faults heal after ``fail_count`` hits, permanent ones do not).  Plans are
  JSON round-trippable, and :meth:`FaultPlan.random` draws reproducible
  plans from a seed (the reference's draws, call for call).
* :class:`PoolFault` — the typed signal every detection path raises, naming
  the pool, device index and fault kind, so the engine can route recovery
  instead of dying.
* :class:`Watchdog` — per-site deadlines: an exchange whose (injected)
  latency exceeds the deadline is *cancelled* and surfaced as a transient
  timeout after charging the deadline, never a hang.
* :class:`RetryPolicy` — exponential backoff with a bounded retry budget;
  pure functions of the attempt number so tests drive them with a fake
  clock.
* :class:`FaultRuntime` — the engine-side state machine: fires scheduled
  injections as the decode step counter passes them, answers health polls
  (heartbeat: any armed device loss in a pool the engine is about to use
  becomes a :class:`PoolFault` *before* the step runs), serves as the
  ``fault_hook`` of the :class:`~repro_torch.serving.disagg.DisaggExecutor`
  exchange path and the :class:`~repro_torch.serving.prefill.PrefillWorker`
  chunk loop, and accumulates :class:`FaultStats` for ``metrics()``.

The fault-free hot path is untouched: executors and workers carry a
``fault_hook`` that is ``None`` unless a plan is armed, and the engine only
consults the runtime when one exists.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

DEVICE_LOSS = "device_loss"
EXCHANGE_TIMEOUT = "exchange_timeout"
EXCHANGE_DELAY = "exchange_delay"
PREFILL_CHUNK_FAIL = "prefill_chunk_fail"

FAULT_KINDS = (DEVICE_LOSS, EXCHANGE_TIMEOUT, EXCHANGE_DELAY, PREFILL_CHUNK_FAIL)
POOLS = ("attn", "moe", "prefill")


class PoolFault(Exception):
    """A detected fault, typed by pool / device / kind.

    Raised by health polls and fault hooks instead of letting a dead device
    surface as a hang or an opaque backend error.  ``transient`` faults are
    retried under the engine's :class:`RetryPolicy`; permanent ones route to
    pool-specific recovery (re-plan / re-prefill / requeue / degrade).
    """

    def __init__(self, pool: str, index: int, kind: str, transient: bool,
                 detail: str = ""):
        self.pool = pool
        self.index = index
        self.kind = kind
        self.transient = transient
        self.detail = detail
        flavor = "transient" if transient else "permanent"
        super().__init__(
            f"{flavor} {kind} in {pool} pool (device {index})"
            + (f": {detail}" if detail else "")
        )


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``at_step`` is the engine's global decode-step ordinal for decode-side
    faults, and the worker's global chunk ordinal for
    ``prefill_chunk_fail`` — both deterministic counters, so a plan replays
    identically across runs.  ``fail_count`` is how many consecutive
    attempts a *transient* fault poisons before healing; permanent faults
    ignore it.
    """

    kind: str
    pool: str = "attn"
    index: int = 0  # device index within the pool
    at_step: int = 0
    transient: bool = False
    fail_count: int = 1
    delay_s: float = 0.0  # EXCHANGE_DELAY magnitude (seconds)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind: {self.kind!r} (one of {FAULT_KINDS})")
        if self.kind == DEVICE_LOSS and self.pool not in POOLS:
            raise ValueError(f"unknown pool: {self.pool!r} (one of {POOLS})")
        if self.kind == DEVICE_LOSS and self.transient:
            raise ValueError("device_loss is permanent by definition")
        if self.kind in (EXCHANGE_TIMEOUT, EXCHANGE_DELAY, PREFILL_CHUNK_FAIL):
            # non-loss faults are transient unless explicitly escalated
            pass


@dataclasses.dataclass
class FaultPlan:
    """A reproducible schedule of faults (seeded + step-scheduled)."""

    faults: List[FaultSpec] = dataclasses.field(default_factory=list)
    seed: int = 0

    # -- construction --------------------------------------------------------
    @staticmethod
    def random(
        seed: int,
        n_faults: int = 3,
        max_step: int = 50,
        kinds: Sequence[str] = FAULT_KINDS,
        pools: Sequence[str] = POOLS,
        pool_sizes: Optional[Dict[str, int]] = None,
    ) -> "FaultPlan":
        """Draw a reproducible plan: same seed → same schedule, always."""
        rng = np.random.default_rng(seed)
        sizes = pool_sizes or {p: 1 for p in pools}
        faults = []
        for _ in range(n_faults):
            kind = str(rng.choice(list(kinds)))
            pool = str(rng.choice(list(pools))) if kind == DEVICE_LOSS else "attn"
            faults.append(
                FaultSpec(
                    kind=kind,
                    pool=pool,
                    index=int(rng.integers(0, max(1, sizes.get(pool, 1)))),
                    at_step=int(rng.integers(1, max_step)),
                    transient=kind != DEVICE_LOSS,
                    fail_count=int(rng.integers(1, 3)),
                    delay_s=float(rng.uniform(0.001, 0.05)) if kind == EXCHANGE_DELAY else 0.0,
                )
            )
        faults.sort(key=lambda f: f.at_step)
        return FaultPlan(faults, seed=seed)

    # -- (de)serialisation ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "faults": [dataclasses.asdict(f) for f in self.faults]},
            indent=2,
        )

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        obj = json.loads(text)
        if isinstance(obj, list):  # bare fault list is accepted too
            obj = {"faults": obj}
        return FaultPlan(
            faults=[FaultSpec(**f) for f in obj.get("faults", [])],
            seed=int(obj.get("seed", 0)),
        )


@dataclasses.dataclass
class RetryPolicy:
    """Bounded exponential backoff for transient faults.

    Pure: ``delay(attempt)`` is a function of the attempt number only, so a
    fake clock can assert the exact charged backoff.  ``recovery_charge_s``
    is the modeled wall cost of one permanent-fault recovery (charged to the
    engine clock when the engine runs a modeled ``step_time_fn`` — real
    wall time is charged otherwise).
    """

    base_delay_s: float = 0.05
    factor: float = 2.0
    max_retries: int = 3
    recovery_charge_s: float = 0.0

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return self.base_delay_s * self.factor ** max(0, attempt - 1)


@dataclasses.dataclass
class Watchdog:
    """Per-site deadlines: turn would-be hangs into typed timeouts.

    ``exchange_deadline_s`` bounds one cross-pool exchange;
    ``prefill_deadline_s`` bounds one prefill chunk.  An injected delay at
    or beyond the deadline is detected (the transfer is cancelled after
    ``deadline`` seconds and surfaced as a transient ``exchange_timeout``);
    a delay below it is charged as latency but is not a fault.
    """

    exchange_deadline_s: float = 1.0
    prefill_deadline_s: float = 5.0


@dataclasses.dataclass
class FaultStats:
    """Counters surfaced through ``ServingEngine.metrics()['faults']``."""

    injected: int = 0
    detected: int = 0
    retries: int = 0
    recoveries: int = 0
    requeued: int = 0  # requests re-driven through the prefill queue
    replayed_slots: int = 0  # KV slots rebuilt by deterministic replay
    degraded: int = 0  # disagg → mono last-resort transitions
    fault_stall_s: float = 0.0  # clock charged to backoff + recovery
    recovery_latency_s: List[float] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict:
        lat = self.recovery_latency_s
        return {
            "injected": self.injected,
            "detected": self.detected,
            "retries": self.retries,
            "recoveries": self.recoveries,
            "requeued": self.requeued,
            "replayed_slots": self.replayed_slots,
            "degraded": self.degraded,
            "fault_stall_s": self.fault_stall_s,
            "recovery_latency_mean_s": float(np.mean(lat)) if lat else 0.0,
            "recovery_latency_max_s": float(np.max(lat)) if lat else 0.0,
        }


@dataclasses.dataclass
class _Armed:
    """Runtime state of one scheduled fault."""

    spec: FaultSpec
    fired: bool = False  # injection happened (step counter passed at_step)
    handled: bool = False  # recovery / healing completed
    hits: int = 0  # transient: failures delivered so far


class FaultRuntime:
    """Engine-side fault state: injection schedule, health polls, hooks.

    The engine owns one runtime per armed :class:`FaultPlan`.  Decode-side
    faults key off the engine's global step counter (``advance_to_step``);
    prefill-chunk faults key off the worker's global chunk counter (the
    hook receives it).  Detection is split by mechanism:

    * **heartbeat** (``poll_health``): armed device losses surface *before*
      the engine uses the pool — a dead device never silently serves;
    * **exchange hook** (``exchange_hook``): transient timeout/delay faults
      fire inside the executor's exchange path, bounded by the
      :class:`Watchdog` deadline;
    * **prefill hook** (``prefill_hook``): chunk failures fire inside the
      worker's chunk loop before any compute, so a retry is trivially safe.
    """

    def __init__(
        self,
        plan: FaultPlan,
        policy: Optional[RetryPolicy] = None,
        watchdog: Optional[Watchdog] = None,
    ):
        self.plan = plan
        self.policy = policy or RetryPolicy()
        self.watchdog = watchdog or Watchdog()
        self.stats = FaultStats()
        self._armed = [_Armed(spec=f) for f in plan.faults]
        self._pending_delay = 0.0
        self._step = -1

    # -- injection schedule --------------------------------------------------
    def advance_to_step(self, step: int) -> None:
        """Fire every decode-side fault whose ``at_step`` the counter passed."""
        self._step = step
        for a in self._armed:
            if a.fired or a.spec.kind == PREFILL_CHUNK_FAIL:
                continue
            if a.spec.at_step <= step:
                a.fired = True
                self.stats.injected += 1

    # -- heartbeat: device-loss detection ------------------------------------
    def poll_health(self, pool_sizes: Dict[str, int]) -> Optional[PoolFault]:
        """Return the next unhandled device loss touching a live pool.

        ``pool_sizes`` maps pool name → current device count; a loss whose
        index fell outside the (already shrunk) pool is marked handled
        rather than re-detected.
        """
        for a in self._armed:
            if not a.fired or a.handled or a.spec.kind != DEVICE_LOSS:
                continue
            n = pool_sizes.get(a.spec.pool, 0)
            if a.spec.index >= n:
                a.handled = True  # pool already shrank past this device
                continue
            self.stats.detected += 1
            return PoolFault(a.spec.pool, a.spec.index, DEVICE_LOSS, transient=False)
        return None

    def mark_handled(self, fault: PoolFault) -> None:
        for a in self._armed:
            if (
                a.fired
                and not a.handled
                and a.spec.kind == fault.kind
                and (fault.kind != DEVICE_LOSS or
                     (a.spec.pool == fault.pool and a.spec.index == fault.index))
            ):
                a.handled = True
                return

    # -- exchange path hook (installed as DisaggExecutor.fault_hook) ---------
    def exchange_hook(self, site: str, layer: int, micro_batch: int) -> None:
        """Called by the executor before each cross-pool exchange."""
        for a in self._armed:
            if not a.fired or a.handled:
                continue
            if a.spec.kind == EXCHANGE_TIMEOUT:
                a.hits += 1
                self.stats.detected += 1
                if a.hits >= a.spec.fail_count and a.spec.transient:
                    a.handled = True  # heals after this delivery
                raise PoolFault(
                    "moe", a.spec.index, EXCHANGE_TIMEOUT,
                    transient=a.spec.transient,
                    detail=f"exchange deadline ({self.watchdog.exchange_deadline_s}s) "
                           f"exceeded at layer {layer}",
                )
            if a.spec.kind == EXCHANGE_DELAY:
                a.hits += 1
                if a.hits >= a.spec.fail_count:
                    a.handled = True
                if a.spec.delay_s >= self.watchdog.exchange_deadline_s:
                    # the watchdog cancels the transfer at the deadline and
                    # surfaces a timeout — the engine charges the deadline,
                    # not the full (unbounded) delay
                    self._pending_delay += self.watchdog.exchange_deadline_s
                    self.stats.detected += 1
                    raise PoolFault(
                        "moe", a.spec.index, EXCHANGE_TIMEOUT,
                        transient=True,
                        detail=f"injected delay {a.spec.delay_s}s ≥ deadline",
                    )
                self._pending_delay += a.spec.delay_s  # slow, but no fault

    # -- prefill chunk hook (installed as PrefillWorker.fault_hook) ----------
    def prefill_hook(self, slot: int, dev_index: int, chunk_ordinal: int) -> None:
        """Called by the worker before each chunk's compute."""
        for a in self._armed:
            if a.handled or a.spec.kind != PREFILL_CHUNK_FAIL:
                continue
            if not a.fired:
                if chunk_ordinal >= a.spec.at_step:
                    a.fired = True
                    self.stats.injected += 1
                else:
                    continue
            a.hits += 1
            self.stats.detected += 1
            if a.hits >= a.spec.fail_count and a.spec.transient:
                a.handled = True
            raise PoolFault(
                "prefill", dev_index, PREFILL_CHUNK_FAIL,
                transient=a.spec.transient,
                detail=f"chunk {chunk_ordinal} (slot {slot})",
            )

    # -- injected latency ----------------------------------------------------
    def consume_delay(self) -> float:
        """Drain delay accumulated by under-deadline EXCHANGE_DELAY faults."""
        d, self._pending_delay = self._pending_delay, 0.0
        return d

    @property
    def has_pending(self) -> bool:
        return any(not a.handled for a in self._armed)
