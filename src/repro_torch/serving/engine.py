"""Continuous-batching decode engine with the Janus scheduled-MoE path
(``repro.serving.engine.ServingEngine``): the monolithic executor or the
disaggregated one (``executor="disagg"``), in FIFO order.

* admission: an arrived request takes the lowest free slot and its prompt
  goes through the chunked :class:`PrefillWorker`.  ``"blocking"`` drains it
  before the next decode iteration (the decode clock is charged);
  ``"pipelined"`` (the default with ``n_prefill``) queues it for the prefill
  pool, whose timeline runs beside the decode clock, and activates the slot
  once the clock passes its completion stamp (``max_prefill_queue`` bounds
  the pending prompts; ``prefill_batch`` packs prompts into one chunk call);
* decode: one batched ``decode_step`` per iteration with per-slot positions;
  MoE layers route -> AEBS (``scheduler="aebs"``; on the card that is the K2
  kernel) -> grouped dispatch over the activated experts (K3 on the card);
  on the card, attention reads contiguous KV (the default) through K4, int8
  contiguous KV (``cfg.kv_quant``) through K5 and paged KV
  (``kv_page_size``) through K1; paged int8 KV gathers and dequantises, as
  the reference does;
* disagg: :class:`repro_torch.serving.disagg.DisaggExecutor` holds the KV
  caches in attention shards and runs every MoE layer per instance (K2 per
  instance, K3 over its local slots); on one card every pool aliases the
  engine's device.  Each step logs its exchange regime, transfer bytes and
  ``a_max``, and :meth:`ServingEngine.reconfigure` resizes a pool mid-run
  (the prefill pool too; :class:`repro_torch.serving.controller.AutoScaler`
  decides the sizes);
* timing: wall clock around work that ends in a device sync, or modeled
  clocks: ``step_time_fn(active slots)`` per decode step and
  ``prefill_time_fn(prompt tokens)`` per prefill call (prefill is free under
  a modeled decode clock without a prefill model), which make the schedule
  the same on every device;
* faults (``fault_plan``, ``retry_policy``, ``watchdog``;
  :mod:`repro_torch.serving.faults`): a heartbeat before each decode step
  detects device losses and recovers from them (a lost MoE device re-plans
  the layout onto the survivors, a lost attention device re-shards the batch
  and rebuilds its slots by deterministic replay, a lost prefill device
  requeues its prompts, the last device of a decode pool degrades to mono);
  transient exchange and prefill-chunk faults retry under bounded
  exponential backoff.  Every replayed token is checked against the
  recorded stream;
* admission deadlines: a request still waiting for a slot or its prefill
  past ``Request.deadline`` is rejected (``metrics()["rejected"]``).

Options of the reference that later slices port raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.disagg import DevicePools
from repro_torch.core.placement import layout_for_survivors
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import model as model_mod
from repro_torch.models.common import resolve_device, tree_to
from repro_torch.serving.faults import DEVICE_LOSS, FaultPlan, FaultRuntime, PoolFault, RetryPolicy, Watchdog
from repro_torch.serving.kv_cache import (
    ACTIVE,
    PREFILLING,
    PagedKVCache,
    SlotManager,
    make_paged_caches,
    paginate_caches,
    scatter_prefill_chunk_caches,
    scatter_prefill_chunk_paged,
    zero_slots,
)
from repro_torch.serving.disagg import DisaggExecutor
from repro_torch.serving.prefill import PrefillEvent, PrefillWorker
from repro_torch.serving.request import Request

# "aebs" and "aebs_kernel" share one contract (kernels/aebs/ops.py:40-41 of
# the reference); the wrapper runs the CUDA kernel on the card and the plain
# aebs_assign on the CPU.
SCHEDULERS = {"aebs": aebs_schedule, "aebs_kernel": aebs_schedule, "none": None}

# reference options this slice does not run: name -> (values it accepts,
# which later slice ports the rest)
_LATER = {
    "sched": (("fifo",), "priority preemption"),
    "dispatch": (("grouped",), "the einsum/scatter oracles"),
    "kv_num_pages": ((None,), "preemption (an undersized page pool)"),
    "extra_builder": ((None,), "the other families"),
    "prefix_cache": ((False,), "the prefix cache"),
    "prefix_cache_pages": ((None,), "the prefix cache"),
    "draft_config": ((None,), "speculative decode"),
    "draft_params": ((None,), "speculative decode"),
    "spec_k": ((0,), "speculative decode"),
}


class ServingEngine:
    def __init__(
        self,
        cfg,
        params,
        *,
        max_batch: int = 8,
        cache_len: int = 512,
        layout: Optional[ReplicaLayout] = None,
        scheduler: str = "aebs",
        prefill_chunk: int = 64,
        kv_page_size: Optional[int] = None,
        capacity_tokens: Optional[int] = None,
        prefill_capacity_tokens: Optional[int] = None,
        executor: str = "mono",
        n_attn: int = 1,
        n_prefill: int = 0,
        admission: Optional[str] = None,  # blocking | pipelined (default: pipelined iff n_prefill)
        max_prefill_queue: Optional[int] = None,  # admission backpressure bound
        prefill_batch: int = 1,  # prompts fused per prefill-device chunk call
        step_time_fn: Optional[Callable[[int], float]] = None,
        prefill_time_fn: Optional[Callable[[int], float]] = None,
        pools: Optional[DevicePools] = None,
        node_size: int = 1,
        ping_pong: bool = False,
        fault_plan: Optional[FaultPlan] = None,
        retry_policy: Optional[RetryPolicy] = None,
        watchdog: Optional[Watchdog] = None,
        device="cuda",
        **later,
    ):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"ServingEngine got an unexpected keyword argument {name!r}")
            accepted, port = _LATER[name]
            if not any(value is v or value == v for v in accepted):
                raise NotImplementedError(f"{name}={value!r}: not ported yet (comes with {port})")
        if scheduler not in SCHEDULERS:
            raise NotImplementedError(
                f"scheduler={scheduler!r}: ported schedulers are {sorted(SCHEDULERS)}; "
                "random and token_hash come in a later slice"
            )
        if max_prefill_queue is not None and max_prefill_queue < 1:
            raise ValueError(
                f"max_prefill_queue must be ≥ 1, got {max_prefill_queue} "
                "(a zero bound would close admission permanently)"
            )
        if admission is None:
            admission = "pipelined" if n_prefill else "blocking"
        if admission not in ("blocking", "pipelined"):
            raise ValueError(f"unknown admission mode: {admission}")
        self.admission = admission
        self.step_time_fn = step_time_fn
        self.max_prefill_queue = max_prefill_queue
        self._ready: List[PrefillEvent] = []
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.layout = layout
        self.slots = SlotManager(max_batch, cache_len)
        # the last token fed per slot; parked slots keep their stale token,
        # as the reference does
        self.tokens = np.zeros((max_batch, 1), np.int64)
        self.clock = 0.0
        self.completed: List[Request] = []
        self.rejected: List[Request] = []
        self.decode_stall_time = 0.0
        self.steps_done = 0  # global decode-step ordinal (fault plans key off it)
        self.amax_log: List[int] = []
        self.regime_log: List[str] = []
        self.transfer_bytes_log: List[int] = []
        self.executor_name = executor
        self.kv_page_size = kv_page_size
        self.faults: Optional[FaultRuntime] = None
        self.degraded_reason: Optional[str] = None
        # notified on every permanent device loss as fn(fault, clock); the
        # AutoScaler attaches here
        self.fault_listeners: List[Callable[[PoolFault, float], None]] = []
        self._scheduler = SCHEDULERS[scheduler]
        self._capacity = capacity_tokens
        self._extra = self._mono_extra(layout)

        self.paged: Optional[PagedKVCache] = None
        self.disagg: Optional[DisaggExecutor] = None
        if executor == "disagg":
            if layout is None or scheduler == "none":
                raise ValueError("executor='disagg' needs a replica layout and scheduler")
            devices = None
            if pools is None:
                # one card: every pool aliases the engine's device
                devices = [self.device]
                pools = DevicePools.split(
                    n_attn, layout.num_instances, devices, node_size=node_size, allow_reuse=True,
                    n_prefill=n_prefill,
                )
            self.disagg = DisaggExecutor(
                cfg, params, pools, layout, max_batch=max_batch, cache_len=cache_len,
                scheduler=SCHEDULERS[scheduler], capacity=capacity_tokens,
                ping_pong=ping_pong, devices=devices, kv_page_size=kv_page_size,
            )
            self.caches = None  # the executor's attention shards hold the KV
        elif executor == "mono":
            if pools is None and n_prefill:
                pools = DevicePools.split(0, 0, [self.device], n_prefill=n_prefill, allow_reuse=True)
            self.caches = model_mod.init_decode_caches(cfg, max_batch, cache_len, self.device)
            if kv_page_size is not None:
                self.paged, self.caches = make_paged_caches(
                    self.caches, max_batch, cache_len, kv_page_size
                )
        else:
            raise ValueError(f"unknown executor: {executor}")
        # one worker serves both admission modes, so their numerics (chunk
        # grid, programs) are the same by construction.  A modeled decode
        # clock never mixes in wall-clock prefill stamps.
        worker_time_fn = prefill_time_fn
        if step_time_fn is not None and prefill_time_fn is None:
            worker_time_fn = lambda n_tok: 0.0  # noqa: E731
        self.prefill_worker = PrefillWorker(
            cfg, params, list(pools.prefill_devices) if pools is not None else [],
            device=self.device, cache_len=cache_len, chunk=prefill_chunk,
            capacity=prefill_capacity_tokens, batch=prefill_batch, prefill_time_fn=worker_time_fn,
        )
        if fault_plan is not None:
            self.arm_faults(fault_plan, policy=retry_policy, watchdog=watchdog)

    def _mono_extra(self, layout: Optional[ReplicaLayout]) -> Optional[Dict]:
        """The mono step's MoE context over ``layout``'s tables on the
        engine's device (None without a layout or scheduler)."""
        if not (self.cfg.has_moe and layout is not None and self._scheduler is not None):
            return None
        return {"moe_ctx": dict(
            layout_tables=layout.device_tables(self.device),
            slot_to_expert=torch.as_tensor(
                layout.slot_to_expert.reshape(-1), dtype=torch.int32, device=self.device
            ),
            num_instances=layout.num_instances,
            scheduler=self._scheduler,
            capacity=self._capacity,
        )}

    # ------------------------------------------------------------------
    # fault injection and recovery
    # ------------------------------------------------------------------
    def arm_faults(
        self,
        plan: FaultPlan,
        policy: Optional[RetryPolicy] = None,
        watchdog: Optional[Watchdog] = None,
    ) -> FaultRuntime:
        """Arm a fault plan: build the runtime and install its hooks on the
        executor's exchange path and the prefill worker's chunk loop."""
        self.faults = FaultRuntime(plan, policy=policy, watchdog=watchdog)
        if self.disagg is not None:
            self.disagg.fault_hook = self.faults.exchange_hook
        self.prefill_worker.fault_hook = self.faults.prefill_hook
        return self.faults

    def _pool_sizes(self) -> Dict[str, int]:
        sizes = {"attn": 0, "moe": 0}
        if self.disagg is not None:
            sizes["attn"] = len(self.disagg.pools.attn_devices)
            sizes["moe"] = len(self.disagg.pools.moe_devices)
        sizes["prefill"] = len(self.prefill_worker.devices)
        return sizes

    def _charge(self, dt: float) -> None:
        """Advance the clock for fault handling (backoff, recovery) and book
        the stall."""
        if dt <= 0:
            return
        self.clock += dt
        if self.faults is not None:
            self.faults.stats.fault_stall_s += dt

    def _fault_preflight(self) -> None:
        """Heartbeat: fire the step-scheduled faults, then recover from every
        device loss the health poll detects before the step runs."""
        self.faults.advance_to_step(self.steps_done)
        while True:
            fault = self.faults.poll_health(self._pool_sizes())
            if fault is None:
                return
            self._recover(fault)

    def _recover(self, fault: PoolFault) -> None:
        """Recover from a permanent fault and book its latency (wall time
        across a device sync; a modeled clock is charged the policy's
        ``recovery_charge_s`` instead)."""
        t0 = time.perf_counter()
        if fault.pool == "moe":
            self._recover_moe_loss(fault)
        elif fault.pool == "attn":
            self._recover_attn_loss(fault)
        elif fault.pool == "prefill":
            self._recover_prefill_loss(fault)
        else:
            self._degrade_to_mono(f"unrecoverable fault: {fault}")
        self.faults.mark_handled(fault)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        stats = self.faults.stats
        stats.recoveries += 1
        stats.recovery_latency_s.append(wall)
        self._charge(self.faults.policy.recovery_charge_s if self.step_time_fn else wall)
        if fault.kind == DEVICE_LOSS:
            for listener in self.fault_listeners:
                listener(fault, self.clock)

    def _recover_moe_loss(self, fault: PoolFault) -> None:
        """Re-plan expert placement onto the surviving MoE devices and rebuild
        only the MoE pool; every expert keeps a seat."""
        ex = self.disagg
        if ex is None:
            return  # already mono: there is no MoE pool to lose
        n_moe = len(ex.pools.moe_devices)
        if n_moe <= 1:
            self._degrade_to_mono("lost the last MoE device")
            return
        ex.exclude_device("moe", fault.index)
        self.reconfigure(n_moe=n_moe - 1, layout=layout_for_survivors(self.cfg.num_experts, n_moe - 1))

    def _recover_attn_loss(self, fault: PoolFault) -> None:
        """The dead shard's KV rows are gone: re-shard the batch over the
        survivors and rebuild each lost slot (or degrade to mono when no
        attention device survives, rebuilding every slot)."""
        ex = self.disagg
        if ex is None:
            return
        if len(ex.pools.attn_devices) <= 1:
            self._degrade_to_mono("lost the last attention device", lost_rows=list(range(self.max_batch)))
            return
        self._rebuild_lost_slots(ex.drop_attn_device(fault.index))

    def _recover_prefill_loss(self, fault: PoolFault) -> None:
        """Drop the dead prefill device's in-flight prompts, shrink the pool
        and requeue them from chunk 0 (chunked prefill is deterministic)."""
        worker = self.prefill_worker
        displaced = worker.fail_device(fault.index)
        if self.disagg is not None and len(self.disagg.pools.prefill_devices) > 0:
            self.disagg.exclude_device("prefill", fault.index)
            self.reconfigure(n_prefill=len(self.disagg.pools.prefill_devices) - 1)
        else:
            worker.set_devices([d for i, d in enumerate(worker.devices) if i != fault.index], self.params)
        for req in displaced:
            self._requeue(req)

    def _requeue(self, req: Request) -> None:
        """Restart ``req``'s prompt from chunk 0 in its own slot."""
        slot = req.slot
        self.slots.fail(slot)
        self.slots.requeue(slot)
        self.slots.start_prefill(slot)
        self._release_pages(slot)
        self.prefill_worker.submit(req, slot, now=max(self.clock, req.arrival))
        self.faults.stats.requeued += 1

    def _rebuild_lost_slots(self, lost_rows: List[int]) -> None:
        """ACTIVE slots whose rows died replay their whole history; PREFILLING
        ones restart their prompt (its streamed chunks died with the rows);
        reserved and free slots lost nothing."""
        for slot in lost_rows:
            state = self.slots.state[slot]
            if state == ACTIVE:
                self._replay_slot(slot)
                self.faults.stats.replayed_slots += 1
            elif state == PREFILLING:
                req = self._withdraw(slot)
                if req is not None:
                    self._requeue(req)

    def _replay_slot(self, slot: int) -> None:
        """Rebuild one slot's KV: re-prefill its prompt on the worker's chunk
        grid, then re-decode its generated tokens one step at a time with
        every other slot parked at the scratch row (position ``cache_len -
        1``, token 0).  Each replayed token must equal the recorded one."""
        req = self.slots.slot_req[slot]
        first = self.prefill_worker.run_sync(self.prefill_worker.prompt_of(req), slot, self._chunk_sink)
        if req.tokens_out and first != req.tokens_out[0]:
            raise RuntimeError(
                f"recovery replay diverged at the first token of slot {slot}: {first} != {req.tokens_out[0]}"
            )
        for t in range(req.generated):
            toks = np.zeros((self.max_batch, 1), np.int64)
            toks[slot, 0] = req.tokens_out[t]
            pos = np.full((self.max_batch,), self.cache_len - 1, np.int64)
            pos[slot] = req.input_len + t
            self._ensure_pages({slot: req.input_len + t})
            toks_d, pos_d = torch.from_numpy(toks).to(self.device), torch.from_numpy(pos).to(self.device)
            if self.disagg is not None:
                logits, _ = self.disagg.decode_step(toks_d, pos_d)
            else:
                logits, self.caches = model_mod.decode_step(
                    self.params, toks_d, self.caches, pos_d, self.cfg, extra=self._extra
                )
            nxt = int(model_mod.greedy_token(logits)[slot])
            if nxt != req.tokens_out[t + 1]:
                raise RuntimeError(
                    f"recovery replay diverged at generated token {t} of slot {slot}: "
                    f"{nxt} != {req.tokens_out[t + 1]}"
                )

    def _degrade_to_mono(self, reason: str, lost_rows: Optional[List[int]] = None) -> None:
        """Last resort: collapse the disaggregated executor onto the engine's
        device.  The surviving KV is exported (re-paginated when paged), the
        ``lost_rows`` zeroed and rebuilt by replay after the switch, and the
        mono step runs over the layout current at this moment."""
        if self.faults is not None:
            self.faults.stats.degraded += 1
        ex = self.disagg
        if ex is None:
            return
        caches = tree_to(ex.export_caches(), self.device)
        lengths = ex.slot_lengths()
        self.disagg = ex = None  # its KV shards are freed before the copy
        if lost_rows:
            zero_slots(caches, lost_rows)
            lengths[np.asarray(lost_rows)] = 0
        if self.kv_page_size is not None:
            self.paged, caches = paginate_caches(caches, lengths, self.kv_page_size)
        self.caches = caches
        self._extra = self._mono_extra(self.layout)
        self.executor_name = "mono"
        self.degraded_reason = reason
        if lost_rows:
            self._rebuild_lost_slots(lost_rows)

    def _guarded_decode(self, positions: torch.Tensor):
        """One decode step in the fault envelope: a transient exchange fault
        retries the (idempotent) step under exponential backoff; a spent
        retry budget degrades to mono; injected sub-deadline delays are
        charged to the clock."""
        if self.faults is None:
            return self._decode_once(positions)
        attempt = 0
        while True:
            try:
                out = self._decode_once(positions)
            except PoolFault as fault:
                if not fault.transient:
                    self._recover(fault)
                    continue
                attempt += 1
                self.faults.stats.retries += 1
                if attempt > self.faults.policy.max_retries:
                    self.faults.mark_handled(fault)
                    self._degrade_to_mono(f"retry budget exhausted: {fault}")
                    continue
                self._charge(self.faults.policy.delay(attempt))
                continue
            self._charge(self.faults.consume_delay())
            return out

    def _decode_once(self, positions: torch.Tensor):
        """One batched step: (next tokens on the host, telemetry or None)."""
        tokens = torch.from_numpy(self.tokens).to(self.device)
        tel = None
        if self.disagg is not None:
            logits, tel = self.disagg.decode_step(tokens, positions)
        else:
            logits, self.caches = model_mod.decode_step(
                self.params, tokens, self.caches, positions, self.cfg, extra=self._extra
            )
        return model_mod.greedy_token(logits).cpu().numpy(), tel  # waits for the device

    def _worker_poll(self) -> List[PrefillEvent]:
        """Poll the prefill worker in the fault envelope: a transient chunk
        fault retries (the hook fires before any compute); a spent budget
        becomes a loss of that device."""
        if self.faults is None:
            return self.prefill_worker.poll(self._chunk_sink)
        attempt = 0
        while True:
            try:
                return self.prefill_worker.poll(self._chunk_sink)
            except PoolFault as fault:
                if not fault.transient:
                    self._recover(fault)
                    continue
                attempt += 1
                self.faults.stats.retries += 1
                if attempt > self.faults.policy.max_retries:
                    self.faults.mark_handled(fault)
                    self._recover(PoolFault("prefill", fault.index, DEVICE_LOSS, transient=False,
                                            detail="chunk retry budget exhausted"))
                    attempt = 0
                    continue
                self._charge(self.faults.policy.delay(attempt))

    def _reject(self, req: Request) -> None:
        """Admission control: the deadline passed before the request was
        served; it holds no slot and emits no tokens."""
        req.rejected = True
        req.finished = self.clock
        self.rejected.append(req)

    def cancel_slot(self, slot: int) -> Optional[Request]:
        """Withdraw a reserved or prefilling request before activation: pull
        it from the worker (or its finished event), release the slot's pages
        and free the slot.  Returns the request, or None when the slot holds
        nothing to cancel (free or active)."""
        req = self._withdraw(slot)
        if req is None:
            held = self.slots.slot_req[slot]
            if held is not None and self.slots.state[slot] != ACTIVE:
                req = held
        if req is None:
            return None
        self._release_pages(slot)
        self.slots.release(slot)
        return req

    def _withdraw(self, slot: int) -> Optional[Request]:
        """Pull a prefilling slot's request from the worker, or drop its
        finished but not yet activated event."""
        req = self.prefill_worker.cancel_slot(slot)
        if req is None:
            req = next((ev.req for ev in self._ready if ev.slot == slot), None)
            self._ready = [ev for ev in self._ready if ev.slot != slot]
        return req

    # ------------------------------------------------------------------
    def _prefill_request(self, req: Request) -> None:
        """Blocking admission: drain the worker for this one request."""
        stalled = self.slots.num_active > 0
        slot = self.slots.reserve(req)
        self.slots.start_prefill(slot)
        now = max(self.clock, req.arrival)
        self.prefill_worker.submit(req, slot, now=now)
        events: List[PrefillEvent] = []
        while not events:
            events = self._worker_poll()
        ev = events[0]
        dt = ev.finish_t - now
        self.slots.activate(slot)
        self.tokens[slot, 0] = ev.first_token
        self.clock += dt
        if stalled:
            self.decode_stall_time += dt
        req.prefill_done = self.clock
        req.token_times.append(self.clock)
        req.tokens_out = [ev.first_token]

    def _submit_request(self, req: Request) -> None:
        """Pipelined admission: reserve the slot and queue the prompt for the
        prefill pool; the decode clock is never charged."""
        slot = self.slots.reserve(req)
        self.slots.start_prefill(slot)
        self.prefill_worker.submit(req, slot, now=max(self.clock, req.arrival))

    def _admission_open(self) -> bool:
        """Backpressure: stop admitting when the prefill queue is full."""
        if self.max_prefill_queue is None:
            return True
        return self.prefill_worker.num_pending < self.max_prefill_queue

    def _chunk_sink(self, slot: int, start: int, length: int, one_caches: Dict) -> None:
        """Land one streamed prefill chunk (or a whole-prompt cache, ``length
        == -1``) in the decode caches."""
        if self.disagg is not None:
            if length < 0:
                self.disagg.scatter_prefill(one_caches, slot)
            else:
                self.disagg.scatter_prefill_chunk(one_caches, slot, start, length)
        elif self.paged is not None:
            if length < 0:  # the prompt's rows as one chunk
                start, length = 0, self.slots.slot_req[slot].input_len
            self.caches = scatter_prefill_chunk_paged(
                self.caches, one_caches, slot, start, length, self.paged
            )
        else:
            if length < 0:  # the whole cache row
                start, length = 0, self.cache_len
            self.caches = scatter_prefill_chunk_caches(self.caches, one_caches, slot, start, length)

    def _poll_prefill(self) -> None:
        """Advance the prefill pipeline and activate the finished requests
        whose completion stamp the decode clock has passed."""
        self._ready.extend(self._worker_poll())
        still: List[PrefillEvent] = []
        for ev in self._ready:
            if ev.finish_t <= self.clock:
                self.slots.activate(ev.slot)
                self.tokens[ev.slot, 0] = ev.first_token
                ev.req.prefill_done = ev.finish_t
                ev.req.token_times.append(ev.finish_t)
                ev.req.tokens_out = [ev.first_token]
            else:
                still.append(ev)
        self._ready = still

    def _prefill_pending(self) -> int:
        return self.prefill_worker.num_pending + len(self._ready)

    def _ensure_pages(self, at: Optional[Dict[int, int]] = None) -> None:
        """Back each slot's next write position with a page: every active
        slot's, or only ``at``'s (slot -> position, as the replay asks)."""
        if at is None:
            at = {s: int(self.slots.positions[s]) for s in self.slots.active_slots}
        if self.paged is not None:
            for s, pos in at.items():
                self.paged.ensure(s, pos)
            self.caches["block_tables"] = self.paged.table_device(self.device)
        elif self.disagg is not None:
            for s, pos in at.items():
                self.disagg.ensure_slot_pages(s, pos)

    def _release_pages(self, slot: int) -> None:
        if self.paged is not None:
            self.paged.release(slot)
        elif self.disagg is not None:
            self.disagg.release_slot(slot)

    def _decode_iteration(self) -> None:
        if self.faults is not None:
            self._fault_preflight()
        self._ensure_pages()
        positions = self.slots.positions_device(self.device)
        t0 = time.perf_counter()
        next_tokens, tel = self._guarded_decode(positions)
        if tel is not None:
            self.regime_log.append(tel["regime"])
            self.transfer_bytes_log.append(tel["bytes_total"])
            self.amax_log.append(tel["a_max"])
        wall = time.perf_counter() - t0
        self.clock += self.step_time_fn(self.slots.num_active) if self.step_time_fn else wall
        self.steps_done += 1
        for s in self.slots.active_slots:
            req = self.slots.slot_req[s]
            req.generated += 1
            req.token_times.append(self.clock)
            self.slots.advance(s)
            self.tokens[s, 0] = int(next_tokens[s])
            if req.tokens_out is not None:
                req.tokens_out.append(int(next_tokens[s]))
            if req.generated >= req.output_len or self.slots.positions[s] >= self.cache_len - 2:
                if req.generated < req.output_len:
                    req.truncated = True  # context exhausted before the target length
                req.finished = self.clock
                self.completed.append(self.slots.release(s))
                self._release_pages(s)

    def run(self, requests: List[Request], max_steps: int = 100_000) -> Dict:
        """Serve all requests (arrivals gated by the engine clock)."""
        waiting = sorted(requests, key=lambda r: r.arrival)
        steps = 0
        while (waiting or self.slots.num_active or self._prefill_pending()) and steps < max_steps:
            # admission control: an arrived request whose deadline passed
            # while the engine was saturated is rejected (it held no slot)
            if any(r.deadline is not None for r in waiting):
                kept = []
                for r in waiting:
                    if r.deadline is not None and r.arrival <= self.clock and self.clock > r.deadline:
                        self._reject(r)
                    else:
                        kept.append(r)
                waiting = kept
            # a reserved or prefilling request whose deadline passed is
            # cancelled, and its slot and pages return to the pool
            for slot in self.slots.pending_slots:
                req = self.slots.slot_req[slot]
                if req is not None and req.deadline is not None and self.clock > req.deadline:
                    if self.cancel_slot(slot) is not None:
                        self._reject(req)
            while (waiting and waiting[0].arrival <= self.clock and self.slots.free_slots
                   and self._admission_open()):
                req = waiting.pop(0)
                if self.admission == "pipelined":
                    self._submit_request(req)
                else:
                    self._prefill_request(req)
            self._poll_prefill()
            if self.slots.num_active == 0:
                if self._ready:  # idle: jump to the next prefill completion
                    self.clock = max(self.clock, min(ev.finish_t for ev in self._ready))
                    continue
                if self._prefill_pending():  # chunks still streaming: keep polling
                    continue
                if waiting:  # idle: jump to the next arrival
                    self.clock = max(self.clock, waiting[0].arrival)
                    continue
                break
            self._decode_iteration()
            steps += 1
        return self.metrics()

    def reconfigure(
        self,
        n_attn: Optional[int] = None,
        n_moe: Optional[int] = None,
        layout: Optional[ReplicaLayout] = None,
        n_prefill: Optional[int] = None,
    ) -> Dict[str, bool]:
        """Actuate a scaling decision mid-run (§3.5): only the pools whose
        counts changed are rebuilt; in-flight KV caches are preserved and
        in-progress prefills move with the prefill pool.  Disagg executor
        only."""
        if self.disagg is None:
            raise NotImplementedError(
                "mid-run reconfigure requires executor='disagg' (the monolithic "
                "engine re-lowers wholesale — rebuild the engine instead)"
            )
        relower = self.disagg.reconfigure(n_attn=n_attn, n_moe=n_moe, layout=layout, n_prefill=n_prefill)
        self.layout = self.disagg.layout
        if relower.get("prefill"):
            self.prefill_worker.set_devices(self.disagg.pools.prefill_devices, self.params)
        return relower

    def metrics(self) -> Dict:
        done = self.completed
        out: Dict = {"completed": len(done), "tokens": sum(r.generated for r in done)}
        out["truncated"] = sum(1 for r in done if r.truncated)
        out["rejected"] = len(self.rejected)
        out["decode_stall_time"] = self.decode_stall_time
        out["prefill_chunks"] = self.prefill_worker.chunks_done
        if self.paged is not None:
            out["kv_pages"] = self.paged.stats()
        elif self.disagg is not None and self.disagg.kv_page_size is not None:
            out["kv_pages"] = self.disagg.page_stats()
        if self.faults is not None:
            out["faults"] = self.faults.stats.as_dict()
            if self.degraded_reason is not None:
                out["degraded_reason"] = self.degraded_reason
        # disaggregated-exchange telemetry: which two-phase regime served
        # each step, the bytes it moved, and the busiest instance's load
        if self.regime_log:
            out["regime_counts"] = {r: self.regime_log.count(r) for r in sorted(set(self.regime_log))}
            out["transfer_bytes_total"] = int(sum(self.transfer_bytes_log))
            out["transfer_bytes_per_step"] = float(np.mean(self.transfer_bytes_log))
        if self.amax_log:
            out["amax_mean"] = float(np.mean(self.amax_log))
            out["amax_max"] = int(np.max(self.amax_log))
        if not done:
            return out
        ttfts = np.array([r.prefill_done - r.arrival for r in done if r.prefill_done >= 0])
        if len(ttfts):
            out["ttft_mean"] = float(ttfts.mean())
            out["ttft_p99"] = float(np.percentile(ttfts, 99))
        gaps = np.concatenate([r.decode_gaps() for r in done if len(r.token_times) > 1] or [np.zeros(0)])
        span = max(r.finished for r in done) - min(r.arrival for r in done)
        out.update(
            throughput_tok_s=out["tokens"] / max(span, 1e-9),
            tpot_mean=float(gaps.mean()) if len(gaps) else 0.0,
            tpot_p99=float(np.percentile(gaps, 99)) if len(gaps) else 0.0,
            clock=self.clock,
        )
        return out
