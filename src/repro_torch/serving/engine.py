"""Continuous-batching decode engine with the Janus scheduled-MoE path
(``repro.serving.engine.ServingEngine``): the monolithic executor or the
disaggregated one (``executor="disagg"``).

* admission: an arrived request takes the lowest free slot and its prompt
  goes through the chunked :class:`PrefillWorker`; ``sched="fifo"`` admits
  in arrival order, ``sched="priority"`` by ``Request.priority`` (then
  arrival), and with paged KV spills the KV of a strictly lower-priority
  active slot to free one (preemption: the slot's page list moves into a
  spill record, nothing is copied; the request later resumes where it
  stopped, or replays its history if a re-shard dissolved the record).
  ``"blocking"`` drains a prompt
  before the next decode iteration (the decode clock is charged);
  ``"pipelined"`` (the default with ``n_prefill``) queues it for the prefill
  pool, whose timeline runs beside the decode clock, and activates the slot
  once the clock passes its completion stamp (``max_prefill_queue`` bounds
  the pending prompts; ``prefill_batch`` packs prompts into one chunk call);
* decode: one batched ``decode_step`` per iteration with per-slot positions;
  MoE layers route -> AEBS (``scheduler="aebs"``; on the card that is the K2
  kernel), or the paper's baselines ``"random"`` and ``"token_hash"`` ->
  grouped dispatch over the activated experts (K3 on the card; the einsum
  and scatter oracles with ``dispatch=``);
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
* admission deadlines: a request still waiting for a slot, its prefill or
  its restore past ``Request.deadline`` is rejected
  (``metrics()["rejected"]``); SLO attainment per tenant is
  ``metrics()["slo"]``;
* prefix cache (``prefix_cache``, paged KV only): a :class:`PrefixIndex`
  over published prompts' chunk-aligned prefixes; a hit splices the shared
  pages into the new slot's block table (copy-on-write for a partial tail
  page) and the prefill starts at the first cold chunk, seeded with the
  matched rows.  A prompt is published at activation, when every row is
  written.  ``kv_num_pages`` sizes the page pool (default: full backing);
* speculative decode (``draft_config``, ``draft_params``, ``spec_k``): a
  draft model on the engine's device proposes ``spec_k`` tokens per slot
  over caches of its own, one verify step scores them with the last
  accepted token on either executor, and the longest prefix that matches
  the target's argmax is accepted.  Acceptance is against the target's own
  greedy tokens, so the stream is greedy decode's whatever the draft
  proposes; the draft moves only the tokens gained per step;
* frontends (``extra_builder``): ``extra_builder(1)`` gives the tensors of a
  frontend stub (whisper's ``encoder_frames``, pixtral's ``patch_embeds``),
  which every prefill call gets, as in the reference (one stub shared by
  every request).  The encoder's output lands in the slot's row of
  ``enc_out`` beside the KV caches, and each decode step attends it.

Expert-parallel dispatch (``dispatch="ep"``) needs a mesh, which the engine
does not pass: its first MoE layer raises ``TypeError``, as the reference's
engine does (``moe_layer_ep`` called without ``mesh``); the sharded steps of
``launch/steps.py`` run it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.disagg import DevicePools
from repro_torch.core.placement import layout_for_survivors
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import resolve_device, tree_to
from repro_torch.serving.faults import DEVICE_LOSS, FaultPlan, FaultRuntime, PoolFault, RetryPolicy, Watchdog
from repro_torch.serving.kv_cache import (
    ACTIVE,
    PAGED_KEYS,
    PREFILLING,
    PagedKVCache,
    PrefixIndex,
    SlotManager,
    make_paged_caches,
    paginate_caches,
    scatter_prefill_caches,
    scatter_prefill_chunk_caches,
    scatter_prefill_chunk_paged,
    zero_slots,
)
from repro_torch.serving.disagg import DisaggExecutor
from repro_torch.serving.prefill import PrefillEvent, PrefillWorker
from repro_torch.serving.request import Request

# "aebs" and "aebs_kernel" share one contract (kernels/aebs/ops.py:40-41 of
# the reference); the wrapper runs the CUDA kernel on the card and the plain
# aebs_assign on the CPU.  "random" and "token_hash" are the paper's
# baselines (plain PyTorch on every device, as in the reference).
SCHEDULERS = {
    "aebs": aebs_schedule,
    "aebs_kernel": aebs_schedule,
    "random": baselines.random_assign,
    "token_hash": baselines.token_hash_assign,
    "none": None,
}

# request admission orders (``sched=``): fifo = arrival order, priority =
# higher ``Request.priority`` first, preempting through KV spill/restore
ADMISSION_SCHEDS = ("fifo", "priority")


@dataclasses.dataclass
class _SpillRecord:
    """A preempted request waiting off-batch: its detached KV (a mono
    ``SpilledKV`` or a disagg ``SpilledSlotKV``) and, on disagg, the shard
    its pages live on.  ``payload=None``: a re-shard dissolved the pages,
    and the restore replays the request's history."""

    req: Request
    payload: Optional[Any]
    shard: Optional[int] = None
    spilled_at: float = 0.0  # engine clock at preemption (TPOT leaves the wait out)


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
        kv_num_pages: Optional[int] = None,  # pool size (default: full backing + null)
        prefix_cache: bool = False,  # page-granular prefix reuse (needs paging)
        prefix_cache_pages: Optional[int] = None,  # the index's pin budget (None: unbounded)
        sched: str = "fifo",  # request admission: fifo | priority (preemptive)
        capacity_tokens: Optional[int] = None,
        prefill_capacity_tokens: Optional[int] = None,
        dispatch: str = "grouped",  # grouped (slot-indirect hot path) | einsum | scatter
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
        draft_config=None,  # a config that drafts tokens: speculative decode
        draft_params=None,  # default: the target's weights (self-draft) or a fresh draw
        spec_k: int = 0,  # drafts per verify step (0 with a draft_config: 2)
        extra_builder: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None,  # frontend stubs
        device="cuda",
    ):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; choose from {sorted(SCHEDULERS)}")
        moe_mod.check_dispatch(dispatch)
        if max_prefill_queue is not None and max_prefill_queue < 1:
            raise ValueError(
                f"max_prefill_queue must be ≥ 1, got {max_prefill_queue} "
                "(a zero bound would close admission permanently)"
            )
        if sched not in ADMISSION_SCHEDS:
            raise ValueError(f"unknown admission scheduler {sched!r}; choose from {ADMISSION_SCHEDS}")
        if prefix_cache:
            if kv_page_size is None:
                raise ValueError(
                    "prefix_cache requires paged KV storage (set kv_page_size) "
                    "— a hit is served by block-table page sharing"
                )
            if not model_mod.supports_batched_prefill(cfg):
                raise ValueError(
                    "prefix_cache requires an architecture whose decode caches "
                    "are all full-attention (dense/moe periods) — rolling-"
                    "window / recurrent state cannot be seeded positionally"
                )
        if spec_k < 0:
            raise ValueError(f"spec_k must be ≥ 0, got {spec_k}")
        if spec_k and draft_config is None:
            raise ValueError("spec_k > 0 requires a draft_config")
        if draft_config is not None:
            if not model_mod.supports_speculative_decode(cfg):
                raise ValueError(
                    "speculative decode requires full-context dense/moe decode "
                    "layers (rolling-window / recurrent state has no batched "
                    "multi-position verify)"
                )
            if draft_config.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({draft_config.vocab_size}) must match target vocab "
                    f"({cfg.vocab_size}) — draft tokens are verified verbatim"
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
        self.kv_num_pages = kv_num_pages
        self.sched = sched
        self._spilled: List[_SpillRecord] = []  # preempted, awaiting restore
        self.preempt_count = 0
        self.restore_count = 0
        self.spill_replay_count = 0  # restores that replayed (their pages dissolved)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_cache_pages = prefix_cache_pages
        self.prefix: Optional[PrefixIndex] = None  # the mono executor's index
        self.faults: Optional[FaultRuntime] = None
        self.degraded_reason: Optional[str] = None
        # notified on every permanent device loss as fn(fault, clock); the
        # AutoScaler attaches here
        self.fault_listeners: List[Callable[[PoolFault, float], None]] = []
        self._scheduler = SCHEDULERS[scheduler]
        self._capacity = capacity_tokens
        self._dispatch = dispatch
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
                kv_num_pages=kv_num_pages, prefix_cache=self.prefix_cache,
                prefix_cache_pages=prefix_cache_pages, prefix_chunk=max(1, int(prefill_chunk)),
            )
            self.caches = None  # the executor's attention shards hold the KV
        elif executor == "mono":
            if pools is None and n_prefill:
                pools = DevicePools.split(0, 0, [self.device], n_prefill=n_prefill, allow_reuse=True)
            self.caches = model_mod.init_decode_caches(cfg, max_batch, cache_len, self.device)
            if kv_page_size is not None:
                self.paged, self.caches = make_paged_caches(
                    self.caches, max_batch, cache_len, kv_page_size, kv_num_pages
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
            capacity=prefill_capacity_tokens, extra=extra_builder(1) if extra_builder else None,
            batch=prefill_batch, prefill_time_fn=worker_time_fn,
        )
        if self.prefix_cache and self.paged is not None:
            self.prefix = PrefixIndex(self.prefill_worker.chunk, self.paged, max_pages=prefix_cache_pages)
        if fault_plan is not None:
            self.arm_faults(fault_plan, policy=retry_policy, watchdog=watchdog)

        # speculative decode: the draft decodes over contiguous caches of its
        # own on the engine's device, without the MoE context (no AEBS)
        self.spec_k = int(spec_k or (2 if draft_config is not None else 0))
        self.draft_config = draft_config if self.spec_k else None
        self.spec_steps = 0  # verify iterations taken
        self.spec_slot_steps = 0  # per-slot verify participations
        self.spec_draft_tokens = 0  # draft proposals scored
        self.spec_draft_accepted = 0  # draft proposals accepted
        self.spec_emitted_tokens = 0  # tokens emitted by verify steps
        self._draft_params = None
        self._draft_caches = None
        # slot -> (rid, n): draft cache rows [0, n) hold request rid's stream;
        # anything less at the slot's position rebuilds them
        self._draft_stream: Dict[int, tuple] = {}
        if self.spec_k:
            dcfg = draft_config
            if draft_params is not None:
                self._draft_params = draft_params
            elif dcfg is cfg or dcfg.name == cfg.name:
                self._draft_params = params  # self-draft: the target's weights
            else:
                # torch draws other numbers than the reference's JAX PRNG
                self._draft_params = model_mod.init_params(dcfg, seed=0, device=self.device)
            self._draft_caches = model_mod.init_decode_caches(dcfg, max_batch, cache_len, self.device)

    def _mono_extra(self, layout: Optional[ReplicaLayout]) -> Optional[Dict]:
        """The mono step's MoE context over ``layout``'s tables on the
        engine's device (None without a layout or scheduler)."""
        if not (self.cfg.has_moe and layout is not None and self._scheduler is not None):
            return None
        return {"moe_ctx": dict(
            dispatch=self._dispatch,
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
        lost = ex.drop_attn_device(fault.index)
        # the re-shard rebuilt the page pools from slot-owned pages: spilled
        # KV dissolved with the old ones
        self._invalidate_spills()
        self._rebuild_lost_slots(lost)

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
        """Restart ``req``'s prompt in its own slot: its pages (prefix pins
        too) are released and the prefix cache spliced afresh, so the restart
        writes only pages of its own."""
        slot = req.slot
        self.slots.fail(slot)
        self.slots.requeue(slot)
        self.slots.start_prefill(slot)
        self._release_pages(slot)
        start, seed = self._prefix_splice(req, slot)
        self.prefill_worker.submit(req, slot, now=max(self.clock, req.arrival), start=start, seed_caches=seed)
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
            self.paged, caches = paginate_caches(caches, lengths, self.kv_page_size, self.kv_num_pages)
            if self.prefix_cache:
                # sharing dissolved with the shards' pools: a fresh index
                self.prefix = PrefixIndex(self.prefill_worker.chunk, self.paged,
                                          max_pages=self.prefix_cache_pages)
        self.caches = caches
        self._extra = self._mono_extra(self.layout)
        self.executor_name = "mono"
        self.degraded_reason = reason
        self._invalidate_spills()  # the shards' pools died with the executor
        if lost_rows:
            self._rebuild_lost_slots(lost_rows)

    def _guarded_decode(self, positions: torch.Tensor, spec=None):
        """One decode (or verify) step in the fault envelope: a transient
        exchange fault retries the (idempotent) step under exponential
        backoff; a spent retry budget degrades to mono; injected
        sub-deadline delays are charged to the clock."""
        if self.faults is None:
            return self._decode_once(positions, spec)
        attempt = 0
        while True:
            try:
                out = self._decode_once(positions, spec)
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

    def _decode_once(self, positions: torch.Tensor, spec=None):
        """One batched step: (next tokens on the host, telemetry or None).
        With ``spec = (tokens [b, c], widths [b])`` it is a verify step and
        the tokens are the ``[b, c]`` argmaxes of its rows."""
        tel = None
        if spec is not None:
            tokens, widths = spec
            if self.disagg is not None:
                logits, tel = self.disagg.decode_step_verify(tokens, positions, widths)
            else:
                logits, self.caches = model_mod.decode_step_verify(
                    self.params, tokens, self.caches, positions, self.cfg, extra=self._extra, widths=widths
                )
            return model_mod.greedy_token(logits).cpu().numpy(), tel  # waits for the device
        tokens = torch.from_numpy(self.tokens).to(self.device)
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
    # prefix cache
    # ------------------------------------------------------------------
    def _prefix_splice(self, req: Request, slot: int):
        """Serve the longest cached prefix of ``req``'s prompt into the empty
        ``slot``: splice the shared pages into its block table, copy the
        first ``rows`` rows of a partial tail page (every pool array of every
        layer), and gather the matched rows on the device to seed the
        worker.  Returns ``(start, seed_caches)``, ``(0, None)`` on a miss.
        The match stays below the prompt length, so at least one token
        prefills (activation needs its logits)."""
        if not self.prefix_cache:
            return 0, None
        tokens = self.prefill_worker.prompt_of(req)
        chunk = self.prefill_worker.chunk
        limit = ((len(tokens) - 1) // chunk) * chunk
        if limit <= 0:
            return 0, None
        if self.disagg is not None:
            return self.disagg.splice_prefix(slot, tokens, limit)
        match, pages = self.prefix.lookup(tokens, limit)
        if not match:
            return 0, None
        cow = self.paged.splice(slot, pages, match)
        keys = [k for k in PAGED_KEYS if k in self.caches]
        if cow is not None:
            src, dst, rows = cow
            for k in keys:
                self.caches[k][:, dst, :rows] = self.caches[k][:, src, :rows]
        pgs, offs = (torch.from_numpy(a.astype(np.int64)).to(self.device)
                     for a in self.paged.rows_of(slot, 0, match))
        self.caches["block_tables"] = self.paged.table_device(self.device)
        return match, {k: self.caches[k][:, pgs, offs] for k in keys}

    def _prefix_publish(self, req: Request, slot: int) -> None:
        """Index the chunk-aligned span of the prompt ``slot`` has prefilled
        (at activation, once every row is written)."""
        if not self.prefix_cache:
            return
        tokens = self.prefill_worker.prompt_of(req)
        upto = (len(tokens) // self.prefill_worker.chunk) * self.prefill_worker.chunk
        if upto <= 0:
            return
        if self.disagg is not None:
            self.disagg.publish_prefix(slot, tokens, upto)
        else:
            self.prefix.publish(tokens, upto, slot)

    # ------------------------------------------------------------------
    # priority scheduling: preemption through KV spill/restore
    # ------------------------------------------------------------------
    def _preempt_capable(self) -> bool:
        """Preemption needs paged KV: a spill detaches a block table."""
        return self.paged is not None or (self.disagg is not None and self.disagg._pagers is not None)

    def _find_slot(self, shard: Optional[int]) -> Optional[int]:
        """The lowest free slot, on disagg shard ``shard`` when a spilled
        record must go back where its pages live."""
        free = self.slots.free_slots
        if shard is None or self.disagg is None:
            return free[0] if free else None
        return next((s for s in free if self.disagg.shard_of(s) == shard), None)

    def _pick_victim(self, priority: int, shard: Optional[int]) -> Optional[int]:
        """The active slot to preempt for a candidate of ``priority``: a
        strictly lower priority only, the least generated first, the slot
        index breaking ties."""
        best = None
        for s in self.slots.active_slots:
            if shard is not None and self.disagg is not None and self.disagg.shard_of(s) != shard:
                continue
            req = self.slots.slot_req[s]
            if req.priority >= priority:
                continue
            key = (req.priority, req.generated, s)
            if best is None or key < best[0]:
                best = (key, s)
        return None if best is None else best[1]

    def preempt_slot(self, slot: int) -> Request:
        """Preempt an ACTIVE slot: its page list moves into a spill record
        (prefix pins ride along in the refcounts) and the slot frees.  The
        request keeps its stream state and resumes where it stopped."""
        if self.slots.state[slot] != ACTIVE:
            raise RuntimeError(f"slot {slot} is {self.slots.state[slot]}, cannot preempt")
        if self.paged is not None:
            payload, shard = self.paged.spill(slot), None
        elif self.disagg is not None and self.disagg._pagers is not None:
            payload, shard = self.disagg.spill_slot(slot)
        else:
            raise RuntimeError("preemption requires paged KV (set kv_page_size)")
        req = self.slots.release(slot)
        req.preemptions += 1
        self._spilled.append(_SpillRecord(req=req, payload=payload, shard=shard, spilled_at=self.clock))
        self.preempt_count += 1
        self._draft_stream.pop(slot, None)
        return req

    def _restore_record(self, rec: _SpillRecord, slot: int) -> None:
        """Re-admit a spilled request into the free ``slot``: re-attach its
        pages (or replay its history when a re-shard dissolved them) and
        resume at ``input_len + generated`` with its last token as input."""
        req = rec.req
        self.slots.reserve(req, slot=slot)
        if rec.payload is None:
            self.slots.resume(slot)
            self._replay_slot(slot)
            self.spill_replay_count += 1
        else:
            if self.paged is not None:
                self.paged.restore(slot, rec.payload)
            else:
                self.disagg.restore_slot(slot, rec.payload)
            self.slots.resume(slot)
        self.tokens[slot, 0] = req.tokens_out[-1]
        # the wait between two of its tokens is scheduling, not decode
        if req.wait_spans is None:
            req.wait_spans = []
        req.wait_spans.append((rec.spilled_at, self.clock))
        self.restore_count += 1

    def _drop_spill(self, rec: _SpillRecord) -> None:
        """Abandon a spill record (its deadline passed): free its pages."""
        if rec.payload is None:
            return
        if self.paged is not None:
            self.paged.drop_spilled(rec.payload)
        elif self.disagg is not None:
            self.disagg.drop_spilled(rec.payload)

    def _invalidate_spills(self) -> None:
        """An attention re-shard (device loss, reconfigure, degrade) rebuilt
        the page pools from slot-owned pages: every spill record restores by
        replay."""
        for rec in self._spilled:
            rec.payload = None
            rec.shard = None

    def _admit(self, req: Request) -> None:
        if self.admission == "pipelined":
            self._submit_request(req)
        else:
            self._prefill_request(req)

    def _schedule_admission(self, waiting: List[Request]) -> List[Request]:
        """Place arrived work into slots.  ``fifo``: strict arrival order.
        ``priority``: spilled and new requests in one order (priority,
        restores before admits, arrival, rid); with no free slot, the
        lowest-priority active slot is spilled for a strictly higher-priority
        candidate."""
        if self.sched == "fifo":
            while waiting and waiting[0].arrival <= self.clock and self.slots.free_slots and self._admission_open():
                self._admit(waiting.pop(0))
            return waiting
        while True:
            cands = [(-rec.req.priority, 0, rec.req.arrival, rec.req.rid, rec) for rec in self._spilled]
            cands += [(-r.priority, 1, r.arrival, r.rid, r) for r in waiting if r.arrival <= self.clock]
            cands.sort(key=lambda c: c[:4])
            progressed = False
            for *_, item in cands:
                is_restore = isinstance(item, _SpillRecord)
                # a restore needs no prefill, so backpressure does not hold it
                if not is_restore and not self._admission_open():
                    continue
                shard = item.shard if is_restore else None
                slot = self._find_slot(shard)
                if slot is None and self._preempt_capable():
                    victim = self._pick_victim(item.req.priority if is_restore else item.priority, shard)
                    if victim is not None:
                        self.preempt_slot(victim)
                        slot = self._find_slot(shard)
                if slot is None:
                    continue
                if is_restore:
                    self._spilled.remove(item)
                    self._restore_record(item, slot)
                else:
                    waiting.remove(item)
                    self._admit(item)
                progressed = True
                break
            if not progressed:
                return waiting

    # ------------------------------------------------------------------
    def _prefill_request(self, req: Request) -> None:
        """Blocking admission: drain the worker for this one request."""
        stalled = self.slots.num_active > 0
        slot = self.slots.reserve(req)
        self.slots.start_prefill(slot)
        now = max(self.clock, req.arrival)
        start, seed = self._prefix_splice(req, slot)
        self.prefill_worker.submit(req, slot, now=now, start=start, seed_caches=seed)
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
        self._prefix_publish(req, slot)

    def _submit_request(self, req: Request) -> None:
        """Pipelined admission: reserve the slot and queue the prompt for the
        prefill pool; the decode clock is never charged."""
        slot = self.slots.reserve(req)
        self.slots.start_prefill(slot)
        start, seed = self._prefix_splice(req, slot)
        self.prefill_worker.submit(req, slot, now=max(self.clock, req.arrival), start=start, seed_caches=seed)

    def _admission_open(self) -> bool:
        """Backpressure: stop admitting when the prefill queue is full."""
        if self.max_prefill_queue is None:
            return True
        return self.prefill_worker.num_pending < self.max_prefill_queue

    def _chunk_sink(self, slot: int, start: int, length: int, one_caches: Dict) -> None:
        """Land one streamed prefill chunk (or a whole-prompt cache, ``length
        == -1``) in the decode caches (``engine.py:1037``)."""
        if self.disagg is not None:
            if length < 0:
                self.disagg.scatter_prefill(one_caches, slot)
            else:
                self.disagg.scatter_prefill_chunk(one_caches, slot, start, length)
        elif self.paged is not None:
            if length < 0:
                # the prompt's rows as one chunk; positionless state (Mamba
                # states) takes the contiguous path
                start, length = 0, self.slots.slot_req[slot].input_len
                rest = {k: v for k, v in one_caches.items() if not k.startswith("kv_")}
                if rest:
                    scatter_prefill_caches(self.caches, rest, slot)
            self.caches = scatter_prefill_chunk_paged(
                self.caches, one_caches, slot, start, length, self.paged
            )
        elif length < 0:
            self.caches = scatter_prefill_caches(self.caches, one_caches, slot)
        else:
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
                self._prefix_publish(ev.req, ev.slot)
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

    # ------------------------------------------------------------------
    # speculative decode: draft -> verify -> greedy acceptance
    # ------------------------------------------------------------------
    def _draft_ensure(self, slot: int) -> None:
        """Make the draft's cache rows of ``slot`` hold its request's stream
        up to the slot's position: a fresh activation, a restore and a reused
        slot rebuild them by a whole-history draft prefill; a slot that went
        on through verify steps is covered already.  The rebuild need not
        match the incremental rows bit for bit: the draft moves only the
        acceptance rate, never the tokens."""
        req = self.slots.slot_req[slot]
        pos = int(self.slots.positions[slot])
        rid, have = self._draft_stream.get(slot, (None, -1))
        if rid == req.rid and have >= pos:
            return
        history = self.prefill_worker.prompt_of(req)
        if req.generated:
            history = np.concatenate([history, np.asarray(req.tokens_out[:-1], np.int32)])
        one = self._draft_prefill(torch.from_numpy(history[None].astype(np.int64)).to(self.device))
        scatter_prefill_caches(self._draft_caches, one, slot)
        self._draft_stream[slot] = (req.rid, pos)

    def _draft_prefill(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The draft's whole-prompt prefill: its caches for one history."""
        return model_mod.prefill(self._draft_params, tokens, self.draft_config, self.cache_len)[1]

    def _spec_widths(self) -> np.ndarray:
        """Per-slot verify width: ``spec_k + 1`` rows (the last accepted
        token and the drafts), clamped so that a slot never scores past its
        remaining output or the cache rows greedy decode could have written
        (positions <= cache_len - 3 before the truncation check)."""
        c = self.spec_k + 1
        widths = np.zeros(self.max_batch, np.int64)
        for s in self.slots.active_slots:
            req = self.slots.slot_req[s]
            pos = int(self.slots.positions[s])
            widths[s] = max(1, min(c, req.output_len - req.generated, self.cache_len - 2 - pos))
        return widths

    def _spec_iteration(self) -> None:
        """One speculative iteration (``engine.py:1165``): ``spec_k + 1``
        draft forwards (the last keeps the draft's cache one token behind the
        feed, so a fully accepted round leaves no stale row), one verify
        step, then per-slot greedy acceptance.  A slot gains 1 to ``spec_k +
        1`` tokens; rejected rows stay past its position, where the decode
        mask never reads them, and the paged high-water mark is truncated
        back to the accepted length."""
        if self.faults is not None:
            self._fault_preflight()
        active = list(self.slots.active_slots)
        widths = self._spec_widths()
        self._ensure_pages({s: int(self.slots.positions[s]) + int(widths[s]) - 1 for s in active})
        for s in active:
            self._draft_ensure(s)
        t0 = time.perf_counter()
        c = self.spec_k + 1
        cols = [torch.from_numpy(self.tokens).to(self.device)]
        for j in range(c):
            dpos = np.minimum(self.slots.positions.astype(np.int64) + j, self.cache_len - 1)
            dlogits, _ = model_mod.decode_step(self._draft_params, cols[-1], self._draft_caches,
                                               torch.from_numpy(dpos).to(self.device), self.draft_config)
            if j < self.spec_k:
                cols.append(torch.argmax(dlogits, dim=-1, keepdim=True))
        vtokens = torch.cat(cols, dim=1)
        positions = self.slots.positions_device(self.device)
        greedy, tel = self._guarded_decode(positions, spec=(vtokens, torch.from_numpy(widths).to(self.device)))
        if tel is not None:
            self.regime_log.append(tel["regime"])
            self.transfer_bytes_log.append(tel["bytes_total"])
            self.amax_log.append(tel["a_max"])
        wall = time.perf_counter() - t0
        self.clock += self.step_time_fn(self.slots.num_active) if self.step_time_fn else wall
        self.steps_done += 1
        self.spec_steps += 1
        drafts = vtokens[:, 1:].cpu().numpy()
        for s in active:
            if self.slots.state[s] != ACTIVE:
                continue  # released by a recovery path mid-iteration
            req = self.slots.slot_req[s]
            w = int(widths[s])
            a = 0
            while a < w - 1 and drafts[s, a] == greedy[s, a]:
                a += 1
            self.spec_slot_steps += 1
            self.spec_draft_tokens += w - 1
            self.spec_draft_accepted += a
            self.spec_emitted_tokens += a + 1
            for j in range(a + 1):
                req.generated += 1
                req.token_times.append(self.clock)
                self.slots.advance(s)
                if req.tokens_out is not None:
                    req.tokens_out.append(int(greedy[s, j]))
            self.tokens[s, 0] = int(greedy[s, a])
            pos = int(self.slots.positions[s])
            # the verify backed w rows and a + 1 advanced: keep the
            # high-water mark (spill records, occupancy) at the accepted rows
            if self.paged is not None:
                self.paged.truncate(s, pos)
            elif self.disagg is not None:
                self.disagg.truncate_slot(s, pos)
            self._draft_stream[s] = (req.rid, pos)
            if req.generated >= req.output_len or pos >= self.cache_len - 2:
                if req.generated < req.output_len:
                    req.truncated = True  # context exhausted before the target length
                req.finished = self.clock
                self.completed.append(self.slots.release(s))
                self._release_pages(s)
                self._draft_stream.pop(s, None)

    def _decode_iteration(self) -> None:
        if self.spec_k:
            self._spec_iteration()
            return
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
        while (waiting or self._spilled or self.slots.num_active or self._prefill_pending()) and steps < max_steps:
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
            # a spilled request whose deadline passed off-batch is dropped,
            # and its pages return to the pool
            for rec in list(self._spilled):
                if rec.req.deadline is not None and self.clock > rec.req.deadline:
                    self._spilled.remove(rec)
                    self._drop_spill(rec)
                    self._reject(rec.req)
            waiting = self._schedule_admission(waiting)
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
        if relower.get("attn"):
            self._invalidate_spills()  # the re-shard rebuilt the page pools
        self.layout = self.disagg.layout
        if relower.get("prefill"):
            self.prefill_worker.set_devices(self.disagg.pools.prefill_devices, self.params)
        return relower

    def metrics(self) -> Dict:
        done = self.completed
        out: Dict = {"completed": len(done), "tokens": sum(r.generated for r in done)}
        out["truncated"] = sum(1 for r in done if r.truncated)
        out["rejected"] = len(self.rejected)
        out["preemptions"] = self.preempt_count
        out["restores"] = self.restore_count
        if self.spill_replay_count:
            out["spill_replays"] = self.spill_replay_count
        # SLO attainment over every request with a TTFT or TPOT target;
        # rejected and unserved ones count as misses
        measured = [r for r in done + self.rejected if r.slo_ok() is not None]
        if measured:
            per_tenant: Dict[str, List[bool]] = {}
            for r in measured:
                per_tenant.setdefault(r.tenant, []).append(bool(r.slo_ok()))
            attained = sum(1 for r in measured if r.slo_ok())
            out["slo"] = {
                "measured": len(measured),
                "attained": attained,
                "attainment": attained / len(measured),
                "per_tenant": {t: sum(v) / len(v) for t, v in sorted(per_tenant.items())},
            }
        out["decode_stall_time"] = self.decode_stall_time
        out["prefill_chunks"] = self.prefill_worker.chunks_done
        if self.spec_k:
            out["spec"] = {
                "k": self.spec_k,
                "steps": self.spec_steps,
                "draft_tokens": self.spec_draft_tokens,
                "accepted_draft_tokens": self.spec_draft_accepted,
                "emitted_tokens": self.spec_emitted_tokens,
                "accepted_per_step": self.spec_emitted_tokens / self.spec_slot_steps if self.spec_slot_steps else 0.0,
                "acceptance_rate": (self.spec_draft_accepted / self.spec_draft_tokens
                                    if self.spec_draft_tokens else 0.0),
            }
        if self.paged is not None:
            out["kv_pages"] = self.paged.stats()
        elif self.disagg is not None and self.disagg.kv_page_size is not None:
            out["kv_pages"] = self.disagg.page_stats()
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.stats()
        elif self.disagg is not None and self.disagg.prefix_stats() is not None:
            out["prefix_cache"] = self.disagg.prefix_stats()
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
