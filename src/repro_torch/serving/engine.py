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
  the same on every device.

Options of the reference that later slices port raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.disagg import DevicePools
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import model as model_mod
from repro_torch.models.common import resolve_device
from repro_torch.serving.kv_cache import (
    PagedKVCache,
    SlotManager,
    make_paged_caches,
    scatter_prefill_chunk_caches,
    scatter_prefill_chunk_paged,
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
    "fault_plan": ((None,), "fault recovery"),
    "retry_policy": ((None,), "fault recovery"),
    "watchdog": ((None,), "fault recovery"),
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
        self.decode_stall_time = 0.0
        self.steps_done = 0
        self.amax_log: List[int] = []
        self.regime_log: List[str] = []
        self.transfer_bytes_log: List[int] = []

        moe_ctx = None
        if cfg.has_moe and layout is not None and scheduler != "none":
            moe_ctx = dict(
                layout_tables=layout.device_tables(self.device),
                slot_to_expert=torch.as_tensor(
                    layout.slot_to_expert.reshape(-1), dtype=torch.int32, device=self.device
                ),
                num_instances=layout.num_instances,
                scheduler=SCHEDULERS[scheduler],
                capacity=capacity_tokens,
            )
        self._extra = {"moe_ctx": moe_ctx} if moe_ctx else None

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
            events = self.prefill_worker.poll(self._chunk_sink)
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
        self._ready.extend(self.prefill_worker.poll(self._chunk_sink))
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

    def _ensure_pages(self) -> None:
        """Back every active slot's next write position with a page."""
        if self.paged is not None:
            for s in self.slots.active_slots:
                self.paged.ensure(s, int(self.slots.positions[s]))
            self.caches["block_tables"] = self.paged.table_device(self.device)
        elif self.disagg is not None:
            for s in self.slots.active_slots:
                self.disagg.ensure_slot_pages(s, int(self.slots.positions[s]))

    def _release_pages(self, slot: int) -> None:
        if self.paged is not None:
            self.paged.release(slot)
        elif self.disagg is not None:
            self.disagg.release_slot(slot)

    def _decode_iteration(self) -> None:
        self._ensure_pages()
        positions = self.slots.positions_device(self.device)
        tokens = torch.from_numpy(self.tokens).to(self.device)
        t0 = time.perf_counter()
        if self.disagg is not None:
            logits, tel = self.disagg.decode_step(tokens, positions)
            self.regime_log.append(tel["regime"])
            self.transfer_bytes_log.append(tel["bytes_total"])
            self.amax_log.append(tel["a_max"])
        else:
            logits, self.caches = model_mod.decode_step(
                self.params, tokens, self.caches, positions, self.cfg, extra=self._extra
            )
        next_tokens = model_mod.greedy_token(logits).cpu().numpy()  # waits for the device
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
        out["decode_stall_time"] = self.decode_stall_time
        out["prefill_chunks"] = self.prefill_worker.chunks_done
        if self.paged is not None:
            out["kv_pages"] = self.paged.stats()
        elif self.disagg is not None and self.disagg.kv_page_size is not None:
            out["kv_pages"] = self.disagg.page_stats()
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
