"""Prefill pool worker: chunked prompt prefill with streamed KV hand-off
(``repro.serving.prefill.PrefillWorker``).

The worker owns the prefill pool's devices (``DevicePools.prefill_devices``;
on one card they alias the engine's device), each with the model's
parameters, and drives an admission pipeline beside the decode loop:

* the engine reserves a slot for an arrived request and submits it here; it
  queues (FIFO) until a pool device is free;
* each :meth:`PrefillWorker.poll` advances every device by up to
  ``max_chunks_per_poll`` fixed-size chunks; with ``batch > 1`` a device
  packs up to ``batch`` pending prompts into one padded-and-masked
  :func:`repro_torch.models.model.prefill_chunk_batched` call (row by row
  what the serial path computes);
* after every chunk its KV rows go to the engine's ``sink``, which lands them
  in the decode caches; a stack that cannot chunk (``chunked`` false: the
  Mamba and hybrid stacks) takes one whole-prompt
  :func:`repro_torch.models.model.prefill` call and hands the whole cache,
  recurrent state included, over (``length == -1``); a sliding-window
  stack's chunk is clamped to its rolling buffer (``prefill.py:90-93``);
* the last chunk's last-position logits give the request's first token;
* a prefix-cache hit submits with ``start`` (the chunk-aligned tokens its
  shared pages already hold) and ``seed_caches`` (those rows' KV): the
  per-request cache is seeded with rows ``[0, start)`` and prefill begins at
  the first cold chunk.

Calls are timed by the wall clock around work that ends in a device read
(or by ``prefill_time_fn(prompt tokens)`` under a modeled clock), on a
per-device pool timeline (``busy_until``) that runs beside the engine's
decode clock; the engine activates a finished request once its clock passes
the completion stamp.  Prompts route over logical experts (no replica
scheduling) with drop-free capacity by default: each call's own token count
(``prefill.py:112-123``); ``capacity`` fixes it instead (the engine's
``prefill_capacity_tokens``).  ``extra`` holds a frontend's tensors
(``encoder_frames``, ``patch_embeds``), which every call of the worker
passes on; each pool device keeps its own copy.

Faults: ``fault_hook(slot, device index, chunk ordinal)`` (the engine's
:meth:`repro_torch.serving.faults.FaultRuntime.prefill_hook` when a plan is
armed) runs before any compute of a chunk, so a retried poll is safe;
:meth:`PrefillWorker.fail_device` drops a dead device's in-flight work and
:meth:`PrefillWorker.run_sync` replays a prompt for recovery.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import model as model_mod
from repro_torch.models.common import tree_to
from repro_torch.serving.request import Request


@dataclasses.dataclass
class PrefillEvent:
    req: Request
    slot: int
    first_token: int
    finish_t: float  # completion stamp on the prefill pool's timeline


@dataclasses.dataclass
class _InFlight:
    req: Request
    slot: int
    dev_index: int
    prompt: np.ndarray
    caches: Optional[Dict[str, torch.Tensor]] = None
    done: int = 0  # prompt tokens already prefilled (or served from the prefix cache)
    ready_t: float = 0.0  # timeline moment the next chunk may start
    prefix: int = 0  # leading tokens served by the prefix cache
    seed: Optional[Dict[str, torch.Tensor]] = None  # their KV rows, [L, prefix, ...] per key


class PrefillWorker:
    def __init__(
        self,
        cfg,
        params,
        devices: Optional[Sequence[torch.device]] = None,
        *,
        device,
        cache_len: int,
        chunk: int = 64,
        capacity: Optional[int] = None,
        extra: Optional[Dict[str, torch.Tensor]] = None,
        max_chunks_per_poll: int = 1,
        batch: int = 1,
        prefill_time_fn: Optional[Callable[[int], float]] = None,
    ):
        self.cfg = cfg
        self.device = torch.device(device)  # the engine's: serves an empty pool
        self.cache_len = cache_len
        self.chunk = max(1, int(chunk))
        if cfg.sliding_window:
            # a windowed layer attends [cache, chunk]: a chunk longer than the
            # rolling buffer would overwrite keys its own queries still need
            self.chunk = min(self.chunk, min(cache_len, cfg.sliding_window))
        self.capacity = capacity
        self.extra = extra
        self.prefill_time_fn = prefill_time_fn
        self.max_chunks_per_poll = max(1, int(max_chunks_per_poll))
        self.chunked = model_mod.supports_chunked_prefill(cfg)
        # batched multi-prompt prefill: up to ``batch`` pending prompts share
        # one padded chunk call per device
        self.batch = max(1, int(batch))
        self.batched = self.batch > 1 and model_mod.supports_batched_prefill(cfg)
        self.chunks_done = 0
        # called before each chunk's compute when a fault plan is armed
        self.fault_hook: Optional[Callable[[int, int, int], None]] = None
        self._queue: List[_InFlight] = []
        self.set_devices(devices, params)

    # ------------------------------------------------------------------
    # pool membership (reconfigure)
    # ------------------------------------------------------------------
    def set_devices(self, devices: Optional[Sequence[torch.device]], params) -> None:
        """(Re-)place the parameters on every pool device; an empty pool runs
        on the engine's device.  A surviving device keeps its timeline, new
        ones start idle, and in-flight requests move with their caches to
        the resized pool, so a resize loses no chunk progress."""
        devs = [torch.device(d) for d in (devices or [])] or [self.device]
        self.devices = devs
        self._params = [tree_to(params, d) for d in devs]
        self._extras = [tree_to(self.extra or {}, d) for d in devs]
        old_busy = getattr(self, "busy_until", [])
        self.busy_until = [old_busy[i] if i < len(old_busy) else 0.0 for i in range(len(devs))]
        cur = getattr(self, "_current", None)
        self._current: List[List[_InFlight]] = [[] for _ in devs]
        for e in [e for group in cur or [] for e in group]:
            e.dev_index = min(e.dev_index, len(devs) - 1)
            if e.caches is not None:
                e.caches = tree_to(e.caches, devs[e.dev_index])
            if len(self._current[e.dev_index]) < self.batch:
                self._current[e.dev_index].append(e)
            else:
                self._queue.insert(0, e)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, req: Request, slot: int, now: float, start: int = 0,
               seed_caches: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Queue a reserved request (FIFO).  A prefix hit passes ``start``
        (tokens its shared pages hold) and ``seed_caches`` (their rows)."""
        start = int(start)
        self._queue.append(_InFlight(req, slot, -1, self.prompt_of(req), done=start, ready_t=now,
                                     prefix=start, seed=seed_caches))

    def prompt_of(self, req: Request) -> np.ndarray:
        """The request's prompt, or the reference's seeded synthetic one."""
        if req.prompt is not None:
            return np.asarray(req.prompt, np.int32)
        rng = np.random.default_rng(req.rid)
        return rng.integers(0, self.cfg.vocab_size, size=req.input_len, dtype=np.int32)

    @property
    def num_pending(self) -> int:
        return len(self._queue) + sum(len(g) for g in self._current)

    # ------------------------------------------------------------------
    # fault recovery
    # ------------------------------------------------------------------
    def fail_device(self, dev_index: int) -> List[Request]:
        """A prefill device died: drop its in-flight entries' partial caches
        (they lived on the dead device) and return the displaced requests for
        the engine to requeue from chunk 0.  The device stays in
        ``self.devices`` until the engine resizes the pool."""
        displaced: List[Request] = []
        if 0 <= dev_index < len(self._current):
            for entry in self._current[dev_index]:
                entry.caches = entry.seed = None
                entry.done = entry.prefix = 0
                displaced.append(entry.req)
            self._current[dev_index] = []
        return displaced

    def cancel_slot(self, slot: int) -> Optional[Request]:
        """Withdraw a queued or in-flight request by slot; returns it, or None
        if the worker no longer holds it."""
        for group in [self._queue] + self._current:
            for entry in group:
                if entry.slot == slot:
                    group.remove(entry)
                    entry.caches = entry.seed = None
                    entry.done = entry.prefix = 0
                    return entry.req
        return None

    def run_sync(self, prompt: np.ndarray, slot: int, sink) -> int:
        """Replay ``prompt`` synchronously on pool device 0, streaming every
        chunk through ``sink``; it bypasses the queue, the pool timeline and
        the fault hook (recovery work is not re-faulted).  The chunk grid is
        the queued path's (fixed size from 0), so the replayed KV is what the
        original admission streamed.  Returns the first generated token."""
        dev, params = self.devices[0], self._params[0]
        prompt = np.asarray(prompt, np.int32)
        n = len(prompt)
        if not self.chunked:
            toks = torch.from_numpy(prompt[None, :].astype(np.int64)).to(dev)
            logits, caches = model_mod.prefill(params, toks, self.cfg, self.cache_len, extra=self._extra(n, 0))
            sink(slot, 0, -1, caches)
            return int(model_mod.greedy_token(logits)[0])
        caches = model_mod.init_decode_caches(self.cfg, 1, self.cache_len, dev)
        for lo in range(0, n, self.chunk):
            hi = min(lo + self.chunk, n)
            toks = torch.from_numpy(prompt[lo:hi][None, :].astype(np.int64)).to(dev)
            logits, caches = model_mod.prefill_chunk(params, toks, caches, lo, self.cfg,
                                                     extra=self._extra(hi - lo, 0))
            sink(slot, lo, hi - lo, caches)
        return int(model_mod.greedy_token(logits)[0])

    # ------------------------------------------------------------------
    # the pipeline: one poll = at most ``max_chunks_per_poll`` chunks a device
    # ------------------------------------------------------------------
    def poll(self, sink: Callable[[int, int, int, Dict], None]) -> List[PrefillEvent]:
        """Advance prefill work, streaming each chunk through ``sink(slot,
        start, length, one_caches)`` (``length == -1``: a whole-prompt
        cache).  Returns the requests whose prefill finished, stamped with
        their completion times on the pool's timeline."""
        events: List[PrefillEvent] = []
        limit = self.batch if self.batched else 1
        for di in range(len(self.devices)):
            group = self._current[di]
            while len(group) < limit and self._queue:
                entry = self._queue.pop(0)
                if entry.caches is not None and entry.dev_index != di:
                    entry.caches = tree_to(entry.caches, self.devices[di])
                entry.dev_index = di
                group.append(entry)
            if not group:
                continue
            for _ in range(self.max_chunks_per_poll):
                events.extend(self._advance_group(di, sink))
                if not self._current[di]:
                    break
        return events

    def _advance_group(self, di: int, sink) -> List[PrefillEvent]:
        group = self._current[di]
        if len(group) == 1:
            ev = self._advance(group[0], sink)
            if ev is None:
                return []
            self._current[di] = []
            return [ev]
        return self._advance_batched(di, sink)

    def _elapsed(self, t0: float, n_tokens: int) -> float:
        return self.prefill_time_fn(n_tokens) if self.prefill_time_fn else time.perf_counter() - t0

    def _extra(self, n_tokens: int, di: int) -> Optional[Dict]:
        """Device ``di``'s frontend tensors, and the MoE context: drop-free
        capacity unless fixed, a call's own token count."""
        extra = dict(self._extras[di])
        if self.cfg.has_moe:
            extra["moe_ctx"] = {"capacity": n_tokens if self.capacity is None else self.capacity}
        return extra or None

    def _init_caches(self, entry: _InFlight, dev) -> Dict[str, torch.Tensor]:
        """Fresh per-request caches; a prefix hit's seed fills rows ``[0,
        prefix)`` so its cold chunks attend the whole span."""
        caches = model_mod.init_decode_caches(self.cfg, 1, self.cache_len, dev)
        if entry.seed:
            for k, rows in entry.seed.items():
                if k in caches:
                    caches[k][:, 0, : entry.prefix] = rows.to(dev, caches[k].dtype)
            entry.seed = None
        return caches

    def _advance(self, entry: _InFlight, sink) -> Optional[PrefillEvent]:
        if self.fault_hook is not None:
            # before any compute or state change: a retried poll is safe
            self.fault_hook(entry.slot, entry.dev_index, self.chunks_done)
        dev = self.devices[entry.dev_index]
        params = self._params[entry.dev_index]
        n = len(entry.prompt)
        if not self.chunked:
            # whole-prompt fallback: one call on the pool device, one hand-off
            toks = torch.from_numpy(entry.prompt[None, :].astype(np.int64)).to(dev)
            t0 = time.perf_counter()
            logits, caches = model_mod.prefill(params, toks, self.cfg, self.cache_len,
                                               extra=self._extra(n, entry.dev_index))
            first = int(model_mod.greedy_token(logits)[0])  # waits for the device
            dt = self._elapsed(t0, n)
            sink(entry.slot, 0, -1, caches)
            return self._finish(entry, first, dt)

        lo = entry.done
        hi = min(lo + self.chunk, n)
        if entry.caches is None:
            entry.caches = self._init_caches(entry, dev)
        toks = torch.from_numpy(entry.prompt[lo:hi][None, :].astype(np.int64)).to(dev)
        t0 = time.perf_counter()
        logits, entry.caches = model_mod.prefill_chunk(
            params, toks, entry.caches, lo, self.cfg, extra=self._extra(hi - lo, entry.dev_index)
        )
        first = int(model_mod.greedy_token(logits)[0])  # waits for the device
        dt = self._elapsed(t0, hi - lo)
        sink(entry.slot, lo, hi - lo, entry.caches)
        entry.done = hi
        self.chunks_done += 1
        if hi < n:
            # the chunk starts once both the device and the request's
            # previous chunk are done; the decode clock is never charged
            start_t = max(self.busy_until[entry.dev_index], entry.ready_t)
            self.busy_until[entry.dev_index] = entry.ready_t = start_t + dt
            return None
        return self._finish(entry, first, dt)

    def _finish(self, entry: _InFlight, first: int, dt: float) -> PrefillEvent:
        start_t = max(self.busy_until[entry.dev_index], entry.ready_t)
        finish_t = start_t + dt
        self.busy_until[entry.dev_index] = finish_t
        entry.caches = None  # KV already streamed out
        return PrefillEvent(entry.req, entry.slot, first, finish_t)

    def _advance_batched(self, di: int, sink) -> List[PrefillEvent]:
        """One fused chunk call for every request on device ``di``: rows are
        padded to the widest chunk and masked by their own (start, length).
        The device's timeline is charged once for the call."""
        group = self._current[di]
        if self.fault_hook is not None:
            for e in group:
                self.fault_hook(e.slot, e.dev_index, self.chunks_done)
        dev = self.devices[di]
        for e in group:
            if e.caches is None:
                e.caches = self._init_caches(e, dev)
        B = len(group)
        los = [e.done for e in group]
        his = [min(e.done + self.chunk, len(e.prompt)) for e in group]
        lens = [hi - lo for lo, hi in zip(los, his)]
        toks = np.zeros((B, max(lens)), np.int64)
        for i, e in enumerate(group):
            toks[i, : lens[i]] = e.prompt[los[i] : his[i]]
        keys = list(group[0].caches)
        stacked = {k: torch.cat([e.caches[k] for e in group], dim=1) for k in keys}
        t0 = time.perf_counter()
        logits, stacked = model_mod.prefill_chunk_batched(
            self._params[di], torch.from_numpy(toks).to(dev), stacked,
            torch.tensor(los, dtype=torch.int64, device=dev),
            torch.tensor(lens, dtype=torch.int64, device=dev), self.cfg,
            extra=self._extra(toks.size, di),
        )
        firsts = model_mod.greedy_token(logits).cpu().numpy()  # waits for the device
        dt = self._elapsed(t0, sum(lens))
        finish_t = max([self.busy_until[di]] + [e.ready_t for e in group]) + dt
        self.busy_until[di] = finish_t
        events: List[PrefillEvent] = []
        remaining: List[_InFlight] = []
        for i, e in enumerate(group):
            e.caches = {k: stacked[k][:, i : i + 1] for k in keys}
            sink(e.slot, los[i], lens[i], e.caches)
            e.done = his[i]
            e.ready_t = finish_t
            self.chunks_done += 1
            if e.done >= len(e.prompt):
                e.caches = None
                events.append(PrefillEvent(e.req, e.slot, int(firsts[i]), finish_t))
            else:
                remaining.append(e)
        self._current[di] = remaining
        return events
