"""Chunked prompt prefill with streamed KV hand-off (``repro.serving
.prefill.PrefillWorker``, one device, one prompt at a time).

The engine reserves a slot and submits the request; each :meth:`poll`
prefills one fixed-size chunk into a per-request contiguous cache and hands
the chunk's rows to the engine's ``sink``, which lands them in the decode
caches.  The last chunk's last-position logits give the first token.  Chunks
are timed on a pool timeline (``busy_until``) that runs beside the engine's
decode clock.  Prompts route over logical experts (no replica scheduling)
with drop-free capacity by default: each call's own token count, the
reference's default (``prefill.py:112-123``); ``capacity`` fixes it instead
(the engine's ``prefill_capacity_tokens``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as model_mod
from repro_torch.serving.request import Request


@dataclasses.dataclass
class PrefillEvent:
    req: Request
    slot: int
    first_token: int
    finish_t: float  # completion stamp on the prefill timeline


@dataclasses.dataclass
class _InFlight:
    req: Request
    slot: int
    prompt: np.ndarray
    caches: Optional[Dict[str, torch.Tensor]] = None
    done: int = 0  # prompt tokens already prefilled
    ready_t: float = 0.0  # timeline moment the next chunk may start


class PrefillWorker:
    def __init__(self, cfg, params, device, *, cache_len: int, chunk: int = 64,
                 capacity: Optional[int] = None):
        if not model_mod.supports_chunked_prefill(cfg):
            raise NotImplementedError(
                f"{cfg.name}: whole-prompt prefill fallback is not ported yet"
            )
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.cache_len = cache_len
        self.chunk = max(1, int(chunk))
        self.capacity = capacity
        self.chunks_done = 0
        self.busy_until = 0.0
        self._queue: List[_InFlight] = []
        self._current: Optional[_InFlight] = None

    def submit(self, req: Request, slot: int, now: float) -> None:
        """Queue a reserved request (FIFO); a request without a prompt gets the
        reference's seeded synthetic one."""
        prompt = req.prompt
        if prompt is None:
            rng = np.random.default_rng(req.rid)
            prompt = rng.integers(0, self.cfg.vocab_size, size=req.input_len, dtype=np.int32)
        self._queue.append(_InFlight(req, slot, np.asarray(prompt, np.int32), ready_t=now))

    def poll(self, sink: Callable[[int, int, int, Dict], None]) -> List[PrefillEvent]:
        """Prefill one chunk and stream it through ``sink(slot, start, length,
        one_caches)``.  Returns the request whose prefill finished, if any."""
        if self._current is None:
            if not self._queue:
                return []
            self._current = self._queue.pop(0)
        ev = self._advance(self._current, sink)
        if ev is None:
            return []
        self._current = None
        return [ev]

    def _advance(self, entry: _InFlight, sink) -> Optional[PrefillEvent]:
        n = len(entry.prompt)
        lo = entry.done
        hi = min(lo + self.chunk, n)
        if entry.caches is None:
            entry.caches = model_mod.init_decode_caches(self.cfg, 1, self.cache_len, self.device)
        toks = torch.from_numpy(entry.prompt[lo:hi][None, :].astype(np.int64)).to(self.device)
        t0 = time.perf_counter()
        cap = hi - lo if self.capacity is None else self.capacity
        extra = {"moe_ctx": {"capacity": cap}} if self.cfg.has_moe else None
        logits, entry.caches = model_mod.prefill_chunk(
            self.params, toks, entry.caches, lo, self.cfg, extra=extra
        )
        first = int(model_mod.greedy_token(logits)[0])  # waits for the device
        dt = time.perf_counter() - t0
        sink(entry.slot, lo, hi - lo, entry.caches)
        entry.done = hi
        self.chunks_done += 1
        start_t = max(self.busy_until, entry.ready_t)
        self.busy_until = entry.ready_t = start_t + dt
        if hi < n:
            return None
        entry.caches = None  # KV already streamed out
        return PrefillEvent(entry.req, entry.slot, first, self.busy_until)
