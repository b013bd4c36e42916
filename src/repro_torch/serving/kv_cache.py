"""Slot manager and paged KV storage for continuous batching
(``repro.serving.kv_cache``).

Slots walk ``FREE -> RESERVED -> PREFILLING -> ACTIVE -> FREE``; a prefill
lost to a fault detours ``PREFILLING -> FAILED -> REQUEUED -> PREFILLING``
(the prompt restarts at chunk 0).  Inactive slots park their write position
at ``cache_len - 1``, a scratch row no live context reaches, so the batched
decode runs unconditionally.

Paged storage replaces the ``[L, B, S, ...]`` caches by page pools
``[L, P, ps, ...]`` and per-slot block tables ``[B, S / ps]``.  Page 0 is the
null page: unbacked table entries and parked writes land there, and every
row read through it is masked by the position-bounded attention mask.  The
block tables and allocator are host (numpy) state; :meth:`table_device`
uploads the tables when they changed.  Pool writes are in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.request import Request

FREE = "free"
RESERVED = "reserved"
PREFILLING = "prefilling"
ACTIVE = "active"
FAILED = "failed"  # the slot's in-flight prefill was lost to a fault
REQUEUED = "requeued"  # handed back to the prefill queue, restarting at chunk 0

# the caches stored page-indirectly: full-attention K/V and, for int8 KV,
# their scales (``kv_cache.py:294``); a config has the keys it needs
PAGED_KEYS = ("kv_k", "kv_v", "kv_k_scale", "kv_v_scale")
NULL_PAGE = 0


@dataclasses.dataclass
class SlotManager:
    max_batch: int
    cache_len: int

    def __post_init__(self):
        self.slot_req: List[Optional[Request]] = [None] * self.max_batch
        self.state: List[str] = [FREE] * self.max_batch
        self.positions = np.full(self.max_batch, self.cache_len - 1, np.int32)

    @property
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.state) if s == FREE]

    @property
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.state) if s == ACTIVE]

    @property
    def pending_slots(self) -> List[int]:
        """Slots owned by a request whose prefill has not finished."""
        return [i for i, s in enumerate(self.state) if s in (RESERVED, PREFILLING, FAILED, REQUEUED)]

    @property
    def num_active(self) -> int:
        return len(self.active_slots)

    def reserve(self, req: Request) -> int:
        """Reserve the lowest free slot for ``req``."""
        free = self.free_slots
        if not free:
            raise RuntimeError("no free slot")
        s = free[0]
        self.slot_req[s] = req
        self.state[s] = RESERVED
        req.slot = s
        return s

    def start_prefill(self, slot: int) -> None:
        if self.state[slot] not in (RESERVED, REQUEUED):
            raise RuntimeError(f"slot {slot} is {self.state[slot]}, expected {RESERVED} or {REQUEUED}")
        self.state[slot] = PREFILLING

    def fail(self, slot: int) -> None:
        """Mark a slot whose in-flight prefill was lost to a fault."""
        if self.state[slot] not in (RESERVED, PREFILLING):
            raise RuntimeError(f"slot {slot} is {self.state[slot]}, cannot fail")
        self.state[slot] = FAILED

    def requeue(self, slot: int) -> None:
        """Hand a failed slot back to the prefill queue (restart at chunk 0)."""
        if self.state[slot] != FAILED:
            raise RuntimeError(f"slot {slot} is {self.state[slot]}, expected {FAILED}")
        self.state[slot] = REQUEUED

    def activate(self, slot: int) -> None:
        if self.state[slot] not in (RESERVED, PREFILLING):
            raise RuntimeError(f"slot {slot} is {self.state[slot]}, cannot activate")
        self.state[slot] = ACTIVE
        self.positions[slot] = self.slot_req[slot].input_len

    def advance(self, slot: int) -> None:
        self.positions[slot] += 1

    def release(self, slot: int) -> Request:
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.state[slot] = FREE
        self.positions[slot] = self.cache_len - 1
        return req

    def positions_device(self, device) -> torch.Tensor:
        return torch.from_numpy(self.positions.astype(np.int64)).to(device)


def zero_slots(
    batch_caches: Dict[str, torch.Tensor],
    slots: List[int],
    paged: Optional["PagedKVCache"] = None,
) -> Dict[str, torch.Tensor]:
    """Destroy the KV rows of ``slots`` (batch axis 1), in place: a dead
    attention shard's rows are zeroed before re-sharding, so recovery must
    rebuild them by replay rather than read what a real failure destroyed.
    With a ``paged`` manager the page pools (:data:`PAGED_KEYS`) zero the
    pages those slots own instead; the block tables survive."""
    if not slots:
        return batch_caches
    idx = torch.as_tensor(np.asarray(slots, np.int64))
    for k, v in batch_caches.items():
        if k == "block_tables":
            continue
        if paged is not None and k in PAGED_KEYS:
            pages = paged.pages_of(slots)
            if len(pages):
                v[:, torch.from_numpy(pages).to(v.device)] = 0
        else:
            v[:, idx.to(v.device)] = 0
    return batch_caches


def chunk_rows(cache_len: int, start: int, length: int) -> np.ndarray:
    """Position-axis rows holding prompt positions ``[start, start + length)``
    in a cache of ``cache_len`` entries (``kv_cache.py:254``): contiguous for
    full-length caches; a rolling-window cache stores position ``p`` at row
    ``p % cache_len``, so rows wrap."""
    return (start + np.arange(length)) % cache_len


def scatter_prefill_chunk_caches(
    batch_caches: Dict[str, torch.Tensor],
    one_caches: Dict[str, torch.Tensor],
    slot: int,
    start: int,
    length: int,
) -> Dict[str, torch.Tensor]:
    """Copy rows ``[start, start + length)`` of a single-request prefill cache
    (batch 1) into slot ``slot`` of the batched contiguous caches, in place."""
    for k, v in one_caches.items():
        if k.startswith("kv_"):
            rows = slice(start, start + length)
            batch_caches[k][:, slot, rows] = v[:, 0, rows].to(batch_caches[k].dtype)
    return batch_caches


class PageAllocator:
    """Free list over pages ``1 .. num_pages - 1`` (page 0 is the null page);
    low ids are handed out first, so allocation order is deterministic."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one null + one usable), got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self.peak_in_use = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._refs)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"out of KV pages ({self.num_pages - 1} allocatable, all in use) -- "
                "raise kv_num_pages or lower the admitted batch"
            )
        p = self._free.pop()
        self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return p

    def free(self, page: int) -> None:
        if page not in self._refs:
            raise RuntimeError(f"double free / foreign page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)


class PagedKVCache:
    """Block tables + page lifecycle for one batched paged pool."""

    def __init__(self, max_batch: int, cache_len: int, page_size: int, num_pages: Optional[int] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if cache_len % page_size:
            raise ValueError(
                f"cache_len ({cache_len}) must be a multiple of the KV page size ({page_size})"
            )
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.page_size = page_size
        self.blocks_per_slot = cache_len // page_size
        if num_pages is None:
            num_pages = max_batch * self.blocks_per_slot + 1  # full backing + null
        self.num_pages = num_pages
        self.allocator = PageAllocator(num_pages)
        self.tables = np.full((max_batch, self.blocks_per_slot), NULL_PAGE, np.int32)
        self._owned: List[List[int]] = [[] for _ in range(max_batch)]
        self.hiwater = np.zeros(max_batch, np.int64)  # rows written per slot
        self._dirty = True
        self._dev: Optional[torch.Tensor] = None

    def ensure(self, slot: int, upto_pos: int) -> None:
        """Back positions ``[0, upto_pos]`` of ``slot`` with pages."""
        if not 0 <= upto_pos < self.cache_len:
            raise ValueError(f"position {upto_pos} outside cache_len {self.cache_len}")
        need = upto_pos // self.page_size + 1
        owned = self._owned[slot]
        while len(owned) < need:
            page = self.allocator.alloc()
            self.tables[slot, len(owned)] = page
            owned.append(page)
            self._dirty = True
        self.hiwater[slot] = max(self.hiwater[slot], upto_pos + 1)

    def release(self, slot: int) -> None:
        """Free every page of ``slot``."""
        for page in self._owned[slot]:
            self.allocator.free(page)
        if self._owned[slot]:
            self._dirty = True
        self._owned[slot] = []
        self.tables[slot, :] = NULL_PAGE
        self.hiwater[slot] = 0

    def rows_of(self, slot: int, start: int, length: int):
        """(pages, offsets) of positions ``[start, start + length)``."""
        positions = start + np.arange(length)
        blocks = positions // self.page_size
        if len(positions) and blocks[-1] >= len(self._owned[slot]):
            raise RuntimeError(f"slot {slot} rows [{start}, {start + length}) not page-backed")
        return self.tables[slot, blocks], positions % self.page_size

    def pages_of(self, slots: List[int]) -> np.ndarray:
        """Every pool page ``slots`` own, sorted (for targeted zeroing)."""
        return np.asarray(sorted(p for s in slots for p in self._owned[s]), np.int64)

    def slot_blocks(self, slot: int) -> int:
        """Pages ``slot`` owns, in block order from block 0."""
        return len(self._owned[slot])

    @property
    def dirty(self) -> bool:
        """The host tables changed since :meth:`table_device` last uploaded."""
        return self._dirty

    def table_device(self, device) -> torch.Tensor:
        """Device copy of the block tables, re-uploaded only after a change."""
        if self._dirty or self._dev is None or self._dev.device != torch.device(device):
            self._dev = torch.from_numpy(self.tables.copy()).to(device)
            self._dirty = False
        return self._dev

    def stats(self) -> Dict[str, float]:
        in_use = self.allocator.in_use
        used_rows = int(self.hiwater.sum())
        alloc_rows = in_use * self.page_size
        return {
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "pages_in_use": in_use,
            "pages_peak": self.allocator.peak_in_use,
            "pages_free": self.allocator.num_free,
            "occupancy": in_use / max(1, self.num_pages - 1),
            "fragmentation": 1.0 - used_rows / alloc_rows if alloc_rows else 0.0,
        }


def make_paged_caches(caches: Dict[str, torch.Tensor], max_batch: int, cache_len: int,
                      page_size: int, num_pages: Optional[int] = None):
    """Replace freshly initialised ``[L, B, S, ...]`` caches by zero page pools
    ``[L, P, ps, ...]`` plus ``block_tables``.  Returns ``(pager, caches)``."""
    pager = PagedKVCache(max_batch, cache_len, page_size, num_pages)
    out = dict(caches)
    for k in PAGED_KEYS:
        if k not in caches:
            continue
        v = caches[k]
        out[k] = torch.zeros((v.shape[0], pager.num_pages, page_size, *v.shape[3:]),
                             dtype=v.dtype, device=v.device)
    out["block_tables"] = pager.table_device(caches["kv_k"].device)
    return pager, out


def scatter_prefill_chunk_paged(
    batch_caches: Dict[str, torch.Tensor],
    one_caches: Dict[str, torch.Tensor],
    slot: int,
    start: int,
    length: int,
    pager: PagedKVCache,
) -> Dict[str, torch.Tensor]:
    """Paged analogue of :func:`scatter_prefill_chunk_caches`: the chunk's
    rows land in ``slot``'s pages (allocated on demand), in place."""
    pager.ensure(slot, start + length - 1)
    pages, offs = pager.rows_of(slot, start, length)
    dev = batch_caches["kv_k"].device
    pages_t = torch.from_numpy(pages.astype(np.int64)).to(dev)
    offs_t = torch.from_numpy(offs.astype(np.int64)).to(dev)
    rows = slice(start, start + length)
    for k in PAGED_KEYS:
        if k not in one_caches:
            continue
        batch_caches[k][:, pages_t, offs_t] = one_caches[k][:, 0, rows].to(batch_caches[k].dtype)
    batch_caches["block_tables"] = pager.table_device(dev)
    return batch_caches


def paginate_caches(caches: Dict[str, torch.Tensor], lengths: np.ndarray, page_size: int):
    """Re-paginate dense ``[L, B, S, ...]`` caches (a disagg export when the
    engine degrades to mono): each slot's live ``lengths`` rows get fresh
    pages and are copied in.  Page ids are new; the position -> value mapping
    is exact, so replayed streams stay the same.  Returns ``(pager,
    paged_caches)`` on the caches' device."""
    B, S = caches["kv_k"].shape[1:3]
    pager, out = make_paged_caches(caches, B, S, page_size)
    dev = caches["kv_k"].device
    for slot in range(B):
        ln = int(lengths[slot])
        if ln <= 0:
            continue
        pager.ensure(slot, ln - 1)
        pages, offs = pager.rows_of(slot, 0, ln)
        pages_t = torch.from_numpy(pages.astype(np.int64)).to(dev)
        offs_t = torch.from_numpy(offs.astype(np.int64)).to(dev)
        for k in PAGED_KEYS:
            if k in caches:
                out[k][:, pages_t, offs_t] = caches[k][:, slot, :ln]
    out["block_tables"] = pager.table_device(dev)
    return pager, out
