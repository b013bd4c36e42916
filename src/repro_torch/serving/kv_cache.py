"""Slot manager and paged KV storage for continuous batching
(``repro.serving.kv_cache``).

Slots walk ``FREE -> RESERVED -> PREFILLING -> ACTIVE -> FREE``; a prefill
lost to a fault detours ``PREFILLING -> FAILED -> REQUEUED -> PREFILLING``
(the prompt restarts at chunk 0).  Inactive slots park their write position
at ``cache_len - 1``, a scratch row no live context reaches, so the batched
decode runs unconditionally.

Paged storage replaces the full-attention ``[L, B, S, ...]`` caches by page
pools ``[L, P, ps, ...]`` and per-slot block tables ``[B, S / ps]``; the
rolling-window (``_local``), shared-block (``_hybrid``) and recurrent
(``ssm_state``, ``conv_state``) caches keep the contiguous per-slot layout
beside them, bounded as they are by the window or the state size, and so
does the encoder's output ``enc_out`` (batch axis 0, not 1, in every
per-slot helper; a spill or restore leaves it in the slot's row).  Page 0 is the
null page: unbacked table entries and parked writes land there, and every
row read through it is masked by the position-bounded attention mask.  The
block tables and allocator are host (numpy) state; :meth:`table_device`
uploads the tables when they changed.  Pool writes are in place.

Pages are refcounted, so one page can back several block tables and the
prefix index at once.  :class:`PrefixIndex` is a trie over chained hashes of
chunk-aligned prompt prefixes whose nodes pin the pages holding those rows;
a hit is block-table surgery (:meth:`PagedKVCache.splice`: full pages
adopted by reference, a trailing partial page copied on write).  Preemption
moves a slot's page list, refcounts and all, into a :class:`SpilledKV`
record (:meth:`PagedKVCache.spill`) and back (:meth:`PagedKVCache.restore`).
A page returns to the free list when its last holder drops it; the index
evicts least-recently-used leaves under its page budget.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

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

    def admit(self, req: Request) -> int:
        """Blocking admission: FREE -> ACTIVE in one call."""
        s = self.reserve(req)
        self.activate(s)
        return s

    def reserve(self, req: Request, slot: Optional[int] = None) -> int:
        """Reserve the lowest free slot for ``req``, or the free ``slot``
        (a restore on disagg must land on the shard holding its pages)."""
        free = self.free_slots
        if not free:
            raise RuntimeError("no free slot")
        if slot is None:
            s = free[0]
        elif slot in free:
            s = slot
        else:
            raise RuntimeError(f"slot {slot} is {self.state[slot]}, not free")
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

    def resume(self, slot: int) -> None:
        """RESERVED -> ACTIVE for a restored request: decode continues at
        ``input_len + generated``, where the spill interrupted it."""
        if self.state[slot] != RESERVED:
            raise RuntimeError(f"slot {slot} is {self.state[slot]}, cannot resume")
        req = self.slot_req[slot]
        self.state[slot] = ACTIVE
        self.positions[slot] = req.input_len + req.generated

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

    def active_mask(self) -> np.ndarray:
        return np.array([s == ACTIVE for s in self.state])


def zero_slots(
    batch_caches: Dict[str, torch.Tensor],
    slots: List[int],
    paged: Optional["PagedKVCache"] = None,
) -> Dict[str, torch.Tensor]:
    """Destroy the KV rows of ``slots`` (batch axis 1; ``enc_out`` axis 0),
    in place: a dead
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
        elif k == "enc_out":
            v[idx.to(v.device)] = 0
        else:
            v[:, idx.to(v.device)] = 0
    return batch_caches


def chunk_rows(cache_len: int, start: int, length: int) -> np.ndarray:
    """Position-axis rows holding prompt positions ``[start, start + length)``
    in a cache of ``cache_len`` entries (``kv_cache.py:254``): contiguous for
    full-length caches; a rolling-window cache stores position ``p`` at row
    ``p % cache_len``, so rows wrap."""
    return (start + np.arange(length)) % cache_len


def scatter_prefill_caches(
    batch_caches: Dict[str, torch.Tensor],
    one_caches: Dict[str, torch.Tensor],
    slot: int,
) -> Dict[str, torch.Tensor]:
    """Write a single-request prefill cache (batch 1) into slot ``slot`` of
    the batched caches (batch axis 1; ``enc_out`` axis 0), in place
    (``kv_cache.py:204``)."""
    for k, v in one_caches.items():
        if k == "enc_out":
            batch_caches[k][slot] = v[0].to(batch_caches[k].dtype)
        else:
            batch_caches[k][:, slot] = v[:, 0].to(batch_caches[k].dtype)
    return batch_caches


def scatter_prefill_chunk_caches(
    batch_caches: Dict[str, torch.Tensor],
    one_caches: Dict[str, torch.Tensor],
    slot: int,
    start: int,
    length: int,
) -> Dict[str, torch.Tensor]:
    """Copy the rows holding prompt positions ``[start, start + length)`` of
    a single-request prefill cache (batch 1) into slot ``slot`` of the
    batched contiguous caches, in place (``kv_cache.py:262``): KV keys only,
    each at :func:`chunk_rows` of its own length (a rolling buffer wraps).
    Positionless state moves with the whole-prompt hand-off
    (:func:`scatter_prefill_caches`)."""
    for k, v in one_caches.items():
        if k.startswith("kv_"):
            rows = torch.from_numpy(chunk_rows(v.shape[2], start, length)).to(v.device)
            batch_caches[k][:, slot, rows] = v[:, 0, rows].to(batch_caches[k].dtype)
    return batch_caches


class PageAllocator:
    """Refcounted free list over pages ``1 .. num_pages - 1`` (page 0 is the
    null page); low ids are handed out first, so allocation order is
    deterministic.  ``alloc`` hands a page out at refcount 1, ``ref`` pins it
    for another holder and ``free`` drops one pin; the last one returns it."""

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
                f"out of KV pages ({self.num_pages - 1} allocatable, all in "
                "use) — raise kv_num_pages or lower the admitted batch"
            )
        p = self._free.pop()
        self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return p

    def ref(self, page: int) -> int:
        """Pin an allocated page for one more holder."""
        if page not in self._refs:
            raise RuntimeError(f"ref of unallocated page {page}")
        self._refs[page] += 1
        return page

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def free(self, page: int) -> None:
        if page not in self._refs:
            raise RuntimeError(f"double free / foreign page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)


@dataclasses.dataclass
class SpilledKV:
    """A preempted slot's detached KV: its page list in block order and the
    rows written.  The record holds the slot's refcounts (a spill moves
    ownership, it copies nothing), so pages shared with the prefix index or
    another slot stay pinned by their other holders meanwhile."""

    pages: List[int]
    tokens: int


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
        """Back positions ``[0, upto_pos]`` of ``slot`` with pages (fresh
        ones, allocated on demand)."""
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

    def truncate(self, slot: int, tokens: int) -> None:
        """Clamp ``slot``'s high-water mark down to ``tokens`` rows
        (``kv_cache.py:423``): a speculative verify backed and wrote rows
        past the accepted prefix, which the decode mask never reads and later
        writes overwrite.  Pages are kept for the next accepted tokens."""
        if tokens < 0:
            raise ValueError(f"cannot truncate slot {slot} to {tokens} tokens")
        self.hiwater[slot] = min(self.hiwater[slot], tokens)

    def release(self, slot: int) -> None:
        """Free every page of ``slot``."""
        for page in self._owned[slot]:
            self.allocator.free(page)
        if self._owned[slot]:
            self._dirty = True
        self._owned[slot] = []
        self.tables[slot, :] = NULL_PAGE
        self.hiwater[slot] = 0

    def spill(self, slot: int) -> SpilledKV:
        """Detach ``slot``'s pages, in block order, into a record: no page is
        copied and no refcount changes.  The slot is left empty."""
        rec = SpilledKV(pages=list(self._owned[slot]), tokens=int(self.hiwater[slot]))
        if self._owned[slot]:
            self._dirty = True
        self._owned[slot] = []
        self.tables[slot, :] = NULL_PAGE
        self.hiwater[slot] = 0
        return rec

    def restore(self, slot: int, rec: SpilledKV) -> None:
        """Re-attach a spilled record to an empty ``slot`` (any slot index):
        block ``b`` maps back to ``rec.pages[b]``; ownership moves back."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds pages — restore needs a fresh slot")
        self.tables[slot, : len(rec.pages)] = rec.pages
        self._owned[slot] = list(rec.pages)
        self.hiwater[slot] = rec.tokens
        if rec.pages:
            self._dirty = True

    def drop_spilled(self, rec: SpilledKV) -> None:
        """Abandon a spilled record: release its page references."""
        for page in rec.pages:
            self.allocator.free(page)
        rec.pages = []
        rec.tokens = 0

    def splice(self, slot: int, pages: List[int], tokens: int) -> Optional[Tuple[int, int, int]]:
        """Map positions ``[0, tokens)`` of an empty ``slot`` onto ``pages``
        (a prefix hit): full pages are adopted by reference; a trailing
        partial page gets a fresh page, and the caller copies its first
        ``rows`` rows of every pool array.  Returns that copy-on-write as
        ``(src_page, dst_page, rows)``, or None when ``tokens`` is
        page-aligned."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds pages — splice needs a fresh slot")
        if tokens <= 0:
            return None
        nb = (tokens + self.page_size - 1) // self.page_size
        if nb > len(pages):
            raise ValueError(f"{tokens} tokens need {nb} pages, got {len(pages)}")
        full = tokens // self.page_size
        for i in range(full):
            self.tables[slot, i] = self.allocator.ref(pages[i])
            self._owned[slot].append(pages[i])
        cow = None
        rem = tokens - full * self.page_size
        if rem:
            dst = self.allocator.alloc()
            self.tables[slot, full] = dst
            self._owned[slot].append(dst)
            cow = (pages[full], dst, rem)
        self.hiwater[slot] = tokens
        self._dirty = True
        return cow

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

    def slot_pages(self, slot: int) -> List[int]:
        """``slot``'s page list in block order (block b -> ``pages[b]``)."""
        return list(self._owned[slot])

    def check_exclusive(self, slot: int, start: int, length: int) -> None:
        """Raise if rows ``[start, start + length)`` of ``slot`` lie in a page
        another holder shares: prefill writes only exclusive pages (a
        prefix hit's shared span is never re-prefilled)."""
        blocks = range(start // self.page_size, (start + length - 1) // self.page_size + 1)
        shared = [int(self.tables[slot, b]) for b in blocks
                  if self.allocator.refcount(int(self.tables[slot, b])) > 1]
        if shared:
            raise RuntimeError(f"slot {slot} rows [{start}, {start + length}) would overwrite shared pages {shared}")

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


def _chunk_key(parent: bytes, tokens: np.ndarray) -> bytes:
    """Chained digest of one prompt chunk: a node's key commits to the whole
    prefix (the parent's digest and this chunk's tokens), so equal keys mean
    equal token prefixes."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass
class _PrefixNode:
    key: bytes
    parent: Optional["_PrefixNode"]
    block0: int  # first cache block this node's pages cover
    pages: List[int]
    children: Dict[bytes, "_PrefixNode"] = dataclasses.field(default_factory=dict)
    last_used: int = 0


class PrefixIndex:
    """Trie over ``chunk``-token prompt prefixes -> the pool pages holding
    their KV rows (``repro.serving.kv_cache.PrefixIndex``).

    A node exists iff some published prompt had that token prefix, and pins
    the pages of its chunk's rows.  Prefill is deterministic on its chunk
    grid, so any prompt with the prefix would write the same rows: a hit
    spliced through :meth:`PagedKVCache.splice` is exact.  ``max_pages``
    bounds the pins; inserts beyond it evict least-recently-used leaves, which
    drops only the index's pin (a page spliced into a live table stays)."""

    def __init__(self, chunk: int, pager: PagedKVCache, max_pages: Optional[int] = None):
        if chunk < 1:
            raise ValueError(f"chunk must be ≥ 1, got {chunk}")
        self.chunk = chunk
        self.pager = pager
        self.max_pages = max_pages
        self.root = _PrefixNode(key=b"", parent=None, block0=0, pages=[])
        self._nodes: List[_PrefixNode] = []
        self._clock = 0
        self.held_pages = 0
        # cumulative telemetry
        self.hits = 0
        self.misses = 0
        self.saved_tokens = 0
        self.lookup_tokens = 0
        self.evicted_pages = 0

    def _touch(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def lookup(self, tokens: np.ndarray, limit: Optional[int] = None) -> Tuple[int, List[int]]:
        """Longest cached chunk-aligned prefix of ``tokens`` (at most
        ``limit`` tokens): ``(matched tokens, pages)`` with ``pages[b]``
        backing block ``b`` of the match.  Matched nodes are touched."""
        n = len(tokens) if limit is None else min(int(limit), len(tokens))
        self.lookup_tokens += len(tokens)
        node, key = self.root, self.root.key
        run: Dict[int, int] = {}
        matched = 0
        for c in range(n // self.chunk):
            key = _chunk_key(key, tokens[c * self.chunk : (c + 1) * self.chunk])
            child = node.children.get(key)
            if child is None:
                break
            node = child
            self._touch(node)
            # a deeper node's page holds a shared boundary block's full rows
            for i, p in enumerate(node.pages):
                run[node.block0 + i] = p
            matched = (c + 1) * self.chunk
        if not matched:
            self.misses += 1
            return 0, []
        self.hits += 1
        self.saved_tokens += matched
        nb = (matched + self.pager.page_size - 1) // self.pager.page_size
        return matched, [run[b] for b in range(nb)]

    def publish(self, tokens: np.ndarray, upto: int, slot: int) -> int:
        """Index the chunk-aligned prefix ``tokens[:upto]`` that ``slot`` has
        prefilled, pinning the slot's pages under each new chunk's node.
        Returns the number of nodes added."""
        owned = self.pager.slot_pages(slot)
        node, key = self.root, self.root.key
        added = 0
        for c in range(int(upto) // self.chunk):
            lo, hi = c * self.chunk, (c + 1) * self.chunk
            key = _chunk_key(key, tokens[lo:hi])
            child = node.children.get(key)
            if child is None:
                b0, b1 = lo // self.pager.page_size, (hi - 1) // self.pager.page_size
                if b1 >= len(owned):
                    break  # the slot's rows are not page-backed that far
                pages = owned[b0 : b1 + 1]
                for p in pages:
                    self.pager.allocator.ref(p)
                child = _PrefixNode(key=key, parent=node, block0=b0, pages=pages)
                node.children[key] = child
                self._nodes.append(child)
                self.held_pages += len(pages)
                added += 1
            node = child
            self._touch(node)
        self._evict()
        return added

    def _evict(self) -> None:
        """LRU leaf eviction down to the page budget."""
        if self.max_pages is None:
            return
        while self.held_pages > self.max_pages:
            leaves = [n for n in self._nodes if not n.children]
            if not leaves:
                break
            self._drop_node(min(leaves, key=lambda n: n.last_used))

    def _drop_node(self, node: _PrefixNode) -> None:
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        self._nodes.remove(node)
        for p in node.pages:
            self.pager.allocator.free(p)
        self.held_pages -= len(node.pages)
        self.evicted_pages += len(node.pages)

    def drop_all(self) -> None:
        """Release every pin and forget the trie; the counters stay."""
        for node in self._nodes:
            for p in node.pages:
                self.pager.allocator.free(p)
        self._nodes = []
        self.root = _PrefixNode(key=b"", parent=None, block0=0, pages=[])
        self.held_pages = 0

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "saved_tokens": self.saved_tokens,
            "saved_frac": self.saved_tokens / self.lookup_tokens if self.lookup_tokens else 0.0,
            "shared_pages": self.held_pages,
            "evicted_pages": self.evicted_pages,
            "nodes": len(self._nodes),
        }


def make_paged_caches(caches: Dict[str, torch.Tensor], max_batch: int, cache_len: int,
                      page_size: int, num_pages: Optional[int] = None):
    """Replace freshly initialised full-attention ``[L, B, S, ...]`` caches
    (:data:`PAGED_KEYS`) by zero page pools ``[L, P, ps, ...]`` plus
    ``block_tables``; every other cache keeps its contiguous layout.
    Returns ``(pager, caches)``."""
    if "kv_k" not in caches:
        raise ValueError(
            "kv_page_size set but this architecture has no full-attention "
            "KV cache to page (only rolling/recurrent state)"
        )
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
    rows of the :data:`PAGED_KEYS` land in ``slot``'s pages (allocated on
    demand), in place, and a page another holder shares is never written;
    any other KV key (a rolling ``_local`` buffer) takes the contiguous row
    path, its last ``S`` positions when the hand-off is longer than its
    ``S`` rows (``kv_cache.py:808-834``)."""
    pager.ensure(slot, start + length - 1)
    pager.check_exclusive(slot, start, length)
    pages, offs = pager.rows_of(slot, start, length)
    dev = batch_caches["kv_k"].device
    pages_t = torch.from_numpy(pages.astype(np.int64)).to(dev)
    offs_t = torch.from_numpy(offs.astype(np.int64)).to(dev)
    rows = slice(start, start + length)
    for k, v in one_caches.items():
        if not k.startswith("kv_"):
            continue
        if k in PAGED_KEYS:
            batch_caches[k][:, pages_t, offs_t] = v[:, 0, rows].to(batch_caches[k].dtype)
            continue
        S_k = v.shape[2]
        st, ln = (start + length - S_k, S_k) if length > S_k else (start, length)
        own = torch.from_numpy(chunk_rows(S_k, st, ln)).to(v.device)
        batch_caches[k][:, slot, own] = v[:, 0, own].to(batch_caches[k].dtype)
    batch_caches["block_tables"] = pager.table_device(dev)
    return batch_caches


def paginate_caches(caches: Dict[str, torch.Tensor], lengths: np.ndarray, page_size: int,
                    num_pages: Optional[int] = None):
    """Re-paginate dense ``[L, B, S, ...]`` caches (a disagg export when the
    engine degrades to mono) into a pool of ``num_pages`` pages (default:
    full backing): each slot's live ``lengths`` rows get fresh pages and are
    copied in.  Page ids are new; the position -> value mapping is exact, so
    replayed streams stay the same.  Returns ``(pager, paged_caches)`` on the
    caches' device."""
    B, S = caches["kv_k"].shape[1:3]
    pager, out = make_paged_caches(caches, B, S, page_size, num_pages)
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


def depaginate_caches(paged_caches: Dict[str, torch.Tensor], pager: PagedKVCache) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`paginate_caches`: gather each slot's pages back into
    dense ``[L, B, S, ...]`` rows (unbacked rows come back as zeros)."""
    out = {k: v for k, v in paged_caches.items() if k != "block_tables"}
    for k in PAGED_KEYS:
        if k not in paged_caches:
            continue
        pool = paged_caches[k]  # [L, P, ps, ...]
        L = pool.shape[0]
        dense = torch.zeros((L, pager.max_batch, pager.cache_len, *pool.shape[3:]),
                            dtype=pool.dtype, device=pool.device)
        for slot in range(pager.max_batch):
            nb = pager.slot_blocks(slot)
            if not nb:
                continue
            pages = torch.from_numpy(pager.tables[slot, :nb].astype(np.int64)).to(pool.device)
            dense[:, slot, : nb * pager.page_size] = pool[:, pages].reshape(
                L, nb * pager.page_size, *pool.shape[3:])
        out[k] = dense
    return out
