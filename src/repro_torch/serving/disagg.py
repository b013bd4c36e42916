"""Two-pool disaggregated decode execution, Janus §3.1-§3.3
(``repro.serving.disagg.DisaggExecutor``, decode only).

:class:`DisaggExecutor` drives one continuous-batching decode step across two
device pools:

* the **attention pool** (``pools.attn_devices``) holds the attention-side
  parameters per device and a contiguous *batch shard* of the in-flight KV
  caches, each shard in tensors of its own; every layer's
  :func:`repro_torch.models.transformer.attention_stage` runs there;
* the **MoE pool** (``pools.moe_devices``) runs every layer's expert FFN
  per instance over *its own slots only*, with the AEBS schedule computed
  redundantly on each instance (synchronisation-free, §3.4).

The per-layer hand-off follows the pattern (case-1 direct node-to-node vs
case-2 pair + multicast) that :func:`repro_torch.core.comm
.adaptive_two_phase` picks per step, as the move schedule of
:func:`repro_torch.core.disagg.plan_exchange`; per-step regime, per-fabric
bytes and message counts come back as telemetry.  On one card every pool
aliases the one device: the moves are no-ops and the counts are the
schedule's.

An instance reads its slots' weights slot-indirectly from the logical
``[E, ...]`` expert weights through its row of ``slot_to_expert`` (K3's
launch over its activated local slots on the card); the reference gathers a
per-instance copy of them instead (``disagg.py:383-389``).  Every slot's
weights are its expert's, so both compute the same function.

Numerics: the executor composes the op sequence of the monolithic
``decode_step`` (stage split + item-level dispatch + attention-side
combine in mono's op order), so a step's KV caches and logits follow
mono's.  Micro-batch ping-pong (``ping_pong=True``, m = 2) routes each
micro-batch on its own; it matches whenever expert capacity is ample.

``reconfigure`` actuates a §3.5 scaling decision mid-run: only the pool
whose count changed is rebuilt, and KV caches are re-sharded so in-flight
requests continue undisturbed.  The prefill pool (``pools.prefill_devices``)
is the engine's :class:`repro_torch.serving.prefill.PrefillWorker`'s; the
executor keeps its place in the device split and reports when it moves.

Faults: ``fault_hook("exchange", layer, micro_batch)`` (the engine's
:meth:`repro_torch.serving.faults.FaultRuntime.exchange_hook` when a plan is
armed) runs before each cross-pool exchange; a step it interrupts is retried
whole (every KV write rewrites the same rows with the same values).
:meth:`DisaggExecutor.exclude_device` drops a dead device from the universe
and :meth:`DisaggExecutor.drop_attn_device` destroys a dead shard's KV and
re-shards the batch over the survivors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import cache_specs
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.comm import H100, CommConfig, HardwareSpec, adaptive_two_phase
from repro_torch.core.disagg import DevicePools, DisaggConfig, plan_exchange
from repro_torch.core.disagg import reconfigure as disagg_reconfigure
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.common import tree_to
from repro_torch.models.ffn import ffn
from repro_torch.serving.kv_cache import PagedKVCache, chunk_rows

# layer-cache key (what attention_stage reads) -> engine-format cache name
_KV_KEYS = {"k": "kv_k", "v": "kv_v", "k_scale": "kv_k_scale", "v_scale": "kv_v_scale"}


@dataclasses.dataclass
class _Shard:
    """One attention-pool batch shard (a micro-batch slice of one device)."""

    dev_index: int  # index into pools.attn_devices
    mb: int  # micro-batch id (0 in sequential mode)
    lo: int  # global batch row range [lo, hi)
    hi: int

    @property
    def rows(self) -> int:
        return self.hi - self.lo


def _shard_bounds(max_batch: int, n: int) -> List[Tuple[int, int]]:
    sizes = [max_batch // n + (1 if i < max_batch % n else 0) for i in range(n)]
    bounds, lo = [], 0
    for s in sizes:
        bounds.append((lo, lo + s))
        lo += s
    return bounds


def _index(parts: List[np.ndarray]) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(parts or [np.zeros(0)]).astype(np.int64))


def _sync(tensors: Sequence[torch.Tensor]) -> None:
    """Wait for the devices that hold ``tensors`` (stage timing only)."""
    for dev in {t.device for t in tensors}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported yet (comes with {slice_name})")


class DisaggExecutor:
    """Placement + per-layer cross-pool exchange for one decode deployment."""

    def __init__(
        self,
        cfg,
        params,
        pools: DevicePools,
        layout: ReplicaLayout,
        *,
        max_batch: int,
        cache_len: int,
        scheduler: Callable = aebs_schedule,
        capacity: Optional[int] = None,
        ping_pong: bool = False,
        hw: HardwareSpec = H100,
        devices: Optional[Sequence[torch.device]] = None,
        kv_page_size: Optional[int] = None,
    ):
        if not cfg.has_moe:
            raise ValueError("disagg executor requires an MoE architecture")
        kinds = cfg.layer_kinds()
        if cfg.encoder_layers or cfg.frontend or any(k not in ("dense", "moe") for k in kinds):
            raise ValueError(f"disagg executor supports attention+FFN stacks only, got {sorted(set(kinds))}")
        if not moe_mod.scheduler_is_single_replica(scheduler):
            raise ValueError(
                "disagg executor requires a single-active-replica scheduler "
                "(AEBS/random) so replica slots carry exact expert semantics"
            )
        if len(pools.attn_devices) < 1:
            raise ValueError("attention pool must have ≥ 1 device")
        self.cfg = cfg
        self.params = params
        self.pools = pools
        self.scheduler = scheduler
        self.capacity = capacity
        self.ping_pong = ping_pong
        self.hw = hw
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.kv_page_size = kv_page_size
        # per-shard page managers (local-row block tables); None = contiguous
        self._pagers: Optional[List[PagedKVCache]] = None
        # per-slot live KV length, executor-level so it survives re-sharding
        self._slot_len = np.zeros(max_batch, np.int64)
        combo = list(pools.attn_devices) + list(pools.prefill_devices) + list(pools.moe_devices)
        # pools that alias devices (one card): exceeds-available validation
        # is meaningless there
        self._aliased = len(set(combo)) < len(combo)
        # reconfigure re-splits this universe: the caller's devices, else
        # the pools' own
        self._all_devices = list(devices) if devices is not None else combo
        self.disagg_cfg = DisaggConfig(
            len(pools.attn_devices), len(pools.moe_devices), layout,
            n_prefill=len(pools.prefill_devices),
        )
        self.relower_log: List[Dict[str, bool]] = []
        # called before each cross-pool exchange when a fault plan is armed
        self.fault_hook: Optional[Callable[[str, int, int], None]] = None
        self._kinds = kinds
        self._build_moe_side(layout)
        self._build_attn_side(len(pools.attn_devices), caches=None)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _build_attn_side(self, n_attn: int, caches: Optional[Dict[str, torch.Tensor]]) -> None:
        """(Re-)place attention params and KV cache shards on ``n_attn``
        devices.  ``caches`` is the stacked engine-format cache dict to
        re-shard (zeros when None); every shard gets tensors of its own."""
        cfg = self.cfg
        pools = self.pools
        bounds = _shard_bounds(self.max_batch, n_attn)
        if self.ping_pong and any(hi - lo < 2 for lo, hi in bounds):
            raise ValueError(
                f"ping_pong (m=2) needs ≥2 batch rows per attention device "
                f"(max_batch={self.max_batch}, n_attn={n_attn})"
            )
        self.shards: List[_Shard] = []
        for i, (lo, hi) in enumerate(bounds):
            if self.ping_pong:
                mid = lo + (hi - lo) // 2
                self.shards.append(_Shard(i, 0, lo, mid))
                self.shards.append(_Shard(i, 1, mid, hi))
            else:
                self.shards.append(_Shard(i, 0, lo, hi))
        self.n_micro = 1 + int(any(s.mb == 1 for s in self.shards))

        # attention-side parameters per pool device
        attn_layers, shared_layers = [], []
        for kind, lp in zip(self._kinds, self.params["layers"]):
            alp = {k: lp[k] for k in ("ln1", "attn", "ln2")}
            if kind == "dense":
                alp["ffn"] = lp["ffn"]
            attn_layers.append(alp)
            shared_layers.append(lp["moe"].get("shared") if kind == "moe" else None)
        self._attn_params = [
            {
                "embed": self.params["embed"].to(dev),
                "final_norm": tree_to(self.params["final_norm"], dev),
                "layers": tree_to(attn_layers, dev),
                "shared": tree_to(shared_layers, dev),
            }
            for dev in pools.attn_devices
        ]

        # KV cache shards: per shard, per layer, the shard's rows.  Paged
        # mode gives each shard its own page pools [P, ps, ...] and a
        # local-row block table, re-paginated from ``_slot_len``: page ids
        # change across re-shards, the position -> value mapping never does.
        specs = cache_specs(cfg, 1, self.cache_len)
        self._kv: List[List[Dict[str, torch.Tensor]]] = []
        self._pagers = [] if self.kv_page_size is not None else None
        for s in self.shards:
            dev = pools.attn_devices[s.dev_index]
            pager = None
            if self._pagers is not None:
                pager = PagedKVCache(s.rows, self.cache_len, self.kv_page_size)
                # every live (global row, position) and the (page, offset) it lands in
                rows, pos, pages, offs = [], [], [], []
                for r in range(s.rows):
                    ln = int(self._slot_len[s.lo + r])
                    if ln > 0:
                        pager.ensure(r, ln - 1)
                        pg, of = pager.rows_of(r, 0, ln)
                        rows.append(np.full(ln, s.lo + r))
                        pos.append(np.arange(ln))
                        pages.append(pg)
                        offs.append(of)
                rows, pos, pages, offs = (_index(v) for v in (rows, pos, pages, offs))
                bt = pager.table_device(dev)
                self._pagers.append(pager)
            per_layer = []
            for l in range(len(self._kinds)):
                layer = {}
                for short, name in _KV_KEYS.items():
                    if name not in specs:
                        continue
                    (_, _, S, *rest), dtype = specs[name]
                    if pager is None:
                        layer[short] = (torch.zeros((s.rows, S, *rest), dtype=dtype, device=dev)
                                        if caches is None else caches[name][l, s.lo : s.hi].to(dev, copy=True))
                        continue
                    t = torch.zeros((pager.num_pages, pager.page_size, *rest), dtype=dtype, device=dev)
                    if caches is not None:
                        src = caches[name][l]
                        t[pages.to(dev), offs.to(dev)] = src[rows.to(src.device), pos.to(src.device)].to(dev)
                    layer[short] = t
                if pager is not None:
                    layer["bt"] = bt
                per_layer.append(layer)
            self._kv.append(per_layer)

        # exchange schedule (regime chosen per step; both plans precomputed)
        self._plans = {r: plan_exchange(self.pools, r) for r in ("case1", "case2")}

    def _build_moe_side(self, layout: ReplicaLayout) -> None:
        """Per MoE instance: the router and the logical expert weights (on an
        aliased pool the very tensors of ``params``), the layout's tables and
        the instance's row of ``slot_to_expert``.  No weights are gathered."""
        cfg = self.cfg
        if layout.num_instances != len(self.pools.moe_devices):
            raise ValueError(
                f"layout has {layout.num_instances} instances but pool has "
                f"{len(self.pools.moe_devices)} MoE devices"
            )
        self.layout = layout
        self.n_moe = layout.num_instances
        self.C = layout.capacity
        # a per-slot budget over the whole batch, as mono's (moe.py:403)
        self.cap = self.capacity or moe_mod.default_capacity(
            self.max_batch, cfg.top_k, layout.total_slots, cfg.capacity_factor
        )
        stx = np.asarray(layout.slot_to_expert)
        self._moe_params = []
        for g, dev in enumerate(self.pools.moe_devices):
            layers = []
            for kind, lp in zip(self._kinds, self.params["layers"]):
                if kind != "moe":
                    layers.append(None)
                    continue
                mp = lp["moe"]
                layers.append({
                    "router": mp["router"].to(dev),
                    "w": {k: mp[k].to(dev) for k in ("w_gate", "w_up", "w_down")},
                })
            self._moe_params.append({
                "layers": layers,
                "tables": layout.device_tables(dev),
                "lo": g * self.C,
                "s2e": torch.as_tensor(stx[g], dtype=torch.int32, device=dev),
            })

    # ------------------------------------------------------------------
    # stage functions
    # ------------------------------------------------------------------
    def _moe_fn(self, g: int, li: int, h: torch.Tensor):
        """One MoE instance: route the whole exchanged batch, schedule over
        every instance's tables (K2 on the card), keep the items whose slot
        is local and run them through the instance's slots (K3 on the card,
        weights read slot-indirectly).  Returns ``(y_items, keep, local,
        gates, load)``."""
        cfg = self.cfg
        mp = self._moe_params[g]
        lp = mp["layers"][li]
        h2d = h.reshape(-1, h.shape[-1])
        gates, eids, _ = moe_mod.route(lp["router"], h2d, cfg.top_k)
        slot_ids, load, _ = self.scheduler(eids, mp["tables"], self.n_moe)
        lo = mp["lo"]
        local = (slot_ids >= lo) & (slot_ids < lo + self.C)
        buckets = torch.where(local, slot_ids - lo, -1)
        y_items, keep = moe_mod.grouped_dispatch_items(
            h2d, buckets, self.C, self.cap, lp["w"], slot_to_expert=mp["s2e"]
        )
        return y_items, keep, local.reshape(-1), gates, load

    def _combine_fn(self, x, h2, shared_p, parts, gates):
        """Attention-side combine in mono's op order: gate x keep, sum over
        k, shared expert, residual."""
        k = self.cfg.top_k
        b, _, d = x.shape
        dt = h2.dtype
        y_items = torch.zeros((b * k, d), dtype=dt, device=x.device)
        keep = torch.zeros((b * k,), dtype=torch.bool, device=x.device)
        for yg, kg, lg in parts:
            y_items = torch.where(lg[:, None], yg, y_items)
            keep = torch.where(lg, kg, keep)
        gflat = (gates.reshape(-1) * keep).to(dt)
        y2d = (y_items * gflat[:, None]).reshape(b, k, -1).sum(dim=1)
        if shared_p is not None:
            y2d = y2d + ffn(shared_p, h2.reshape(b, d), "swiglu")
        return x + y2d.reshape(b, 1, d)

    # ------------------------------------------------------------------
    # cache interop (engine format: stacked [L, b, S, ...])
    # ------------------------------------------------------------------
    def scatter_prefill(self, one_caches: Dict[str, torch.Tensor], slot: int) -> None:
        """Write a single-request prefill cache (batch 1) into ``slot``: the
        whole-prompt case of the streamed chunk hand-off."""
        self.scatter_prefill_chunk(one_caches, slot, 0, one_caches["kv_k"].shape[2])

    def scatter_prefill_chunk(
        self, one_caches: Dict[str, torch.Tensor], slot: int, start: int, length: int
    ) -> None:
        """Stream one prefill chunk's KV rows (prompt positions ``[start,
        start + length)``) into ``slot`` on its owning shard, in place."""
        si = self.shard_of(slot)
        shard = self.shards[si]
        dev = self.pools.attn_devices[shard.dev_index]
        local = slot - shard.lo
        self._slot_len[slot] = max(self._slot_len[slot], start + length)
        if self._pagers is not None:
            pager = self._pagers[si]
            pager.ensure(local, start + length - 1)
            pages, offs = pager.rows_of(local, start, length)
            pages_t = torch.from_numpy(pages.astype(np.int64)).to(dev)
            offs_t = torch.from_numpy(offs.astype(np.int64)).to(dev)
            rows = slice(start, start + length)
            for l, layer_kv in enumerate(self._kv[si]):
                for short, name in _KV_KEYS.items():
                    if short in layer_kv:
                        dst = layer_kv[short]
                        dst[pages_t, offs_t] = one_caches[name][l, 0, rows].to(dev, dst.dtype)
            return
        src_dev = one_caches["kv_k"].device
        idx = torch.from_numpy(chunk_rows(one_caches["kv_k"].shape[2], start, length))
        idx_src, idx_dst = idx.to(src_dev), idx.to(dev)
        for l, layer_kv in enumerate(self._kv[si]):
            for short, name in _KV_KEYS.items():
                if short in layer_kv:
                    dst = layer_kv[short]
                    dst[local, idx_dst] = one_caches[name][l, 0, idx_src].to(dev, dst.dtype)

    def load_caches(self, caches: Dict[str, torch.Tensor], lengths: Optional[np.ndarray] = None) -> None:
        """Adopt an engine-format stacked cache dict (re-shards onto the pool).
        ``lengths`` (per-slot live rows) drives paged re-pagination; defaults
        to treating every slot as fully live."""
        if lengths is not None:
            self._slot_len = np.asarray(lengths, np.int64).copy()
        elif self.kv_page_size is not None:
            self._slot_len = np.full(self.max_batch, self.cache_len, np.int64)
        self._build_attn_side(len(self.pools.attn_devices), caches=caches)

    def export_caches(self) -> Dict[str, torch.Tensor]:
        """Reassemble the engine-format stacked cache dict (global row order)
        on the first attention device.  Paged shards gather their pages back
        into dense rows (unbacked rows come back as zeros)."""
        order = sorted(range(len(self.shards)), key=lambda i: self.shards[i].lo)
        host = self.pools.attn_devices[0]
        out: Dict[str, torch.Tensor] = {}
        for short, name in _KV_KEYS.items():
            if short not in self._kv[0][0]:
                continue
            per_layer = []
            for l in range(len(self._kv[0])):
                rows = []
                for i in order:
                    arr = self._kv[i][l][short].to(host)
                    if self._pagers is not None:
                        pager = self._pagers[i]
                        dense = torch.zeros((pager.max_batch, pager.cache_len, *arr.shape[2:]),
                                            dtype=arr.dtype, device=host)
                        for r in range(pager.max_batch):
                            nb = pager.slot_blocks(r)
                            if nb:
                                pages = torch.from_numpy(pager.tables[r, :nb].astype(np.int64)).to(host)
                                dense[r, : nb * pager.page_size] = arr[pages].reshape(
                                    nb * pager.page_size, *arr.shape[2:])
                        arr = dense
                    rows.append(arr)
                per_layer.append(torch.cat(rows, dim=0))
            out[name] = torch.stack(per_layer)
        return out

    # ------------------------------------------------------------------
    # paged slot lifecycle
    # ------------------------------------------------------------------
    def shard_of(self, slot: int) -> int:
        """Which attention shard owns ``slot``."""
        return next(si for si, s in enumerate(self.shards) if s.lo <= slot < s.hi)

    def ensure_slot_pages(self, slot: int, pos: int) -> None:
        """Back ``slot``'s write position with a page (alloc on append)."""
        self._slot_len[slot] = max(self._slot_len[slot], pos + 1)
        if self._pagers is None:
            return
        si = self.shard_of(slot)
        self._pagers[si].ensure(slot - self.shards[si].lo, pos)

    def release_slot(self, slot: int) -> None:
        """Free a released slot's pages and forget its live length."""
        self._slot_len[slot] = 0
        if self._pagers is None:
            return
        si = self.shard_of(slot)
        self._pagers[si].release(slot - self.shards[si].lo)

    def _sync_tables(self) -> None:
        """Hand every layer of a shard its block table after a change
        (``table_device`` returns a new tensor when the table is dirty)."""
        if self._pagers is None:
            return
        for si, pager in enumerate(self._pagers):
            if pager.dirty:
                dev = self.pools.attn_devices[self.shards[si].dev_index]
                bt = pager.table_device(dev)
                for layer_kv in self._kv[si]:
                    layer_kv["bt"] = bt

    def slot_lengths(self) -> np.ndarray:
        """Per-slot live KV lengths (rows written), global row order."""
        return self._slot_len.copy()

    def page_stats(self) -> Optional[Dict[str, float]]:
        """Aggregated page telemetry across the attention shards."""
        if self._pagers is None:
            return None
        num_pages = sum(p.num_pages for p in self._pagers)
        in_use = sum(p.allocator.in_use for p in self._pagers)
        peak = sum(p.allocator.peak_in_use for p in self._pagers)
        free = sum(p.allocator.num_free for p in self._pagers)
        used_rows = sum(int(p.hiwater.sum()) for p in self._pagers)
        alloc_rows = in_use * self.kv_page_size
        allocatable = sum(p.num_pages - 1 for p in self._pagers)
        return {
            "page_size": self.kv_page_size,
            "num_pages": num_pages,
            "pages_in_use": in_use,
            "pages_peak": peak,
            "pages_free": free,
            "occupancy": in_use / max(1, allocatable),
            "fragmentation": 1.0 - used_rows / alloc_rows if alloc_rows else 0.0,
        }

    # engine features of later slices
    def spill_slot(self, slot: int):
        raise _later("spill", "priority preemption")

    def restore_slot(self, slot: int, payload) -> None:
        raise _later("restore", "priority preemption")

    def drop_spilled(self, payload) -> None:
        raise _later("drop_spilled", "priority preemption")

    def splice_prefix(self, slot: int, tokens: np.ndarray, limit: int):
        raise _later("splice_prefix", "the prefix cache")

    def publish_prefix(self, slot: int, tokens: np.ndarray, upto: int) -> None:
        raise _later("publish_prefix", "the prefix cache")

    # ------------------------------------------------------------------
    # reconfigure (§3.5): rebuild only the affected pool
    # ------------------------------------------------------------------
    def reconfigure(
        self,
        n_attn: Optional[int] = None,
        n_moe: Optional[int] = None,
        layout: Optional[ReplicaLayout] = None,
        n_prefill: Optional[int] = None,
    ) -> Dict[str, bool]:
        cur_a = len(self.pools.attn_devices)
        cur_e = len(self.pools.moe_devices)
        cur_p = len(self.pools.prefill_devices)
        n_attn = cur_a if n_attn is None else int(n_attn)
        n_moe = cur_e if n_moe is None else int(n_moe)
        n_prefill = cur_p if n_prefill is None else int(n_prefill)
        # validate before any state mutates
        if n_attn < 1:
            raise ValueError(
                f"attention pool size must be ≥ 1, got n_attn={n_attn} "
                "(the engine cannot decode without an attention pool)"
            )
        if n_moe < 1:
            raise ValueError(
                f"MoE pool size must be ≥ 1, got n_moe={n_moe} "
                "(expert layers need at least one MoE device)"
            )
        if n_prefill < 0:
            raise ValueError(f"prefill pool size must be ≥ 0, got n_prefill={n_prefill}")
        avail = len(self._all_devices)
        if not self._aliased and n_attn + n_moe + n_prefill > avail:
            raise ValueError(
                f"pool sizes {n_attn} (attn) + {n_moe} (moe) + {n_prefill} "
                f"(prefill) = {n_attn + n_moe + n_prefill} exceed the {avail} "
                "available devices"
            )
        relower = {
            "attn": n_attn != cur_a,
            "moe": n_moe != cur_e or layout is not None,
            # a MoE resize re-anchors the prefill pool, which sits just
            # ahead of the MoE pool in the device list
            "prefill": n_prefill != cur_p or (n_prefill > 0 and n_moe != cur_e),
        }
        if not (relower["attn"] or relower["moe"] or relower["prefill"]):
            self.relower_log.append(relower)
            return relower

        caches = self.export_caches() if relower["attn"] else None
        devs = self._all_devices
        self.pools = DevicePools.split(
            n_attn, n_moe, devs, node_size=self.pools.node_size,
            allow_reuse=len(devs) < n_attn + n_moe + n_prefill, n_prefill=n_prefill,
        )
        new_layout = layout or (
            self.layout
            if n_moe == cur_e
            else ReplicaLayout.round_robin(self.cfg.num_experts, n_moe, self.C)
        )
        if relower["moe"]:
            self._build_moe_side(new_layout)
        if relower["attn"]:
            # in-flight KV caches are preserved: re-shard the exported rows
            self._build_attn_side(n_attn, caches=caches)
        else:
            # a MoE-only change still needs fresh exchange plans
            self._plans = {r: plan_exchange(self.pools, r) for r in ("case1", "case2")}
        self.disagg_cfg = disagg_reconfigure(self.disagg_cfg, n_attn, n_moe, new_layout, n_prefill=n_prefill)
        self.relower_log.append(relower)
        return relower

    # ------------------------------------------------------------------
    # fault recovery: device loss
    # ------------------------------------------------------------------
    def exclude_device(self, pool: str, index: int) -> None:
        """Remove a dead device (by identity) from the universe the next
        ``reconfigure`` re-splits.  A no-op on aliased pools (one card): the
        loss is logical and recovery goes on on the shared device."""
        dead = {
            "attn": self.pools.attn_devices,
            "moe": self.pools.moe_devices,
            "prefill": self.pools.prefill_devices,
        }[pool][index]
        hits = [i for i, d in enumerate(self._all_devices) if d is dead]
        if self._aliased or len(hits) != 1:
            return
        self._all_devices = [d for i, d in enumerate(self._all_devices) if i != hits[0]]

    def drop_attn_device(self, dead: int) -> List[int]:
        """Attention device ``dead`` died: zero its shards' KV (and release
        their pages), set those slots' lengths to 0, exclude the device,
        re-shard over the survivors and return the lost global batch rows
        for the engine to rebuild.  Needs >= 2 attention devices; with one
        the engine degrades to mono instead."""
        n_attn = len(self.pools.attn_devices)
        if not 0 <= dead < n_attn:
            raise ValueError(f"no attention device {dead} (pool has {n_attn})")
        if n_attn < 2:
            raise ValueError("cannot drop the last attention device — degrade instead")
        lost: List[int] = []
        for si, s in enumerate(self.shards):
            if s.dev_index != dead:
                continue
            lost.extend(range(s.lo, s.hi))
            for layer_kv in self._kv[si]:
                for short, t in layer_kv.items():
                    if short != "bt":
                        t.zero_()
            if self._pagers is not None:
                for r in range(s.rows):
                    self._pagers[si].release(r)
        if lost:
            self._slot_len[np.asarray(lost)] = 0
        self.exclude_device("attn", dead)
        self.reconfigure(n_attn=n_attn - 1)
        return sorted(lost)

    # ------------------------------------------------------------------
    # the exchange: realised two-phase transfer
    # ------------------------------------------------------------------
    def _dev_of(self, addr: Tuple[str, int]) -> torch.device:
        pool, idx = addr
        return (self.pools.attn_devices if pool == "attn" else self.pools.moe_devices)[idx]

    def _run_exchange(self, h2s: Dict[int, torch.Tensor], regime: str, tel: Dict) -> List[torch.Tensor]:
        """Land the concatenation of all shards' ``h2`` on every MoE device
        following the regime's move schedule.  ``h2s`` maps attention-device
        index -> this micro-batch's activation slice."""
        chunks, steps = self._plans[regime]
        have: Dict[Tuple[int, Tuple[str, int]], torch.Tensor] = {}
        node_payload: Dict[Tuple[int, ...], torch.Tensor] = {}
        for cid, ch in enumerate(chunks):
            leader = ("attn", ch.members[0])
            if ch.members not in node_payload:
                parts = [h2s[i].to(self._dev_of(leader)) for i in ch.members]
                node_payload[ch.members] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
            payload = node_payload[ch.members]
            if ch.n_subs > 1:  # case-2 pair split: ~total/pairs rows per chunk
                payload = torch.tensor_split(payload, ch.n_subs, dim=0)[ch.sub]
            have[(cid, leader)] = payload
        for st in steps:
            if st.phase == 1:
                tel["bytes_fast"] += h2s[st.src[1]].nbytes
                tel["msgs_fast"] += 1
                continue
            arr = have[(st.chunk, st.src)]
            have[(st.chunk, st.dst)] = arr.to(self._dev_of(st.dst))
            tel[f"bytes_{st.fabric}"] += arr.nbytes
            tel[f"msgs_{st.fabric}"] += 1
        outs = []
        for g in range(len(self.pools.moe_devices)):
            got = [have[(cid, ("moe", g))] for cid in range(len(chunks))]
            outs.append(got[0] if len(got) == 1 else torch.cat(got, dim=0))
        return outs

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def decode_step(self, tokens, positions, collect_stage_times: bool = False) -> Tuple[torch.Tensor, Dict]:
        """One batched decode step: ``tokens`` [b, 1], ``positions`` [b].
        Returns (logits [b, vocab] f32, telemetry)."""
        return self._decode_impl(tokens, positions, collect_stage_times)

    def decode_step_verify(self, tokens, positions, widths, collect_stage_times: bool = False):
        raise _later("decode_step_verify", "speculative decode")

    def _decode_impl(self, tokens, positions, collect_stage_times: bool = False) -> Tuple[torch.Tensor, Dict]:
        self._sync_tables()
        cfg = self.cfg
        pools = self.pools
        c = CommConfig(
            n_attn=len(pools.attn_devices),
            n_moe=self.n_moe,
            bytes_per_token=cfg.d_model * cfg.torch_dtype.itemsize,
            batch=self.max_batch,
            hw=dataclasses.replace(self.hw, devices_per_node=max(1, pools.node_size)),
        )
        t_pred, regime = adaptive_two_phase(c)
        tel: Dict = {
            "regime": regime,
            "t_comm_pred": t_pred,
            "bytes_slow": 0,
            "bytes_fast": 0,
            "msgs_slow": 0,
            "msgs_fast": 0,
        }
        times: Dict[str, float] = {"attn": 0.0, "exchange": 0.0, "moe": 0.0, "combine": 0.0}

        def _tick(key, arrs, t0):
            if collect_stage_times:
                _sync(arrs)
                times[key] += time.perf_counter() - t0
            return time.perf_counter()

        # shard inputs + embed (attention pool)
        xs: List[torch.Tensor] = []
        poss: List[torch.Tensor] = []
        for s in self.shards:
            dev = pools.attn_devices[s.dev_index]
            poss.append(positions[s.lo : s.hi].to(dev))
            xs.append(transformer.embed_tokens(self._attn_params[s.dev_index], tokens[s.lo : s.hi].to(dev), cfg))

        mbs = [[si for si, s in enumerate(self.shards) if s.mb == m] for m in range(self.n_micro)]
        # per-micro-batch item offsets (token order = shard order within the mb)
        offs = []
        for group in mbs:
            o, acc = {}, 0
            for si in group:
                o[si] = acc
                acc += self.shards[si].rows
            offs.append((o, acc))

        amax_parts: List[torch.Tensor] = []
        for li, kind in enumerate(self._kinds):
            h2s_all: List[Optional[torch.Tensor]] = [None] * len(self.shards)

            def attn_mb(group, li=li):
                t0 = time.perf_counter()
                for si in group:
                    s = self.shards[si]
                    lp = self._attn_params[s.dev_index]["layers"][li]
                    xs[si], h2s_all[si] = transformer.attention_stage(lp, xs[si], self._kv[si][li], poss[si], cfg)
                _tick("attn", [xs[si] for si in group], t0)

            if kind == "dense":
                for group in mbs:
                    attn_mb(group)
                    for si in group:
                        lp = self._attn_params[self.shards[si].dev_index]["layers"][li]
                        xs[si] = transformer.moe_stage(lp, xs[si], h2s_all[si], cfg)
                continue

            # MoE layer: per micro-batch attention -> exchange -> expert ->
            # combine, dispatched in ping-pong order: micro-batch m's expert
            # stage is issued before m-1's combine, and m+1's attention after
            # it (§6 / MegaScale micro-batch pipelining).
            pending: List[Tuple[int, List[int], List]] = []
            for m, group in enumerate(mbs):
                attn_mb(group)
                t0 = time.perf_counter()
                h2s = {self.shards[si].dev_index: h2s_all[si] for si in group}
                if self.fault_hook is not None:
                    self.fault_hook("exchange", li, m)
                h_on_moe = self._run_exchange(h2s, regime, tel)
                t0 = _tick("exchange", h_on_moe, t0)
                res = [self._moe_fn(g, li, h_on_moe[g]) for g in range(self.n_moe)]
                _tick("moe", [r[0] for r in res], t0)
                if pending:
                    self._combine_mb(*pending.pop(0), xs, h2s_all, offs, li, tel, times,
                                     collect_stage_times, amax_parts)
                pending.append((m, group, res))
            while pending:
                self._combine_mb(*pending.pop(0), xs, h2s_all, offs, li, tel, times,
                                 collect_stage_times, amax_parts)

        t0 = time.perf_counter()
        logit_shards = {}
        for si, s in enumerate(self.shards):
            p = self._attn_params[s.dev_index]
            logit_shards[s.lo] = transformer.lm_head(p, xs[si][:, 0, :], cfg)
        out_dev = pools.attn_devices[0]
        logits = torch.cat([logit_shards[lo].to(out_dev) for lo in sorted(logit_shards)], dim=0)
        if collect_stage_times:
            _sync([logits])
            times["head"] = time.perf_counter() - t0
            tel["stage_times"] = times
        # one host read a step: the largest instance-0 load of any layer
        tel["a_max"] = int(torch.stack([a.to(out_dev) for a in amax_parts]).max()) if amax_parts else 0
        tel["bytes_total"] = tel["bytes_slow"] + tel["bytes_fast"]
        return logits, tel

    def _combine_mb(self, m, group, res, xs, h2s_all, offs, li, tel, times, collect, amax_parts) -> None:
        """Ship expert partials back to the owning attention shards and run
        the gate-combine there (mono's op order)."""
        t0 = time.perf_counter()
        k = self.cfg.top_k
        off, _total = offs[m]
        amax_parts.append(res[0][4].max())  # load from instance 0 (redundant copies agree)
        for si in group:
            s = self.shards[si]
            dev = self.pools.attn_devices[s.dev_index]
            r0, r1 = off[si], off[si] + s.rows
            parts = []
            for y_items, keep, local, _gates, _load in res:
                part = (
                    y_items[r0 * k : r1 * k].to(dev),
                    keep[r0 * k : r1 * k].to(dev),
                    local[r0 * k : r1 * k].to(dev),
                )
                tel["bytes_slow"] += sum(a.nbytes for a in part)
                tel["msgs_slow"] += 1
                parts.append(part)
            gates = res[0][3][r0:r1].to(dev)
            tel["bytes_slow"] += gates.nbytes
            tel["msgs_slow"] += 1
            shared = self._attn_params[s.dev_index]["shared"][li]
            xs[si] = self._combine_fn(xs[si], h2s_all[si], shared, parts, gates)
        if collect:
            _sync([xs[si] for si in group])
            times["combine"] += time.perf_counter() - t0
