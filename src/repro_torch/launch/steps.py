"""Launch-layer builders for serving (``repro.launch.steps``, its serving
builders only): the default replica layout and one-call constructors of the
disaggregated executor, the serving engine and the prefill worker.

The reference looks devices up with ``jax.devices()``; here the caller hands
in the device universe (``devices``, default ``[device]``, one card) and
nothing looks devices up.  On one card every pool aliases that device.  The
SPMD and training builders of the reference's module (the sharded step
functions, ``materialize_slot_params``, ``pad_attention_heads``,
``make_moe_ctx``) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.disagg import DevicePools
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models.common import resolve_device


def serving_layout(cfg, n_instances: int) -> ReplicaLayout:
    """The default production layout (``steps.py:32``): round-robin over
    ``n_instances`` instances of C slots, C the least that seats every expert
    with a slot of headroom (``n_e * C > E``)."""
    C = math.ceil((cfg.num_experts + 1) / n_instances)
    return ReplicaLayout.round_robin(cfg.num_experts, n_instances, C)


def _universe(devices: Optional[Sequence], device) -> list:
    return [resolve_device(d) for d in devices] if devices is not None else [resolve_device(device)]


def build_disagg_executor(
    cfg,
    params,
    n_attn: int,
    n_moe: int,
    *,
    max_batch: int,
    cache_len: int,
    layout: Optional[ReplicaLayout] = None,
    scheduler=aebs_schedule,
    capacity: Optional[int] = None,
    ping_pong: bool = False,
    node_size: int = 1,
    n_prefill: int = 0,
    devices: Optional[Sequence] = None,
    device="cuda",
):
    """The pool deployment (``steps.py:106``): split the device universe into
    (n_attn, n_moe) decode pools plus an optional ``n_prefill`` prefill pool
    (aliased round-robin when there are fewer devices), derive the default
    layout when none is given, and build the
    :class:`repro_torch.serving.disagg.DisaggExecutor` over them."""
    from repro_torch.serving.disagg import DisaggExecutor

    devs = _universe(devices, device)
    pools = DevicePools.split(
        n_attn, n_moe, devs, node_size=node_size, n_prefill=n_prefill,
        allow_reuse=len(devs) < n_attn + n_moe + n_prefill,
    )
    if layout is None:
        layout = serving_layout(cfg, n_moe)
    return DisaggExecutor(
        cfg, params, pools, layout, max_batch=max_batch, cache_len=cache_len,
        scheduler=scheduler, capacity=capacity, ping_pong=ping_pong, devices=devs,
    )


def build_serving_engine(
    cfg,
    params,
    n_attn: int,
    n_moe: int,
    *,
    max_batch: int,
    cache_len: int,
    n_prefill: int = 0,
    layout: Optional[ReplicaLayout] = None,
    scheduler: str = "aebs",
    capacity: Optional[int] = None,
    prefill_chunk: int = 64,
    fault_plan=None,
    retry_policy=None,
    watchdog=None,
    kv_page_size: Optional[int] = None,
    kv_num_pages: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device="cuda",
    **engine_kw,
):
    """A fault-tolerant pool deployment in one call (``steps.py:152``): the
    disaggregated :class:`repro_torch.serving.engine.ServingEngine` with the
    default layout over ``n_moe`` instances, its pools split from the device
    universe, and an optional armed fault plan."""
    from repro_torch.serving.engine import ServingEngine

    if layout is None and cfg.has_moe:
        layout = serving_layout(cfg, n_moe)
    devs = _universe(devices, device)
    pools = engine_kw.pop("pools", None)
    if pools is None:
        n_e = layout.num_instances if layout is not None else n_moe
        pools = DevicePools.split(
            n_attn, n_e, devs, node_size=engine_kw.pop("node_size", 1), n_prefill=n_prefill,
            allow_reuse=len(devs) < n_attn + n_e + n_prefill,
        )
    return ServingEngine(
        cfg, params, max_batch=max_batch, cache_len=cache_len, layout=layout,
        scheduler=scheduler, capacity_tokens=capacity, executor="disagg", n_attn=n_attn,
        n_prefill=n_prefill, prefill_chunk=prefill_chunk, fault_plan=fault_plan,
        retry_policy=retry_policy, watchdog=watchdog, kv_page_size=kv_page_size,
        kv_num_pages=kv_num_pages, pools=pools, device=devs[0], **engine_kw,
    )


def build_prefill_worker(
    cfg,
    params,
    n_prefill: int,
    *,
    cache_len: int,
    chunk: int = 64,
    n_attn: int = 0,
    n_moe: int = 0,
    devices: Optional[Sequence] = None,
    device="cuda",
    prefill_time_fn=None,
):
    """A prefill pool (``steps.py:193``): a
    :class:`repro_torch.serving.prefill.PrefillWorker` over the prefill
    slice of the three-way split.  Pass the deployment's ``n_attn`` and
    ``n_moe`` so the worker lands on the devices a composed
    :func:`build_disagg_executor` reserves for prefill (just ahead of the MoE
    pool); with the defaults it takes the tail of the device list."""
    from repro_torch.serving.prefill import PrefillWorker

    devs = _universe(devices, device)
    pools = DevicePools.split(
        n_attn, n_moe, devs, n_prefill=n_prefill,
        allow_reuse=len(devs) < n_attn + n_moe + n_prefill,
    )
    return PrefillWorker(
        cfg, params, pools.prefill_devices, device=devs[0], cache_len=cache_len, chunk=chunk,
        prefill_time_fn=prefill_time_fn,
    )
