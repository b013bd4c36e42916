"""Launch-layer builders (``repro.launch.steps``): the default replica layout,
one-call constructors of the disaggregated executor, the serving engine and
the prefill worker, and the sharded steps.

The reference looks devices up with ``jax.devices()``; here the caller hands
in the device universe (``devices``, default ``[device]``, one card) and
nothing looks devices up.  On one card every pool aliases that device.

The sharded steps (``build_{train,prefill,serve}_step``) bind a step to a
``DeviceMesh`` with every weight placed by ``sharding.rules.param_pspecs``
and every input by ``input_pspecs``: the port's counterpart of the
reference's ``jax.jit(in_shardings=..., out_shardings=...)``.  Each builder
returns ``(step, example_args)``: ``step`` takes the global tensors (it
places them, as ``jit`` reshards its arguments) or DTensors already placed,
and runs the model eagerly over DTensors (``models/spmd.py``); the example
arguments are fake DTensors of the step's shapes, made in
``step.fake_mode``.  MoE layers take the expert-parallel path
(``models/moe_ep.py``): ``logical`` for train and prefill, ``scheduled``
(AEBS over replica slots pinned with :func:`materialize_slot_params`) for
decode, the Janus decode path as a first-class feature of the step
function.  Params, optimizer state and caches are updated in place where
the reference donates them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig, empty_inputs, input_specs
from repro_torch.core.aebs import ReplicaLayout, aebs_assign
from repro_torch.core.disagg import DevicePools
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import model as model_mod
from repro_torch.models import spmd
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.sharding.rules import axis_sizes, batch_axes, input_pspecs, param_pspecs, to_placements, P
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update, init_opt_state


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


# ---------------------------------------------------------------------------
# Sharded steps (``steps.py:28-104`` and ``steps.py:226-449``)
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no storage
    (``jax.eval_shape`` of ``init_params``)."""
    return transformer.init_params(cfg, None, torch.device("meta"))


def _walk(tree, fn, names=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, names + (str(i),)) for i, v in enumerate(tree)]
    return fn(names, tree)


def materialize_slot_params(params, cfg: ModelConfig, slot_to_expert):
    """Pin replica-slot expert weights (Janus places replicas in device
    memory at reconfiguration time): each MoE layer's ``[E, d, f]`` expert
    leaves become ``[S_total, d, f]`` copies (an empty slot, -1, holds
    expert 0's); the shared expert is not slotted, every other leaf is the
    same tensor."""
    idx = torch.as_tensor(slot_to_expert).long().clamp(min=0)

    def walk(names, leaf):
        if "moe" in names and "shared" not in names and names[-1] in ("w_gate", "w_up", "w_down"):
            return torch.index_select(leaf, 0, idx.to(leaf.device))
        return leaf

    return _walk(params, walk)


def pad_attention_heads(params, cfg: ModelConfig, n_model: int):
    """Pad query heads up to a multiple of the model-axis size, so attention
    shards by head instead of falling back to the d_model contraction.
    Heads are grouped KV-major, so the padding goes *within* each KV group;
    the padded ``wo`` rows are zero, so outputs are exact; ``num_kv_heads``
    is untouched (the group grows)."""
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if nh == 0 or nh % n_model == 0 or nkv == 0 or nh % nkv:
        return params
    lcm = n_model * nkv // math.gcd(n_model, nkv)
    target = ((nh + lcm - 1) // lcm) * lcm
    g_old, pad_g = nh // nkv, target // nkv - nh // nkv

    def walk(names, leaf):
        if names[-1] == "wq":  # [d, nh, hd] -> [d, nkv, g, hd], pad g
            d, _, hd = leaf.shape
            w = torch.nn.functional.pad(leaf.reshape(d, nkv, g_old, hd), (0, 0, 0, pad_g))
            return w.reshape(d, target, hd)
        if names[-1] == "wo":  # [nh, hd, d] -> [nkv, g, hd, d], pad g with zeros
            _, hd, d = leaf.shape
            w = torch.nn.functional.pad(leaf.reshape(nkv, g_old, hd, d), (0, 0, 0, 0, 0, pad_g))
            return w.reshape(target, hd, d)
        return leaf

    return _walk(params, walk)


def make_moe_ctx(cfg: ModelConfig, mesh, mode: str, scheduler=None, fsdp: bool = False) -> Optional[Dict]:
    """The MoE layers' context for ``mode`` (``steps.py:226``): expert
    parallelism over ``mesh``; ``scheduled`` adds the grouped body, the
    default layout over the model axis (one instance a rank) and its
    scheduler: ``scheduler``, else the device's AEBS (``aebs_schedule``, K2,
    on a ``cuda`` mesh; ``aebs_assign`` on the CPU), as the engine's
    ``aebs`` choice follows its device."""
    if not cfg.has_moe:
        return None
    n_model = axis_sizes(mesh)["model"]
    ctx: Dict[str, Any] = dict(
        dispatch="ep",
        ep_ctx=dict(mesh=mesh, dp_axes=batch_axes(mesh), model_axis="model", mode=mode, fsdp=fsdp),
    )
    if mode == "scheduled":
        # the serving hot path: sort-based grouped dispatch, no per-step weight
        # copies, inactive replica slots stream no weights
        ctx["ep_ctx"]["dispatch"] = "grouped"
        dev = _mesh_device(mesh)
        layout = serving_layout(cfg, n_model)
        if scheduler is None:
            scheduler = aebs_schedule if dev.type == "cuda" else aebs_assign
        ctx.update(
            scheduler=scheduler,
            layout_tables=layout.device_tables(dev),
            slot_to_expert=torch.as_tensor(layout.slot_to_expert.reshape(-1), dtype=torch.int32, device=dev),
            num_instances=n_model,
        )
    return ctx


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _extra_inputs(cfg: ModelConfig, specs: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Split the input-spec dict into (model extras, remaining)."""
    extras = {k: specs[k] for k in ("encoder_frames", "patch_embeds") if k in specs}
    rest = {k: v for k, v in specs.items() if k not in extras}
    return extras, rest


def place(tree, specs, mesh, own_storage: bool = False):
    """Each tensor of ``tree`` as a DTensor with its spec's placements
    (``rules.to_placements``): a plain tensor is the global value (each rank
    keeps its part, ``spmd.as_dtensor``), a DTensor is redistributed if its
    placements differ."""
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh, own_storage) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(v, s, mesh, own_storage) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, mesh, own_storage) for v, s in zip(tree, specs))
    pl = to_placements(specs, mesh)
    if hasattr(tree, "placements"):
        return tree if list(tree.placements) == pl else tree.redistribute(mesh, pl)
    return spmd.as_dtensor(tree, mesh, pl, own_storage)


class ShardedStep:
    """A step bound to a mesh (``jax.jit`` with shardings): ``step(*args)``
    places each argument by its specs (:func:`place`) and runs ``fn``.
    ``example_args`` of the builder are fake DTensors of ``fake_mode``."""

    def __init__(self, fn, mesh, arg_specs, fake_mode, **info):
        self.fn, self.mesh, self.arg_specs, self.fake_mode = fn, mesh, arg_specs, fake_mode
        self.info = info

    def __call__(self, *args):
        return self.fn(*(place(a, s, self.mesh) for a, s in zip(args, self.arg_specs)))


def _example(fake_mode, mesh, trees_and_specs):
    """Fake DTensors of the given meta trees (or input specs), each placed
    with storage of its own."""
    dev = _mesh_device(mesh)
    out = []
    with fake_mode:
        for tree, specs in trees_and_specs:
            out.append(place(_like(tree, dev), specs, mesh, own_storage=True))
    return out


def _like(tree, dev):
    """Empty tensors of ``tree``'s shapes and dtypes on ``dev``, its dicts,
    lists and named tuples kept."""
    if isinstance(tree, dict):
        return {k: _like(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_like(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_like(v, dev) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device=dev)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the MoE context's layout tables are real tensors made at build time
    return FakeTensorMode(allow_non_fake_inputs=True)


def _abstract_params(cfg, mesh, pad_heads: bool):
    params_abs = abstract_params(cfg)
    n_model = axis_sizes(mesh)["model"]
    if pad_heads and cfg.num_heads and cfg.num_heads % n_model:
        # head padding: head-sharded attention, one psum less a layer
        params_abs = pad_attention_heads(params_abs, cfg, n_model)
    return params_abs


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, mesh, shape: InputShape, opt_cfg: Optional[AdamWConfig] = None):
    """ZeRO-1 training (``steps.py:265``): weights placed by ``param_pspecs``
    (tensor parallel over ``model``, replicated over the data axes), AdamW
    moments split over every axis (``fsdp=True``).  A step takes the loss
    and its gradients over the DTensors (remat, 512-position cross-entropy
    chunks, the MoE layers on logical expert parallelism with the
    ``scatter`` body), redistributes the gradients to the moments' layout
    (a reduce-scatter over the data axes), runs AdamW on those shards in
    place, and gathers the updated shards back into the weights.  A caller
    of a config whose heads do not divide the model axis passes weights
    padded by :func:`pad_attention_heads`.  Returns ``(step,
    (params, opt_state, batch))``; ``step`` returns ``(params, opt_state,
    {"loss", "grad_norm"})``, params and moments updated in place."""
    from torch.distributed.tensor.experimental import implicit_replication

    opt_cfg = opt_cfg or AdamWConfig()
    specs = input_specs(cfg, shape)
    extras_abs, _ = _extra_inputs(cfg, specs)
    moe_ctx = make_moe_ctx(cfg, mesh, "logical")
    params_abs = _abstract_params(cfg, mesh, pad_heads=True)
    opt_abs = init_opt_state(params_abs)
    p_pspecs = param_pspecs(cfg, params_abs, mesh, fsdp=False)
    m_pspecs = param_pspecs(cfg, params_abs, mesh, fsdp=True)
    opt_pspecs = OptState(P(), m_pspecs, m_pspecs)
    in_pspecs = input_pspecs(cfg, shape, specs, mesh)
    # the sequence-parallel residual applies to attention stacks only:
    # recurrent layers consume the sequence serially, and MoE layers take
    # the batch layout
    seq_ok = (shape.seq_len % axis_sizes(mesh)["model"] == 0 and not cfg.has_moe
              and cfg.family not in ("ssm", "hybrid"))
    act_pl = to_placements(P(in_pspecs["tokens"][0], "model" if seq_ok else None, None), mesh)

    def train_step(params, opt_state, batch):
        extra = {k: batch[k] for k in extras_abs}
        if moe_ctx:
            extra["moe_ctx"] = moe_ctx
        extra["act_constraint"] = lambda x: x.redistribute(mesh, act_pl)
        leaves = tree_leaves(params)
        with implicit_replication():
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss, _ = model_mod.loss_fn(params, batch["tokens"], batch["labels"], cfg, extra=extra,
                                            remat=True, xent_chunk=512)
                grads = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            with torch.no_grad():
                # ZeRO-1: reduce-scatter the gradients to the moments' layout
                # and update the matching shards of the weights, then gather
                mu, nu = tree_leaves(opt_state.mu), tree_leaves(opt_state.nu)
                g_sh = [g.redistribute(mesh, m.placements) for g, m in zip(grads, mu)]
                del grads
                p_sh = [p.redistribute(mesh, m.placements) for p, m in zip(leaves, mu)]
                _, state, info = adamw_update(opt_cfg, p_sh, g_sh, OptState(opt_state.step, mu, nu))
                del g_sh
                for p, s in zip(leaves, p_sh):
                    p.copy_(s.redistribute(mesh, p.placements))
        return params, OptState(state.step, opt_state.mu, opt_state.nu), {
            "loss": loss.detach(), "grad_norm": info["grad_norm"]}

    batch_specs = {k: in_pspecs[k] for k in specs}
    fake_mode = _fake_mode()
    example = _example(fake_mode, mesh, [(params_abs, p_pspecs), (opt_abs, opt_pspecs),
                                         (empty_inputs(specs), batch_specs)])
    step = ShardedStep(train_step, mesh, (p_pspecs, opt_pspecs, batch_specs), fake_mode,
                       param_pspecs=p_pspecs, opt_pspecs=opt_pspecs, input_pspecs=in_pspecs)
    return step, tuple(example)


# ---------------------------------------------------------------------------
# Prefill step
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, mesh, shape: InputShape):
    """Whole-prompt prefill (``steps.py:339``): returns ``(step, (params,
    batch))``; ``step`` returns ``(next_tok [B] int32, caches)``, the caches
    in the decode step's layout (``input_pspecs`` of the decode shape)."""
    from torch.distributed.tensor.experimental import implicit_replication

    specs = input_specs(cfg, shape)
    extras_abs, _ = _extra_inputs(cfg, specs)
    moe_ctx = make_moe_ctx(cfg, mesh, "logical")
    params_abs = _abstract_params(cfg, mesh, pad_heads=True)
    p_pspecs = param_pspecs(cfg, params_abs, mesh)
    in_pspecs = input_pspecs(cfg, shape, specs, mesh)
    # caches produced by prefill follow the decode cache shardings
    decode_shape = InputShape(shape.name, shape.seq_len, shape.global_batch, "decode")
    cache_specs_ = input_specs(cfg, decode_shape)
    cache_pspecs = input_pspecs(cfg, decode_shape, cache_specs_, mesh)
    cache_pl = {k: to_placements(cache_pspecs[k], mesh) for k in cache_specs_ if k not in ("tokens", "cache_index")}

    def prefill_step(params, batch):
        extra = {k: batch[k] for k in extras_abs}
        if moe_ctx:
            extra["moe_ctx"] = moe_ctx
        with torch.no_grad(), implicit_replication():
            logits, caches = model_mod.prefill(params, batch["tokens"], cfg, cache_len=shape.seq_len,
                                               extra=extra or None)
            next_tok = spmd.argmax(logits)
            caches = {k: v.redistribute(mesh, cache_pl[k]) for k, v in caches.items()}
        return next_tok, caches

    batch_specs = {k: in_pspecs[k] for k in specs}
    fake_mode = _fake_mode()
    example = _example(fake_mode, mesh, [(params_abs, p_pspecs), (empty_inputs(specs), batch_specs)])
    step = ShardedStep(prefill_step, mesh, (p_pspecs, batch_specs), fake_mode, param_pspecs=p_pspecs,
                       input_pspecs=in_pspecs, cache_pspecs=cache_pspecs)
    return step, tuple(example)


# ---------------------------------------------------------------------------
# Serve (decode) step
# ---------------------------------------------------------------------------


def build_serve_step(cfg: ModelConfig, mesh, shape: InputShape, scheduler=None, unroll: bool = True):
    """One new token with a cache of ``shape.seq_len`` rows, the Janus decode
    path (``steps.py:390``).  The MoE layers schedule with AEBS over
    ``serving_layout(cfg, model-axis size)`` (``make_moe_ctx``; K2 on the
    card) and run the grouped body over each rank's pinned slots (K3); the
    caller pins them with :func:`materialize_slot_params` and
    ``step.info["moe_ctx"]["slot_to_expert"]``.  ``step(params, tokens,
    cache_index, caches)`` takes the reference's scalar ``cache_index`` (every
    slot at that position) and returns ``(next_tok [B] int32, caches)``, the
    caches updated in place.  ``unroll`` is the reference's (its decode
    unrolls the layer loop); an eager step runs layer by layer anyway."""
    from torch.distributed.tensor.experimental import implicit_replication

    del unroll
    specs = input_specs(cfg, shape)
    moe_ctx = make_moe_ctx(cfg, mesh, "scheduled", scheduler)
    params_abs = abstract_params(cfg)
    if moe_ctx is not None:
        params_abs = materialize_slot_params(params_abs, cfg, moe_ctx["slot_to_expert"])
    p_pspecs = param_pspecs(cfg, params_abs, mesh)
    in_pspecs = input_pspecs(cfg, shape, specs, mesh)
    cache_keys = [k for k in specs if k not in ("tokens", "cache_index")]

    def serve_step(params, tokens, cache_index, caches):
        ci = cache_index.to_local() if hasattr(cache_index, "placements") else torch.as_tensor(cache_index)
        pos = ci.reshape(()).expand(tokens.shape[0])
        with torch.no_grad(), implicit_replication():
            logits, caches = model_mod.decode_step(params, tokens, caches, pos, cfg,
                                                   extra={"moe_ctx": moe_ctx} if moe_ctx else None)
            next_tok = spmd.argmax(logits)
        return next_tok, caches

    cache_specs_ = {k: in_pspecs[k] for k in cache_keys}
    fake_mode = _fake_mode()
    example = _example(fake_mode, mesh, [
        (params_abs, p_pspecs), (empty_inputs({"tokens": specs["tokens"]}), {"tokens": in_pspecs["tokens"]}),
        (empty_inputs({"cache_index": specs["cache_index"]}), {"cache_index": in_pspecs["cache_index"]}),
        (empty_inputs({k: specs[k] for k in cache_keys}), cache_specs_)])
    step = ShardedStep(serve_step, mesh, (p_pspecs, in_pspecs["tokens"], in_pspecs["cache_index"], cache_specs_),
                       fake_mode, param_pspecs=p_pspecs, input_pspecs=in_pspecs, moe_ctx=moe_ctx)
    return step, (example[0], example[1]["tokens"], example[2]["cache_index"], example[3])


BUILDERS = {
    "train": build_train_step,
    "prefill": build_prefill_step,
    "decode": build_serve_step,
}
