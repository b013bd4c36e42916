"""Multi-process runs of the port's SPMD layer for ``tests/test_torch_moe_ep.py``
and ``tests/test_torch_spmd_steps.py``.

The pytest process never opens a process group: a test runs

    python -c "import _torch_spmd; _torch_spmd.main()" CASE WORLD IN.npz OUT.npz

with ``tests`` and ``src`` on ``sys.path``, which spawns ``WORLD`` ranks over a
``gloo`` group (one torch thread each) meeting at a ``FileStore`` beside
``OUT.npz``; each rank runs ``CASE`` on the inputs and rank 0 writes the
global values of its outputs.  Trees cross as flat ``{"a/b/c": array}``
dicts.
"""

import dataclasses
import os
import sys

import numpy as np


def flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _np(t):
    import torch

    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _entry(rank, world, store, case, in_path, out_path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.launch.mesh import close_group, open_group

    open_group("gloo", world, rank, dist.FileStore(store, world))
    try:
        out = {k: _np(v) for k, v in flatten(CASES[case](world, dict(np.load(in_path)))).items()}  # every rank gathers
        if rank == 0:
            np.savez(out_path, **out)
        dist.barrier()
    finally:
        close_group()


def main():
    import torch.multiprocessing as mp

    case, world, in_path, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    store = out_path + ".store"
    if os.path.exists(store):
        os.remove(store)
    mp.start_processes(_entry, args=(world, store, case, in_path, out_path), nprocs=world, start_method="spawn")


def _mesh(world):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(*((2, 4) if world == 8 else (1, world)), device_type="cpu")


# ---------------------------------------------------------------------------
# expert-parallel MoE (tests/test_torch_moe_ep.py)
# ---------------------------------------------------------------------------


def moe_ep_case(world, d):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.aebs import ReplicaLayout, aebs_assign
    from repro_torch.launch.steps import place
    from repro_torch.models.moe_ep import moe_layer_ep
    from repro_torch.sharding.rules import param_pspecs

    mesh = _mesh(world)
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b-reduced"), dtype="float32")
    params = unflatten({k[2:]: torch.from_numpy(v) for k, v in d.items() if k.startswith("p/")})
    x = torch.from_numpy(d["x"])
    ep = dict(mesh=mesh, dp_axes=("data",), model_axis="model", capacity_factor=8.0)
    layout = ReplicaLayout.round_robin(cfg.num_experts, 4, 2)
    stx = torch.from_numpy(layout.slot_to_expert.reshape(-1))
    sched = dict(mode="scheduled", scheduler=aebs_assign, layout_tables=layout.device_tables("cpu"),
                 slot_to_expert=stx, num_instances=4, with_aux=True)
    out = {}
    for disp in ("scatter", "grouped"):
        out[f"logical_{disp}"] = moe_layer_ep(params, x, cfg, mode="logical", dispatch=disp, **ep)
        y, aux = moe_layer_ep(params, x, cfg, dispatch=disp, **ep, **sched)
        out[f"scheduled_{disp}"], out[f"load_{disp}"] = y, aux["load"]
    pinned = dict(params, **{k: params[k][stx.long().clamp(min=0)] for k in ("w_gate", "w_up", "w_down")})
    y, aux = moe_layer_ep(pinned, x, cfg, dispatch="grouped", **ep, **sched)
    out["pinned"], out["load_pinned"] = y, aux["load"]
    # gradients of the logical layer: weights placed as the train step places them
    placed = place(params, param_pspecs(cfg, params, mesh), mesh)
    leaves = flatten(placed)
    for t in leaves.values():
        t.requires_grad_(True)
    y = moe_layer_ep(placed, x, cfg, mode="logical", dispatch="scatter", **ep)
    (y ** 2).sum().full_tensor().backward()
    out["grad"] = unflatten({k: t.grad for k, t in leaves.items()})
    return out


# ---------------------------------------------------------------------------
# the sharded steps (tests/test_torch_spmd_steps.py)
# ---------------------------------------------------------------------------


def steps_case(world, d):
    import torch

    from repro_torch import bridge
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import period_pattern
    from repro_torch.training.optimizer import init_opt_state

    mesh = _mesh(world)
    out = {}
    for arch in sorted({k.split("/")[1] for k in d if k.startswith("p/")}):
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        ref = unflatten({k[len(f"p/{arch}/"):]: v for k, v in d.items() if k.startswith(f"p/{arch}/")})
        params = bridge.params_from_jax(ref)
        B, S = d["train_tokens"].shape
        if f"{arch}/train" in d["cases"]:
            step, _ = steps.build_train_step(cfg, mesh, InputShape("train", S, B, "train"))
            p, st = bridge.params_from_jax(ref), None
            batch = {"tokens": torch.from_numpy(d["train_tokens"]), "labels": torch.from_numpy(d["train_labels"])}
            st = init_opt_state(p)
            for i in range(2):
                p, st, info = step(p, st, batch)
                out[f"{arch}/train/loss{i}"] = info["loss"]
                out[f"{arch}/train/grad_norm{i}"] = info["grad_norm"]
            full = tree_map(lambda t: t.full_tensor(), p)
            out[f"{arch}/train/params"] = bridge.params_to_numpy(full, len(period_pattern(cfg)[0]))
        if f"{arch}/prefill" in d["cases"]:
            step, _ = steps.build_prefill_step(cfg, mesh, InputShape("prefill", S, B, "prefill"))
            tok, caches = step(params, {"tokens": torch.from_numpy(d["prefill_tokens"])})
            out[f"{arch}/prefill/tok"] = tok
            out[f"{arch}/prefill/caches"] = caches
        if f"{arch}/decode" in d["cases"]:
            rows = int(d["cache_rows"])
            step, _ = steps.build_serve_step(cfg, mesh, InputShape("decode", rows, B, "decode"))
            ctx = step.info["moe_ctx"]
            if ctx is not None:
                params = steps.materialize_slot_params(params, cfg, ctx["slot_to_expert"])
            caches = {k[len(f"c/{arch}/"):]: torch.from_numpy(v.copy()) for k, v in d.items()
                      if k.startswith(f"c/{arch}/")}
            tok = torch.from_numpy(d["decode_tokens"])
            toks = []
            for i in range(int(d["decode_steps"])):
                nxt, caches = step(params, tok, torch.tensor(int(d["cache_index"]) + i, dtype=torch.int32), caches)
                tok = nxt.full_tensor()[:, None]
                toks.append(tok)
            out[f"{arch}/decode/tokens"] = torch.cat(toks, dim=1)
            out[f"{arch}/decode/caches"] = caches
    # head-parallel attention whose ranks' query heads straddle KV groups
    # (12 heads over 3 KV heads, 3 a rank on a model axis of 4)
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b-reduced"), dtype="float32", num_heads=12, num_kv_heads=3)
    B, S = d["train_tokens"].shape
    step, _ = steps.build_train_step(cfg, mesh, InputShape("train", S, B, "train"))
    p = model_mod.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(d["train_tokens"]), "labels": torch.from_numpy(d["train_labels"])}
    p, _, info = step(p, init_opt_state(p), batch)
    out["straddle/train/loss"] = info["loss"]
    out["straddle/train/params"] = bridge.params_to_numpy(tree_map(lambda t: t.full_tensor(), p))
    step, _ = steps.build_prefill_step(cfg, mesh, InputShape("prefill", S, B, "prefill"))
    out["straddle/prefill/tok"], out["straddle/prefill/caches"] = step(
        model_mod.init_params(cfg, seed=0, device="cpu"), {"tokens": torch.from_numpy(d["prefill_tokens"])})
    # cross attention (whisper's decoder over its encoder's output)
    cfg = dataclasses.replace(get_config("whisper-tiny-reduced"), dtype="float32")
    step, _ = steps.build_prefill_step(cfg, mesh, InputShape("prefill", S, B, "prefill"))
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=torch.Generator().manual_seed(0))
    out["cross/prefill/tok"], out["cross/prefill/caches"] = step(
        model_mod.init_params(cfg, seed=0, device="cpu"),
        {"tokens": torch.from_numpy(d["prefill_tokens"]) % cfg.vocab_size, "encoder_frames": frames})
    return out


CASES = {"moe_ep": moe_ep_case, "steps": steps_case}
