"""Partition rules, input shapes and the launch layer's parameter transforms
of the port (``repro_torch.sharding.rules``, ``configs.base``,
``launch.steps``) against the reference's (``repro.sharding.rules``,
``repro.configs.base``, ``repro.launch.steps``).

The rules need no process group: both sides take an object whose ``.shape``
maps axis names to sizes, as ``tests/test_sharding_rules.py`` passes.  The
port's parameters are one dict per layer where the reference stacks each
period position's layers (``blocks/pos{p}``, and ``encoder``) over a leading
axis, so a stacked leaf's reference spec is compared without its first
entry."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro.sharding import rules as ref_rules
from repro_torch import bridge
from repro_torch.configs import ASSIGNED, REGISTRY, SHAPES, get_config, input_specs, shape_supported
from repro_torch.launch import steps
from repro_torch.sharding import rules

torch.set_num_threads(1)

MESHES = {
    "16x16": SimpleNamespace(shape={"data": 16, "model": 16}, mesh_dim_names=("data", "model")),
    "2x16x16": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16}, mesh_dim_names=("pod", "data", "model")),
}


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return ref_steps.abstract_params(ref_configs.get_config(arch))


def _port_leaves(tree, names=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, names + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, names + (i,))
    else:
        yield names, tree


def _ref_path(names, period):
    """The reference tree's path of a port leaf, and whether it is stacked."""
    if names[0] == "layers":
        return ("blocks", f"pos{names[1] % period}") + names[2:], True
    if names[0] == "encoder":
        return ("encoder",) + names[2:], True
    return names, False


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _period(arch):
    return len(ref_transformer.period_pattern(ref_configs.get_config(arch))[0])


def _ref_params(cfg, seed=0):
    """The reference's parameter tree at ``cfg``'s shapes (``eval_shape`` of
    its ``init_params``) filled with seeded normals, float32."""
    rng = np.random.default_rng(seed)
    abstract = ref_steps.abstract_params(cfg)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), abstract)


def test_shapes_and_support_equal_reference():
    assert list(SHAPES) == list(ref_configs.SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(ref_configs.SHAPES[name])
    for arch in REGISTRY:
        for name in SHAPES:
            for suffix in ("", "-reduced"):
                assert shape_supported(get_config(arch + suffix), SHAPES[name]) == \
                    ref_configs.shape_supported(ref_configs.get_config(arch + suffix), ref_configs.SHAPES[name])


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_input_specs_equal_reference(arch):
    """Names (in order), shapes and dtypes of every shape's inputs."""
    for kv_quant in (False, True):
        cfg = dataclasses.replace(get_config(arch), kv_quant=kv_quant)
        ref_cfg = dataclasses.replace(ref_configs.get_config(arch), kv_quant=kv_quant)
        for name in SHAPES:
            got = input_specs(cfg, SHAPES[name])
            want = ref_configs.input_specs(ref_cfg, ref_configs.SHAPES[name])
            assert list(got) == list(want), (arch, name)
            for k, (shape, dtype) in got.items():
                assert shape == tuple(want[k].shape), (arch, name, k)
                assert str(dtype).replace("torch.", "") == str(np.dtype(want[k].dtype)), (arch, name, k)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_param_pspecs_equal_reference(arch, mesh_name):
    """Leaf for leaf, the stacked entry dropped, with and without fsdp."""
    cfg, mesh = REGISTRY[arch], MESHES[mesh_name]
    port_abs = steps.abstract_params(cfg)
    ref_abs = _ref_abstract(arch)
    n_ref = len(jax.tree.leaves(ref_abs))
    for fsdp in (False, True):
        got = rules.param_pspecs(cfg, port_abs, mesh, fsdp=fsdp)
        want = ref_rules.param_pspecs(ref_configs.get_config(arch), ref_abs, mesh, fsdp=fsdp)
        seen = set()
        for names, spec in _port_leaves(got):
            path, stacked = _ref_path(names, _period(arch))
            ref_spec = tuple(_get(want, path))
            assert tuple(spec) == (ref_spec[1:] if stacked else ref_spec), (names, fsdp)
            assert isinstance(spec, rules.P)
            seen.add(path)
        assert len(seen) == n_ref


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_input_pspecs_equal_reference_and_divide(arch, mesh_name):
    """Exactly the reference's specs, and every spec divides its dimension
    (``tests/test_sharding_rules.py``'s check), params included."""
    cfg, mesh = REGISTRY[arch], MESHES[mesh_name]
    ref_cfg = ref_configs.get_config(arch)
    for name, shape in SHAPES.items():
        if not shape_supported(cfg, shape)[0]:
            continue
        specs = input_specs(cfg, shape)
        got = rules.input_pspecs(cfg, shape, specs, mesh)
        want = ref_rules.input_pspecs(ref_cfg, ref_configs.SHAPES[name],
                                      ref_configs.input_specs(ref_cfg, ref_configs.SHAPES[name]), mesh)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}, name
        for k, (s, _) in specs.items():
            _check_divides(s, got[k], mesh, f"{arch}/{name}/{k}")
    params = steps.abstract_params(cfg)
    for fsdp in (False, True):
        specs = dict(_port_leaves(rules.param_pspecs(cfg, params, mesh, fsdp=fsdp)))
        for names, leaf in _port_leaves(params):
            _check_divides(tuple(leaf.shape), specs[names], mesh, f"{arch}/{names} fsdp={fsdp}")


def _check_divides(shape, spec, mesh, what):
    assert len(spec) <= len(shape), (what, shape, spec)
    for dim, entry in zip(shape, spec):
        k = 1
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            k *= mesh.shape[a]
        assert dim % k == 0, f"{what}: dim {dim} not divisible by {k} ({spec})"


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_to_placements_round_trips(mesh_name):
    """Every spec the rules give for decode and training inputs and for the
    weights maps to placements and back to itself (a trailing replicated
    dimension spelled out)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES[mesh_name]
    cfg = REGISTRY["qwen2-moe-a2.7b"]
    all_specs = list(rules.input_pspecs(cfg, SHAPES["decode_32k"], input_specs(cfg, SHAPES["decode_32k"]), mesh).values())
    all_specs += [s for _, s in _port_leaves(rules.param_pspecs(cfg, steps.abstract_params(cfg), mesh, fsdp=True))]
    all_specs += [rules.P(None, None, ("pod", "data", "model")) if "pod" in mesh.shape else rules.P(("data", "model"))]
    for spec in all_specs:
        pl = rules.to_placements(spec, mesh)
        assert len(pl) == len(mesh.mesh_dim_names)
        assert all(isinstance(p, (Shard, Replicate)) for p in pl)
        ndim = max(len(spec), 1)
        back = rules.from_placements(pl, mesh, ndim)
        assert tuple(back) == tuple(spec) + (None,) * (ndim - len(spec)), spec
    with pytest.raises(ValueError):
        rules.to_placements(rules.P(("model", "data")), mesh)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b-reduced", "whisper-tiny-reduced"])
def test_pad_attention_heads_equals_reference(name):
    """At ``n_model`` 3 (4 heads over 2 and 4 KV heads: padded to 6 and 12
    within each KV group, ``wo``'s new rows zero), encoder and cross
    attention included."""
    ref_cfg = dataclasses.replace(ref_configs.get_config(name), dtype="float32")
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    ref_p = _ref_params(ref_cfg)
    want = ref_steps.pad_attention_heads(ref_p, ref_cfg, 3)
    got = steps.pad_attention_heads(bridge.params_from_jax(ref_p), cfg, 3)
    want_t = bridge.params_from_jax(jax.tree.map(np.asarray, want))
    assert got["layers"][0]["attn"]["wq"].shape[1] > cfg.num_heads
    for (names, a), (_, b) in zip(_port_leaves(got), _port_leaves(want_t)):
        assert torch.equal(a, b), names


def test_materialize_slot_params_equals_reference():
    """Every MoE layer's expert leaves become per-slot copies of the
    default 4-instance layout; the shared expert and everything else are
    untouched."""
    name = "qwen2-moe-a2.7b-reduced"
    ref_cfg = dataclasses.replace(ref_configs.get_config(name), dtype="float32")
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    ref_p = _ref_params(ref_cfg)
    stx = ref_steps.serving_layout(ref_cfg, 4).slot_to_expert.reshape(-1)
    assert np.array_equal(stx, steps.serving_layout(cfg, 4).slot_to_expert.reshape(-1))
    want = bridge.params_from_jax(jax.tree.map(np.asarray, ref_steps.materialize_slot_params(ref_p, ref_cfg, stx)))
    src = bridge.params_from_jax(ref_p)
    got = steps.materialize_slot_params(src, cfg, torch.from_numpy(stx))
    assert got["layers"][0]["moe"]["w_gate"].shape[0] == len(stx)
    assert got["layers"][0]["moe"]["shared"]["w_gate"] is src["layers"][0]["moe"]["shared"]["w_gate"]
    for (names, a), (_, b) in zip(_port_leaves(got), _port_leaves(want)):
        assert torch.equal(a, b), names


def test_abstract_params_match_init_params():
    """``abstract_params`` is ``init_params``' tree as ``meta`` tensors."""
    from repro_torch.models import model as model_mod

    for name in ("dsv2-lite-reduced", "zamba2-2.7b-reduced", "whisper-tiny-reduced"):
        cfg = get_config(name)
        real = dict(_port_leaves(model_mod.init_params(cfg, 0, "cpu")))
        abst = dict(_port_leaves(steps.abstract_params(cfg)))
        assert list(real) == list(abst)
        for k, t in abst.items():
            assert t.device.type == "meta" and t.shape == real[k].shape and t.dtype == real[k].dtype, k
