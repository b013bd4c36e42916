"""The port's MoE layer against the reference: routing, the sort-based
dispatch plan and the AEBS-scheduled grouped layer (``moe_layer``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, assert_equal_int, tol_for
from repro.configs import get_config as ref_get_config
from repro.core.aebs import aebs_assign as ref_aebs_assign
from repro.core.placement import build_layout as ref_build_layout
from repro.models import moe as ref_moe
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.models import moe


def test_route_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 64)) / 8).astype(np.float32)
    g, e, p = moe.route(torch.from_numpy(w), torch.from_numpy(x), 6)
    g_r, e_r, p_r = ref_moe.route(jnp.asarray(w), jnp.asarray(x), 6)
    assert_equal_int(e, e_r)  # torch.topk orders like lax.top_k here
    assert_close(g, g_r, TOL["f32_op"])
    assert_close(p, p_r, TOL["f32_op"])


@pytest.mark.parametrize("num_buckets,capacity", [(4, 4), (68, 2), (16, 64)])
def test_sort_dispatch_plan_matches_reference(num_buckets, capacity):
    rng = np.random.default_rng(num_buckets)
    flat = rng.integers(-1, num_buckets + 2, size=96).astype(np.int32)  # invalid ids too
    mask = rng.random(96) < 0.9
    got = moe.sort_dispatch_plan(torch.from_numpy(flat), num_buckets, capacity,
                                 torch.from_numpy(mask))
    want = ref_moe.sort_dispatch_plan(jnp.asarray(flat), num_buckets, capacity, jnp.asarray(mask))
    for k in ("pos", "keep", "counts", "src", "row_valid"):
        assert_equal_int(got[k], want[k])


def _layer_case(kind, dtype):
    """(reference cfg, port cfg, routing trace, instances, slots per
    instance, tokens per row) for one layer case."""
    ref_cfg = ref_get_config("dsv2-lite-reduced")
    port_cfg = get_config("dsv2-lite-reduced")
    if kind == "dsv2-lite-reduced":
        n_e, C, s = 2, 3, 6
    else:  # dsv2-lite's routing (64 experts, top-6, 2 shared) at narrow width
        over = dict(d_model=64, num_experts=64, top_k=6, d_ff_expert=32, num_shared_experts=2)
        ref_cfg = dataclasses.replace(ref_cfg, **over)
        port_cfg = dataclasses.replace(port_cfg, **over)
        n_e, C, s = 4, 17, 8
    ref_cfg = dataclasses.replace(ref_cfg, dtype=dtype)
    port_cfg = dataclasses.replace(port_cfg, dtype=dtype)
    trace = make_routing_trace(512, ref_cfg.num_experts, ref_cfg.top_k, skew=0.8, seed=0)
    return ref_cfg, port_cfg, trace, n_e, C, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dsv2-lite-reduced", "synthetic-64x6"])
def test_moe_layer_aebs_matches_reference(kind, dtype):
    from repro_torch.kernels.aebs.ops import aebs_schedule

    ref_cfg, cfg, trace, n_e, C, s = _layer_case(kind, dtype)
    layout = build_layout(trace, cfg.num_experts, n_e, C)
    ref_layout = ref_build_layout(trace, cfg.num_experts, n_e, C)
    for name in ("slot_to_expert", "expert_hosts", "replica_counts", "slot_of"):
        np.testing.assert_array_equal(getattr(layout, name), getattr(ref_layout, name))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params = ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(0), jdt)
    params = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a)), ref_params)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, s, cfg.d_model)) * 0.5).astype(np.float32)
    s2e = layout.slot_to_expert.reshape(-1)

    ref_layer = jax.jit(lambda p, xx: ref_moe.moe_layer(
        p, xx, ref_cfg, dispatch="grouped", layout_tables=ref_layout.device_tables(),
        slot_to_expert=jnp.asarray(s2e), num_instances=n_e, scheduler=ref_aebs_assign,
        with_aux=True,
    ))
    y_ref, aux_ref = ref_layer(ref_params, jnp.asarray(x).astype(jdt))
    y, aux = moe.moe_layer(
        params, torch.from_numpy(x).to(cfg.torch_dtype), cfg, layout_tables=layout.device_tables("cpu"),
        slot_to_expert=torch.from_numpy(s2e.astype(np.int32)),
        num_instances=n_e, scheduler=aebs_schedule, with_aux=True,
    )
    assert_equal_int(aux["load"], aux_ref["load"])
    assert int(aux["a_max"]) == int(aux_ref["a_max"])
    assert y.dtype == cfg.torch_dtype
    assert_close(y, y_ref, tol_for(dtype, "layer"))
    # without with_aux the layer returns the bare output, the same tensor
    bare = moe.moe_layer(
        params, torch.from_numpy(x).to(cfg.torch_dtype), cfg, layout_tables=layout.device_tables("cpu"),
        slot_to_expert=torch.from_numpy(s2e.astype(np.int32)),
        num_instances=n_e, scheduler=aebs_schedule,
    )
    assert isinstance(bare, torch.Tensor)
    assert torch.equal(bare, y)
