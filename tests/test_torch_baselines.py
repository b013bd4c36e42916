"""The paper's baseline schedulers (``repro_torch.core.baselines``) and the
reference's dispatch oracles (``moe.capacity_dispatch_ffn``,
``moe.scatter_dispatch_ffn``) against the reference's, then float32 engine
streams on ``qwen2-moe-a2.7b-reduced`` under each scheduler and dispatch.

Slot ids, loads and ``act_rep`` equal the reference's exactly, and the
default random draw equals JAX's ``PRNGKey(0)`` draw bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, assert_equal_int, tol_for
from repro.configs import get_config as ref_get_config
from repro.core import baselines as ref_baselines
from repro.core.aebs import ReplicaLayout as RefLayout
from repro.models import moe as ref_moe
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import baselines
from repro_torch.core.aebs import ReplicaLayout, aebs_numpy
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.launch.steps import serving_layout
from repro_torch.models import moe
from test_torch_configs import serve_both, streams_of


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("E", [4, 60, 64, 160, 200])
def test_default_draw_equals_jax_prngkey0(E):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (E,)))
    got = baselines.default_uniform(E)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _ref_tables(layout):
    return {k: jnp.asarray(getattr(layout, k)) for k in ("expert_hosts", "replica_counts", "slot_of")}


def _layouts():
    """(name, port layout, reference layout): trace-planned layouts with
    replicas of 1-3 copies, and serving_layout's round-robin ones of the
    MoE configs at 4 instances."""
    out = []
    for E, n_e, C, k in ((16, 4, 6, 2), (64, 8, 12, 6)):
        trace = make_routing_trace(1024, E, k, skew=0.8, seed=E)
        stx = build_layout(trace, E, n_e, C).slot_to_expert
        out.append((f"trace-E{E}", ReplicaLayout.build(stx, E), RefLayout.build(stx, E), k))
    for name in ("qwen2-moe-a2.7b", "scaled-ds-1", "scaled-ds-2"):
        cfg = get_config(name)
        stx = serving_layout(cfg, 4).slot_to_expert
        out.append((name, ReplicaLayout.build(stx, cfg.num_experts), RefLayout.build(stx, cfg.num_experts),
                    cfg.top_k))
    return out


LAYOUTS = _layouts()


@pytest.mark.parametrize("case", range(len(LAYOUTS)), ids=[c[0] for c in LAYOUTS])
@pytest.mark.parametrize("sched", ["random", "token_hash"])
def test_scheduler_equals_reference(sched, case):
    _, layout, ref_layout, k = LAYOUTS[case]
    E, n_e = layout.num_experts, layout.num_instances
    eids = make_routing_trace(37, E, k, skew=0.5, seed=3).astype(np.int32)
    fn, ref_fn = getattr(baselines, f"{sched}_assign"), getattr(ref_baselines, f"{sched}_assign")
    got = fn(torch.from_numpy(eids), layout.device_tables("cpu"), n_e)
    want = ref_fn(jnp.asarray(eids), _ref_tables(ref_layout), n_e)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert_equal_int(g, w)
    if sched == "random":  # an explicit draw stands for the reference's key
        key = jax.random.PRNGKey(7)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (E,))))
        got = fn(torch.from_numpy(eids), layout.device_tables("cpu"), n_e, u=u)
        want = ref_fn(jnp.asarray(eids), _ref_tables(ref_layout), n_e, key=key)
        for g, w in zip(got, want):
            assert_equal_int(g, w)


@pytest.mark.parametrize("case", range(len(LAYOUTS)), ids=[c[0] for c in LAYOUTS])
def test_numpy_twins_equal_reference(case):
    _, layout, ref_layout, k = LAYOUTS[case]
    eids = make_routing_trace(64, layout.num_experts, k, skew=0.8, seed=5)
    got = baselines.random_numpy(eids, layout, np.random.default_rng(9))
    want = ref_baselines.random_numpy(eids, ref_layout, np.random.default_rng(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = baselines.token_hash_numpy(eids, layout)
    want = ref_baselines.token_hash_numpy(eids, ref_layout)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] is None and want[2] is None


def test_single_active_replica_attribute_as_reference():
    assert moe.scheduler_is_single_replica(baselines.random_assign)
    assert not moe.scheduler_is_single_replica(baselines.token_hash_assign)
    for name in ("random_assign", "token_hash_assign"):
        assert moe.scheduler_is_single_replica(getattr(baselines, name)) == \
            ref_moe.scheduler_is_single_replica(getattr(ref_baselines, name))


@pytest.mark.parametrize("skew", [0.0, 0.7, 1.2])
@pytest.mark.parametrize("batch", [32, 128, 512])
def test_aebs_beats_baselines_on_average(skew, batch):
    """tests/test_aebs.py:69 on the port's numpy twins: AEBS's a_max is no
    worse than random's or token hash's on average (Fig. 13/14)."""
    E, n_e, C, k = 64, 8, 12, 6
    trace = make_routing_trace(8192, E, k, skew=skew, seed=1)
    layout = build_layout(trace, E, n_e, C)
    rng = np.random.default_rng(2)
    a_aebs, a_rand, a_tok = [], [], []
    for _ in range(10):
        sample = trace[rng.integers(0, trace.shape[0], size=batch)]
        a_aebs.append(aebs_numpy(sample, layout)[1].max())
        a_rand.append(baselines.random_numpy(sample, layout, rng)[1].max())
        a_tok.append(baselines.token_hash_numpy(sample, layout)[1].max())
    assert np.mean(a_aebs) <= np.mean(a_rand) + 1e-9
    assert np.mean(a_aebs) <= np.mean(a_tok) + 1e-9


# ---------------------------------------------------------------------------
# dispatch oracles (tests/test_moe_dispatch.py:36,206,232,260)
# ---------------------------------------------------------------------------


def _dispatch_inputs(seed, T, k, E, d, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    ids = rng.integers(0, E, (T, k)).astype(np.int32)
    g = rng.standard_normal((T, k)).astype(np.float32)
    gates = (np.exp(g) / np.exp(g).sum(-1, keepdims=True)).astype(np.float32)
    w = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
         for n, s in (("w_gate", (E, d, f)), ("w_up", (E, d, f)), ("w_down", (E, f, d)))}
    return x, ids, gates, w


@pytest.mark.parametrize("T,k,E,cap", [(12, 2, 5, 3), (40, 4, 16, 8), (7, 1, 3, 1), (30, 3, 8, 64)])
def test_dispatch_oracles_equal_reference_and_grouped(T, k, E, cap):
    """einsum, scatter and grouped equal the reference's einsum and each
    other, capacity drops included (and a dropped item masked out)."""
    x, ids, gates, w = _dispatch_inputs(T, T, k, E, 32, 64)
    mask = np.random.default_rng(1).random(T * k) > 0.2
    tw = {n: torch.from_numpy(v) for n, v in w.items()}
    jw = {n: jnp.asarray(v) for n, v in w.items()}
    want = ref_moe.capacity_dispatch_ffn(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(gates), E, cap, jw)
    args = (torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(gates), E, cap, tw)
    outs = [moe.DISPATCH_FNS[n](*args) for n in ("einsum", "scatter", "grouped")]
    for y in outs:
        assert_close(y, want, TOL["f32_op"])
    want_m = ref_moe.scatter_dispatch_ffn(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(gates), E, cap, jw,
                                          item_mask=jnp.asarray(mask))
    for fn in (moe.capacity_dispatch_ffn, moe.scatter_dispatch_ffn):
        assert_close(fn(*args, item_mask=torch.from_numpy(mask)), want_m, TOL["f32_op"])


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_capacity_drops_tokens(dispatch):
    """cap 1 with every token on expert 0: the first is served, the rest
    dropped (tests/test_moe_dispatch.py:260)."""
    x, _, _, w = _dispatch_inputs(3, 8, 1, 2, 16, 32)
    y = moe.DISPATCH_FNS[dispatch](torch.from_numpy(x), torch.zeros((8, 1), dtype=torch.int32),
                                   torch.ones((8, 1)), 2, 1, {n: torch.from_numpy(v) for n, v in w.items()})
    assert y[0].abs().max() > 0 and y[1:].abs().max() == 0


def test_gather_slot_weights_exact():
    rng = np.random.default_rng(0)
    p = {n: rng.standard_normal((5, 4, 3)).astype(np.float32) for n in ("w_gate", "w_up", "w_down")}
    s2e = np.array([3, -1, 0, 4, 4, 1], np.int32)
    got = moe.gather_slot_weights({n: torch.from_numpy(v) for n, v in p.items()}, torch.from_numpy(s2e))
    want = ref_moe.gather_slot_weights({n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(s2e))
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter", "grouped"])
def test_moe_layer_schedulers_and_dispatch_equal_reference(dispatch, dtype):
    """``moe_layer`` on qwen2-moe-a2.7b-reduced over a 2 x 4 layout, under
    AEBS, random and token hash: the reference's output and loads, and the
    same output for every scheduler (tests/test_moe_dispatch.py:232)."""
    from repro.core.aebs import aebs_assign as ref_aebs
    from repro_torch.kernels.aebs.ops import aebs_schedule

    ref_cfg = dataclasses.replace(ref_get_config("qwen2-moe-a2.7b-reduced"), dtype=dtype)
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b-reduced"), dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params = ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(0), jdt)
    params = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a)), ref_params)
    layout = ReplicaLayout.round_robin(cfg.num_experts, 2, 4)
    ref_layout = RefLayout.round_robin(cfg.num_experts, 2, 4)
    s2e = layout.slot_to_expert.reshape(-1).astype(np.int32)
    x = (np.random.default_rng(2).standard_normal((1, 12, cfg.d_model)) * 0.3).astype(np.float32)
    outs = []
    for sched, ref_sched in ((aebs_schedule, ref_aebs), (baselines.random_assign, ref_baselines.random_assign),
                             (baselines.token_hash_assign, ref_baselines.token_hash_assign)):
        want, ref_aux = ref_moe.moe_layer(
            ref_params, jnp.asarray(x).astype(jdt), ref_cfg, dispatch=dispatch,
            layout_tables=_ref_tables(ref_layout), slot_to_expert=jnp.asarray(s2e), num_instances=2,
            scheduler=ref_sched, capacity=64, with_aux=True)
        got, aux = moe.moe_layer(
            params, torch.from_numpy(x).to(cfg.torch_dtype), cfg, dispatch=dispatch,
            layout_tables=layout.device_tables("cpu"), slot_to_expert=torch.from_numpy(s2e),
            num_instances=2, scheduler=sched, capacity=64, with_aux=True)
        assert_equal_int(aux["load"], ref_aux["load"])
        assert_close(got, want, tol_for(dtype, "layer"))
        outs.append(got)
    for y in outs[1:]:
        assert_close(y, outs[0], tol_for(dtype, "layer"))


def test_moe_layer_refuses_expert_parallel_dispatch():
    """``dispatch="ep"`` needs ``ep_ctx`` (a mesh and its axes): without one
    ``moe_layer_ep`` raises ``TypeError``, as the reference's does; an
    unknown dispatch raises ``ValueError``."""
    cfg = get_config("qwen2-moe-a2.7b-reduced")
    with pytest.raises(TypeError, match="mesh"):
        moe.moe_layer({}, torch.zeros((1, 1, cfg.d_model)), cfg, dispatch="ep")
    with pytest.raises(ValueError):
        moe.moe_layer({}, torch.zeros((1, 1, cfg.d_model)), cfg, dispatch="dense")


# ---------------------------------------------------------------------------
# float32 engine streams on qwen2-moe-a2.7b-reduced (tests/test_engine.py:18):
# a 2 x 3 layout, blocking, paged KV, mono under each scheduler and dispatch,
# and disagg (2 attention shards) under random
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "aebs": dict(scheduler="aebs"),
    "random": dict(scheduler="random"),
    "token_hash": dict(scheduler="token_hash"),
    "einsum": dict(scheduler="aebs", dispatch="einsum"),
    "scatter": dict(scheduler="aebs", dispatch="scatter"),
    "disagg_random": dict(scheduler="random", executor="disagg", n_attn=2, capacity_tokens=64),
}


@pytest.fixture(scope="module")
def qwen2_runs():
    """Each case served once on both engines."""
    from test_torch_configs import ENGINE_KW

    cache = {}

    def run(case):
        if case not in cache:
            cache[case] = serve_both("qwen2-moe-a2.7b-reduced", dict(ENGINE_KW, **ENGINE_CASES[case]), (2, 3))
        return cache[case]
    return run


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_float32_streams_equal_reference(qwen2_runs, case):
    ref_eng, eng = qwen2_runs(case)
    assert len(eng.completed) == len(ref_eng.completed) > 0
    assert streams_of(eng) == streams_of(ref_eng)
    assert eng.amax_log == ref_eng.amax_log  # [] on mono; per step on disagg
    # numerically transparent: every scheduler and dispatch serves AEBS's streams
    assert streams_of(eng) == streams_of(qwen2_runs("aebs")[1])
