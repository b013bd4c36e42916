"""The port's disaggregated executor (``repro_torch.serving.disagg``) against
the reference's (``repro.serving.disagg``), and against the port's own mono
path, on ``dsv2-lite-reduced`` in float32 unless a test says otherwise.

Both executors run on one device with aliased pools (the single-card mode):
the whole stage / exchange / combine path executes, the moves are local.
The reference's own pool-shape equality is broken on XLA (ROADMAP.md §3), so
pool shapes are held against each other inside the port.  JAX and ``repro``
are imported inside the tests: the card's machine, which runs the ``gpu``
test, has no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import TOL, as_f32, assert_close, first_divergence, tol_for
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import comm
from repro_torch.core.aebs import ReplicaLayout, aebs_assign
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.disagg import DevicePools, plan_exchange
from repro_torch.core.placement import build_layout
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import model as model_mod
from repro_torch.serving.disagg import DisaggExecutor
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests

CPU = torch.device("cpu")
CAP = 64  # expert capacity: ample, so micro-batching drops nothing
B, S, CACHE_LEN = 6, 16, 32  # the step fixture: 6 slots at position 16
# the engine workload of tests/test_torch_engine.py
ENGINE_KW = dict(max_batch=4, cache_len=64, prefill_chunk=16, scheduler="aebs", capacity_tokens=CAP)
SPEC = dict(mean_input=8, mean_output=10, max_input=24, max_output=16, seed=1)
N_REQ = 6


def _cfgs(dtype="float32", kv_quant=False):
    from repro.configs import get_config as ref_get_config

    ref = dataclasses.replace(ref_get_config("dsv2-lite-reduced"), dtype=dtype, kv_quant=kv_quant)
    return ref, dataclasses.replace(get_config("dsv2-lite-reduced"), dtype=dtype, kv_quant=kv_quant)


@pytest.fixture(scope="module")
def setup():
    """float32 weights drawn by the reference and carried across exactly,
    the reference's test layout (2 instances x 3 slots), and one decode
    step's inputs: caches of a 16-token prefill, positions and tokens."""
    import jax

    from repro.core.aebs import ReplicaLayout as RefLayout
    from repro.models import model as ref_model

    ref_cfg, cfg = _cfgs()
    ref_params = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (B, S + 1), 0, cfg.vocab_size))
    _, ref_caches = ref_model.prefill(ref_params, tokens[:, :S], ref_cfg, cache_len=CACHE_LEN)
    caches = {k: np.asarray(v) for k, v in ref_caches.items()}
    return dict(
        ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params, params=params,
        ref_layout=RefLayout.round_robin(cfg.num_experts, 2, 3),
        layout=ReplicaLayout.round_robin(cfg.num_experts, 2, 3),
        prompt=tokens[:, :S], tokens=tokens[:, S:], caches=caches, positions=np.full((B,), S, np.int32),
    )


def _port_caches(setup):
    return {k: torch.from_numpy(v.copy()) for k, v in setup["caches"].items()}


def _port_step_inputs(setup):
    return (torch.from_numpy(setup["tokens"].astype(np.int64)),
            torch.from_numpy(setup["positions"].astype(np.int64)))


def _executor(setup, n_attn, layout=None, node_size=1, **kw):
    layout = layout or setup["layout"]
    pools = DevicePools.split(n_attn, layout.num_instances, [CPU], node_size=node_size, allow_reuse=True)
    kw.setdefault("capacity", CAP)
    kw.setdefault("scheduler", aebs_assign)
    return DisaggExecutor(setup["cfg"], setup["params"], pools, layout,
                          max_batch=B, cache_len=CACHE_LEN, **kw)


def _port_step(setup, n_attn, **kw):
    ex = _executor(setup, n_attn, **kw)
    ex.load_caches(_port_caches(setup))
    logits, tel = ex.decode_step(*_port_step_inputs(setup))
    return ex, logits, tel


# ---------------------------------------------------------------------------
# core/comm.py and core/disagg.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["TPU_V5E", "H100"])
def test_comm_costs_equal_reference(spec):
    """Every cost and the chosen regime equal the reference's exactly over a
    grid of pool sizes, node sizes and batches."""
    from repro.core import comm as ref_comm

    hw, ref_hw = getattr(comm, spec), getattr(ref_comm, spec)
    assert dataclasses.asdict(hw) == dataclasses.asdict(ref_hw)
    for n_attn in (1, 2, 3, 8):
        for n_moe in (1, 2, 4, 16):
            for node in (1, 2, 8):
                for batch in (1, 8, 256, 4096):
                    h = dataclasses.replace(hw, devices_per_node=node)
                    rh = dataclasses.replace(ref_hw, devices_per_node=node)
                    c = comm.CommConfig(n_attn, n_moe, 2048 * 2, batch, h)
                    rc = ref_comm.CommConfig(n_attn, n_moe, 2048 * 2, batch, rh)
                    for fn in ("one_phase_cost", "two_phase_case1", "two_phase_case2",
                               "adaptive_two_phase"):
                        assert getattr(comm, fn)(c) == getattr(ref_comm, fn)(rc), fn
                    assert comm.agate_cost(c, 6, 64) == ref_comm.agate_cost(rc, 6, 64)
                    for scheme in ("2pc", "1pc", "agate"):
                        assert comm.layer_comm_time(n_attn, n_moe, batch, 2048, h, scheme=scheme) == \
                            ref_comm.layer_comm_time(n_attn, n_moe, batch, 2048, rh, scheme=scheme)


class _Dev:
    """A distinct sentinel device, so identity checks are real."""


def _as_indices(pools, devs):
    index = {id(d): i for i, d in enumerate(devs)}
    return ([index[id(d)] for d in pools.attn_devices], [index[id(d)] for d in pools.moe_devices],
            [index[id(d)] for d in pools.prefill_devices])


@pytest.mark.parametrize("shape", [
    (4, 4, 2, 0), (2, 8, 2, 0), (1, 2, 1, 0), (3, 2, 2, 0), (2, 4, 1, 2), (8, 8, 4, 0),
])
def test_plan_exchange_equals_reference(shape):
    """Pools, chunks and move schedules equal the reference's on the same
    pool shapes (devices compared as pool indices), and every MoE device
    ends up holding every chunk."""
    from repro.core.disagg import DevicePools as RefPools
    from repro.core.disagg import plan_exchange as ref_plan

    n_attn, n_moe, node, n_prefill = shape
    devs = [_Dev() for _ in range(n_attn + n_moe + n_prefill + 1)]
    pools = DevicePools.split(n_attn, n_moe, devs, node_size=node, n_prefill=n_prefill)
    ref_pools = RefPools.split(n_attn, n_moe, devs, node_size=node, n_prefill=n_prefill)
    assert _as_indices(pools, devs) == _as_indices(ref_pools, devs)
    assert len(pools.attn_nodes) == len(ref_pools.attn_nodes)
    assert len(pools.moe_nodes) == len(ref_pools.moe_nodes)
    for regime in ("case1", "case2"):
        chunks, steps = plan_exchange(pools, regime)
        ref_chunks, ref_steps = ref_plan(ref_pools, regime)
        assert [dataclasses.astuple(c) for c in chunks] == [dataclasses.astuple(c) for c in ref_chunks]
        assert [dataclasses.astuple(s) for s in steps] == [dataclasses.astuple(s) for s in ref_steps]
        have = {(cid, ("attn", c.members[0])) for cid, c in enumerate(chunks)}
        for st in steps:
            if st.phase == 2:
                assert (st.chunk, st.src) in have, (regime, st)
                have.add((st.chunk, st.dst))
        assert all((cid, ("moe", g)) in have for g in range(n_moe) for cid in range(len(chunks)))
    with pytest.raises(ValueError, match="need"):
        DevicePools.split(n_attn, n_moe, devs[: n_attn + n_moe - 1])


def test_plan_exchange_patterns():
    """The reference's pattern test on the port: 4 + 4 devices in nodes of
    2; case-1 sends attn_nodes x moe_nodes slow messages, case-2 one per
    pair, and with 1 attention node and 4 MoE nodes case-2 row-splits the
    payload into 4 chunks, one per pair."""
    pools = DevicePools.split(4, 4, [CPU] * 8, node_size=2, allow_reuse=True)
    for regime in ("case1", "case2"):
        chunks, _ = plan_exchange(pools, regime)
        assert [c.members for c in chunks] == [(0, 1), (2, 3)]
    assert sum(s.fabric == "slow" for s in plan_exchange(pools, "case1")[1]) == 4
    assert sum(s.fabric == "slow" for s in plan_exchange(pools, "case2")[1]) == 2
    pools = DevicePools.split(2, 8, [CPU] * 10, node_size=2, allow_reuse=True)
    chunks, steps = plan_exchange(pools, "case2")
    assert [(c.sub, c.n_subs) for c in chunks] == [(0, 4), (1, 4), (2, 4), (3, 4)]
    slow = [s for s in steps if s.fabric == "slow"]
    assert {s.dst for s in slow} == {("moe", 0), ("moe", 2), ("moe", 4), ("moe", 6)}


def test_pools_anchoring():
    """Resizing one pool never relocates another's devices: attention from
    the front, MoE from the back, prefill just ahead of MoE."""
    devs = [_Dev() for _ in range(10)]
    a = DevicePools.split(2, 4, devs, n_prefill=2)
    assert (a.attn_devices, a.moe_devices, a.prefill_devices) == (devs[:2], devs[-4:], devs[4:6])
    b = DevicePools.split(2, 4, devs, n_prefill=3)
    assert b.attn_devices == a.attn_devices and b.moe_devices == a.moe_devices
    c = DevicePools.split(3, 4, devs, n_prefill=2)
    assert c.prefill_devices == a.prefill_devices and c.moe_devices == a.moe_devices
    d = DevicePools.split(2, 3, devs)
    assert d.attn_devices == a.attn_devices and d.prefill_devices == []


def test_round_robin_layout_equals_reference():
    from repro.core.aebs import ReplicaLayout as RefLayout

    for E, n_e, C in ((4, 2, 3), (4, 4, 2), (64, 4, 17), (8, 3, 2)):
        got, want = ReplicaLayout.round_robin(E, n_e, C), RefLayout.round_robin(E, n_e, C)
        for f in ("slot_to_expert", "expert_hosts", "replica_counts", "slot_of"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))


# ---------------------------------------------------------------------------
# the executor against the reference's, and against the port's mono step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_attn,ping_pong,page,node", [(2, False, None, 1), (1, False, None, 1),
                                                        (2, True, None, 1), (2, True, 16, 1),
                                                        (3, False, None, 2)])
def test_executor_matches_reference(setup, n_attn, ping_pong, page, node):
    """One decode step on the same weights and caches: logits and exported
    KV within the float32 layer tolerance; a_max, regime, predicted comm
    time, bytes and message counts equal (both priced on the reference's
    default spec)."""
    from repro.core.aebs import aebs_assign as ref_aebs
    from repro.core.disagg import DevicePools as RefPools
    from repro.serving.disagg import DisaggExecutor as RefExecutor

    import jax
    import jax.numpy as jnp

    ref_pools = RefPools.split(n_attn, 2, [jax.devices()[0]], node_size=node, allow_reuse=True)
    ref = RefExecutor(setup["ref_cfg"], setup["ref_params"], ref_pools, setup["ref_layout"],
                      max_batch=B, cache_len=CACHE_LEN, scheduler=ref_aebs, capacity=CAP,
                      ping_pong=ping_pong, kv_page_size=page)
    ref.load_caches({k: jnp.asarray(v) for k, v in setup["caches"].items()})
    ref_logits, ref_tel = ref.decode_step(jnp.asarray(setup["tokens"]), jnp.asarray(setup["positions"]))
    ex, logits, tel = _port_step(setup, n_attn, ping_pong=ping_pong, kv_page_size=page,
                                 hw=comm.TPU_V5E, node_size=node)
    assert_close(logits, np.asarray(ref_logits), TOL["f32_layer"])
    for key in ("regime", "t_comm_pred", "a_max", "bytes_fast", "bytes_slow", "msgs_fast",
                "msgs_slow", "bytes_total"):
        assert tel[key] == ref_tel[key], key
    ref_kv = ref.export_caches()
    got_kv = ex.export_caches()
    assert set(got_kv) == set(ref_kv)
    for k in got_kv:
        assert_close(got_kv[k], np.asarray(ref_kv[k]), TOL["f32_layer"])


def test_executor_matches_reference_int8(setup):
    """int8 KV: the step's logits, a_max and telemetry against the
    reference's, from the same int8 caches (quantised once, by the
    reference), and the exported int8 rows equal exactly."""
    import jax
    import jax.numpy as jnp

    from repro.core.aebs import aebs_assign as ref_aebs
    from repro.core.disagg import DevicePools as RefPools
    from repro.models import model as ref_model
    from repro.serving.disagg import DisaggExecutor as RefExecutor

    ref_cfg, cfg = _cfgs(kv_quant=True)
    _, ref_caches = ref_model.prefill(setup["ref_params"], setup["prompt"], ref_cfg, cache_len=CACHE_LEN)
    caches = {k: np.asarray(v) for k, v in ref_caches.items()}
    ref_pools = RefPools.split(2, 2, [jax.devices()[0]], allow_reuse=True)
    ref = RefExecutor(ref_cfg, setup["ref_params"], ref_pools, setup["ref_layout"], max_batch=B,
                      cache_len=CACHE_LEN, scheduler=ref_aebs, capacity=CAP)
    ref.load_caches({k: jnp.asarray(v) for k, v in caches.items()})
    ref_logits, ref_tel = ref.decode_step(jnp.asarray(setup["tokens"]), jnp.asarray(setup["positions"]))
    pools = DevicePools.split(2, 2, [CPU], allow_reuse=True)
    ex = DisaggExecutor(cfg, setup["params"], pools, setup["layout"], max_batch=B,
                        cache_len=CACHE_LEN, scheduler=aebs_assign, capacity=CAP, hw=comm.TPU_V5E)
    ex.load_caches({k: torch.from_numpy(v.copy()) for k, v in caches.items()})
    logits, tel = ex.decode_step(*_port_step_inputs(setup))
    assert_close(logits, np.asarray(ref_logits), TOL["f32_layer"])
    for key in ("regime", "a_max", "bytes_total", "msgs_slow", "msgs_fast"):
        assert tel[key] == ref_tel[key], key
    got, want = ex.export_caches(), ref.export_caches()
    assert got["kv_k"].dtype == torch.int8
    # rows before the new one were loaded, not computed: equal exactly
    for k in got:
        np.testing.assert_array_equal(got[k][:, :, :S].numpy(), np.asarray(want[k])[:, :, :S])


def _mono_step(setup):
    layout = setup["layout"]
    moe_ctx = dict(layout_tables=layout.device_tables(CPU),
                   slot_to_expert=torch.as_tensor(layout.slot_to_expert.reshape(-1), dtype=torch.int32),
                   num_instances=layout.num_instances, scheduler=aebs_schedule, capacity=CAP)
    tokens, positions = _port_step_inputs(setup)
    return model_mod.decode_step(setup["params"], tokens, _port_caches(setup), positions, setup["cfg"],
                                 extra={"moe_ctx": moe_ctx})


@pytest.mark.parametrize("page", [None, 16])
def test_disagg_matches_port_mono_step(setup, page):
    """Inside the port, disagg and mono share op-for-op semantics: the
    updated KV caches are bitwise equal, logits within the float32 layer
    tolerance with the same argmax."""
    mono_logits, mono_caches = _mono_step(setup)
    ex, logits, _ = _port_step(setup, 2, kv_page_size=page)
    assert_close(logits, mono_logits, TOL["f32_layer"])
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), mono_logits.argmax(-1).numpy())
    got = ex.export_caches()
    for k in got:
        torch.testing.assert_close(got[k], mono_caches[k], rtol=0, atol=0)
    # timing the stages waits for each one and changes nothing
    ex.load_caches(_port_caches(setup))
    again, tel = ex.decode_step(*_port_step_inputs(setup), collect_stage_times=True)
    torch.testing.assert_close(again, logits, rtol=0, atol=0)
    assert set(tel["stage_times"]) == {"attn", "exchange", "moe", "combine", "head"}
    assert all(t >= 0 for t in tel["stage_times"].values())


def test_pool_shapes_bit_identical(setup):
    """Pool sharding and the two-phase exchange are numerically transparent
    inside the port: n_attn 1, 2 and 3 give bitwise-equal logits (the
    reference fails this on XLA, ROADMAP.md §3).

    Ping-pong at n_attn 2 splits a device's 3 rows into shards of 1 and 2,
    and torch's float32 CPU matmul of a single row (the attention
    projections' ``x @ w`` at M = 1, a matrix-vector product) rounds other
    than its row of a 2-row product.  That shape is held to the float32
    layer tolerance with the same argmax (ROADMAP.md §3)."""
    want = None
    for n_attn, pp in [(1, False), (2, False), (3, False), (2, True)]:
        ex, logits, tel = _port_step(setup, n_attn, ping_pong=pp)
        if want is None:
            want = logits
        if min(s.rows for s in ex.shards) > 1:
            torch.testing.assert_close(logits, want, rtol=0, atol=0, msg=f"n_attn={n_attn} pp={pp}")
        else:
            assert pp  # only ping-pong makes a 1-row shard at B = 6
            assert_close(logits, want, TOL["f32_layer"])
            np.testing.assert_array_equal(logits.argmax(-1).numpy(), want.argmax(-1).numpy())
        assert tel["regime"] in ("case1", "case2") and tel["bytes_total"] > 0 and tel["a_max"] >= 1


def test_exchange_split_chunks_consistent(setup):
    """Case-2 sub-chunking (1 attention node feeding 2 MoE nodes) reassembles
    the whole activation block, in row order, on every MoE device."""
    ex = _executor(setup, 1)
    h = torch.arange(B * setup["cfg"].d_model, dtype=torch.float32).reshape(B, 1, -1)
    for regime in ("case1", "case2"):
        tel = {"bytes_slow": 0, "bytes_fast": 0, "msgs_slow": 0, "msgs_fast": 0}
        outs = ex._run_exchange({0: h}, regime, tel)
        assert len(outs) == 2 and all(torch.equal(o, h) for o in outs)
    chunks, _ = plan_exchange(ex.pools, "case2")
    assert len(chunks) == 2 and all(c.n_subs == 2 for c in chunks)


@pytest.mark.parametrize("page", [None, 16])
def test_reconfigure_preserves_caches_and_logits(setup, page):
    """Resizing either pool mid-run keeps the KV caches bitwise and the
    decode function unchanged; only the resized pool is rebuilt."""
    ex, ref, _ = _port_step(setup, 2, kv_page_size=page)
    ex.load_caches(_port_caches(setup))  # back to the step's inputs
    before = {k: v.clone() for k, v in ex.export_caches().items()}
    moe_params = ex._moe_params
    assert ex.reconfigure(n_attn=3) == {"attn": True, "moe": False, "prefill": False}
    assert ex._moe_params is moe_params and len(ex.shards) == 3
    for k, v in ex.export_caches().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    got, _ = ex.decode_step(*_port_step_inputs(setup))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)

    ex.load_caches(_port_caches(setup))
    attn_params = ex._attn_params
    assert ex.reconfigure(n_moe=4, layout=ReplicaLayout.round_robin(4, 4, 2)) == \
        {"attn": False, "moe": True, "prefill": False}
    assert ex._attn_params is attn_params and len(ex._moe_params) == 4
    got, _ = ex.decode_step(*_port_step_inputs(setup))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert ex.relower_log == [{"attn": True, "moe": False, "prefill": False},
                              {"attn": False, "moe": True, "prefill": False}]
    assert ex.disagg_cfg.describe() == "3A4E"
    # a MoE resize without a layout deals experts round-robin
    ex.reconfigure(n_moe=2)
    assert np.array_equal(ex.layout.slot_to_expert, ReplicaLayout.round_robin(4, 2, 2).slot_to_expert)
    assert ex.reconfigure() == {"attn": False, "moe": False, "prefill": False}
    with pytest.raises(ValueError, match="n_attn=0"):
        ex.reconfigure(n_attn=0)
    # the prefill pool moves alone; a MoE resize re-anchors a non-empty one
    assert ex.reconfigure(n_prefill=1) == {"attn": False, "moe": False, "prefill": True}
    assert len(ex.pools.prefill_devices) == 1 and ex.disagg_cfg.describe() == "1P3A2E"
    assert ex.reconfigure(n_moe=4) == {"attn": False, "moe": True, "prefill": True}


def test_shards_own_their_storage(setup):
    """Every shard's caches are tensors of their own: a write into one
    shard cannot land in another, and export/load round-trips bitwise."""
    for page in (None, 16):
        ex = _executor(setup, 3, kv_page_size=page)
        ex.load_caches(_port_caches(setup), lengths=np.full(B, S, np.int64))
        ptrs = [t.untyped_storage().data_ptr() for kv in ex._kv for layer in kv
                for key, t in layer.items() if key != "bt"]
        assert len(set(ptrs)) == len(ptrs)
        exported = ex.export_caches()
        ex.load_caches(exported, lengths=np.full(B, S, np.int64))
        for k, v in ex.export_caches().items():
            torch.testing.assert_close(v, exported[k], rtol=0, atol=0)
        if page is None:
            for k, v in exported.items():
                torch.testing.assert_close(v, torch.from_numpy(setup["caches"][k].copy()), rtol=0, atol=0)
        # a whole-prompt hand-off lands one request's rows in its shard only
        fresh = _executor(setup, 3, kv_page_size=page)
        one = {k: v[:, 4:5].clone() for k, v in exported.items()}
        fresh.scatter_prefill(one, 4)
        assert fresh.shard_of(4) == 2 and list(fresh.slot_lengths()) == [0, 0, 0, 0, CACHE_LEN, 0]
        for k, v in fresh.export_caches().items():
            torch.testing.assert_close(v[:, 4], exported[k][:, 4], rtol=0, atol=0)
            assert not v[:, [0, 1, 2, 3, 5]].any()


def test_moe_side_holds_logical_weights_only(setup):
    """On aliased pools no instance holds a copy of expert weights: each
    instance's weights are the parameters themselves, beside one
    ``slot_to_expert`` row."""
    ex = _executor(setup, 2)
    for g, mp in enumerate(ex._moe_params):
        for li, lp in enumerate(setup["params"]["layers"]):
            for k in ("w_gate", "w_up", "w_down"):
                assert mp["layers"][li]["w"][k] is lp["moe"][k]
        np.testing.assert_array_equal(mp["s2e"].numpy(), setup["layout"].slot_to_expert[g])
    assert ex._attn_params[0]["layers"][0]["attn"]["wq"] is setup["params"]["layers"][0]["attn"]["wq"]


def test_executor_validation(setup):
    """The reference's validation errors, with its messages."""
    from repro.core import baselines
    from repro.core.disagg import DevicePools as RefPools
    from repro.serving.disagg import DisaggExecutor as RefExecutor

    import jax

    def messages(port_kw, ref_kw, n_attn=2, cfg_change=None):
        cfg, ref_cfg = setup["cfg"], setup["ref_cfg"]
        if cfg_change:
            cfg, ref_cfg = (dataclasses.replace(c, **cfg_change) for c in (cfg, ref_cfg))
        with pytest.raises(ValueError) as port_err:
            DisaggExecutor(cfg, setup["params"], DevicePools.split(n_attn, 2, [CPU], allow_reuse=True),
                           setup["layout"], max_batch=B, cache_len=CACHE_LEN, **port_kw)
        with pytest.raises(ValueError) as ref_err:
            RefExecutor(ref_cfg, setup["ref_params"],
                        RefPools.split(n_attn, 2, [jax.devices()[0]], allow_reuse=True),
                        setup["ref_layout"], max_batch=B, cache_len=CACHE_LEN, **ref_kw)
        return str(port_err.value), str(ref_err.value)

    def unscheduled(eids, tables, n):  # a scheduler that may activate several replicas
        return aebs_assign(eids, tables, n)

    got, want = messages(dict(scheduler=unscheduled), dict(scheduler=baselines.token_hash_assign))
    assert got == want and "single-active-replica" in got
    got, want = messages(dict(ping_pong=True), dict(ping_pong=True), n_attn=4)
    assert got == want and "ping_pong" in got
    got, want = messages({}, {}, cfg_change=dict(num_experts=0, top_k=0))
    assert got == want
    bad = ReplicaLayout.round_robin(4, 3, 2)
    with pytest.raises(ValueError, match="3 instances"):
        DisaggExecutor(setup["cfg"], setup["params"], DevicePools.split(2, 2, [CPU], allow_reuse=True),
                       bad, max_batch=B, cache_len=CACHE_LEN)
    ex = _executor(setup, 2)
    for call in (lambda: ex.decode_step_verify(None, None, None), lambda: ex.spill_slot(0),
                 lambda: ex.splice_prefix(0, None, 0)):
        with pytest.raises(NotImplementedError, match="comes with"):
            call()
    universe = list(ex._all_devices)
    ex.exclude_device("moe", 0)  # pools alias one device: a logical loss
    assert ex._all_devices == universe


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _requests(cfg, ref=False):
    if ref:
        from repro.serving.request import WorkloadSpec as RefSpec
        from repro.serving.request import sample_requests as ref_sample_requests

        return ref_sample_requests(RefSpec(vocab_size=cfg.vocab_size, **SPEC), np.zeros(N_REQ), True)
    return sample_requests(WorkloadSpec(vocab_size=cfg.vocab_size, **SPEC), np.zeros(N_REQ), True)


def _layouts(cfg):
    from repro.core.placement import build_layout as ref_build_layout

    trace = make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0)
    return (ref_build_layout(trace, cfg.num_experts, 2, 3), build_layout(trace, cfg.num_experts, 2, 3))


def _serve_both(dtype, page, ping_pong, record=False):
    """The reference's disagg engine and the port's on one workload; returns
    (reference engine, port engine, per-step logits of each if recorded)."""
    import jax

    from repro.models import model as ref_model
    from repro.serving.engine import ServingEngine as RefEngine

    ref_cfg, cfg = _cfgs(dtype)
    ref_params = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    ref_layout, layout = _layouts(cfg)
    kw = dict(ENGINE_KW, kv_page_size=page, executor="disagg", n_attn=2, ping_pong=ping_pong)
    ref_eng = RefEngine(ref_cfg, ref_params, layout=ref_layout, **kw)
    eng = ServingEngine(cfg, params, layout=layout, device="cpu", **kw)
    logs = ([], [])
    if record:
        for e, out in ((ref_eng, logs[0]), (eng, logs[1])):
            def wrapped(*args, fn=e.disagg.decode_step, e=e, out=out, **kwargs):
                res = fn(*args, **kwargs)
                out.append(as_f32(res[0])[e.slots.active_slots])
                return res
            e.disagg.decode_step = wrapped
    m_ref = ref_eng.run(_requests(cfg, ref=True), max_steps=500)
    m = eng.run(_requests(cfg), max_steps=500)
    assert m["completed"] == m_ref["completed"] == N_REQ
    return ref_eng, eng, params, logs


@pytest.mark.parametrize("page,ping_pong", [(None, False), (None, True), (16, True)])
def test_engine_disagg_streams_equal(page, ping_pong):
    """float32 streams equal the reference's disagg engine and the port's
    mono engine, and ``amax_log`` equals the reference's exactly."""
    ref_eng, eng, params, _ = _serve_both("float32", page, ping_pong)
    streams = {r.rid: r.tokens_out for r in eng.completed}
    assert streams == {r.rid: r.tokens_out for r in ref_eng.completed}
    assert eng.amax_log == ref_eng.amax_log and len(eng.amax_log) == eng.steps_done
    assert len(eng.regime_log) == len(eng.transfer_bytes_log) == eng.steps_done
    m = eng.metrics()
    assert set(m["regime_counts"]) <= {"case1", "case2"} and m["transfer_bytes_total"] > 0
    assert m["amax_max"] >= 1 and m["amax_mean"] == float(np.mean(ref_eng.amax_log))
    if page is not None:
        assert m["kv_pages"] == ref_eng.metrics()["kv_pages"]
    assert not eng.disagg.slot_lengths().any()  # every slot released
    mono = ServingEngine(eng.cfg, params, layout=eng.layout, kv_page_size=page, device="cpu", **ENGINE_KW)
    mono.run(_requests(eng.cfg), max_steps=500)
    assert streams == {r.rid: r.tokens_out for r in mono.completed}
    assert "regime_counts" not in mono.metrics() and mono.amax_log == []
    with pytest.raises(NotImplementedError, match="executor='disagg'"):
        mono.reconfigure(n_attn=2)


def test_engine_reconfigure_mid_run():
    """Resizing the attention pool, then the MoE pool, between decode steps
    keeps the served streams those of an uninterrupted run."""
    _, cfg = _cfgs()
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    _, layout = _layouts(cfg)
    kw = dict(ENGINE_KW, executor="disagg", n_attn=2, layout=layout, device="cpu")
    want = ServingEngine(cfg, params, **kw)
    want.run(_requests(cfg), max_steps=500)
    eng = ServingEngine(cfg, params, **kw)
    step = eng._decode_iteration

    def resizing():
        if eng.steps_done == 4:
            assert eng.reconfigure(n_attn=1)["attn"]
        if eng.steps_done == 9:
            assert eng.reconfigure(n_moe=4, layout=ReplicaLayout.round_robin(4, 4, 2))["moe"]
        step()

    eng._decode_iteration = resizing
    eng.run(_requests(cfg), max_steps=500)
    assert {r.rid: r.tokens_out for r in eng.completed} == {r.rid: r.tokens_out for r in want.completed}
    assert eng.disagg.disagg_cfg.describe() == "1A4E" and eng.layout.num_instances == 4


def test_engine_disagg_bfloat16_logits_agree(record_property):
    """bf16 on the two frameworks rounds at other places: every step up to
    and including the first greedy flip agrees within the bf16 tolerance;
    the flip, if any, is reported with the reference's top-2 margin."""
    ref_eng, eng, _, (ref_logs, logs) = _serve_both("bfloat16", None, False, record=True)
    flip = None
    for step, (a, b) in enumerate(zip(logs, ref_logs)):
        assert_close(a, b, tol_for("bfloat16"))
        if (a.argmax(-1) != b.argmax(-1)).any():
            row = int(np.nonzero(a.argmax(-1) != b.argmax(-1))[0][0])
            top2 = np.sort(b[row])[-2:]
            flip = (step, row, float(top2[1] - top2[0]))
            break
    streams = {r.rid: r.tokens_out for r in eng.completed}
    ref_streams = {r.rid: r.tokens_out for r in ref_eng.completed}
    diverged = {rid: first_divergence(streams[rid], ref_streams[rid]) for rid in ref_streams}
    record_property("bf16_first_flip", flip)
    record_property("bf16_stream_divergence", diverged)
    print(f"bf16 disagg: first flip (step, row, reference top-2 margin) = {flip}; "
          f"first diverging token per request = {diverged}")
    if flip is None:
        assert all(d is None for d in diverged.values())


def test_engine_prefill_capacity_equals_reference():
    """``prefill_capacity_tokens`` fixes the prompt chunks' expert capacity
    (here below what a 16-token chunk routes, so prompts drop items), as the
    reference's engine does: float32 streams equal."""
    import jax

    from repro.models import model as ref_model
    from repro.serving.engine import ServingEngine as RefEngine

    ref_cfg, cfg = _cfgs()
    ref_params = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    ref_layout, layout = _layouts(cfg)
    kw = dict(ENGINE_KW, prefill_capacity_tokens=4)
    ref_eng = RefEngine(ref_cfg, ref_params, layout=ref_layout, **kw)
    eng = ServingEngine(cfg, params, layout=layout, device="cpu", **kw)
    ref_eng.run(_requests(cfg, ref=True), max_steps=500)
    eng.run(_requests(cfg), max_steps=500)
    streams = {r.rid: r.tokens_out for r in eng.completed}
    assert len(streams) == N_REQ and streams == {r.rid: r.tokens_out for r in ref_eng.completed}
    drop_free = ServingEngine(cfg, params, layout=layout, device="cpu", **ENGINE_KW)
    drop_free.run(_requests(cfg), max_steps=500)
    assert streams != {r.rid: r.tokens_out for r in drop_free.completed}  # the cap bites


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_disagg_engine_on_card_matches_cpu(cuda_device):
    """The reduced disagg engine (contiguous, paged with ping-pong, int8) on
    the card serves the streams of the plain versions on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    layout = build_layout(make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0),
                          cfg.num_experts, 2, 3)
    for page, pp, quant in ((None, False, False), (16, True, False), (None, False, True)):
        run_cfg = dataclasses.replace(cfg, kv_quant=quant)
        streams, amax = [], []
        for dev in (CPU, cuda_device):
            p = params if dev == CPU else {
                "embed": params["embed"].to(dev), "final_norm": {"scale": params["final_norm"]["scale"].to(dev)},
                "layers": [{k: ({kk: (vv.to(dev) if torch.is_tensor(vv) else {a: b.to(dev) for a, b in vv.items()})
                                 for kk, vv in v.items()}) for k, v in lp.items()} for lp in params["layers"]]}
            eng = ServingEngine(run_cfg, p, layout=layout, kv_page_size=page, device=dev,
                                **dict(ENGINE_KW, executor="disagg", n_attn=2, ping_pong=pp))
            eng.run(_requests(cfg), max_steps=500)
            streams.append({r.rid: r.tokens_out for r in eng.completed})
            amax.append(eng.amax_log)
        assert streams[0] == streams[1] and len(streams[0]) == N_REQ, (page, pp, quant)
        assert amax[0] == amax[1]
