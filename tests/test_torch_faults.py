"""The port's fault model and recovery (``repro_torch.serving.faults`` and the
engine's fault envelope) against the reference's, on ``dsv2-lite-reduced`` in
float32 with the deployment of ``tests/test_faults.py``: 4 slots, cache 64,
2 attention shards, 2 x 3-slot MoE instances, 1 prefill device, 4-token
chunks and a modeled 2 ms step.

Plans, retry delays, runtime state machines, survivor layouts, cache helpers
and slot transitions equal the reference's exactly; under every fault plan
the port's streams equal the fault-free ones (its own and the reference's),
and its ``FaultStats`` (without the wall-clock latencies), pool sizes and
layout equal the reference's under the same plan.  Weights are drawn by the
reference and carried across with ``repro_torch.bridge``.  JAX and ``repro``
are imported inside the tests: the card's machine, which runs the ``gpu``
test, has no JAX.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.disagg import DevicePools
from repro_torch.core.placement import layout_for_survivors
from repro_torch.core.scaling import PerfModel
from repro_torch.models import model as model_mod
from repro_torch.models.common import tree_to
from repro_torch.serving import faults
from repro_torch.serving import kv_cache
from repro_torch.serving.controller import AutoScaler
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests

CPU = torch.device("cpu")
# tests/test_faults.py's deployment (`_engine`), its workload (`_reqs`) and
# its recovery charge
DEPLOY = dict(max_batch=4, cache_len=64, scheduler="aebs", capacity_tokens=64, executor="disagg",
              n_prefill=1, prefill_chunk=4, step_time_fn=lambda n: 2e-3)
SPEC = dict(mean_input=6, mean_output=24, max_input=16, max_output=32, seed=3)
N_REQ = 5
LATENCY = ("recovery_latency_mean_s", "recovery_latency_max_s")


# tests/test_faults.py's engine cases: (name, fault specs as kwargs, engine options)
ENGINE_CASES = {
    "attn": ([dict(kind="device_loss", pool="attn", index=1, at_step=6)], {}),
    "moe": ([dict(kind="device_loss", pool="moe", index=0, at_step=6)], {}),
    "prefill": ([dict(kind="device_loss", pool="prefill", index=0, at_step=2)], {}),
    "exchange": ([dict(kind="exchange_timeout", at_step=4, transient=True, fail_count=2)], {}),
    "degrade_attn": ([dict(kind="device_loss", pool="attn", index=0, at_step=5)], dict(n_attn=1)),
    "degrade_retry": ([dict(kind="exchange_timeout", at_step=5, transient=True, fail_count=99)], {}),
    "prefill_chunk": ([dict(kind="prefill_chunk_fail", pool="prefill", at_step=2, transient=True,
                            fail_count=2)], {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny ops (restored afterwards):
    test workers sharing the machine's cores would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (i) the unit layer: plans, retry policy, runtime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (7, dict(n_faults=4, max_step=20)),
    (11, dict(n_faults=6, pool_sizes={"attn": 2, "moe": 4, "prefill": 1})),
    (42, dict(n_faults=5, max_step=9, kinds=("device_loss", "exchange_delay"), pools=("moe", "prefill"))),
])
def test_fault_plan_random_equals_reference(seed, kw):
    """``FaultPlan.random`` draws the reference's plan (same rng call order):
    equal JSON, and each side's JSON loads on the other."""
    from repro.serving import faults as ref_faults

    ref = ref_faults.FaultPlan.random(seed, **kw)
    got = faults.FaultPlan.random(seed, **kw)
    assert got.to_json() == ref.to_json()
    assert ref_faults.FaultPlan.from_json(got.to_json()).to_json() == ref.to_json()
    assert faults.FaultPlan.from_json(ref.to_json()).faults == got.faults


def test_fault_plan_json_and_spec_validation_equal_reference():
    """A bare JSON list of specs loads on both sides alike, and an invalid
    spec is refused with the reference's message."""
    from repro.serving import faults as ref_faults

    bare = json.dumps([{"kind": "device_loss", "pool": "moe", "index": 1}, {"kind": "exchange_delay",
                                                                             "delay_s": 0.2}])
    assert faults.FaultPlan.from_json(bare).to_json() == ref_faults.FaultPlan.from_json(bare).to_json()
    for kw in (dict(kind="meteor_strike"), dict(kind="device_loss", pool="gpu"),
               dict(kind="device_loss", pool="attn", transient=True)):
        with pytest.raises(ValueError) as got:
            faults.FaultSpec(**kw)
        with pytest.raises(ValueError) as want:
            ref_faults.FaultSpec(**kw)
        assert str(got.value) == str(want.value)


def test_retry_policy_equals_reference():
    from repro.serving import faults as ref_faults

    for kw in ({}, dict(base_delay_s=0.1, factor=3.0, max_retries=4), dict(base_delay_s=0.02, factor=1.5)):
        got, want = faults.RetryPolicy(**kw), ref_faults.RetryPolicy(**kw)
        assert [got.delay(a) for a in range(0, 7)] == [want.delay(a) for a in range(0, 7)]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(faults.Watchdog()) == dataclasses.asdict(ref_faults.Watchdog())


# scripted runtime sequences: (fault specs, watchdog, ops); an op is
# ("advance", step), ("exchange", layer, mb), ("prefill", slot, dev, chunk),
# ("poll", pool sizes), ("mark",) the last fault, ("delay",) or ("pending",)
RUNTIME_SCRIPTS = {
    "transient_heals_after_fail_count": (
        [dict(kind="exchange_timeout", at_step=2, transient=True, fail_count=2)], {},
        [("advance", 1), ("exchange", 0, 0), ("advance", 2), ("exchange", 0, 0), ("exchange", 1, 0),
         ("exchange", 3, 1), ("pending",)]),
    "delay_under_and_over_the_watchdog": (
        [dict(kind="exchange_delay", at_step=0, delay_s=0.2), dict(kind="exchange_delay", at_step=3,
                                                                   delay_s=30.0, fail_count=2)],
        dict(exchange_deadline_s=0.5),
        [("advance", 0), ("exchange", 0, 0), ("delay",), ("exchange", 1, 0), ("advance", 3),
         ("exchange", 0, 0), ("exchange", 0, 1), ("delay",), ("exchange", 2, 0), ("delay",), ("pending",)]),
    "health_poll_loss_outside_the_shrunk_pool": (
        [dict(kind="device_loss", pool="moe", index=3, at_step=0), dict(kind="device_loss", pool="attn",
                                                                        index=0, at_step=0),
         dict(kind="device_loss", pool="prefill", index=1, at_step=4)], {},
        [("advance", 0), ("poll", {"attn": 2, "moe": 2, "prefill": 0}), ("mark",),
         ("poll", {"attn": 2, "moe": 2, "prefill": 0}), ("advance", 4), ("poll", {"attn": 1, "moe": 2,
                                                                                "prefill": 2}),
         ("mark",), ("poll", {"attn": 1, "moe": 2, "prefill": 1}), ("pending",)]),
    "prefill_chunk_transient_then_permanent": (
        [dict(kind="prefill_chunk_fail", pool="prefill", at_step=2, transient=True, fail_count=2),
         dict(kind="prefill_chunk_fail", pool="prefill", at_step=6)], {},
        [("prefill", 0, 0, 1), ("prefill", 0, 0, 2), ("prefill", 1, 0, 2), ("prefill", 1, 0, 3),
         ("advance", 9), ("prefill", 2, 0, 6), ("mark",), ("prefill", 2, 0, 7), ("pending",)]),
}


def _drive(mod, specs, watchdog_kw, ops):
    """Run ``ops`` on a runtime of module ``mod``; each op's outcome (its
    value, or the raised fault's fields) and the stats after it."""
    rt = mod.FaultRuntime(mod.FaultPlan([mod.FaultSpec(**s) for s in specs]),
                          watchdog=mod.Watchdog(**watchdog_kw))
    log, last = [], None
    for op in ops:
        try:
            if op[0] == "advance":
                out = rt.advance_to_step(op[1])
            elif op[0] == "exchange":
                out = rt.exchange_hook("exchange", op[1], op[2])
            elif op[0] == "prefill":
                out = rt.prefill_hook(*op[1:])
            elif op[0] == "poll":
                out = last = rt.poll_health(op[1])
            elif op[0] == "mark":
                out = rt.mark_handled(last)
            elif op[0] == "delay":
                out = rt.consume_delay()
            else:
                out = rt.has_pending
            if isinstance(out, mod.PoolFault):
                out = ("fault", out.pool, out.index, out.kind, out.transient, str(out))
        except mod.PoolFault as f:
            last = f
            out = ("raised", f.pool, f.index, f.kind, f.transient, f.detail, str(f))
        log.append((op[0], out, rt.stats.as_dict()))
    return log


@pytest.mark.parametrize("name", sorted(RUNTIME_SCRIPTS))
def test_fault_runtime_script_equals_reference(name):
    """Every hook, poll and drain of a scripted sequence gives the reference's
    outcome (raised ``PoolFault`` fields, returned values) and stats."""
    from repro.serving import faults as ref_faults

    specs, wd, ops = RUNTIME_SCRIPTS[name]
    got = _drive(faults, specs, wd, ops)
    assert got == _drive(ref_faults, specs, wd, ops)
    assert any(isinstance(o[1], tuple) for o in got)  # the script reaches a fault


# ---------------------------------------------------------------------------
# (ii) layout_for_survivors, (iii) cache helpers and slot transitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E", [8, 16, 64])
def test_layout_for_survivors_equals_reference(E):
    """Every expert seated; ``slot_to_expert`` equal to the reference's over
    survivors, capacities and with or without a routing trace."""
    from repro.core.placement import layout_for_survivors as ref_layout_for_survivors

    trace = make_routing_trace(256, E, 4, skew=0.8, seed=E)
    for n in (1, 2, 3, 4, 5):
        for capacity in (None, 3, E // 2):
            for tr in (None, trace):
                got = layout_for_survivors(E, n, capacity, tr)
                want = ref_layout_for_survivors(E, n, capacity, tr)
                assert np.array_equal(got.slot_to_expert, np.asarray(want.slot_to_expert))
                assert (got.num_instances, got.capacity) == (want.num_instances, want.capacity) == (n, got.capacity)
                seated = got.slot_to_expert[got.slot_to_expert >= 0]
                assert set(seated.tolist()) == set(range(E))
    with pytest.raises(ValueError, match="degrade to mono"):
        layout_for_survivors(E, 0)


def _dense_caches(L=2, B=4, S=16, H=2, D=3, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((L, B, S, H, D)).astype(np.float32) for k in ("kv_k", "kv_v")}


def _pagers(ref_kv, B=4, S=16, ps=4, lengths=(5, 0, 16, 9)):
    got, want = kv_cache.PagedKVCache(B, S, ps), ref_kv.PagedKVCache(B, S, ps)
    for slot, ln in enumerate(lengths):
        if ln:
            got.ensure(slot, ln - 1)
            want.ensure(slot, ln - 1)
    return got, want


@pytest.mark.parametrize("paged", [False, True])
def test_zero_slots_equals_reference(paged):
    """``zero_slots`` wipes the slots' rows (contiguous) or the pages they own
    (paged) as the reference's does; the block tables survive."""
    import jax.numpy as jnp

    from repro.serving import kv_cache as ref_kv

    caches = _dense_caches()
    pager = ref_pager = None
    if paged:
        pager, ref_pager = _pagers(ref_kv)
        rng = np.random.default_rng(1)
        caches = {k: rng.standard_normal((2, pager.num_pages, 4, 2, 3)).astype(np.float32) for k in caches}
        caches["block_tables"] = pager.tables.copy()
    for slots in ([], [1], [0, 2], [3, 2, 0]):
        got = kv_cache.zero_slots({k: torch.from_numpy(v.copy()) for k, v in caches.items()}, slots, pager)
        want = ref_kv.zero_slots({k: jnp.asarray(v) for k, v in caches.items()}, slots, ref_pager)
        for k in caches:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (k, slots)


def test_paginate_caches_equals_reference():
    """Re-paginating a dense export gives the reference's pools, block tables
    and allocator state, and reads back the same live rows."""
    import jax.numpy as jnp

    from repro.serving import kv_cache as ref_kv

    caches = _dense_caches(seed=2)
    lengths = np.array([5, 0, 16, 9])
    pager, got = kv_cache.paginate_caches({k: torch.from_numpy(v) for k, v in caches.items()}, lengths, 4)
    ref_pager, want = ref_kv.paginate_caches({k: jnp.asarray(v) for k, v in caches.items()}, lengths, 4)
    for k in ("kv_k", "kv_v", "block_tables"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(pager.tables, ref_pager.tables)
    assert pager.stats() == ref_pager.stats()
    for slot, ln in enumerate(lengths):
        if ln:
            pages, offs = pager.rows_of(slot, 0, int(ln))
            assert np.array_equal(got["kv_k"][:, pages, offs].numpy(), caches["kv_k"][:, slot, :ln])


def test_depaginate_caches_equals_reference():
    """``depaginate_caches`` inverts ``paginate_caches`` (tests/test_paged_kv.py
    :146-155): the reference's dense rows, zeros where no page backs a row,
    and ``zero_slots`` on the pool clears exactly the slot's pages."""
    import jax.numpy as jnp

    from repro.serving import kv_cache as ref_kv

    caches = _dense_caches(seed=3)
    lengths = np.array([5, 0, 16, 9])
    pager, paged = kv_cache.paginate_caches({k: torch.from_numpy(v) for k, v in caches.items()}, lengths, 4)
    ref_pager, ref_paged = ref_kv.paginate_caches({k: jnp.asarray(v) for k, v in caches.items()}, lengths, 4)
    back = kv_cache.depaginate_caches(paged, pager)
    want = ref_kv.depaginate_caches(ref_paged, ref_pager)
    assert set(back) == set(want) and "block_tables" not in back
    for k in want:
        assert np.array_equal(back[k].numpy(), np.asarray(want[k])), k
        for b, ln in enumerate(lengths):
            assert np.array_equal(back[k][:, b, :ln].numpy(), caches[k][:, b, :ln]), (k, b)
    back2 = kv_cache.depaginate_caches(kv_cache.zero_slots(paged, [2], pager), pager)
    assert not back2["kv_k"][:, 2].any()
    assert np.array_equal(back2["kv_k"][:, 0, :5].numpy(), caches["kv_k"][:, 0, :5])


def test_slot_manager_admit_and_active_mask_equal_reference():
    """Blocking ``admit`` and ``active_mask`` (tests/test_kv_cache.py:39-63),
    state for state against the reference's ``SlotManager``."""
    from repro.serving import kv_cache as ref_kv
    from repro.serving.request import Request as RefRequest
    from repro_torch.serving.request import Request

    sides = []
    for mod, req_cls in ((kv_cache, Request), (ref_kv, RefRequest)):
        sm = mod.SlotManager(3, 16)
        log = []
        r0 = req_cls(rid=0, arrival=0.0, input_len=5, output_len=2)
        log.append((sm.admit(r0), r0.slot, list(sm.state), sm.positions.tolist(), sm.active_mask().tolist()))
        sm.advance(0)
        s = sm.reserve(req_cls(rid=1, arrival=0.0, input_len=9, output_len=2))
        sm.start_prefill(s)
        log.append((s, sm.active_mask().tolist(), sm.pending_slots, sm.positions.tolist()))
        sm.activate(s)
        log.append((sm.active_mask().tolist(), sm.active_slots, sm.positions.tolist()))
        log.append((sm.release(0).rid, sm.admit(req_cls(rid=2, arrival=0.0, input_len=2, output_len=1)),
                    sm.positions.tolist(), sm.active_mask().tolist()))
        sides.append(log)
    assert sides[0] == sides[1]
    assert sides[0][0][4] == [True, False, False]


def test_slot_manager_fault_transitions_equal_reference():
    """The ``FAILED``/``REQUEUED`` detour and its refusals, state for state
    and message for message."""
    from repro.serving import kv_cache as ref_kv
    from repro.serving.request import Request as RefRequest
    from repro_torch.serving.request import Request

    sides = []
    for mod, req_cls in ((kv_cache, Request), (ref_kv, RefRequest)):
        sm = mod.SlotManager(3, 16)
        log = []
        steps = [("reserve", 0), ("reserve", 1), ("start_prefill", 0), ("fail", 0), ("start_prefill", 0),
                 ("activate", 0), ("requeue", 0), ("start_prefill", 0), ("fail", 1), ("requeue", 1),
                 ("requeue", 1), ("activate", 1), ("start_prefill", 1), ("activate", 1), ("fail", 1),
                 ("fail", 2), ("release", 0), ("requeue", 0)]
        for op, slot in steps:
            try:
                if op == "reserve":
                    out = sm.reserve(req_cls(rid=slot, arrival=0.0, input_len=4 + slot, output_len=2))
                else:
                    out = getattr(sm, op)(slot)
                out = out if isinstance(out, (int, type(None))) else out.rid
            except RuntimeError as e:
                out = str(e)
            log.append((op, slot, out, list(sm.state), sm.pending_slots, sm.positions.tolist()))
        sides.append(log)
    assert sides[0] == sides[1]


# ---------------------------------------------------------------------------
# (iv) the engine under fault plans, against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.core.aebs import ReplicaLayout as RefLayout
    from repro.models import model as ref_model

    ref_cfg = dataclasses.replace(ref_get_config("dsv2-lite-reduced"), dtype="float32")
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, 0)
    return dict(
        ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
        params=bridge.params_from_jax(jax.tree.map(np.asarray, ref_params)),
        ref_layout=RefLayout.round_robin(cfg.num_experts, 2, 3),
        layout=ReplicaLayout.round_robin(cfg.num_experts, 2, 3),
    )


def _requests(cfg, ref=False):
    spec = dict(SPEC, vocab_size=cfg.vocab_size)
    arrivals = np.linspace(0, 0.005, N_REQ)  # packed: the batch is full when a fault lands
    if ref:
        from repro.serving.request import WorkloadSpec as RefSpec
        from repro.serving.request import sample_requests as ref_sample_requests

        return ref_sample_requests(RefSpec(**spec), arrivals, with_prompts=True)
    return sample_requests(WorkloadSpec(**spec), arrivals, with_prompts=True)


def _port_engine(setup, specs=None, n_attn=2, **kw):
    plan = faults.FaultPlan([faults.FaultSpec(**s) for s in specs]) if specs is not None else None
    return ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], n_attn=n_attn, device=CPU,
                         fault_plan=plan, retry_policy=faults.RetryPolicy(recovery_charge_s=0.01),
                         **{**DEPLOY, **kw})


def _outcome(eng, m, ctrl=None):
    """What a run is held to: streams, stats without the wall-clock
    latencies, the executor and its pools, the controller's view."""
    out = dict(streams={r.rid: list(r.tokens_out) for r in eng.completed}, executor=eng.executor_name,
               degraded_reason=m.get("degraded_reason"))
    if "faults" in m:
        out["faults"] = {k: v for k, v in m["faults"].items() if k not in LATENCY}
    if eng.disagg is not None:
        pools = eng.disagg.pools
        out["pools"] = (len(pools.prefill_devices), len(pools.attn_devices), len(pools.moe_devices),
                        eng.layout.num_instances)
    if ctrl is not None:
        out["controller"] = (ctrl.scaler.n_max, ctrl.n_prefill_max, [p for _, p in ctrl.device_losses])
    return out


def _controllers(setup):
    from repro.core.scaling import PerfModel as RefPerfModel
    from repro.serving.controller import AutoScaler as RefAutoScaler

    kw = dict(slo=0.2, n_max=4, n_prefill_max=2)
    return (AutoScaler(PerfModel(setup["cfg"], slots_per_instance=3, s_ctx=64), **kw),
            RefAutoScaler(RefPerfModel(setup["ref_cfg"], slots_per_instance=3, s_ctx=64), **kw))


@pytest.fixture(scope="module")
def reference(setup):
    """The reference engine's outcome per case, each run once (the MoE loss
    with an AutoScaler attached, which ``test_controller_sees_lost_capacity``
    also reads)."""
    from repro.serving import faults as ref_faults
    from repro.serving.engine import ServingEngine as RefEngine

    def run(specs=None, n_attn=2, attach=False, **kw):
        plan = ref_faults.FaultPlan([ref_faults.FaultSpec(**s) for s in specs]) if specs is not None else None
        eng = RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], n_attn=n_attn,
                        fault_plan=plan, retry_policy=ref_faults.RetryPolicy(recovery_charge_s=0.01),
                        **{**DEPLOY, **kw})
        ctrl = _controllers(setup)[1] if attach else None
        if ctrl is not None:
            ctrl.attach(eng)
        m = eng.run(_requests(setup["cfg"], ref=True), max_steps=2000)
        return _outcome(eng, m, ctrl)

    out = {"fault_free": run()}
    for name, (specs, kw) in ENGINE_CASES.items():
        out[name] = run(specs, attach=name == "moe", **kw)
    return out


@pytest.fixture(scope="module")
def fault_free(setup, reference):
    eng = _port_engine(setup)
    m = eng.run(_requests(setup["cfg"]), max_steps=2000)
    got = _outcome(eng, m)
    assert len(got["streams"]) == N_REQ
    assert got["streams"] == reference["fault_free"]["streams"]
    return got["streams"]


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_fault_case_equals_reference(setup, reference, fault_free, name):
    """tests/test_faults.py's engine cases: a device loss in each pool, the
    transient exchange timeout, both degrade-to-mono paths and the transient
    prefill-chunk failure.  The port's streams equal the fault-free ones;
    its stats, executor, pools and layout equal the reference's."""
    specs, kw = ENGINE_CASES[name]
    eng = _port_engine(setup, specs, **kw)
    m = eng.run(_requests(setup["cfg"]), max_steps=2000)
    got = _outcome(eng, m)
    want = {k: v for k, v in reference[name].items() if k != "controller"}
    assert got["streams"] == fault_free
    assert got == want
    f = m["faults"]
    assert f["injected"] == 1 and f["detected"] >= 1
    if f["recoveries"]:
        assert f["recovery_latency_max_s"] > 0
    expect = {"attn": ("replayed_slots", 1), "moe": ("recoveries", 1), "prefill": ("requeued", 1),
              "exchange": ("retries", 2), "degrade_attn": ("degraded", 1), "degrade_retry": ("degraded", 1),
              "prefill_chunk": ("retries", 2)}[name]
    assert f[expect[0]] >= expect[1]
    if name == "exchange":
        assert f["fault_stall_s"] == pytest.approx(0.05 + 0.10)
    if name.startswith("degrade"):
        assert eng.disagg is None and eng.executor_name == "mono"


def test_controller_sees_lost_capacity(setup, reference, fault_free):
    """``AutoScaler.attach`` subscribes ``on_device_loss`` to the engine's
    fault events: the MoE loss shrinks the decode bound as the reference's."""
    ctrl, _ = _controllers(setup)
    eng = _port_engine(setup, ENGINE_CASES["moe"][0])
    ctrl.attach(eng)
    assert len(eng.fault_listeners) == 1
    m = eng.run(_requests(setup["cfg"]), max_steps=2000)
    got = _outcome(eng, m, ctrl)
    assert got == reference["moe"] and got["streams"] == fault_free
    assert ctrl.scaler.n_max == 3 and ctrl.device_losses[0][1] == "moe"


@pytest.mark.parametrize("ping_pong", [False, True])
def test_paged_degrade_to_mono_replays_every_slot(setup, fault_free, ping_pong):
    """The last attention device lost under paged KV: the export is
    re-paginated (``paginate_caches`` on the live path) and every active slot
    replays through the mono step; the streams equal the fault-free run's.
    With ping-pong the shard splits into micro-batches."""
    specs = [dict(kind="device_loss", pool="attn", index=0, at_step=5)]
    eng = _port_engine(setup, specs, n_attn=1, kv_page_size=16, ping_pong=ping_pong)
    m = eng.run(_requests(setup["cfg"]), max_steps=2000)
    assert {r.rid: r.tokens_out for r in eng.completed} == fault_free
    f = m["faults"]
    assert f["degraded"] == 1 and f["replayed_slots"] >= 1 and eng.paged is not None
    assert m["kv_pages"]["pages_in_use"] == 0  # every page returned at the end
    assert "attention" in m["degraded_reason"]


def test_all_pools_lost_in_one_plan(setup, fault_free):
    """One plan with a prefill loss, a transient exchange timeout, an
    attention loss and an MoE loss (the card's phase 4 plan): the streams
    equal the fault-free run's and the pools end at 0P 1A 1E."""
    specs = [dict(kind="device_loss", pool="prefill", index=0, at_step=2),
             dict(kind="exchange_timeout", at_step=4, transient=True, fail_count=2),
             dict(kind="device_loss", pool="attn", index=1, at_step=6),
             dict(kind="device_loss", pool="moe", index=0, at_step=9)]
    eng = _port_engine(setup, specs)
    m = eng.run(_requests(setup["cfg"]), max_steps=2000)
    got = _outcome(eng, m)
    assert got["streams"] == fault_free
    assert got["pools"] == (0, 1, 1, 1)
    f = got["faults"]
    assert (f["injected"], f["recoveries"], f["retries"], f["degraded"]) == (4, 3, 2, 0)
    assert f["requeued"] >= 1 and f["replayed_slots"] >= 1


def test_replay_divergence_raises(setup):
    """A replayed token that differs from the recorded stream raises."""
    eng = _port_engine(setup, [dict(kind="device_loss", pool="attn", index=1, at_step=6)])
    decode = eng.disagg.decode_step

    def tampered(tokens, positions):
        logits, tel = decode(tokens, positions)
        if eng.faults.stats.recoveries == 0 and eng.disagg is not None and len(eng.disagg.shards) == 1:
            logits = logits.flip(-1)  # the replay's steps only: re-sharded, recovery not booked yet
        return logits, tel

    eng.disagg.decode_step = tampered
    with pytest.raises(RuntimeError, match="recovery replay diverged"):
        eng.run(_requests(setup["cfg"]), max_steps=2000)


def test_worker_run_sync_streams_the_queued_chunks(setup):
    """``run_sync`` replays a prompt on the queued path's chunk grid (same KV
    rows, same first token) and ``set_devices([])`` falls back to the
    engine's device."""
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.request import Request

    cfg = setup["cfg"]
    worker = PrefillWorker(cfg, setup["params"], [], device=CPU, cache_len=64, chunk=4)
    assert worker.devices == [CPU]
    prompt = np.arange(11, dtype=np.int32) % cfg.vocab_size
    sunk = {"queued": [], "sync": []}
    worker.submit(Request(rid=0, arrival=0.0, input_len=11, output_len=2, prompt=prompt), 1, now=0.0)
    events = []
    while not events:
        events = worker.poll(lambda *a: sunk["queued"].append((a[0], a[1], a[2], a[3]["kv_k"].clone())))
    first = worker.run_sync(prompt, 1, lambda *a: sunk["sync"].append((a[0], a[1], a[2], a[3]["kv_k"].clone())))
    assert first == events[0].first_token
    assert [s[:3] for s in sunk["sync"]] == [s[:3] for s in sunk["queued"]] == [(1, 0, 4), (1, 4, 4), (1, 8, 3)]
    for (_, lo, n, got), (_, _, _, want) in zip(sunk["sync"], sunk["queued"]):
        assert torch.equal(got[:, :, lo:lo + n], want[:, :, lo:lo + n])
    assert worker.cancel_slot(1) is None


# ---------------------------------------------------------------------------
# (v) admission deadlines and backpressure
# ---------------------------------------------------------------------------


def test_admission_deadline_rejection_equals_reference(setup):
    """A request whose deadline passes while the one slot is busy is rejected
    without holding a slot, as in the reference."""
    from repro.serving.engine import ServingEngine as RefEngine
    from repro.serving.request import WorkloadSpec as RefSpec
    from repro.serving.request import sample_requests as ref_sample_requests

    spec = dict(mean_input=4, mean_output=8, vocab_size=setup["cfg"].vocab_size, max_input=8, max_output=8,
                seed=0)
    kw = dict(max_batch=1, cache_len=64, scheduler="aebs", capacity_tokens=64, step_time_fn=lambda n: 1.0)
    got_reqs = sample_requests(WorkloadSpec(**spec), [0.0, 0.1], with_prompts=True)
    want_reqs = ref_sample_requests(RefSpec(**spec), [0.0, 0.1], with_prompts=True)
    got_reqs[1].deadline = want_reqs[1].deadline = 2.0
    eng = ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device=CPU, **kw)
    ref = RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], **kw)
    m, want = eng.run(got_reqs, max_steps=200), ref.run(want_reqs, max_steps=200)
    assert (m["completed"], m["rejected"]) == (want["completed"], want["rejected"]) == (1, 1)
    assert got_reqs[1].rejected and got_reqs[1].slot == -1 and eng.rejected == [got_reqs[1]]
    assert got_reqs[1].finished == want_reqs[1].finished
    assert got_reqs[0].tokens_out == want_reqs[0].tokens_out


def test_deadline_cancels_a_prefilling_request(setup):
    """Pipelined admission with slow prefill: a request still prefilling
    past its deadline is cancelled (slot and pages freed) and rejected, as
    in the reference; the others are served."""
    from repro.serving.engine import ServingEngine as RefEngine

    kw = dict(max_batch=2, cache_len=64, scheduler="aebs", capacity_tokens=64, admission="pipelined",
              prefill_chunk=4, kv_page_size=16, step_time_fn=lambda n: 0.01,
              prefill_time_fn=lambda n: 0.02 * n)
    sides = []
    for eng, reqs in ((ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device=CPU, **kw),
                       _requests(setup["cfg"])),
                      (RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], **kw),
                       _requests(setup["cfg"], ref=True))):
        for r in reqs:
            r.arrival = 0.0  # requests 0 and 1 take both slots at once
        reqs[1].deadline = 0.1  # its prompt queues behind request 0's 0.08 s chunks
        m = eng.run(reqs, max_steps=2000)
        sides.append((m["completed"], m["rejected"], [(r.rid, r.slot, r.tokens_out) for r in eng.rejected],
                      {r.rid: list(r.tokens_out) for r in eng.completed}, m["kv_pages"]["pages_in_use"]))
    assert sides[0] == sides[1]
    # request 1 held slot 1 and was cancelled mid-prefill, before any token
    assert sides[0][:3] == (N_REQ - 1, 1, [(1, 1, None)]) and sides[0][4] == 0


def test_admission_backpressure_equals_reference(setup):
    """``max_prefill_queue=1``: admission defers instead of flooding the
    prefill queue, and everything completes with the reference's streams."""
    from repro.serving.engine import ServingEngine as RefEngine

    kw = dict(max_batch=4, cache_len=64, scheduler="aebs", capacity_tokens=64, admission="pipelined",
              prefill_chunk=4, step_time_fn=lambda n: 2e-3, max_prefill_queue=1)
    sides = []
    for eng, reqs in ((ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device=CPU, **kw),
                       _requests(setup["cfg"])[:4]),
                      (RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], **kw),
                       _requests(setup["cfg"], ref=True)[:4])):
        pending = []
        submit = eng.prefill_worker.submit

        def spy(req, slot, now, submit=submit, eng=eng, pending=pending, **skw):
            pending.append(eng.prefill_worker.num_pending)
            return submit(req, slot, now=now, **skw)

        eng.prefill_worker.submit = spy
        m = eng.run(reqs, max_steps=2000)
        sides.append((m["completed"], m["rejected"], pending, {r.rid: list(r.tokens_out) for r in eng.completed}))
    assert sides[0] == sides[1]
    assert sides[0][:2] == (4, 0) and max(sides[0][2]) == 0


# ---------------------------------------------------------------------------
# (vi) exclude_device on a universe of distinct devices
# ---------------------------------------------------------------------------


def test_exclude_device_on_a_real_universe(setup):
    """On a universe of distinct device objects (indexed CPU devices compare
    unequal, as separate cards do), a dead device leaves the universe by
    identity and the re-split never hands it out again; on aliased pools
    (equal devices, as on one card) the exclusion is a no-op."""

    def engine(universe):
        pools = DevicePools.split(2, 2, universe, n_prefill=1)
        return ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], pools=pools, device=CPU,
                             max_batch=4, cache_len=64, scheduler="aebs", capacity_tokens=64,
                             executor="disagg", n_prefill=1, prefill_chunk=4)

    ex = engine([torch.device("cpu") for _ in range(6)]).disagg
    assert ex._aliased  # equal devices: the executor cannot tell them apart
    before = list(ex._all_devices)
    ex.exclude_device("moe", 0)
    assert ex._all_devices == before
    universe = [torch.device("cpu", i) for i in range(6)]
    eng = engine(universe)
    ex = eng.disagg
    assert not ex._aliased and len(ex._all_devices) == 5  # the pools own five of the six
    # an MoE loss, as the engine recovers it: exclude, then re-plan
    dead_moe = ex.pools.moe_devices[0]
    ex.exclude_device("moe", 0)
    assert len(ex._all_devices) == 4 and not any(d is dead_moe for d in ex._all_devices)
    eng.reconfigure(n_moe=1, layout=layout_for_survivors(setup["cfg"].num_experts, 1))
    dead_attn = ex.pools.attn_devices[1]
    lost = ex.drop_attn_device(1)
    assert lost == [2, 3]
    assert not any(d is dead_attn for d in ex._all_devices) and len(ex._all_devices) == 3
    live = ex.pools.attn_devices + ex.pools.moe_devices + ex.pools.prefill_devices
    assert not any(d is dead_attn or d is dead_moe for d in live)
    assert sorted(d.index for d in live) == sorted(d.index for d in ex._all_devices)
    assert (len(ex.pools.attn_devices), len(ex.pools.moe_devices)) == (1, 1)
    with pytest.raises(ValueError, match="exceed"):
        eng.reconfigure(n_attn=2)  # three devices survive: 2 + 1 + 1 do not fit
    with pytest.raises(ValueError, match="last attention device"):
        ex.drop_attn_device(0)
    with pytest.raises(ValueError, match="no attention device 3"):
        ex.drop_attn_device(3)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_attn_loss_on_card_matches_cpu(cuda_device):
    """Case (iv)'s attention loss on the card's kernels: streams, stats and
    ``amax_log`` equal the plain versions' on the CPU and the fault-free
    streams."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    layout = ReplicaLayout.round_robin(cfg.num_experts, 2, 3)
    specs = ENGINE_CASES["attn"][0]
    sides = []
    for dev in (CPU, cuda_device):
        outs = []
        for plan in (None, specs):
            eng = ServingEngine(cfg, tree_to(params, dev), layout=layout, n_attn=2, device=dev,
                                fault_plan=None if plan is None else faults.FaultPlan(
                                    [faults.FaultSpec(**s) for s in plan]),
                                retry_policy=faults.RetryPolicy(recovery_charge_s=0.01), **DEPLOY)
            m = eng.run(_requests(cfg), max_steps=2000)
            outs.append((_outcome(eng, m), eng.amax_log))
        assert outs[0][0]["streams"] == outs[1][0]["streams"] and len(outs[0][0]["streams"]) == N_REQ
        sides.append(outs)
    assert sides[0] == sides[1]
    assert sides[1][1][0]["faults"]["replayed_slots"] >= 1
