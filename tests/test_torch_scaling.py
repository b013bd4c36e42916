"""The port's resource management (``repro_torch.core.amax``'s estimators,
``core/scaling.py``, ``serving/controller.py``) against the reference's on
the same numpy inputs: integers and decisions equal exactly, floats to 1e-12
relative (the same float64 arithmetic in the same order).  Both sides run at
``hw=TPU_V5E``, the reference's default and the port's."""

import dataclasses
import types

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core import amax as ref_amax
from repro.core import scaling as ref_scaling
from repro.core.aebs import ReplicaLayout as RefLayout
from repro.core.comm import H100 as REF_H100
from repro.core.comm import TPU_V5E as REF_V5E
from repro.serving import controller as ref_controller
from repro_torch.configs import get_config
from repro_torch.core import amax, scaling
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.comm import H100, TPU_V5E
from repro_torch.core.placement import build_layout
from repro_torch.serving import controller

REL = 1e-12
CONFIGS = ("dsv2-lite", "dsv2-lite-reduced")


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), (a, b)


def _layouts(trace, E, n_e, C):
    from repro.core.placement import build_layout as ref_build_layout

    lay = build_layout(trace, E, n_e, C)
    ref = ref_build_layout(trace, E, n_e, C)
    assert np.array_equal(lay.slot_to_expert, ref.slot_to_expert)
    return lay, ref


@pytest.mark.parametrize("name", CONFIGS)
def test_config_accounting_equals_reference(name):
    cfg, ref = get_config(name), ref_get_config(name)
    assert cfg.param_counts() == ref.param_counts()
    assert cfg.bytes_per_param() == ref.bytes_per_param()
    assert cfg.kv_bytes_per_token() == ref.kv_bytes_per_token()
    f32 = dataclasses.replace(cfg, dtype="float32")
    assert f32.bytes_per_param() == dataclasses.replace(ref, dtype="float32").bytes_per_param()


def test_amax_bound_and_estimators_equal_reference():
    """Eq. 4-5 (symmetric, with probabilities and a layout), the trace's
    per-expert probabilities and the Monte Carlo estimate equal exactly."""
    E, K, C = 64, 6, 12
    trace = amax.make_routing_trace(2048, E, K, skew=1.0, seed=0)
    assert np.array_equal(trace, ref_amax.make_routing_trace(2048, E, K, skew=1.0, seed=0))
    probs = amax.trace_expert_probs(trace, E)
    assert np.array_equal(probs, ref_amax.trace_expert_probs(trace, E))
    mc = amax.MonteCarloAmax(trace, E, trials=4, seed=3)
    ref_mc = ref_amax.MonteCarloAmax(trace, E, trials=4, seed=3)
    for n_e in (6, 8, 16):
        lay, ref_lay = _layouts(trace, E, n_e, C)
        for B in (1, 4, 64, 512, 4096):
            assert amax.amax_bound(n_e, B, E, K, C) == ref_amax.amax_bound(n_e, B, E, K, C)
            assert amax.amax_bound(n_e, B, E, K, C, probs=probs, layout=lay) == \
                ref_amax.amax_bound(n_e, B, E, K, C, probs=probs, layout=ref_lay)
            g = lay.slot_to_expert[0]
            hosted = probs[np.unique(g[g >= 0])]
            assert amax.expected_instance_load(hosted, B) == ref_amax.expected_instance_load(hosted, B)
            assert mc.estimate(lay, B) == ref_mc.estimate(ref_lay, B)
    assert mc.estimate(lay, 64) == ref_mc.estimate(ref_lay, 64)  # the cached value


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("spec", ["TPU_V5E", "H100"])
def test_layer_coeffs_equal_reference(name, spec):
    hw, ref_hw = (TPU_V5E, REF_V5E) if spec == "TPU_V5E" else (H100, REF_H100)
    got = dataclasses.asdict(scaling.LayerCoeffs.from_config(get_config(name), hw))
    want = dataclasses.asdict(ref_scaling.LayerCoeffs.from_config(ref_get_config(name), ref_hw))
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])


def _models(name, mc=False, **kw):
    cfg, ref_cfg = get_config(name), ref_get_config(name)
    est = ref_est = None
    if mc:
        trace = amax.make_routing_trace(1024, cfg.num_experts, cfg.top_k, skew=1.0, seed=0)
        est = amax.MonteCarloAmax(trace, cfg.num_experts, trials=2)
        ref_est = ref_amax.MonteCarloAmax(trace, cfg.num_experts, trials=2)
    return (scaling.PerfModel(cfg, amax_estimator=est, **kw),
            ref_scaling.PerfModel(ref_cfg, amax_estimator=ref_est, **kw))


def _same_result(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert (a["n_a"], a["n_e"], a["feasible"]) == (b["n_a"], b["n_e"], b["feasible"])
    for k in ("batch", "tpot", "t_attn", "t_moe", "t_comm", "a_max", "tpg"):
        _close(a[k], b[k])


@pytest.mark.parametrize("name,mc", [("dsv2-lite", False), ("dsv2-lite", True), ("dsv2-lite-reduced", False)])
def test_perf_model_and_solve_batch_equal_reference(name, mc):
    """Eq. 1's terms, TPOT, the memory terms and Eq. 2's steady batch."""
    kw = dict(slots_per_instance=12, s_ctx=512) if name == "dsv2-lite" else {}
    pm, ref = _models(name, mc=mc, **kw)
    assert pm.C == ref.C
    _close(pm.max_local_batch(), ref.max_local_batch())
    for n_a, n_e in ((1, 6), (2, 8), (4, 16)):
        for B in (1.0, 7.3, 64.0, 512.0):
            _same_result(pm.tpot(B, n_a, n_e), ref.tpot(B, n_a, n_e))
            for scheme in ("2pc", "1pc", "agate"):
                _close(pm.t_comm(n_a, n_e, B, scheme), ref.t_comm(n_a, n_e, B, scheme))
            _close(pm.attn_memory(B / n_a), ref.attn_memory(B / n_a))
        b_max = pm.max_local_batch() * n_a
        for demand in (10.0, 300.0, 5e3, 1e6):
            got = scaling.solve_batch(pm, demand, n_a, n_e, b_max)
            want = ref_scaling.solve_batch(ref, demand, n_a, n_e, b_max)
            assert (got is None) == (want is None)
            if got is not None:
                _close(got, want)


def test_calibrate_and_layout_for_equal_reference():
    pm, ref = _models("dsv2-lite", slots_per_instance=12)
    for m in (pm, ref):
        m.calibrate(beta=2e-5, c_e=1e-5)
    _same_result(pm.tpot(64.0, 2, 8), ref.tpot(64.0, 2, 8))
    with pytest.raises(KeyError):
        pm.calibrate(gamma=1.0)
    assert np.array_equal(pm.layout_for(8).slot_to_expert, ref.layout_for(8).slot_to_expert)
    fn = scaling.PerfModel(get_config("dsv2-lite"), slots_per_instance=12,
                           layout_fn=lambda n: ReplicaLayout.round_robin(64, n, 12))
    assert np.array_equal(fn.layout_for(6).slot_to_expert, RefLayout.round_robin(64, 6, 12).slot_to_expert)


@pytest.mark.parametrize("name", CONFIGS)
def test_slo_scaler_decisions_equal_reference(name):
    """Algorithm 2 makes the same (n_a, n_e, feasible) decision over a grid
    of demands and SLOs, and logs the same search space."""
    kw = dict(slots_per_instance=12, s_ctx=512) if name == "dsv2-lite" else {}
    pm, ref = _models(name, **kw)
    sc, ref_sc = scaling.SLOScaler(pm, n_max=10), ref_scaling.SLOScaler(ref, n_max=10)
    assert sc.n_e_min == ref_sc.n_e_min
    decisions = set()
    grid = ((50.0, 2e3, 2e4, 2e5), (0.02, 0.05, 0.15)) if name == "dsv2-lite" else \
        ((1e3, 1e5, 1e6, 1e7), (1e-4, 3e-4, 1e-2))
    for demand in grid[0]:
        for slo in grid[1]:
            got, want = sc.scale(demand, slo), ref_sc.scale(demand, slo)
            _same_result(got, want)
            assert len(sc.search_log) == len(ref_sc.search_log)
            for a, b in zip(sc.search_log, ref_sc.search_log):
                _same_result(a, b)
            decisions.add(None if got is None else (got.n_a, got.n_e))
    assert len(decisions) > 1  # the grid moves the decision


def _observations(seed=0, n=60, window=60.0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * window, n))
    toks = rng.integers(8, 400, n).astype(float)
    ins = rng.integers(16, 2048, n).astype(float)
    occ = np.where(rng.random(n) < 0.3, rng.uniform(0.2, 0.95, n), 0.0)
    acc = np.where(rng.random(n) < 0.2, rng.uniform(1.0, 3.0, n), 0.0)
    return list(zip(t, toks, ins, occ, acc))


@pytest.mark.parametrize("objective", ["min_devices", "slo_per_device"])
def test_autoscaler_decisions_equal_reference(objective):
    """``decide``, ``decide_prefill``, ``demand_samples`` and the demand
    signals equal the reference's over one seeded observation sequence."""
    pm, ref = _models("dsv2-lite", slots_per_instance=12, s_ctx=512)
    kw = dict(slo=0.05, n_max=8, window=60.0, prefill_tok_rate=3000.0, n_prefill_max=6,
              objective=objective)
    ctl, ref_ctl = controller.AutoScaler(pm, **kw), ref_controller.AutoScaler(ref, **kw)
    seen = set()
    for i, (t, tok, n_in, occ, acc) in enumerate(_observations()):
        for c in (ctl, ref_ctl):
            c.observe(t, tok, input_tokens=n_in, kv_occupancy=occ, saved_input_tokens=n_in * 0.1,
                      accepted_per_step=acc)
        if i % 6 == 5:
            assert ctl.demand(t) == ref_ctl.demand(t)
            assert ctl.prefill_demand(t) == ref_ctl.prefill_demand(t)
            assert ctl.kv_pressure(t) == ref_ctl.kv_pressure(t)
            assert ctl.demand_samples(t) == ref_ctl.demand_samples(t)
            assert ctl.decide_prefill(t) == ref_ctl.decide_prefill(t)
            _same_result(ctl.decide(t), ref_ctl.decide(t))
            seen.add((ctl.current.n_a, ctl.current.n_e, ctl.decide_prefill(t)))
    for d in (0.0, 1e4, 1e6):
        assert ctl.decide_prefill(0.0, demand=d) == ref_ctl.decide_prefill(0.0, demand=d)
    assert [dataclasses.astuple(e) for e in ctl.events] == [dataclasses.astuple(e) for e in ref_ctl.events]
    assert len(seen) > 1
    for c in (ctl, ref_ctl):
        c.on_device_loss("prefill", 1.0)
        c.on_device_loss("moe", 2.0)
    assert (ctl.n_prefill_max, ctl.scaler.n_max, ctl.device_losses) == \
        (ref_ctl.n_prefill_max, ref_ctl.scaler.n_max, ref_ctl.device_losses)


def test_autoscaler_validation_and_replan():
    pm, ref = _models("dsv2-lite", slots_per_instance=12)
    with pytest.raises(ValueError, match="unknown objective"):
        controller.AutoScaler(pm, slo=0.1, objective="fastest")
    ctl, ref_ctl = controller.AutoScaler(pm, slo=0.1), ref_controller.AutoScaler(ref, slo=0.1)
    assert ctl.decide_prefill(0.0) is None  # no rate: prefill scaling off
    trace = amax.make_routing_trace(1024, 64, 6, skew=0.8, seed=2)
    assert np.array_equal(ctl.replan_layout(trace, 8).slot_to_expert,
                          ref_ctl.replan_layout(trace, 8).slot_to_expert)
    with pytest.raises(ValueError, match="executor='disagg'"):
        ctl.actuate(object(), now=0.0)
    engine = types.SimpleNamespace(fault_listeners=[])
    ctl.attach(engine)
    assert len(engine.fault_listeners) == 1
    engine.fault_listeners[0](types.SimpleNamespace(pool="attn"), 3.0)
    assert ctl.device_losses == [(3.0, "attn")] and ctl.scaler.n_max == ref_ctl.scaler.n_max - 1


def test_autoscaler_hysteresis_decides_as_reference():
    """``AutoScaler(hysteresis=)`` is accepted and stored; its only use in the
    reference is a branch that does nothing, so decisions equal the
    reference's at any value (``controller.py:49,59,243-249``)."""
    pm, ref = _models("dsv2-lite", slots_per_instance=12, s_ctx=512)
    for h in (0.0, 0.3, 5.0):
        kw = dict(slo=0.05, n_max=8, window=60.0, hysteresis=h)
        ctl, ref_ctl = controller.AutoScaler(pm, **kw), ref_controller.AutoScaler(ref, **kw)
        assert ctl.hysteresis == ref_ctl.hysteresis == h
        for t, tok, *_ in _observations():
            for c in (ctl, ref_ctl):
                c.observe(t, tok)
        for t in (5.0, 30.0, 90.0):
            _same_result(ctl.decide(t), ref_ctl.decide(t))
    assert controller.AutoScaler(pm, slo=0.05).hysteresis == ref_controller.AutoScaler(ref, slo=0.05).hysteresis


@pytest.mark.parametrize("n_e,C", [(4, 17), (8, 12)])
def test_instance_coactivation_load_equals_reference(n_e, C):
    """Eq. 6's I(g) per instance (tests/test_placement.py:92-93) of a
    trace-planned layout and of a round-robin one."""
    from repro.core.placement import instance_coactivation_load as ref_icl
    from repro_torch.core.placement import instance_coactivation_load

    trace = amax.make_routing_trace(2048, 64, 6, skew=0.8, seed=4)
    A = amax.coactivation_matrix(trace, 64)
    lay, ref = _layouts(trace, 64, n_e, C)
    got, want = instance_coactivation_load(lay, A), ref_icl(ref, A)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    naive, ref_naive = ReplicaLayout.round_robin(64, n_e, C), RefLayout.round_robin(64, n_e, C)
    assert np.array_equal(instance_coactivation_load(naive, A), ref_icl(ref_naive, A))
