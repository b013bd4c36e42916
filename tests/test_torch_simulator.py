"""The port's cluster simulator (``repro_torch.serving.simulator``) and
system scaling policies (``repro_torch.core.baselines``) against the
reference's on the same numpy inputs.  Integers, booleans and floats are
exactly equal: both run the same float64 code in the same order over
``PerfModel``s whose decisions already equal
(``tests/test_torch_scaling.py``).  Both sides run at ``hw=TPU_V5E``, the
default of both.  The settings are the reference's
``tests/test_simulator.py`` and ``tests/test_trace.py``'s 10k-request
replay."""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core import amax as ref_amax
from repro.core import baselines as ref_baselines
from repro.core import scaling as ref_scaling
from repro.serving import request as ref_request
from repro.serving import simulator as ref_simulator
from repro.serving import trace as ref_trace
from repro_torch.configs import get_config
from repro_torch.core import amax, baselines, scaling
from repro_torch.serving import request, simulator, trace

POLICIES = ("janus", "sglang", "megascale", "xdeepserve")
PROPERTIES = ("gpu_hours", "slo_attainment", "mean_gpus", "slo_per_device")


def _sims(trace_tokens=2048, skew=1.0, trials=4, n_max=16):
    """The reference's ``test_simulator.py`` fixture on both sides."""
    cfg, ref_cfg = get_config("dsv2-lite"), ref_get_config("dsv2-lite")
    tr = amax.make_routing_trace(trace_tokens, cfg.num_experts, cfg.top_k, skew=skew, seed=0)
    ref_tr = ref_amax.make_routing_trace(trace_tokens, cfg.num_experts, cfg.top_k, skew=skew, seed=0)
    assert np.array_equal(tr, ref_tr)
    pm = scaling.PerfModel(cfg, amax_estimator=amax.MonteCarloAmax(tr, cfg.num_experts, trials=trials),
                           slots_per_instance=12, s_ctx=512)
    ref_pm = ref_scaling.PerfModel(ref_cfg, amax_estimator=ref_amax.MonteCarloAmax(ref_tr, cfg.num_experts,
                                                                                   trials=trials),
                                   slots_per_instance=12, s_ctx=512)
    return (simulator.ClusterSimulator(pm, slo=0.2, n_max=n_max),
            ref_simulator.ClusterSimulator(ref_pm, slo=0.2, n_max=n_max))


def _trace_spec(mod):
    """``tests/test_trace.py``'s 10k-request ``TraceSpec``."""
    return mod.TraceSpec(duration=100.0, seed=2, tenants=[
        mod.TenantSpec(name="chat", klass="chat", rate=100.0, arrival="bursty", burstiness=3.0),
        mod.TenantSpec(name="batch", klass="batch-offline", rate=40.0,
                       workload=dict(mean_output=48.0, max_output=128)),
    ])


def _assert_results_equal(got, want):
    assert type(got) is simulator.SimResult
    assert len(got.records) == len(want.records)
    for r, w in zip(got.records, want.records):
        assert type(r) is simulator.WindowRecord
        assert dataclasses.astuple(r) == dataclasses.astuple(w)
        assert [type(v) for v in dataclasses.astuple(r)] == [type(v) for v in dataclasses.astuple(w)]
    for name in PROPERTIES:
        assert getattr(got, name) == getattr(want, name), name


@pytest.fixture(scope="module")
def profiles():
    """Both sides' Fig. 11 runs: ``compare`` on the seed-1 profile and
    ``run_janus`` on the seed-2 one, each simulator built afresh as the
    reference's fixture is built once a module."""
    sim, ref_sim = _sims()
    t, rates = trace.diurnal_rate_profile(hours=6, mean_rate=3.0, seed=1)
    ref_t, ref_rates = ref_trace.diurnal_rate_profile(hours=6, mean_rate=3.0, seed=1)
    assert np.array_equal(t, ref_t) and np.array_equal(rates, ref_rates)
    t2, rates2 = trace.diurnal_rate_profile(hours=6, mean_rate=12.0, peak_over_mean=3.0, seed=2)
    return dict(
        compare=(sim.compare(t, rates, tokens_per_req=256.0), ref_sim.compare(t, rates, tokens_per_req=256.0)),
        janus=(sim.run_janus(t2, rates2, tokens_per_req=256.0),
               ref_sim.run_janus(t2, rates2, tokens_per_req=256.0)),
        rates2=rates2,
    )


@pytest.fixture(scope="module")
def replays():
    """Both sides' replay of the 10k-request trace (``n_max=8``, a 1024-token
    routing trace at skew 0.8, 10 s windows) and the request lists."""
    reqs = _trace_spec(trace).build(with_prompts=False)
    ref_reqs = _trace_spec(ref_trace).build(with_prompts=False)
    assert len(reqs) == len(ref_reqs) >= 10_000
    sim, ref_sim = _sims(trace_tokens=1024, skew=0.8, n_max=8)
    return reqs, ref_reqs, sim.replay(reqs, window_s=10.0), ref_sim.replay(ref_reqs, window_s=10.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_compare_records_equal_reference(profiles, policy):
    got, want = profiles["compare"]
    assert set(got) == set(want) == set(POLICIES)
    assert len(got[policy].records) == 24  # one record a 15-minute window over 6 hours
    _assert_results_equal(got[policy], want[policy])


def test_run_janus_records_equal_reference(profiles):
    _assert_results_equal(*profiles["janus"])


@pytest.mark.parametrize("policy", POLICIES)
def test_replay_records_equal_reference(replays, policy):
    _, _, got, want = replays
    assert set(got) == set(want) == set(POLICIES)
    assert len(got[policy].records) == 10
    _assert_results_equal(got[policy], want[policy])
    res = got[policy]
    assert 0.0 <= res.slo_attainment <= 1.0
    assert res.slo_per_device <= res.slo_attainment / max(res.mean_gpus, 1) + 1e-9


def test_window_demand_equals_reference(replays):
    reqs, ref_reqs, _, _ = replays
    starts, lams = simulator.ClusterSimulator.window_demand(reqs, 10.0)
    ref_starts, ref_lams = ref_simulator.ClusterSimulator.window_demand(ref_reqs, 10.0)
    assert starts.dtype == ref_starts.dtype and lams.dtype == ref_lams.dtype
    assert np.array_equal(starts, ref_starts) and np.array_equal(lams, ref_lams)
    for fn in (simulator.ClusterSimulator.window_demand, ref_simulator.ClusterSimulator.window_demand):
        s, lam = fn([], 10.0)
        assert s.shape == lam.shape == (0,)
    few = [request.Request(rid=i, arrival=a, input_len=4, output_len=o, token_times=[])
           for i, (a, o) in enumerate([(0.5, 10), (1.5, 20), (1.9, 30)])]
    starts, lam = simulator.ClusterSimulator.window_demand(few, 1.0)
    assert starts.tolist() == [0.0, 1.0] and lam.tolist() == [10.0, 50.0]


def test_spec_path_equals_scalar_path():
    """With ``spec=``, the token demand is ``expected_tokens_per_request``
    (equal to the reference's), and every record equals the scalar path's;
    neither given raises the reference's ``ValueError``."""
    spec = request.WorkloadSpec(mean_output=40.0, seed=11)
    ref_spec = ref_request.WorkloadSpec(mean_output=40.0, seed=11)
    tpr = request.expected_tokens_per_request(spec)
    assert tpr == ref_request.expected_tokens_per_request(ref_spec)
    sim = simulator.ClusterSimulator.__new__(simulator.ClusterSimulator)
    assert sim._tokens_per_req(None, spec) == tpr
    assert sim._tokens_per_req(256.0, None) == 256.0
    with pytest.raises(ValueError, match="tokens_per_req or a WorkloadSpec"):
        sim._tokens_per_req(None, None)
    sim, ref_sim = _sims(trace_tokens=512, trials=2, n_max=6)
    t, rates = trace.diurnal_rate_profile(hours=2, mean_rate=40.0, seed=3)
    by_spec = sim.run_policy(baselines.FixedUnitPolicy(), t, rates, spec=spec)
    _assert_results_equal(by_spec, sim.run_policy(baselines.FixedUnitPolicy(), t, rates, tokens_per_req=tpr))
    _assert_results_equal(by_spec, ref_sim.run_policy(ref_baselines.FixedUnitPolicy(), t, rates, spec=ref_spec))
    _assert_results_equal(sim.run_janus(t, rates, spec=spec), ref_sim.run_janus(t, rates, spec=ref_spec))
    with pytest.raises(ValueError, match="tokens_per_req or a WorkloadSpec"):
        sim.compare(t, rates)


@pytest.fixture(scope="module")
def scalers():
    sim, ref_sim = _sims(trace_tokens=512, trials=2, n_max=8)
    return scaling.SLOScaler(sim.model, n_max=8), ref_scaling.SLOScaler(ref_sim.model, n_max=8)


# token demands from idle to beyond any plan of 8 + 8 devices
DEMANDS = (1.0, 300.0, 3000.0, 12000.0, 40000.0, 1e9)


@pytest.mark.parametrize("policy", ["MonolithicPolicy", "CoupledPolicy", "FixedUnitPolicy"])
def test_policy_decisions_equal_reference(scalers, policy):
    sc, ref_sc = scalers
    pol, ref_pol = getattr(baselines, policy)(), getattr(ref_baselines, policy)()
    feasible = []
    for demand in DEMANDS:
        for slo in (0.05, 0.2):
            d = pol.decide(sc, demand, slo)
            want = ref_pol.decide(ref_sc, demand, slo)
            assert type(d) is baselines.PolicyDecision
            assert dataclasses.astuple(d) == dataclasses.astuple(want), (demand, slo)
            feasible.append(d.feasible)
    assert any(feasible) and not pol.decide(sc, 1e9, 0.05).feasible  # the last demand fits no plan


@pytest.mark.parametrize("name", ["dsv2-lite", "dsv2"])
def test_min_tier_equals_reference(name):
    """The monolithic memory floor: dsv2-lite fits the first tier, dsv2
    (236 B parameters in bf16) does not."""
    pm = scaling.PerfModel(get_config(name))
    ref_pm = ref_scaling.PerfModel(ref_get_config(name))
    sc, ref_sc = scaling.SLOScaler(pm), ref_scaling.SLOScaler(ref_pm)
    got = baselines.MonolithicPolicy().min_tier(sc)
    assert got == ref_baselines.MonolithicPolicy().min_tier(ref_sc)
    assert (got == 8) == (name == "dsv2-lite")


def test_janus_min_gpu_hours(profiles):
    """Fig. 11, restated on the port: Janus at full SLO attainment, at or
    below every baseline in GPU-hours."""
    res = profiles["compare"][0]
    assert res["janus"].slo_attainment == 1.0
    for name in ("sglang", "megascale", "xdeepserve"):
        assert res["janus"].gpu_hours <= res[name].gpu_hours + 1e-9, name


def test_janus_tracks_load(profiles):
    rates = profiles["rates2"]
    gpus = np.array([r.total_gpus for r in profiles["janus"][0].records])
    assert gpus.max() > gpus.min()
    q1, q3 = np.quantile(rates, [0.25, 0.75])
    assert gpus[rates >= q3].mean() >= gpus[rates <= q1].mean()
