"""The port's trace-replay workload file and SLO accounting
(``repro_torch.serving.trace``, the SLO fields of
``repro_torch.serving.request.Request``, ``metrics()["slo"]``) against the
reference's.

Arrival processes equal the reference's for the same seeds, a
:class:`TraceSpec` builds the reference's requests field by field (arrivals
exact) and its JSON loads in either package; ``tpot_p``, the wait-span split
and ``slo_ok`` give the reference's answers, and ``metrics()["slo"]`` over
mixed terminal states and over a served two-tenant trace equals the
reference's.  JAX and ``repro`` are imported inside the tests: the card's
machine, which runs the ``gpu`` test, has no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.models import model as model_mod
from repro_torch.models.common import tree_to
from repro_torch.serving import request, trace
from repro_torch.serving.engine import ServingEngine

CPU = torch.device("cpu")
# the fields a built request is compared on (arrival, lengths, prompt, SLO contract)
FIELDS = ("rid", "arrival", "input_len", "output_len", "deadline", "tenant", "klass", "priority", "ttft_slo",
          "tpot_slo")
# a two-tenant trace the reduced engine serves: a chat tenant with SLOs at
# priority 5 over a batch tenant; lengths cut to the 64-row cache
SERVE_KW = dict(max_batch=2, cache_len=64, scheduler="aebs", kv_page_size=16, sched="priority",
                step_time_fn=lambda n: 2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny ops (restored afterwards):
    test workers sharing the machine's cores would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(mod):
    """Trace specs on one side: tests/test_trace.py's two tenants (bursty
    chat with SLOs and a deadline, Poisson batch with overrides), a diurnal
    long-context tenant, and the served trace."""
    T = mod.TenantSpec
    short = dict(mean_input=6.0, max_input=12, mean_output=10.0, max_output=16)
    return {
        "two_tenants": mod.TraceSpec(duration=5.0, seed=3, tenants=[
            T(name="chat", klass="chat", rate=4.0, arrival="bursty", priority=5, ttft_slo=0.05, tpot_slo=0.01,
              deadline=2.0),
            T(name="batch", klass="batch-offline", rate=2.0, arrival="poisson", priority=0,
              workload=dict(mean_output=32.0, max_output=64))]),
        "diurnal": mod.TraceSpec(duration=10.0, seed=1, tenants=[
            T(name="d", klass="long-context", rate=3.0, arrival="diurnal",
              workload=dict(max_input=64, mean_input=16.0))]),
        "served": mod.TraceSpec(duration=0.06, seed=5, tenants=[
            T(name="batch", klass="batch-offline", rate=60.0, priority=0, ttft_slo=1.0,
              workload=dict(short, mean_output=20.0, max_output=24), seed=11),
            T(name="chat", klass="chat", rate=60.0, arrival="bursty", epoch=0.02, priority=5, ttft_slo=0.01,
              tpot_slo=0.004, workload=short)]),
    }


def _fields(reqs):
    return [tuple(getattr(r, f) for f in FIELDS) + (None if r.prompt is None else r.prompt.tolist(),)
            for r in reqs]


# ---------------------------------------------------------------------------
# (i) arrival processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 17, 2**31 - 5])
def test_arrival_processes_equal_reference(seed):
    from repro.serving import trace as ref_trace

    for got, want in (
        (trace.poisson_arrivals(37.5, 6.0, seed=seed), ref_trace.poisson_arrivals(37.5, 6.0, seed=seed)),
        (trace.bursty_arrivals(12.0, 40.0, burstiness=3.5, epoch=5.0, seed=seed),
         ref_trace.bursty_arrivals(12.0, 40.0, burstiness=3.5, epoch=5.0, seed=seed)),
        (trace.bursty_arrivals(0.5, 3.0, seed=seed), ref_trace.bursty_arrivals(0.5, 3.0, seed=seed)),
    ):
        np.testing.assert_array_equal(got, want)
    t, rates = trace.diurnal_rate_profile(hours=2.0, step_minutes=10.0, mean_rate=5.0, seed=seed)
    rt, rrates = ref_trace.diurnal_rate_profile(hours=2.0, step_minutes=10.0, mean_rate=5.0, seed=seed)
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_array_equal(rates, rrates)
    np.testing.assert_array_equal(trace.arrivals_from_profile(t, rates, seed=seed),
                                  ref_trace.arrivals_from_profile(rt, rrates, seed=seed))
    # the old import path of poisson_arrivals still works
    np.testing.assert_array_equal(request.poisson_arrivals(37.5, 6.0, seed=seed),
                                  ref_trace.poisson_arrivals(37.5, 6.0, seed=seed))


def test_class_presets_and_workload_helpers_equal_reference():
    from repro.serving import request as ref_request
    from repro.serving import trace as ref_trace

    assert trace.CLASS_PRESETS == ref_trace.CLASS_PRESETS and trace.ARRIVAL_PROCESSES == ref_trace.ARRIVAL_PROCESSES
    assert dataclasses.asdict(request.long_prompt_spec(seed=2)) == dataclasses.asdict(
        ref_request.long_prompt_spec(seed=2))
    for spec in (request.WorkloadSpec(seed=5), request.long_prompt_spec(), request.shared_prefix_spec()):
        ref_spec = ref_request.WorkloadSpec(**dataclasses.asdict(spec))
        assert request.expected_tokens_per_request(spec, 512) == ref_request.expected_tokens_per_request(ref_spec,
                                                                                                         512)


# ---------------------------------------------------------------------------
# (ii) the workload file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["two_tenants", "diurnal", "served"])
@pytest.mark.parametrize("with_prompts", [False, True])
def test_trace_spec_build_equals_reference(name, with_prompts):
    """``build`` draws the reference's merged request list, field by field
    (arrivals, lengths, prompts, tenant, priority, SLOs, deadlines)."""
    from repro.serving import trace as ref_trace

    got = _specs(trace)[name].build(vocab_size=1000, with_prompts=with_prompts)
    want = _specs(ref_trace)[name].build(vocab_size=1000, with_prompts=with_prompts)
    assert got and _fields(got) == _fields(want)
    assert [r.rid for r in got] == list(range(len(got)))


def test_trace_json_loads_across_packages():
    from repro.serving import trace as ref_trace

    for name, spec in _specs(trace).items():
        ref_spec = _specs(ref_trace)[name]
        assert spec.to_json() == ref_spec.to_json()
        assert trace.TraceSpec.from_json(ref_spec.to_json()) == spec
        assert ref_trace.TraceSpec.from_json(spec.to_json()) == ref_spec


def test_trace_validation_equals_reference():
    from repro.serving import trace as ref_trace

    for call in (lambda m: m.TenantSpec(name="x", klass="nope").workload_spec(100, 0),
                 lambda m: m.TenantSpec(name="x", arrival="nope").arrivals(1.0, 0)):
        with pytest.raises(ValueError) as got:
            call(trace)
        with pytest.raises(ValueError) as want:
            call(ref_trace)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# (iii) per-request SLO accounting
# ---------------------------------------------------------------------------

# tests/test_trace.py's cases: Request fields -> (decode gaps, tpot_p at 0 /
# 50 / 99 / 100, ttft, slo_ok) on each side
REQ_CASES = [
    dict(token_times=None), dict(token_times=[]), dict(token_times=[0.5]),
    dict(token_times=[0.0, 0.1, 0.3]),
    dict(token_times=[0.0, 0.1, 0.6], wait_spans=[(0.1, 0.5)]),
    dict(token_times=[0.0, 0.1, 0.6], tpot_slo=0.2, prefill_done=0.0),
    dict(token_times=[0.0, 0.1, 0.6], wait_spans=[(0.1, 0.5)], tpot_slo=0.2, prefill_done=0.0),
    dict(token_times=[0.0, 0.3], wait_spans=[(0.0, 0.4)]),
    dict(token_times=[1.0, 1.2], wait_spans=[(0.0, 0.5)]),
    dict(token_times=[0.0, 0.2, 0.3, 0.9, 1.0], wait_spans=[(0.3, 0.8), (0.05, 0.1)], tpot_slo=0.25,
         prefill_done=0.0),
    dict(ttft_slo=0.1), dict(ttft_slo=0.1, rejected=True),
    dict(ttft_slo=0.1, prefill_done=0.05, token_times=[0.05]), dict(ttft_slo=0.1, prefill_done=0.2),
    dict(tpot_slo=0.01, prefill_done=0.0, token_times=[0.0, 0.5]),
]


def _slo_answers(R, kw):
    r = R(rid=0, arrival=0.0, input_len=4, output_len=8, **kw)
    return (r.decode_gaps().tolist(), [r.tpot_p(q) for q in (0.0, 50.0, 99.0, 100.0)], r.ttft(), r.slo_ok())


@pytest.mark.parametrize("case", range(len(REQ_CASES)))
def test_request_slo_accounting_equals_reference(case):
    from repro.serving.request import Request as RefRequest

    got = _slo_answers(request.Request, REQ_CASES[case])
    assert got == _slo_answers(RefRequest, REQ_CASES[case])
    if case == 4:
        assert got[0] == pytest.approx([0.1, 0.1])  # the 0.5 s gap less its 0.4 s wait
    if case in (5, 6):
        assert got[3] is (case == 6)  # the wait split keeps the TPOT SLO


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


def _terminal_mix(R):
    """tests/test_trace.py's mix: two completed chat requests (one preempted,
    one truncated) and a rejected batch request, each with a TTFT target."""
    def req(**kw):
        base = dict(rid=0, arrival=0.0, input_len=4, output_len=8, token_times=[])
        base.update(kw)
        return R(**base)

    done = [req(rid=0, generated=4, finished=1.0, prefill_done=0.1, token_times=[0.1, 0.2, 0.3, 0.4, 0.5],
                ttft_slo=0.5, tenant="chat", preemptions=1, wait_spans=[(0.2, 0.25)]),
            req(rid=1, generated=2, finished=1.2, prefill_done=0.9, token_times=[0.9, 1.0, 1.2], ttft_slo=0.5,
                tenant="chat", truncated=True)]
    rej = req(rid=2, ttft_slo=0.5, tenant="batch", rejected=True, finished=0.4)
    return done, [rej]


def test_metrics_slo_over_mixed_terminal_states_equals_reference(setup):
    from repro.serving.engine import ServingEngine as RefEngine
    from repro.serving.request import Request as RefRequest

    kw = dict(max_batch=2, cache_len=64, scheduler="none", step_time_fn=lambda n: 1e-3)
    sides = []
    for eng, R in ((ServingEngine(setup["cfg"], setup["params"], device=CPU, **kw), request.Request),
                   (RefEngine(setup["ref_cfg"], setup["ref_params"], **kw), RefRequest)):
        out = []
        for mix in (_terminal_mix(R), ([R(rid=0, arrival=0.0, input_len=4, output_len=8, generated=1,
                                          finished=0.2, prefill_done=0.1, token_times=[0.1, 0.2])], [])):
            eng.completed, eng.rejected = mix
            eng.preempt_count, eng.restore_count = len(mix[1]) * 2, len(mix[1])
            m = eng.metrics()
            out.append({k: m.get(k) for k in ("completed", "tokens", "truncated", "rejected", "preemptions",
                                               "restores", "slo", "ttft_mean", "tpot_mean", "tpot_p99")})
        sides.append(out)
    assert sides[0] == sides[1]
    slo = sides[0][0]["slo"]
    assert slo["measured"] == 3 and slo["attained"] == 1 and slo["per_tenant"] == {"batch": 0.0, "chat": 0.5}
    assert sides[0][1]["slo"] is None and sides[0][1]["preemptions"] == 0


def _serve(engine, spec_mod, cfg):
    reqs = _specs(spec_mod)["served"].build(vocab_size=cfg.vocab_size, with_prompts=True)
    m = engine.run(reqs, max_steps=4000)
    return dict(streams={r.rid: list(r.tokens_out) for r in engine.completed},
                **{k: m.get(k) for k in ("completed", "rejected", "preemptions", "restores", "slo", "kv_pages")},
                ttft={r.rid: r.ttft() for r in engine.completed})


def test_two_tenant_trace_served_equals_reference(setup):
    """The served trace (batch tenant first, a chat burst with SLOs at
    priority 5), built by each package and served on mono paged KV under
    ``sched="priority"``: streams, preemptions, SLO attainment and pages
    equal the reference's, and the streams equal FIFO's."""
    from repro.serving import trace as ref_trace
    from repro.serving.engine import ServingEngine as RefEngine

    got = _serve(ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device=CPU, **SERVE_KW),
                 trace, setup["cfg"])
    want = _serve(RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], **SERVE_KW),
                  ref_trace, setup["ref_cfg"])
    fifo = _serve(ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device=CPU,
                                **dict(SERVE_KW, sched="fifo")), trace, setup["cfg"])
    assert got == want
    assert got["completed"] >= 4 and got["preemptions"] >= 1 and got["restores"] == got["preemptions"]
    assert got["streams"] == fifo["streams"] and set(got["slo"]["per_tenant"]) == {"batch", "chat"}
    assert got["slo"]["per_tenant"]["chat"] >= fifo["slo"]["per_tenant"]["chat"]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_trace_served_on_card_matches_cpu(cuda_device):
    """The two-tenant trace served on the card's kernels: streams, counts
    and SLO attainment equal the plain versions' on the CPU (modeled clock)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    layout = ReplicaLayout.round_robin(cfg.num_experts, 2, 3)
    sides = [_serve(ServingEngine(cfg, tree_to(params, dev), layout=layout, device=dev, **SERVE_KW), trace, cfg)
             for dev in (CPU, cuda_device)]
    assert sides[0] == sides[1] and sides[1]["preemptions"] >= 1
