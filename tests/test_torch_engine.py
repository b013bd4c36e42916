"""The port's ServingEngine against the reference's on one workload:
``dsv2-lite-reduced``, mono executor, blocking admission, paged KV, AEBS.

Four slots keep the decode batch drop-free (an expert receives at most one
item per token, and the default capacity is 4), so every slot's stream is
independent of its neighbours' and the two engines serve the same schedule.
"""

import dataclasses

import jax
import numpy as np
import pytest

import repro_torch.models.model as port_model_mod
from _torch_parity import as_f32, assert_close, first_divergence, tol_for
from repro.configs import get_config as ref_get_config
from repro.core.placement import build_layout as ref_build_layout
from repro.models import model as ref_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import WorkloadSpec as RefSpec
from repro.serving.request import sample_requests as ref_sample_requests
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests

ENGINE_KW = dict(max_batch=4, cache_len=64, kv_page_size=16, prefill_chunk=16, scheduler="aebs")
# Workload seed 1: with seed 0, a router near-tie in bf16 sends one prompt
# token of request 0 to another expert, which moves that slot's first decode
# logits by 0.27 -- a discrete flip like a greedy-token flip, recorded in
# ROADMAP.md's queue 3.  float32 streams are equal under either seed.
SPEC = dict(mean_input=8, mean_output=10, max_input=24, max_output=16, seed=1)
N_REQ = 6


def _serve(dtype, monkeypatch):
    """Run both engines; returns per-engine (streams by rid, per-step logits
    of the active slots)."""
    ref_cfg = dataclasses.replace(ref_get_config("dsv2-lite-reduced"), dtype=dtype)
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype=dtype)
    ref_params = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    trace = make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0)
    layout = build_layout(trace, cfg.num_experts, 2, 3)
    arrivals = np.zeros(N_REQ)  # one burst: admission order is independent of wall time
    ref_reqs = ref_sample_requests(RefSpec(vocab_size=cfg.vocab_size, **SPEC), arrivals, True)
    reqs = sample_requests(WorkloadSpec(vocab_size=cfg.vocab_size, **SPEC), arrivals, True)
    for a, b in zip(ref_reqs, reqs):
        assert (a.input_len, a.output_len) == (b.input_len, b.output_len)
        np.testing.assert_array_equal(a.prompt, b.prompt)

    ref_eng = RefEngine(ref_cfg, ref_params,
                        layout=ref_build_layout(trace, cfg.num_experts, 2, 3), **ENGINE_KW)
    eng = ServingEngine(cfg, params, layout=layout, device="cpu", **ENGINE_KW)
    ref_logs, logs = [], []

    def recorder(fn, eng_, out):
        def wrapped(*args, **kw):
            res = fn(*args, **kw)
            out.append(as_f32(res[0])[eng_.slots.active_slots])
            return res
        return wrapped

    ref_eng._decode_jit = recorder(ref_eng._decode_jit, ref_eng, ref_logs)
    monkeypatch.setattr(port_model_mod, "decode_step",
                        recorder(port_model_mod.decode_step, eng, logs))
    m_ref = ref_eng.run(ref_reqs, max_steps=500)
    m = eng.run(reqs, max_steps=500)
    assert m["completed"] == m_ref["completed"] == N_REQ
    assert m["tokens"] == m_ref["tokens"]
    assert m["kv_pages"]["pages_peak"] == m_ref["kv_pages"]["pages_peak"]
    streams = {r.rid: r.tokens_out for r in eng.completed}
    ref_streams = {r.rid: r.tokens_out for r in ref_eng.completed}
    return (ref_streams, ref_logs), (streams, logs)


@pytest.mark.parametrize("seed", [0, 7])
def test_workload_sampling_matches_reference(seed):
    """Poisson arrivals and the requests drawn on them (lengths, prompts)
    equal the reference's for the same seed."""
    from repro.serving.trace import poisson_arrivals as ref_poisson_arrivals
    from repro_torch.serving.request import poisson_arrivals

    arrivals = poisson_arrivals(20.0, 2.0, seed=seed)
    np.testing.assert_array_equal(arrivals, ref_poisson_arrivals(20.0, 2.0, seed=seed))
    spec = dict(SPEC, seed=seed)
    ref_reqs = ref_sample_requests(RefSpec(vocab_size=512, **spec), arrivals, True)
    reqs = sample_requests(WorkloadSpec(vocab_size=512, **spec), arrivals, True)
    assert len(reqs) == len(ref_reqs) > 0
    for a, b in zip(ref_reqs, reqs):
        assert (a.rid, a.arrival, a.input_len, a.output_len) == (b.rid, b.arrival, b.input_len, b.output_len)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_engine_float32_streams_equal(monkeypatch):
    (ref_streams, _), (streams, _) = _serve("float32", monkeypatch)
    assert streams == ref_streams


def test_engine_bfloat16_logits_agree(monkeypatch, record_property):
    """bf16 rounds at other places in the two frameworks, so a near-tie may
    flip a greedy token.  Every step up to and including the first flip
    feeds both engines the same tokens, and its logits must agree within the
    bf16 tolerance; the flip (if any) is reported with its logit margin."""
    (ref_streams, ref_logs), (streams, logs) = _serve("bfloat16", monkeypatch)
    assert len(logs) == len(ref_logs)
    flip = None
    for step, (a, b) in enumerate(zip(logs, ref_logs)):
        assert_close(a, b, tol_for("bfloat16"))
        if (a.argmax(-1) != b.argmax(-1)).any():
            row = int(np.nonzero(a.argmax(-1) != b.argmax(-1))[0][0])
            top2 = np.sort(b[row])[-2:]
            flip = (step, row, float(top2[1] - top2[0]))
            break
    diverged = {rid: first_divergence(streams[rid], ref_streams[rid]) for rid in ref_streams}
    record_property("bf16_first_flip", flip)
    record_property("bf16_stream_divergence", diverged)
    print(f"bf16: first flip (step, row, reference top-2 margin) = {flip}; "
          f"first diverging token per request = {diverged}")
    if flip is None:
        assert all(d is None for d in diverged.values())


def test_engine_paged_equals_contiguous():
    """Inside the port, paged and contiguous KV serve identical streams (the
    reference's own invariant), through each layout's prefill hand-off."""
    from repro_torch.models import model

    cfg = get_config("dsv2-lite-reduced")
    params = model.init_params(cfg, seed=0, device="cpu")
    trace = make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0)
    layout = build_layout(trace, cfg.num_experts, 2, 3)
    runs = []
    for page in (16, None):
        kw = dict(ENGINE_KW, kv_page_size=page)
        eng = ServingEngine(cfg, params, layout=layout, device="cpu", **kw)
        m = eng.run(sample_requests(WorkloadSpec(vocab_size=cfg.vocab_size, **SPEC),
                                    np.zeros(N_REQ), True), max_steps=500)
        assert m["completed"] == N_REQ and ("kv_pages" in m) == (page is not None)
        runs.append({r.rid: r.tokens_out for r in eng.completed})
    assert runs[0] == runs[1]


@pytest.mark.parametrize("option", [
    dict(sched="priority"), dict(prefix_cache=True), dict(spec_k=2), dict(scheduler="random"),
])
def test_engine_rejects_unported_options(option):
    """Options of the reference's engine that later slices port raise
    instead of being ignored; their defaults are accepted."""
    from repro_torch.models import model

    cfg = get_config("dsv2-lite-reduced")
    params = model.init_params(cfg, seed=0, device="cpu")
    ServingEngine(cfg, params, device="cpu", executor="mono", admission="blocking",
                  sched="fifo", prefix_cache=False, spec_k=0, n_prefill=0)
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, params, device="cpu", **option)
