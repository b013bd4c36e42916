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
import torch

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


@pytest.mark.parametrize("option", [dict(dispatch="ep")])
def test_engine_rejects_unported_options(option):
    """No option of the reference's engine is left unported: every one is
    accepted.  Expert-parallel dispatch needs a mesh, which the engine does
    not pass (the sharded steps of ``launch/steps.py`` run it), so with a
    replica layout its first decode step raises ``TypeError`` from
    ``moe_layer_ep``, as the reference's engine does; an unknown dispatch
    raises ``ValueError``."""
    from repro_torch.models import model

    cfg = get_config("dsv2-lite-reduced")
    params = model.init_params(cfg, seed=0, device="cpu")
    ServingEngine(cfg, params, device="cpu", executor="mono", admission="blocking",
                  sched="fifo", prefix_cache=False, spec_k=0, n_prefill=0, extra_builder=None)
    for ported in (dict(dispatch="einsum"), dict(dispatch="scatter"), dict(scheduler="random"),
                   dict(scheduler="token_hash"), option):
        ServingEngine(cfg, params, device="cpu", **ported)
    with pytest.raises(ValueError, match="unknown dispatch"):
        ServingEngine(cfg, params, device="cpu", dispatch="alltoall")
    layout = build_layout(make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0), cfg.num_experts, 2, 3)
    eng = ServingEngine(cfg, params, device="cpu", layout=layout, **dict(ENGINE_KW, **option))
    reqs = sample_requests(WorkloadSpec(vocab_size=cfg.vocab_size, **SPEC), np.zeros(2), True)
    with pytest.raises(TypeError, match="mesh"):
        eng.run(reqs, max_steps=50)


@pytest.mark.parametrize("name", ["whisper-tiny-reduced", "pixtral-12b-reduced"])
def test_engine_accepts_frontends(name):
    """An engine on the encoder-decoder or vision-patch family takes an
    ``extra_builder``: ``extra_builder(1)`` is called once and its tensors go
    with every prefill call; two requests are served to the end."""
    from repro_torch.models import model

    cfg = get_config(name)
    params = model.init_params(cfg, seed=0, device="cpu")
    key, rows = ("encoder_frames", cfg.encoder_seq) if cfg.encoder_layers else ("patch_embeds", cfg.num_patch_tokens)
    calls = []

    def builder(batch):
        calls.append(batch)
        return {key: torch.ones((batch, rows, cfg.d_model), dtype=cfg.torch_dtype)}

    eng = ServingEngine(cfg, params, max_batch=2, cache_len=64, scheduler="none", extra_builder=builder, device="cpu")
    assert calls == [1] and set(eng.prefill_worker.extra) == {key}
    spec = WorkloadSpec(mean_input=20, mean_output=4, vocab_size=cfg.vocab_size, max_input=24, max_output=4, seed=0)
    reqs = [r for r in sample_requests(spec, np.zeros(4), True) if r.input_len >= cfg.num_patch_tokens][:2]
    m = eng.run(reqs, max_steps=100)
    assert m["completed"] == len(reqs) == 2 and calls == [1]


@pytest.mark.parametrize("option", [
    dict(spec_k=2), dict(spec_k=-1, draft="same"), dict(spec_k=2, draft="wide_vocab"),
])
def test_engine_rejects_bad_speculation_as_reference(option):
    """Speculative decode is ported: ``spec_k > 0`` without a draft, a
    negative ``spec_k`` and a draft of another vocabulary each raise
    ``ValueError`` with the reference's message (``engine.py:284-313``)."""
    from repro_torch.models import model

    msgs = []
    for Engine, cfg, extra in ((ServingEngine, get_config("dsv2-lite-reduced"), dict(device="cpu")),
                               (RefEngine, ref_get_config("dsv2-lite-reduced"), {})):
        params = model.init_params(cfg, seed=0, device="cpu") if Engine is ServingEngine else None
        kw = dict(option)
        draft = kw.pop("draft", None)
        if draft is not None:
            kw["draft_config"] = cfg if draft == "same" else dataclasses.replace(cfg, vocab_size=2 * cfg.vocab_size)
        with pytest.raises(ValueError) as e:
            Engine(cfg, params, max_batch=2, cache_len=32, scheduler="none", **kw, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
