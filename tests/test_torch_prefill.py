"""The port's prefill pool (``repro_torch.serving.prefill``), pipelined and
batched admission, whole-prompt prefill and the AutoScaler's actuation
against the reference's, on ``dsv2-lite-reduced`` in float32 unless a test
says otherwise.

Weights are drawn by the reference and carried across exactly.  Batched
prefill is held against serial prefill inside the port, and whole-prompt
prefill against the reference's, within ``TOL["f32_layer"]``; engine
streams token for token.  JAX and ``repro`` are imported inside the tests:
the card's machine, which runs the ``gpu`` test, has no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import TOL, as_f32, assert_close
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.core.scaling import EvalResult, PerfModel
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.serving.controller import AutoScaler
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests

CPU = torch.device("cpu")
CACHE_LEN = 64
# the engine workload of tests/test_torch_disagg.py, prompts in 4-token chunks
ENGINE_KW = dict(max_batch=4, cache_len=CACHE_LEN, prefill_chunk=4, scheduler="aebs", capacity_tokens=64)
SPEC = dict(mean_input=8, mean_output=10, max_input=24, max_output=16, seed=1)
N_REQ = 6
# modeled clocks (seconds): a decode step by active slots, a prefill call by tokens
STEP_TIME = lambda b: 0.01 + 0.002 * b  # noqa: E731
PREFILL_TIME = lambda n: 0.001 * n  # noqa: E731


def _cfgs(kv_quant=False):
    from repro.configs import get_config as ref_get_config

    ref = dataclasses.replace(ref_get_config("dsv2-lite-reduced"), dtype="float32", kv_quant=kv_quant)
    return ref, dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32", kv_quant=kv_quant)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny ops: test workers that
    share the machine's cores would otherwise oversubscribe them many
    times over (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    import jax

    from repro.core.placement import build_layout as ref_build_layout
    from repro.models import model as ref_model

    ref_cfg, cfg = _cfgs()
    ref_params = ref_model.init_params(ref_cfg, 0)
    trace = make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0)
    return dict(
        ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
        params=bridge.params_from_jax(jax.tree.map(np.asarray, ref_params)),
        ref_layout=ref_build_layout(trace, cfg.num_experts, 2, 3),
        layout=build_layout(trace, cfg.num_experts, 2, 3),
    )


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int64)


# ---------------------------------------------------------------------------
# models: attention_full, the vector-start chunk, prefill, batched chunks
# ---------------------------------------------------------------------------


def _ref_layer0_attn(setup):
    """Layer 0's attention weights of the reference's period-stacked tree."""
    return {k: v[0] for k, v in setup["ref_params"]["blocks"]["pos0"]["attn"].items()}


def test_attention_full_equals_reference(setup):
    import jax.numpy as jnp

    from repro.models import attention as ref_attn

    cfg, lp = setup["cfg"], setup["params"]["layers"][0]["attn"]
    x = np.random.default_rng(0).standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    y, (k, v) = attn_mod.attention_full(lp, torch.from_numpy(x), cfg, return_kv=True)
    ref_y, (ref_k, ref_v) = ref_attn.attention_full(_ref_layer0_attn(setup), jnp.asarray(x), setup["ref_cfg"],
                                                    return_kv=True)
    for got, want in ((y, ref_y), (k, ref_k), (v, ref_v)):
        assert_close(got, np.asarray(want), TOL["f32_op"])
    assert torch.equal(attn_mod.attention_full(lp, torch.from_numpy(x), cfg), y)




@pytest.mark.parametrize("kv_quant", [False, True])
def test_vector_start_chunk_equals_reference(setup, kv_quant):
    """Rows at their own starts and lengths (one row of padding only) write
    and attend as the reference's vector-start branch: outputs of valid rows,
    caches and scales."""
    import jax.numpy as jnp

    from repro.models import attention as ref_attn

    ref_cfg, cfg = _cfgs(kv_quant)
    b, c, S = 3, 6, 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, c, cfg.d_model)).astype(np.float32)
    starts, lengths = np.array([0, 5, 20], np.int32), np.array([6, 3, 1], np.int32)
    specs = model_mod.init_decode_caches(cfg, b, S, "cpu")
    caches = {k: v[0] for k, v in specs.items()}
    if kv_quant:
        caches["kv_k"] = torch.from_numpy(rng.integers(-127, 128, caches["kv_k"].shape).astype(np.int8))
        caches["kv_v"] = torch.from_numpy(rng.integers(-127, 128, caches["kv_v"].shape).astype(np.int8))
        caches["kv_k_scale"] = torch.from_numpy(rng.uniform(0.001, 0.01, caches["kv_k_scale"].shape).astype(np.float32))
        caches["kv_v_scale"] = torch.from_numpy(rng.uniform(0.001, 0.01, caches["kv_v_scale"].shape).astype(np.float32))
    else:
        caches["kv_k"] = torch.from_numpy(rng.standard_normal(caches["kv_k"].shape).astype(np.float32))
        caches["kv_v"] = torch.from_numpy(rng.standard_normal(caches["kv_v"].shape).astype(np.float32))
    ref_in = {k: jnp.asarray(v.numpy()) for k, v in caches.items()}
    scales = dict(k_scale=caches.get("kv_k_scale"), v_scale=caches.get("kv_v_scale"))
    got = attn_mod.attention_prefill_chunk(
        setup["params"]["layers"][0]["attn"], torch.from_numpy(x), caches["kv_k"], caches["kv_v"],
        torch.from_numpy(starts), cfg, lengths=torch.from_numpy(lengths), **scales)
    ref_scales = dict(k_scale=ref_in.get("kv_k_scale"), v_scale=ref_in.get("kv_v_scale"))
    want = ref_attn.attention_prefill_chunk(
        _ref_layer0_attn(setup), jnp.asarray(x), ref_in["kv_k"], ref_in["kv_v"], jnp.asarray(starts),
        ref_cfg, lengths=jnp.asarray(lengths), **ref_scales)
    valid = np.arange(c)[None, :] < lengths[:, None]
    assert_close(as_f32(got[0])[valid], np.asarray(want[0])[valid], TOL["f32_op"])
    if kv_quant:  # the chunk's own rows: one int8 step at most (ROADMAP.md §3)
        for g, w in zip(got[1:3], want[1:3]):
            assert np.abs(as_f32(g) - np.asarray(w, np.float32)).max() <= 1
        for g, w in zip(got[3:], want[3:]):
            assert_close(g, np.asarray(w), TOL["f32_op"])
    else:
        for g, w in zip(got[1:], want[1:]):
            assert_close(g, np.asarray(w), TOL["f32_op"])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_equals_reference(setup, kv_quant):
    """Whole-prompt prefill: last-token logits within TOL["f32_layer"], caches
    (float32) within it too, int8 caches within one step and their scales
    within TOL["f32_op"]."""
    import jax.numpy as jnp

    from repro.models import model as ref_model

    ref_cfg, cfg = _cfgs(kv_quant)
    toks = _tokens((2, 21), 0, cfg.vocab_size)
    logits, caches = model_mod.prefill(setup["params"], torch.from_numpy(toks), cfg, CACHE_LEN,
                                       extra={"moe_ctx": {"capacity": toks.size}})
    ref_logits, ref_caches = ref_model.prefill(
        setup["ref_params"], jnp.asarray(toks.astype(np.int32)), ref_cfg, CACHE_LEN,
        extra={"moe_ctx": {"capacity": toks.size, "dispatch": "grouped"}})
    assert_close(logits, np.asarray(ref_logits), TOL["f32_layer"])
    assert sorted(caches) == sorted(ref_caches)
    for k, v in caches.items():
        assert v.shape == ref_caches[k].shape
        if v.dtype == torch.int8:
            assert np.abs(as_f32(v) - np.asarray(ref_caches[k], np.float32)).max() <= 1
        else:
            assert_close(v, np.asarray(ref_caches[k]), TOL["f32_op"] if "scale" in k else TOL["f32_layer"])
    assert model_mod.supports_batched_prefill(cfg)


def _serial(params, cfg, prompts, chunk):
    out = []
    for pr in prompts:
        c = model_mod.init_decode_caches(cfg, 1, CACHE_LEN, "cpu")
        for lo in range(0, len(pr), chunk):
            hi = min(lo + chunk, len(pr))
            lg, c = model_mod.prefill_chunk(params, torch.from_numpy(pr[lo:hi][None]), c, lo, cfg,
                                            extra={"moe_ctx": {"capacity": hi - lo}})
        out.append((lg[0], c))
    return out


def _batched(params, cfg, prompts, chunk, prefill_fn, call_cfg=None):
    """The worker's schedule: every unfinished prompt's next chunk in one
    padded call (``prefill_fn`` with ``call_cfg``, default ``cfg``), until
    all are done.  Returns each prompt's (last logits, caches)."""
    n = len(prompts)
    caches = model_mod.init_decode_caches(cfg, n, CACHE_LEN, "cpu")
    done, out = [0] * n, [None] * n
    while any(d < len(p) for d, p in zip(done, prompts)):
        rows = [i for i in range(n) if done[i] < len(prompts[i])]
        his = [min(done[i] + chunk, len(prompts[i])) for i in rows]
        lens = [h - done[i] for h, i in zip(his, rows)]
        toks = np.zeros((len(rows), max(lens)), np.int64)
        for j, i in enumerate(rows):
            toks[j, : lens[j]] = prompts[i][done[i] : his[j]]
        sub = {k: v[:, rows].clone() for k, v in caches.items()}
        starts = np.array([done[i] for i in rows])
        lg, sub = prefill_fn(params, toks, sub, starts, np.array(lens), call_cfg or cfg,
                             extra={"moe_ctx": {"capacity": toks.size}})
        for j, i in enumerate(rows):
            for k in caches:
                caches[k][:, i] = torch.as_tensor(np.array(sub[k][:, j]))
            done[i] = his[j]
            if done[i] >= len(prompts[i]):
                out[i] = torch.as_tensor(np.array(lg[j]))
    return [(out[i], {k: v[:, i : i + 1] for k, v in caches.items()}) for i in range(n)]


def _port_batched(params, toks, sub, starts, lens, cfg, extra):
    return model_mod.prefill_chunk_batched(params, torch.from_numpy(toks), sub, torch.from_numpy(starts),
                                           torch.from_numpy(lens), cfg, extra=extra)


@pytest.mark.parametrize("lens,chunk,kv_quant", [
    ((21, 7), 8, False), ((21, 7, 16), 16, False), ((12, 12), 16, False), ((30, 3, 14), 4, True),
    ((17, 3, 9), 4, False),
])
def test_prefill_chunk_batched_matches_serial(setup, lens, chunk, kv_quant, record_property):
    """Prompts packed into padded chunk calls give every prompt the logits
    and KV caches of serial chunks, within TOL["f32_layer"] with the same
    argmax.  Not bitwise in general: torch's float32 CPU matrix product
    rounds a row by its place in the product's row blocking, and a one-row
    product is a matrix-vector product (ROADMAP.md §3); the count of
    bitwise-equal prompts is recorded."""
    _, cfg = _cfgs(kv_quant)
    prompts = [_tokens(n, 3 + i, cfg.vocab_size) for i, n in enumerate(lens)]
    bitwise = 0
    for (lg, c), (slg, sc) in zip(_batched(setup["params"], cfg, prompts, chunk, _port_batched),
                                  _serial(setup["params"], cfg, prompts, chunk)):
        assert_close(lg, slg, TOL["f32_layer"])
        assert int(lg.argmax()) == int(slg.argmax())
        for k in sc:
            if sc[k].dtype == torch.int8:
                assert np.abs(as_f32(c[k]) - as_f32(sc[k])).max() <= 1
            else:
                assert_close(c[k], sc[k], TOL["f32_layer"])
        bitwise += torch.equal(lg, slg) and all(torch.equal(c[k], sc[k]) for k in sc)
    record_property("bitwise_equal_prompts", f"{bitwise} of {len(lens)}")


def test_prefill_chunk_batched_equals_reference(setup):
    import jax.numpy as jnp

    from repro.models import model as ref_model

    def ref_batched(params, toks, sub, starts, lens, cfg, extra):
        return ref_model.prefill_chunk_batched(
            params, jnp.asarray(toks.astype(np.int32)), {k: jnp.asarray(v.numpy()) for k, v in sub.items()},
            jnp.asarray(starts.astype(np.int32)), jnp.asarray(lens.astype(np.int32)), cfg,
            extra={"moe_ctx": dict(extra["moe_ctx"], dispatch="grouped")})

    cfg = setup["cfg"]
    prompts = [_tokens(n, 11 + i, cfg.vocab_size) for i, n in enumerate((13, 6))]
    got = _batched(setup["params"], cfg, prompts, 8, _port_batched)
    want = _batched(setup["ref_params"], cfg, prompts, 8, ref_batched, call_cfg=setup["ref_cfg"])
    for (lg, c), (wlg, wc) in zip(got, want):
        assert_close(lg, wlg, TOL["f32_layer"])
        for k in c:
            assert_close(c[k], wc[k], TOL["f32_layer"])


# ---------------------------------------------------------------------------
# the engine: admission modes, whole-prompt fallback, pool resizes
# ---------------------------------------------------------------------------


def _requests(cfg, ref=False, seed=SPEC["seed"], n=N_REQ, rid0=0):
    spec = dict(SPEC, seed=seed, vocab_size=cfg.vocab_size)
    if ref:
        from repro.serving.request import WorkloadSpec as RefSpec
        from repro.serving.request import sample_requests as ref_sample_requests

        reqs = ref_sample_requests(RefSpec(**spec), np.zeros(n), True)
    else:
        reqs = sample_requests(WorkloadSpec(**spec), np.zeros(n), True)
    for r in reqs:
        r.rid += rid0
    return reqs


def _engines(setup, **kw):
    from repro.serving.engine import ServingEngine as RefEngine

    kw = dict(ENGINE_KW, **kw)
    return (RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], **kw),
            ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device="cpu", **kw))


@pytest.fixture(scope="module")
def blocking_streams(setup):
    eng = ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device="cpu", **ENGINE_KW)
    eng.run(_requests(setup["cfg"]), max_steps=500)
    assert eng.admission == "blocking" and eng.metrics()["decode_stall_time"] > 0
    return {r.rid: r.tokens_out for r in eng.completed}


def _check_admission(eng, m, kw, want):
    assert m["completed"] == N_REQ and {r.rid: r.tokens_out for r in eng.completed} == want
    assert eng.admission == kw.get("admission", "pipelined" if kw.get("n_prefill") else "blocking")
    if eng.admission == "pipelined":
        assert m["decode_stall_time"] == 0.0 and m["ttft_mean"] > 0
    assert m["prefill_chunks"] >= N_REQ  # prompts really went chunk-wise
    assert len(eng.prefill_worker.devices) == max(1, kw.get("n_prefill", 0))


@pytest.mark.parametrize("name,kw", [
    ("mono_batched", dict(n_prefill=1, prefill_batch=2)),
    ("disagg_batched_modeled", dict(executor="disagg", n_attn=2, n_prefill=2, prefill_batch=2,
                                    kv_page_size=16, step_time_fn=STEP_TIME, prefill_time_fn=PREFILL_TIME)),
])
def test_engine_admission_streams_equal_reference(setup, blocking_streams, name, kw):
    """Pipelined and batched admission serve, token for token, the
    reference's engine with the same options and the port's blocking mono
    streams (the port of ``tests/test_disagg.py:294``); the decode clock is
    never charged under pipelined admission.  On the wall clock the schedule
    follows each machine's speed; under modeled clocks it is the
    reference's, and so are ``amax_log`` and the clock's metrics."""
    ref_eng, eng = _engines(setup, **kw)
    m_ref = ref_eng.run(_requests(setup["cfg"], ref=True), max_steps=500)
    m = eng.run(_requests(setup["cfg"]), max_steps=500)
    _check_admission(eng, m, kw, {r.rid: r.tokens_out for r in ref_eng.completed})
    _check_admission(eng, m, kw, blocking_streams)
    assert (eng.admission, m["prefill_chunks"]) == (ref_eng.admission, m_ref["prefill_chunks"])
    if eng.disagg is not None:
        assert eng.disagg.disagg_cfg.describe() == ref_eng.disagg.disagg_cfg.describe()
    if "step_time_fn" in kw:
        assert eng.amax_log == ref_eng.amax_log and eng.steps_done == ref_eng.steps_done
        for key in ("clock", "ttft_mean", "tpot_mean", "throughput_tok_s"):
            assert m[key] == pytest.approx(m_ref[key], rel=1e-12), key


@pytest.mark.parametrize("name,kw", [
    ("mono_pipelined", dict(n_prefill=1)),
    ("disagg_pipelined", dict(executor="disagg", n_attn=2, n_prefill=1)),
    ("mono_pipelined_paged", dict(n_prefill=2, kv_page_size=16)),
    ("mono_batched_paged", dict(n_prefill=1, prefill_batch=3, kv_page_size=16)),
    ("disagg_blocking_prefill_pool", dict(executor="disagg", n_attn=2, n_prefill=1, admission="blocking")),
    ("disagg_batched_pingpong", dict(executor="disagg", n_attn=2, n_prefill=1, prefill_batch=2,
                                     ping_pong=True, max_batch=6)),
])
def test_engine_admission_streams_equal_blocking(setup, blocking_streams, name, kw):
    """More admission and pool shapes, inside the port: the streams of the
    blocking mono engine."""
    eng = ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device="cpu",
                        **dict(ENGINE_KW, **kw))
    _check_admission(eng, eng.run(_requests(setup["cfg"]), max_steps=500), kw, blocking_streams)


@pytest.mark.parametrize("kw", [dict(executor="disagg", n_attn=2, n_prefill=1), dict(), dict(kv_page_size=16)])
def test_engine_whole_prompt_fallback(setup, blocking_streams, kw):
    """A stack that cannot chunk prefills each prompt in one whole-prompt
    call (``prefill``, held against the reference's above) and hands the
    whole cache over (``length == -1``): forced here, each sink (disagg,
    mono contiguous, mono paged) serves the chunked streams."""
    eng = ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device="cpu",
                        **dict(ENGINE_KW, **kw))
    eng.prefill_worker.chunked = False
    m = eng.run(_requests(setup["cfg"]), max_steps=500)
    streams = {r.rid: r.tokens_out for r in eng.completed}
    assert m["completed"] == N_REQ and m["prefill_chunks"] == 0 and streams == blocking_streams


def test_engine_prefill_queue_bound(setup, blocking_streams):
    """``max_prefill_queue`` holds admission back (one prompt in flight) and
    changes no stream; a zero bound is refused with the reference's message."""
    ref_eng, eng = _engines(setup, n_prefill=1, max_prefill_queue=1)
    pending = []
    poll = eng.prefill_worker.poll

    def watched(sink):
        pending.append(eng.prefill_worker.num_pending)
        return poll(sink)

    eng.prefill_worker.poll = watched
    eng.run(_requests(setup["cfg"]), max_steps=500)
    assert max(pending) == 1
    assert {r.rid: r.tokens_out for r in eng.completed} == blocking_streams
    with pytest.raises(ValueError) as err:
        _engines(setup, max_prefill_queue=0)
    assert "max_prefill_queue must be" in str(err.value)
    with pytest.raises(ValueError, match="unknown admission mode"):
        ServingEngine(setup["cfg"], setup["params"], device="cpu", admission="eager")


def test_worker_several_chunks_per_poll(setup, blocking_streams):
    """``max_chunks_per_poll`` lets a device run several chunks a poll; the
    streams do not change."""
    eng = ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device="cpu", n_prefill=1,
                        **ENGINE_KW)
    eng.prefill_worker.max_chunks_per_poll = 3
    poll, per_poll = eng.prefill_worker.poll, []

    def counted(sink):
        before = eng.prefill_worker.chunks_done
        out = poll(sink)
        per_poll.append(eng.prefill_worker.chunks_done - before)
        return out

    eng.prefill_worker.poll = counted
    eng.run(_requests(setup["cfg"]), max_steps=500)
    assert max(per_poll) == 3
    assert {r.rid: r.tokens_out for r in eng.completed} == blocking_streams


def test_worker_resize_mid_prefill_keeps_progress(setup, blocking_streams):
    """Resizing the prefill pool between chunks moves in-flight prompts with
    their caches: progress is kept and the streams do not change."""
    eng = ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device="cpu",
                        executor="disagg", n_attn=2, n_prefill=2, prefill_batch=2, **ENGINE_KW)
    poll = eng.prefill_worker.poll
    seen = {}

    def resizing(sink):
        if eng.prefill_worker.chunks_done >= 3 and not seen:
            seen["done"] = {id(e): e.done for g in eng.prefill_worker._current for e in g}
            assert any(seen["done"].values())
            assert eng.reconfigure(n_prefill=1) == {"attn": False, "moe": False, "prefill": True}
            assert {id(e): e.done for g in eng.prefill_worker._current for e in g} | {
                id(e): e.done for e in eng.prefill_worker._queue} == seen["done"] | {
                id(e): e.done for e in eng.prefill_worker._queue}
        return poll(sink)

    eng.prefill_worker.poll = resizing
    eng.run(_requests(setup["cfg"]), max_steps=500)
    assert seen and len(eng.prefill_worker.devices) == len(eng.prefill_worker.busy_until) == 1
    assert {r.rid: r.tokens_out for r in eng.completed} == blocking_streams


def test_engine_reconfigure_prefill_pool(setup):
    """The port of the reference's ``test_engine_reconfigure_prefill_pool``
    (``tests/test_disagg.py:322``): a prefill-pool resize moves only that
    pool, the AutoScaler sizes it from prompt demand, and every ``relower``
    dict and served stream equals the reference's."""
    from repro.core.scaling import EvalResult as RefEvalResult
    from repro.core.scaling import PerfModel as RefPerfModel
    from repro.serving.controller import AutoScaler as RefAutoScaler

    engines = _engines(setup, executor="disagg", n_attn=2, n_prefill=1)
    ctrls = (RefAutoScaler(RefPerfModel(setup["ref_cfg"], slots_per_instance=3, s_ctx=64), slo=0.2,
                           prefill_tok_rate=100.0),
             AutoScaler(PerfModel(setup["cfg"], slots_per_instance=3, s_ctx=64), slo=0.2,
                        prefill_tok_rate=100.0))
    got = []
    for ref, eng, ctrl, Eval in zip((True, False), engines, ctrls, (RefEvalResult, EvalResult)):
        eng.run(_requests(setup["cfg"], ref=ref, n=3, seed=1), max_steps=500)
        rel = eng.reconfigure(n_prefill=2)
        assert len(eng.disagg.pools.prefill_devices) == len(eng.prefill_worker.devices) == 2
        m = eng.run(_requests(setup["cfg"], ref=ref, n=3, seed=2, rid0=100), max_steps=500)
        assert m["completed"] == 6
        decision = Eval(n_a=2, n_e=2, batch=4, tpot=0.1, t_attn=0, t_moe=0, t_comm=0, a_max=1, tpg=1.0,
                        feasible=True)
        ctrl.scaler.scale = lambda lam, slo, d=decision: d  # pin the decode decision
        for t, n_in in [(0.0, 120.0), (1.0, 150.0)]:
            ctrl.observe(t, 16.0, input_tokens=n_in)
        assert ctrl.decide_prefill(now=2.0, demand=250.0) == 3  # ceil(250 / 100)
        ctrl.actuate(eng, now=2.0)
        assert len(eng.disagg.pools.prefill_devices) == ctrl.events[-1].n_p == 1  # 270 / 300 s window
        m = eng.run(_requests(setup["cfg"], ref=ref, n=2, seed=9, rid0=200), max_steps=500)
        assert m["completed"] == 8
        got.append((rel, list(eng.disagg.relower_log), dataclasses.astuple(ctrl.events[-1]),
                    {r.rid: r.tokens_out for r in eng.completed}))
    assert got[0][0] == got[1][0] == {"attn": False, "moe": False, "prefill": True}
    assert got[0][1:] == got[1][1:]


def test_controller_actuates_reconfigure(setup):
    """The port of ``test_controller_actuates_reconfigure``
    (``tests/test_disagg.py:387``), then a MoE resize with a replanned
    layout that re-anchors the prefill pool: ``relower_log`` and streams
    equal the reference's."""
    from repro.core.scaling import EvalResult as RefEvalResult
    from repro.core.scaling import PerfModel as RefPerfModel
    from repro.serving.controller import AutoScaler as RefAutoScaler

    trace = make_routing_trace(512, setup["cfg"].num_experts, setup["cfg"].top_k, skew=0.8, seed=4)
    got = []
    for ref, eng in zip((True, False), _engines(setup, executor="disagg", n_attn=2, n_prefill=1)):
        eng.run(_requests(setup["cfg"], ref=ref, n=3), max_steps=500)
        cfg = setup["ref_cfg"] if ref else setup["cfg"]
        ctrl = (RefAutoScaler(RefPerfModel(cfg, slots_per_instance=3, s_ctx=64), slo=0.2) if ref
                else AutoScaler(PerfModel(cfg, slots_per_instance=3, s_ctx=64), slo=0.2))
        Eval = RefEvalResult if ref else EvalResult
        for n_a, n_e in ((3, 2), (3, 3)):
            d = Eval(n_a=n_a, n_e=n_e, batch=4, tpot=0.1, t_attn=0, t_moe=0, t_comm=0, a_max=1, tpg=1.0,
                     feasible=True)
            ctrl.scaler.scale = lambda lam, slo, d=d: d  # pin the decision
            best = ctrl.actuate(eng, now=0.0, trace=trace)
            assert (best.n_a, best.n_e) == (n_a, n_e)
            assert len(eng.disagg.pools.attn_devices) == n_a and eng.disagg.n_moe == n_e
            assert ctrl.events[-1].n_p is None  # no prefill rate: the pool keeps its size
            assert len(eng.prefill_worker.devices) == 1
            m = eng.run(_requests(setup["cfg"], ref=ref, n=2, seed=9, rid0=10 * n_e), max_steps=500)
        assert m["completed"] == 7
        got.append((list(eng.disagg.relower_log), eng.layout.slot_to_expert.tolist(),
                    {r.rid: r.tokens_out for r in eng.completed}, eng.amax_log))
    assert got[0][0][-2:] == [{"attn": True, "moe": False, "prefill": False},
                              {"attn": False, "moe": True, "prefill": True}]
    assert got[0] == got[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_pipelined_batched_disagg_on_card_matches_cpu(cuda_device):
    """The reduced disagg engine with a prefill pool, pipelined and batched
    admission (contiguous and paged KV) on the card serves the streams and
    ``amax_log`` of the plain versions on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    layout = build_layout(make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0),
                          cfg.num_experts, 2, 3)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    for page in (None, 16):
        streams, amax = [], []
        for dev in (CPU, cuda_device):
            eng = ServingEngine(cfg, to(params, dev), layout=layout, kv_page_size=page, device=dev,
                                executor="disagg", n_attn=2, n_prefill=2, prefill_batch=2,
                                step_time_fn=STEP_TIME, prefill_time_fn=PREFILL_TIME, **ENGINE_KW)
            m = eng.run(_requests(cfg), max_steps=500)
            assert m["decode_stall_time"] == 0.0
            streams.append({r.rid: r.tokens_out for r in eng.completed})
            amax.append(eng.amax_log)
        assert streams[0] == streams[1] and len(streams[0]) == N_REQ, page
        assert amax[0] == amax[1]
