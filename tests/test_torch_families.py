"""The periodic and recurrent families through the port's entry points,
against the reference, in float32 on their reduced configs: sliding-window
``gemma2-2b`` (local/global period 2, window 64, softcaps 50/30, GeGLU),
Mamba-1 ``falcon-mamba-7b`` and hybrid ``zamba2-2.7b`` (Mamba-2 with the
shared attention block).  Weights are drawn by the reference and carried
across with ``repro_torch.bridge``; also layer periods above the reduced
configs' (4 gemma2 layers, 6 zamba2 layers of period 3).

Covered: the bridge for periods above 1, whole-prompt prefill and decode
against the reference's (and against the port's own full forward), engine
streams on mono against the reference's (contiguous, paged, int8, pipelined
admission, priority preemption, a lost prefill device), paged = contiguous
inside the port, and every refusal the reference makes on these stacks.
The reference's chunked window path is among its known bitwise failures
(ROADMAP.md §3): streams are compared, chunks never bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import model, transformer

FAMILIES = ("gemma2-2b-reduced", "falcon-mamba-7b-reduced", "zamba2-2.7b-reduced")
# (name, config changes): the reduced configs, and periods above theirs
PERIODS = {
    "gemma2-2b-reduced": ("gemma2-2b-reduced", {}),
    "gemma2-2b-4-layers": ("gemma2-2b-reduced", dict(num_layers=4)),
    "falcon-mamba-7b-reduced": ("falcon-mamba-7b-reduced", {}),
    "zamba2-2.7b-reduced": ("zamba2-2.7b-reduced", {}),
    "zamba2-2.7b-6-layers-period-3": ("zamba2-2.7b-reduced", dict(num_layers=6, hybrid_attn_every=3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Engine runs in one torch thread: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged(name, dtype="float32", **changes):
    ref_cfg = dataclasses.replace(ref_get_config(name), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(name), dtype=dtype, **changes)
    ref_params = ref_model.init_params(ref_cfg, 0)
    return ref_cfg, cfg, ref_params, bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("case", list(PERIODS))
def test_params_round_trip_bit_exact(case):
    """bf16 weights cross both ways bit for bit: layer ``l`` of the port is
    ``blocks/pos{l % period}[l // period]``, and the hybrid stack's
    ``shared_attn`` is one dict."""
    name, changes = PERIODS[case]
    ref_cfg = dataclasses.replace(ref_get_config(name), dtype="bfloat16", **changes)
    tree = jax.tree.map(np.asarray, ref_model.init_params(ref_cfg, 0))
    params = bridge.params_from_jax(tree)
    period, n_periods = transformer.period_pattern(dataclasses.replace(get_config(name), **changes))
    assert len(params["layers"]) == len(period) * n_periods == ref_cfg.num_layers
    assert ("shared_attn" in params) == (ref_cfg.family == "hybrid")
    l = len(params["layers"]) - 1
    np.testing.assert_array_equal(
        bridge.tensor_to_numpy(params["layers"][l]["ln1"]["scale"]),
        tree["blocks"][f"pos{l % len(period)}"]["ln1"]["scale"][l // len(period)])
    a, b = _flatten(tree), _flatten(bridge.params_to_numpy(params, period=len(period)))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("case", list(PERIODS))
def test_prefill_then_decode_matches_reference(case):
    """An 80-token prompt (past gemma2's 64-token window), then four decode
    steps, each slot at its own position: logits, and every decode-state
    array (rolling ``_local`` buffer, ``_hybrid`` KV, Mamba states) in the
    reference's layout, within ``TOL["f32_layer"]``."""
    name, changes = PERIODS[case]
    ref_cfg, cfg, ref_params, params = _bridged(name, **changes)
    B, S, D, CL = 2, 80, 4, 96
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + D)).astype(np.int32)
    want, ref_caches = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :S]), ref_cfg, CL)
    got, caches = model.prefill(params, torch.from_numpy(tokens[:, :S]), cfg, CL)
    assert_close(got, want, TOL["f32_layer"])
    empty = model.init_decode_caches(cfg, B, CL, device="cpu")
    assert set(caches) == set(ref_caches) == set(empty)
    for k, v in ref_caches.items():
        assert tuple(caches[k].shape) == v.shape == tuple(empty[k].shape), k
        assert caches[k].dtype == empty[k].dtype, k
        assert_close(caches[k], v, TOL["f32_layer"])
    for t in range(D):
        pos = np.array([S + t, S + t], np.int32)
        want, ref_caches = ref_model.decode_step(ref_params, jnp.asarray(tokens[:, S + t : S + t + 1]), ref_caches,
                                                 jnp.asarray(pos), ref_cfg)
        got, caches = model.decode_step(params, torch.from_numpy(tokens[:, S + t : S + t + 1]), caches,
                                        torch.from_numpy(pos.astype(np.int64)), cfg)
        assert_close(got, want, TOL["f32_layer"])
    for k, v in ref_caches.items():
        assert_close(caches[k], v, TOL["f32_layer"])


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_decode_matches_forward(name):
    """The port's own decode consistency (``tests/test_decode_consistency.py``):
    prefill, then decode steps, give the full forward pass's logits at each
    position, past the window."""
    _, cfg, _, params = _bridged(name)
    B, S, D = 2, 70, 4
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + D)))
    hidden, _ = transformer.forward(params, tokens, cfg)
    full = transformer.lm_head(params, hidden, cfg)
    logits, caches = model.prefill(params, tokens[:, :S], cfg, S + D + 8)
    assert_close(logits, full[:, S - 1], TOL["f32_layer"])
    for t in range(D):
        logits, caches = model.decode_step(params, tokens[:, S + t : S + t + 1], caches, torch.full((B,), S + t), cfg)
        assert_close(logits, full[:, S + t], TOL["f32_layer"])


def test_chunked_prefill_equals_whole_prompt_on_window_stack():
    """gemma2's chunked prefill over a prompt past the window (chunks of 16
    and 64) gives the whole-prompt logits and caches within tolerance: the
    port's counterpart of the reference's windowed chunk tests."""
    _, cfg, _, params = _bridged("gemma2-2b-reduced")
    S, CL = 150, 192
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, S)))
    want_logits, want = model.prefill(params, tokens, cfg, CL)
    for chunk in (16, 64):
        caches = model.init_decode_caches(cfg, 1, CL, device="cpu")
        for lo in range(0, S, chunk):
            logits, caches = model.prefill_chunk(params, tokens[:, lo : lo + chunk], caches, lo, cfg)
        assert_close(logits, want_logits, TOL["f32_layer"])
        for k in want:
            assert_close(caches[k], want[k], TOL["f32_layer"])


def test_supports_and_period_pattern_equal_reference():
    from repro.configs import REGISTRY as REF_REGISTRY
    from repro.models import transformer as ref_transformer
    from repro_torch.configs import REGISTRY

    for base in REGISTRY:
        for name in (base, base + "-reduced"):
            ref_cfg, cfg = ref_get_config(name), get_config(name)
            assert transformer.period_pattern(cfg) == ref_transformer.period_pattern(ref_cfg), name
            for fn in ("supports_chunked_prefill", "supports_batched_prefill", "supports_speculative_decode"):
                assert getattr(model, fn)(cfg) == getattr(ref_model, fn)(ref_cfg), (name, fn)
            assert cfg.kv_bytes_per_token() == ref_cfg.kv_bytes_per_token(), name
    assert set(REF_REGISTRY) == set(REGISTRY)


# ---------------------------------------------------------------------------
# engine streams on mono against the reference's
# ---------------------------------------------------------------------------

WINDOWED = dict(max_batch=2, cache_len=128, prefill_chunk=32, scheduler="none")
STEP = dict(step_time_fn=lambda n: 2e-3, prefill_time_fn=lambda n: 1e-4 * n)
PREFILL_LOSS = [dict(kind="device_loss", pool="prefill", index=0, at_step=2)]
# (config, kv_quant, engine options, request mix, fault specs)
ENGINE_CASES = {
    "gemma2_contiguous": ("gemma2-2b-reduced", False, {}, "long", None),
    "gemma2_paged": ("gemma2-2b-reduced", False, dict(kv_page_size=16), "long", None),
    "gemma2_int8": ("gemma2-2b-reduced", True, {}, "long", None),
    "gemma2_int8_paged": ("gemma2-2b-reduced", True, dict(kv_page_size=16), "long", None),
    "gemma2_pipelined": ("gemma2-2b-reduced", False, dict(n_prefill=1, **STEP), "long", None),
    "gemma2_priority": ("gemma2-2b-reduced", False, dict(kv_page_size=16, sched="priority", **STEP), "priority",
                        None),
    "falcon_mamba": ("falcon-mamba-7b-reduced", False, {}, "long", None),
    "falcon_mamba_pipelined_prefill_loss": ("falcon-mamba-7b-reduced", False, dict(n_prefill=1, **STEP), "long",
                                            PREFILL_LOSS),
    "zamba2": ("zamba2-2.7b-reduced", False, {}, "long", None),
    "zamba2_int8": ("zamba2-2.7b-reduced", True, {}, "long", None),
}


def _requests(vocab, mix, ref):
    """"long": 4 prompts of 49-100 tokens (three past the 64-token window)
    at once; "priority": two low-priority requests fill both slots and two
    high-priority ones land 10 ms later (tests/test_preempt.py's mix)."""
    if ref:
        from repro.serving.request import WorkloadSpec, sample_requests
    else:
        from repro_torch.serving.request import WorkloadSpec, sample_requests
    if mix == "long":
        spec = WorkloadSpec(mean_input=70, mean_output=10, vocab_size=vocab, max_input=100, max_output=12, seed=0)
        return sample_requests(spec, np.zeros(4), with_prompts=True)
    spec = WorkloadSpec(mean_input=40, mean_output=24, vocab_size=vocab, max_input=90, max_output=30, seed=0)
    rs = sample_requests(spec, np.linspace(0, 0.001, 4), with_prompts=True)
    for r in rs[:2]:
        r.priority = 0
    for r in rs[2:]:
        r.priority = 5
        r.arrival += 0.01
    return rs


def _outcome(eng, m):
    out = {k: m.get(k) for k in ("completed", "rejected", "preemptions", "restores", "spill_replays", "kv_pages")}
    out["streams"] = {r.rid: list(r.tokens_out) for r in eng.completed}
    if "faults" in m:
        out["faults"] = {k: v for k, v in m["faults"].items() if not k.startswith("recovery_latency")}
    return out


_WEIGHTS = {}


def _weights(name, kv_quant):
    if (name, kv_quant) not in _WEIGHTS:
        _WEIGHTS[name, kv_quant] = _bridged(name, kv_quant=kv_quant)
    return _WEIGHTS[name, kv_quant]


def _engine_run(case, ref, params=None, device="cpu"):
    name, kv_quant, kw, mix, specs = ENGINE_CASES[case]
    ref_cfg, cfg, ref_params, port_params = _weights(name, kv_quant)
    if ref:
        from repro.serving import faults as fmod
        from repro.serving.engine import ServingEngine as Engine

        c, p, extra = ref_cfg, ref_params, {}
    else:
        from repro_torch.serving import faults as fmod
        from repro_torch.serving.engine import ServingEngine as Engine

        c, p, extra = cfg, port_params if params is None else params, dict(device=device)
    plan = fmod.FaultPlan([fmod.FaultSpec(**s) for s in specs], seed=0) if specs else None
    eng = Engine(c, p, fault_plan=plan, retry_policy=fmod.RetryPolicy(recovery_charge_s=0.01),
                 **{**WINDOWED, **kw, **extra})
    return eng, _outcome(eng, eng.run(_requests(c.vocab_size, mix, ref), max_steps=2000))


@pytest.fixture(scope="module")
def reference():
    """The reference engine's outcome of each case, each run once."""
    return {case: _engine_run(case, ref=True)[1] for case in ENGINE_CASES}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_equal_reference(case, reference):
    """Token streams, counters (preemptions, restores, pages) and fault
    stats equal the reference's."""
    _, got = _engine_run(case, ref=False)
    want = reference[case]
    assert got["completed"] == want["completed"] == 4
    assert got == want
    if case == "gemma2_priority":
        assert got["preemptions"] >= 1 and got["restores"] >= 1
    if case.endswith("prefill_loss"):
        # a whole-prompt prefill is one call, never in flight at a step
        # boundary: the loss resizes the pool and requeues nothing
        assert got["faults"]["recoveries"] == 1 and got["faults"]["requeued"] == 0


def test_engine_paged_equals_contiguous_bitwise():
    """Inside the port, paged gemma2 (global layers paged, the rolling
    ``_local`` buffers contiguous beside them) decodes bit for bit as
    contiguous (``tests/test_paged_kv.py:214``): the same streams, and every
    active slot's logits at every step equal bitwise (a parked slot attends
    other garbage in the two layouts)."""
    from repro_torch.serving.engine import ServingEngine

    _, cfg, _, params = _weights("gemma2-2b-reduced", False)
    logits, streams = {}, {}
    for page in (None, 16):
        eng = ServingEngine(cfg, params, kv_page_size=page, device="cpu", step_time_fn=lambda n: 2e-3, **WINDOWED)
        seen = []
        step = model.decode_step

        def traced(*args, **kwargs):
            out = step(*args, **kwargs)
            seen.append(out[0][torch.from_numpy(eng.slots.active_mask())].clone())
            return out

        model.decode_step = traced
        try:
            eng.run(_requests(cfg.vocab_size, "long", False), max_steps=2000)
        finally:
            model.decode_step = step
        logits[page], streams[page] = seen, {r.rid: r.tokens_out for r in eng.completed}
    assert streams[None] == streams[16] and len(streams[16]) == 4
    assert len(logits[None]) == len(logits[16]) > 0
    for a, b in zip(logits[None], logits[16]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# refusals, as the reference's
# ---------------------------------------------------------------------------


def _both_raise(fn_port, fn_ref, exc, match):
    with pytest.raises(exc, match=match) as port_err:
        fn_port()
    with pytest.raises(exc, match=match) as ref_err:
        fn_ref()
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("name,option,match", [
    ("gemma2-2b-reduced", dict(kv_page_size=16, prefix_cache=True), "prefix_cache requires an architecture"),
    ("zamba2-2.7b-reduced", dict(kv_page_size=16, prefix_cache=True), "prefix_cache requires an architecture"),
    ("gemma2-2b-reduced", dict(draft_config="self"), "speculative decode requires"),
    ("falcon-mamba-7b-reduced", dict(draft_config="self", spec_k=2), "speculative decode requires"),
    ("zamba2-2.7b-reduced", dict(draft_config="self"), "speculative decode requires"),
    ("falcon-mamba-7b-reduced", dict(kv_page_size=16), "no full-attention KV cache"),
    ("zamba2-2.7b-reduced", dict(kv_page_size=16), "no full-attention KV cache"),
    ("gemma2-2b-reduced", dict(executor="disagg"), "needs a replica layout"),
])
def test_engine_refuses_as_reference(name, option, match):
    from repro.serving.engine import ServingEngine as RefEngine
    from repro_torch.serving.engine import ServingEngine

    ref_cfg, cfg, ref_params, params = _weights(name, False)
    kw = dict(WINDOWED, **option)
    ref_kw = dict(kw)
    if kw.get("draft_config") == "self":
        kw["draft_config"], ref_kw["draft_config"] = cfg, ref_cfg
    _both_raise(lambda: ServingEngine(cfg, params, device="cpu", **kw), lambda: RefEngine(ref_cfg, ref_params, **ref_kw),
                ValueError, match)


@pytest.mark.parametrize("name", FAMILIES)
def test_model_and_executor_refuse_as_reference(name):
    """Batched prefill (and chunked prefill on the recurrent stacks) and the
    disaggregated executor raise on these stacks, with the reference's
    messages."""
    from repro.core.aebs import ReplicaLayout as RefLayout
    from repro.core.disagg import DevicePools as RefPools
    from repro.serving.disagg import DisaggExecutor as RefExecutor
    from repro_torch.core.aebs import ReplicaLayout
    from repro_torch.core.disagg import DevicePools
    from repro_torch.serving.disagg import DisaggExecutor

    ref_cfg, cfg, ref_params, params = _weights(name, False)
    toks = np.zeros((2, 4), np.int32)
    caches = model.init_decode_caches(cfg, 2, 64, device="cpu")
    ref_caches = ref_model.init_decode_caches(ref_cfg, 2, 64)
    _both_raise(lambda: model.prefill_chunk_batched(params, torch.from_numpy(toks), caches, torch.zeros(2),
                                                    torch.full((2,), 4), cfg),
                lambda: ref_model.prefill_chunk_batched(ref_params, jnp.asarray(toks), ref_caches,
                                                        jnp.zeros(2, jnp.int32), jnp.full(2, 4), ref_cfg),
                ValueError, "does not support batched prefill")
    if cfg.family != "dense":
        _both_raise(lambda: model.prefill_chunk(params, torch.from_numpy(toks), caches, 0, cfg),
                    lambda: ref_model.prefill_chunk(ref_params, jnp.asarray(toks), ref_caches, jnp.int32(0), ref_cfg),
                    ValueError, "does not support chunked prefill")
    moe_cfg = dataclasses.replace(cfg, num_experts=4, top_k=2, d_ff_expert=32)
    ref_moe_cfg = dataclasses.replace(ref_cfg, num_experts=4, top_k=2, d_ff_expert=32)
    from repro.core.aebs import aebs_assign as ref_aebs
    from repro_torch.core.aebs import aebs_assign

    # without experts, and (the recurrent stacks) with them: a MoE layer in
    # gemma2's pattern makes every layer MoE, which the executor runs
    for c, rc in [(cfg, ref_cfg)] + ([(moe_cfg, ref_moe_cfg)] if cfg.family != "dense" else []):
        _both_raise(
            lambda: DisaggExecutor(c, params, DevicePools.split(1, 2, [torch.device("cpu")], allow_reuse=True),
                                   ReplicaLayout.round_robin(4, 2, 2), max_batch=2, cache_len=64,
                                   scheduler=aebs_assign),
            lambda: RefExecutor(rc, ref_params, RefPools.split(1, 2, [jax.devices()[0]], allow_reuse=True),
                                RefLayout.round_robin(4, 2, 2), max_batch=2, cache_len=64, scheduler=ref_aebs),
            ValueError, "disagg executor")


@pytest.mark.parametrize("name", ("gemma2-2b", "falcon-mamba-7b", "zamba2-2.7b"))
def test_cli_serves_family(name, capsys):
    """``repro_torch.launch.serve --arch <family>`` serves every request of
    the reference's CLI workload on its reduced config."""
    from repro_torch.launch import serve

    m = serve.main(["--arch", name, "--scheduler", "none", "--duration", "0.2", "--max-batch", "4",
                    "--cache-len", "128", "--device", "cpu"])
    out = capsys.readouterr().out
    n_req = int(out.split()[1])
    assert m["completed"] == n_req > 0 and not m["truncated"]
    assert f"on {name}-reduced" in out.splitlines()[0]


# (paged, start, length): chunks before, across and past the 64-row window;
# a whole-prompt hand-off longer than the window exists on the paged path only
@pytest.mark.parametrize("paged,start,length", [
    (p, st, ln) for p in (False, True) for st, ln in ((0, 32), (48, 32), (96, 32))] + [(True, 0, 100)])
def test_chunk_scatter_equals_reference_on_window_caches(paged, start, length):
    """A prefill chunk's hand-off into the batched caches: full-attention
    rows (paged or contiguous) and the rolling ``_local`` rows at ``p % W``
    (wrapping), a hand-off longer than the buffer keeping its last ``W``
    positions (paged, as ``kv_cache.py:826-830``), equal to the reference's."""
    from repro.models import model as ref_model
    from repro.serving import kv_cache as ref_kv
    from repro_torch.serving import kv_cache

    ref_cfg = dataclasses.replace(ref_get_config("gemma2-2b-reduced"), dtype="float32")
    B, CL = 2, 128
    rng = np.random.default_rng(start + length)
    one = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in ref_model.init_decode_caches(ref_cfg, 1, CL).items()}
    batch = {k: np.zeros(v.shape, np.float32) for k, v in ref_model.init_decode_caches(ref_cfg, B, CL).items()}
    if paged:
        ref_pager, ref_batch = ref_kv.make_paged_caches({k: jnp.asarray(v) for k, v in batch.items()}, B, CL, 16)
        want = ref_kv.scatter_prefill_chunk_paged(ref_batch, {k: jnp.asarray(v) for k, v in one.items()}, 1,
                                                  start, length, ref_pager)
        pager, port_batch = kv_cache.make_paged_caches({k: torch.from_numpy(v) for k, v in batch.items()}, B, CL, 16)
        got = kv_cache.scatter_prefill_chunk_paged(port_batch, {k: torch.from_numpy(v) for k, v in one.items()}, 1,
                                                   start, length, pager)
        np.testing.assert_array_equal(pager.tables, ref_pager.tables)
    else:
        want = ref_kv.scatter_prefill_chunk_caches({k: jnp.asarray(v) for k, v in batch.items()},
                                                   {k: jnp.asarray(v) for k, v in one.items()}, 1, start, length)
        got = kv_cache.scatter_prefill_chunk_caches({k: torch.from_numpy(v) for k, v in batch.items()},
                                                    {k: torch.from_numpy(v) for k, v in one.items()}, 1, start, length)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
