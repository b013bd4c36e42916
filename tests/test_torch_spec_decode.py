"""The port's speculative decode (``decode_step_verify`` in
``repro_torch.models``, ``PagedKVCache.truncate``, the disagg executor's
verify step and ``truncate_slot``, the engine's ``draft_config``,
``draft_params`` and ``spec_k``) against the reference's, on
``dsv2-lite-reduced`` in float32 with the deployments of
``tests/test_spec_decode.py`` and of the reference's composition tests.

The verify step equals the reference's within ``TOL["f32_layer"]`` and, bit
for bit, ``c`` sequential port ``decode_step`` calls, for contiguous, paged
and int8 contiguous KV; a parked row never writes a readable row.  Engine
streams equal the port's own greedy streams and the reference's speculative
ones, and ``metrics()["spec"]`` equals the reference's exactly, on mono
(contiguous, paged, a cross draft) and disagg (with ``amax_log``,
``regime_log`` and ``transfer_bytes_log``), and composed with prefix hits,
preemption and an attention loss.  Weights are drawn by the reference and
carried across with ``repro_torch.bridge``; a draft that is not the target
gets bridged weights too (torch cannot draw the reference's).  JAX and
``repro`` are imported inside the tests: the card's machine, which runs the
``gpu`` test, has no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.scaling import PerfModel
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import model as model_mod
from repro_torch.models.common import tree_to
from repro_torch.serving import faults
from repro_torch.serving import kv_cache
from repro_torch.serving.controller import AutoScaler
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests

CPU = torch.device("cpu")
PS = 16
B, PROMPT, CACHE_LEN, C = 3, 12, 32, 4  # the verify fixture: 3 slots, a 12-token prompt, 4 candidate rows
# tests/test_spec_decode.py's mono deployment (`_mono`), on dsv2-lite with AEBS
SPEC_MONO = dict(max_batch=4, cache_len=64, scheduler="aebs", n_prefill=1, prefill_chunk=4,
                 step_time_fn=lambda n: 2e-3)
# its disagg deployment (SPEC_SCRIPT), which is tests/test_faults.py's (`_engine`)
SPEC_DISAGG = dict(SPEC_MONO, capacity_tokens=64, executor="disagg", n_attn=2)
# tests/test_prefix_cache.py's and tests/test_preempt.py's mono deployments
PREFIX_MONO = dict(max_batch=3, cache_len=64, scheduler="aebs", n_prefill=1, prefill_chunk=8, kv_page_size=PS,
                   step_time_fn=lambda n: 2e-3, prefill_time_fn=lambda n: 1e-3 + n * 1e-3)
PREEMPT_MONO = dict(max_batch=2, cache_len=64, scheduler="aebs", step_time_fn=lambda n: 2e-3, kv_page_size=PS)
# attention device 1 lost at step 6, as tests/test_faults.py's attention
# case (under speculation a loss at its step 3 catches only a prefill)
ATTN_LOSS = [dict(kind="device_loss", pool="attn", index=1, at_step=6)]
# engine cases: (deployment, workload, engine options, fault specs, the
# options of the non-speculative run the case is held to); "self" drafts
# with the target's config, "cross" with the reference's seed-1 weights
CASES = {
    "mono_contiguous": (SPEC_MONO, "chat", dict(draft="self", spec_k=3), None, {}),
    "mono_paged": (SPEC_MONO, "chat", dict(draft="self", spec_k=3, kv_page_size=PS), None, dict(kv_page_size=PS)),
    "mono_cross": (SPEC_MONO, "chat", dict(draft="cross", spec_k=2), None, {}),
    "disagg": (SPEC_DISAGG, "chat", dict(draft="self", spec_k=3), None, {}),
    "prefix": (PREFIX_MONO, "shared", dict(draft="self", spec_k=2, prefix_cache=True), None, {}),
    "preempt": (PREEMPT_MONO, "contended", dict(draft="self", spec_k=2, sched="priority"), None, dict(sched="fifo")),
    "attn_loss": (SPEC_DISAGG, "faults", dict(draft="self", spec_k=2), ATTN_LOSS, {}),
}
# this file's engine cases; tests/test_torch_spec_compose.py runs the rest
MONO_CASES = ("mono_contiguous", "mono_paged", "mono_cross")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny ops (restored afterwards):
    test workers sharing the machine's cores would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (i) PagedKVCache.truncate and scatter_prefill_caches
# ---------------------------------------------------------------------------


def _pager_state(pager):
    return (pager.tables.tolist(), [pager.slot_pages(s) for s in range(pager.max_batch)], pager.hiwater.tolist(),
            dict(pager.allocator._refs), list(pager.allocator._free))


def _truncate_rounds(mod, seed):
    """tests/test_spec_decode.py's accept/reject rounds (``:64-91``) from a
    seeded draw: back every verify row, advance by the accepted count plus
    one, truncate.  Returns the pager's state after every round."""
    rng = np.random.default_rng(seed)
    cache_len, page, k = 64, 8, 3
    pager = mod.PagedKVCache(max_batch=2, cache_len=cache_len, page_size=page)
    slot, input_len = int(rng.integers(0, 2)), int(rng.integers(1, 17))
    pager.ensure(slot, input_len - 1)
    pos, generated, log = input_len, 0, []
    for _ in range(int(rng.integers(1, 13))):
        if pos >= cache_len - 2:
            break
        w = int(rng.integers(1, min(k + 1, cache_len - 2 - pos) + 1))
        a = int(rng.integers(0, w))
        pager.ensure(slot, pos + w - 1)
        generated, pos = generated + a + 1, pos + a + 1
        pager.truncate(slot, pos)
        assert pager.hiwater[slot] == input_len + generated == pos
        log.append(_pager_state(pager))
    pager.release(slot)
    assert pager.hiwater[slot] == 0 and pager.allocator.in_use == 0
    return log


@pytest.mark.parametrize("seed", range(6))
def test_truncate_rounds_equal_reference(seed):
    """Ensure-then-truncate rounds keep the high-water mark at ``input_len +
    generated`` and the pages allocated; state equals the reference's."""
    from repro.serving import kv_cache as ref_kv

    got = _truncate_rounds(kv_cache, seed)
    assert got and got == _truncate_rounds(ref_kv, seed)


def test_truncate_rejects_negative_as_reference():
    from repro.serving import kv_cache as ref_kv

    msgs = []
    for mod in (kv_cache, ref_kv):
        pager = mod.PagedKVCache(max_batch=1, cache_len=32, page_size=8)
        pager.ensure(0, 9)
        with pytest.raises(ValueError) as e:
            pager.truncate(0, -1)
        pager.truncate(0, 40)  # above the mark: unchanged
        msgs.append((str(e.value), _pager_state(pager)))
    assert msgs[0] == msgs[1] and msgs[0][1][2] == [10]


def test_scatter_prefill_caches_equals_reference():
    import jax.numpy as jnp

    from repro.serving import kv_cache as ref_kv

    rng = np.random.default_rng(0)
    batch = {"kv_k": rng.standard_normal((2, 3, 8, 2, 4)).astype(np.float32),
             "kv_k_scale": rng.standard_normal((2, 3, 8, 2)).astype(np.float32)}
    one = {k: rng.standard_normal((v.shape[0], 1, *v.shape[2:])).astype(np.float32) for k, v in batch.items()}
    want = ref_kv.scatter_prefill_caches({k: jnp.asarray(v) for k, v in batch.items()},
                                         {k: jnp.asarray(v) for k, v in one.items()}, 1)
    got = kv_cache.scatter_prefill_caches(bridge.caches_from_numpy(batch), bridge.caches_from_numpy(one), 1)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# (ii) decode_step_verify
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import model as ref_model

    ref_cfg = dataclasses.replace(ref_get_config("dsv2-lite-reduced"), dtype="float32")
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    ref_params, ref_draft = ref_model.init_params(ref_cfg, 0), ref_model.init_params(ref_cfg, 1)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params, ref_draft=ref_draft,
                params=bridge.params_from_jax(jax.tree.map(np.asarray, ref_params)),
                draft=bridge.params_from_jax(jax.tree.map(np.asarray, ref_draft)))


def _verify_inputs(weights, kv):
    """Both sides' caches after a 12-token prefill of 3 slots (paged: the
    first two backed over the whole cache, the third unbacked), the verify
    tokens, and positions and widths: slot 0 scores all 4 rows, slot 1 two
    (rows 2-3 parked), slot 2 is parked (position ``CACHE_LEN - 1``, width
    0), as the engine parks a free slot."""
    import jax.numpy as jnp

    from repro.models import model as ref_model
    from repro.serving import kv_cache as ref_kv

    ref_cfg = dataclasses.replace(weights["ref_cfg"], kv_quant=kv == "int8")
    cfg = dataclasses.replace(weights["cfg"], kv_quant=kv == "int8")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, PROMPT), dtype=np.int32)
    _, ref_caches = ref_model.prefill(weights["ref_params"], jnp.asarray(prompt), ref_cfg, CACHE_LEN)
    caches = bridge.caches_from_numpy({k: np.asarray(v) for k, v in ref_caches.items()})
    if kv == "paged":
        lengths = np.array([CACHE_LEN, CACHE_LEN, 0])
        _, ref_caches = ref_kv.paginate_caches(ref_caches, lengths, PS)
        _, caches = kv_cache.paginate_caches(caches, lengths, PS)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, C), dtype=np.int32)
    positions = np.array([PROMPT, PROMPT, CACHE_LEN - 1])
    widths = np.array([C, 2, 0])
    return ref_cfg, cfg, ref_caches, caches, tokens, positions, widths


def _port_verify(weights, cfg, caches, tokens, positions, widths):
    t = torch.from_numpy
    return model_mod.decode_step_verify(weights["params"], t(tokens.astype(np.int64)), caches,
                                        t(positions.astype(np.int64)), cfg, widths=t(widths.astype(np.int64)))


def _clone(caches):
    return {k: v.clone() for k, v in caches.items()}


@pytest.mark.parametrize("kv", ["contiguous", "paged", "int8"])
def test_verify_equals_reference_and_sequential_decode(weights, kv):
    """Valid rows' logits and the KV rows they wrote equal the reference's
    verify within ``TOL["f32_layer"]``; every row's logits and the whole
    cache equal ``c`` sequential port ``decode_step`` calls bit for bit."""
    import jax.numpy as jnp

    from repro.models import model as ref_model

    ref_cfg, cfg, ref_caches, caches, tokens, positions, widths = _verify_inputs(weights, kv)
    seq = _clone(caches)
    logits, caches = _port_verify(weights, cfg, caches, tokens, positions, widths)
    ref_logits, ref_caches = ref_model.decode_step_verify(
        weights["ref_params"], jnp.asarray(tokens), ref_caches, jnp.asarray(positions), ref_cfg,
        widths=jnp.asarray(widths))
    assert logits.shape == (B, C, cfg.vocab_size)
    ref_logits = np.asarray(ref_logits)
    for b in range(B):
        assert_close(logits[b, : widths[b]], ref_logits[b, : widths[b]], TOL["f32_layer"])
    live = [(0, p) for p in range(PROMPT + C)] + [(1, p) for p in range(PROMPT + 2)]
    if kv == "paged":
        bt = caches["block_tables"].numpy()
        live = [(int(bt[b, p // PS]), p % PS) for b, p in live]
    rows = tuple(np.array(v) for v in zip(*live))
    for k in ("kv_k", "kv_v", "kv_k_scale", "kv_v_scale"):
        if k in caches:
            if kv == "int8" and k in ("kv_k", "kv_v"):  # one ulp of a scale may move a value one step
                assert np.abs(caches[k].numpy()[:, rows[0], rows[1]].astype(np.int32)
                              - np.asarray(ref_caches[k])[:, rows[0], rows[1]].astype(np.int32)).max() <= 1
            else:
                assert_close(caches[k][:, rows[0], rows[1]], np.asarray(ref_caches[k])[:, rows[0], rows[1]],
                             TOL["f32_layer"])
    # c sequential decode steps at the verify's write positions
    t = torch.from_numpy
    cols = []
    for j in range(C):
        pos = np.where(j < widths, np.minimum(positions + j, CACHE_LEN - 1), CACHE_LEN - 1)
        lg, seq = model_mod.decode_step(weights["params"], t(tokens[:, j : j + 1].astype(np.int64)), seq,
                                        t(pos.astype(np.int64)), cfg)
        cols.append(lg)
    assert torch.equal(logits, torch.stack(cols, dim=1))
    for k in caches:
        assert torch.equal(caches[k], seq[k]), k


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_parked_rows_touch_no_readable_row(weights, kv):
    """A parked row writes only at the cache's last row: every other row is
    the prefill's or a valid row's, and the valid rows' logits equal a
    verify of only those rows.  With wrong drafts from row 2 on, rows 0-1
    still give the greedy stream (``tests/test_spec_decode.py:152``)."""
    _, cfg, _, caches, tokens, positions, widths = _verify_inputs(weights, kv)
    before = _clone(caches)
    logits, after = _port_verify(weights, cfg, caches, tokens, positions, widths)
    narrow, _ = _port_verify(weights, cfg, _clone(before), tokens[:, :2], positions, np.minimum(widths, 2))
    assert torch.equal(logits[:2, :2], narrow[:2])
    if kv == "contiguous":
        touched = np.zeros((B, CACHE_LEN), bool)
        for b in range(B):
            touched[b, positions[b] : positions[b] + widths[b]] = True
        touched[:, CACHE_LEN - 1] = True
        for k in ("kv_k", "kv_v"):
            assert torch.equal(after[k][:, torch.from_numpy(~touched)], before[k][:, torch.from_numpy(~touched)])
    else:  # a parked row's page is its slot's last block or the null page, at the last offset
        bt = after["block_tables"].numpy()
        for k in ("kv_k", "kv_v"):
            changed = (after[k] != before[k]).reshape(*after[k].shape[:3], -1).any(-1).any(0).numpy()
            allowed = np.zeros_like(changed)
            for b in range(B):
                for p in range(positions[b], positions[b] + widths[b]):
                    allowed[bt[b, p // PS], p % PS] = True
                allowed[bt[b, -1], PS - 1] = True
            assert not (changed & ~allowed).any()
    # the greedy continuation of slot 0, then drafts that are wrong from row 2
    seq, stream = _clone(before), [int(tokens[0, 0])]
    t = torch.from_numpy
    for j in range(3):
        lg, seq = model_mod.decode_step(weights["params"], t(np.array([[stream[-1]]] * B, np.int64)), seq,
                                        t(np.array([PROMPT + j] * 2 + [CACHE_LEN - 1], np.int64)), cfg)
        stream.append(int(lg[0].argmax()))
    vt = tokens.copy()
    vt[0] = [stream[0], stream[1], (stream[2] + 1) % cfg.vocab_size, (stream[3] + 1) % cfg.vocab_size]
    vlogits, _ = _port_verify(weights, cfg, _clone(before), vt, positions, widths)
    greedy = vlogits[0].argmax(-1).tolist()
    assert greedy[:2] == stream[1:3]
    assert next(a for a in range(C) if a == C - 1 or vt[0, a + 1] != greedy[a]) == 1  # one draft accepted


def test_draft_config_alone_self_drafts_two_tokens(weights):
    """A ``draft_config`` without ``spec_k`` drafts 2 tokens a step, and the
    target's config without ``draft_params`` shares the target's weights
    (``engine.py:288-318``); a draft of another config gets weights of its
    own.  The refusals are tests/test_torch_engine.py's."""
    cfg, params = weights["cfg"], weights["params"]
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=32, scheduler="none", device=CPU, draft_config=cfg)
    assert eng.spec_k == 2 and eng._draft_params is params
    assert eng._draft_caches["kv_k"].shape == (cfg.num_layers, 2, 32, cfg.num_kv_heads, cfg.resolved_head_dim)
    small = dataclasses.replace(cfg, num_layers=1, name="dsv2-lite-draft-1l")
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=32, scheduler="none", device=CPU, draft_config=small,
                        spec_k=1)
    assert eng.spec_k == 1 and len(eng._draft_params["layers"]) == 1
    assert "spec" not in ServingEngine(cfg, params, max_batch=2, cache_len=32, scheduler="none",
                                       device=CPU).metrics()


# ---------------------------------------------------------------------------
# (iii) the engine: speculative = greedy, and = the reference's
# ---------------------------------------------------------------------------


def _requests(cfg, mix, ref=False):
    """The reference tests' workloads: "chat" (tests/test_spec_decode.py),
    "shared" (tests/test_prefix_cache.py: one shared head, staggered),
    "contended" (tests/test_preempt.py: a chat burst at 10 ms over batch
    requests), "faults" (tests/test_faults.py)."""
    if ref:
        from repro.serving.request import WorkloadSpec as Spec
        from repro.serving.request import sample_requests as sample
    else:
        Spec, sample = WorkloadSpec, sample_requests
    if mix == "chat":
        return sample(Spec(mean_input=6, mean_output=12, vocab_size=cfg.vocab_size, seed=3),
                      np.linspace(0, 0.005, 4), with_prompts=True)
    if mix == "faults":
        return sample(Spec(mean_input=6, mean_output=24, vocab_size=cfg.vocab_size, max_input=16, max_output=32,
                           seed=3), np.linspace(0, 0.005, 5), with_prompts=True)
    if mix == "shared":
        rs = sample(Spec(mean_input=6, mean_output=6, vocab_size=cfg.vocab_size, max_input=12, max_output=8,
                         seed=123), np.arange(6) * 0.5, with_prompts=True)
        rng = np.random.default_rng(123)
        head = rng.integers(0, cfg.vocab_size, size=10, dtype=np.int32)
        for i, r in enumerate(rs):
            r.prompt = np.concatenate([head, rng.integers(0, cfg.vocab_size, size=4 + i % 3, dtype=np.int32)])
            r.input_len = len(r.prompt)
        return rs
    rs = sample(Spec(mean_input=6, mean_output=24, vocab_size=cfg.vocab_size, max_input=12, max_output=30, seed=0),
                np.linspace(0, 0.001, 4), with_prompts=True)
    for r in rs[:2]:
        r.priority, r.tenant, r.ttft_slo = 0, "batch", 10.0
    for r in rs[2:]:
        r.priority, r.tenant, r.ttft_slo = 5, "chat", 0.012
        r.arrival += 0.01
    return rs


def _outcome(eng, m):
    out = {k: m.get(k) for k in ("completed", "tokens", "spec", "preemptions", "restores", "prefix_cache",
                                 "kv_pages", "prefill_chunks")}
    out["streams"] = {r.rid: list(r.tokens_out) for r in eng.completed}
    out["logs"] = (eng.amax_log, eng.regime_log, eng.transfer_bytes_log)
    if "faults" in m:
        out["faults"] = {k: v for k, v in m["faults"].items() if not k.startswith("recovery_latency")}
    return out


def _options(kw, cfg, draft):
    kw = dict(kw)
    which = kw.pop("draft", None)
    if which is not None:
        kw["draft_config"] = cfg
        if which == "cross":
            kw["draft_params"] = draft
    return kw


def _port_engine(weights, deploy, kw, specs=None, device=CPU, params=None, draft=None):
    plan = faults.FaultPlan([faults.FaultSpec(**s) for s in specs]) if specs else None
    return ServingEngine(weights["cfg"], weights["params"] if params is None else params,
                         layout=ReplicaLayout.round_robin(weights["cfg"].num_experts, 2, 3), device=device,
                         fault_plan=plan, retry_policy=faults.RetryPolicy(recovery_charge_s=0.01),
                         **{**deploy, **_options(kw, weights["cfg"], weights["draft"] if draft is None else draft)})


def reference_outcomes(weights, names):
    """The reference engine's outcome of each named case, each run once."""
    from repro.core.aebs import ReplicaLayout as RefLayout
    from repro.serving import faults as ref_faults
    from repro.serving.engine import ServingEngine as RefEngine

    out, jits = {}, {}
    for name in names:
        deploy, mix, kw, specs, _ = CASES[name]
        plan = ref_faults.FaultPlan([ref_faults.FaultSpec(**s) for s in specs]) if specs else None
        eng = RefEngine(weights["ref_cfg"], weights["ref_params"],
                        layout=RefLayout.round_robin(weights["cfg"].num_experts, 2, 3), fault_plan=plan,
                        retry_policy=ref_faults.RetryPolicy(recovery_charge_s=0.01),
                        **{**deploy, **_options(kw, weights["ref_cfg"], weights["ref_draft"])})
        # the first engine's compiled closures serve the later ones (as
        # tests/test_torch_engine.py wraps `_decode_jit`): the draft's capture
        # only its config and the cache length, the mono step's and verify's
        # also the MoE context, which every mono case has alike
        for attr in ("_draft_prefill_jit", "_draft_decode_jit") + (("_decode_jit", "_verify_jit")
                                                                   if eng.disagg is None else ()):
            setattr(eng, attr, jits.setdefault(attr, getattr(eng, attr)))
        out[name] = _outcome(eng, eng.run(_requests(weights["ref_cfg"], mix, ref=True), max_steps=4000))
    return out


def port_outcomes(weights, names, speculative=True):
    """The port's engine and outcome of each named case, or of the
    non-speculative run it is held to."""
    out = {}
    for name in names:
        deploy, mix, kw, specs, greedy_kw = CASES[name]
        eng = _port_engine(weights, deploy, kw if speculative else greedy_kw, specs if speculative else None)
        out[name] = (eng, _outcome(eng, eng.run(_requests(weights["cfg"], mix), max_steps=4000)))
    return out


@pytest.fixture(scope="module")
def engine_runs(weights):
    """(reference outcomes, port's speculative runs, port's greedy outcomes)."""
    return (reference_outcomes(weights, MONO_CASES), port_outcomes(weights, MONO_CASES),
            {n: o for n, (_, o) in port_outcomes(weights, MONO_CASES, speculative=False).items()})


def check_spec_case(name, runs):
    """Streams equal the greedy run's and the reference's; the whole outcome
    (``spec``, pages, ``amax_log``, ``regime_log``, ``transfer_bytes_log``)
    equals the reference's.  Returns the port's engine and outcome."""
    reference, served, greedy = runs
    eng, got = served[name]
    assert got == reference[name]
    assert got["streams"] == greedy[name]["streams"] and got["completed"] == greedy[name]["completed"]
    spec = got["spec"]
    assert spec["k"] == CASES[name][2]["spec_k"] and spec["emitted_tokens"] == got["tokens"]
    assert spec["accepted_per_step"] > 1.0 or name == "mono_cross"
    return eng, got, greedy[name]


@pytest.mark.parametrize("name", MONO_CASES)
def test_spec_streams_equal_greedy_and_reference(engine_runs, name):
    """Mono, contiguous and paged, self-draft ``spec_k=3`` and a cross draft
    ``spec_k=2``: streams equal the port's greedy streams and the
    reference's, ``spec`` and the pages the reference's exactly.  A
    self-draft accepts nearly every draft; the cross draft's rejections are
    real."""
    eng, got, base = check_spec_case(name, engine_runs)
    spec = got["spec"]
    if name == "mono_cross":
        assert 0.0 < spec["acceptance_rate"] < 1.0
    else:
        # the draft's cache is rebuilt by a whole-prompt prefill without AEBS,
        # so a self-draft may still miss a token the target's chunked path gives
        assert spec["acceptance_rate"] > 0.9 and spec["accepted_per_step"] > 3.0
        assert spec["steps"] < base["tokens"]
    assert got["logs"] == ([], [], [])
    if name == "mono_paged":
        assert got["kv_pages"]["pages_in_use"] == 0 and not eng.paged.hiwater.any()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [None, PS])
def test_verify_on_card_equals_sequential_decode(cuda_device, page):
    """On the card (K1 or K4, K2 and K3 through the engine's MoE context)
    the verify step equals ``c`` sequential decode steps bit for bit, and
    its argmaxes equal the CPU plain versions'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    layout = ReplicaLayout.round_robin(cfg.num_experts, 2, 3)
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int64))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, C)).astype(np.int64))
    positions = torch.tensor([PROMPT, PROMPT, CACHE_LEN - 1])
    widths = torch.tensor([C, 2, 0])
    argmaxes = []
    for dev in (CPU, cuda_device):
        p = tree_to(params, dev)
        extra = {"moe_ctx": dict(layout_tables=layout.device_tables(dev), slot_to_expert=torch.as_tensor(
            layout.slot_to_expert.reshape(-1), dtype=torch.int32, device=dev), num_instances=layout.num_instances,
            scheduler=aebs_schedule, capacity=None)}
        _, caches = model_mod.prefill(p, prompt.to(dev), cfg, CACHE_LEN)
        if page is not None:
            _, caches = kv_cache.paginate_caches(caches, np.array([CACHE_LEN, CACHE_LEN, 0]), page)
        seq = _clone(caches)
        logits, caches = model_mod.decode_step_verify(p, tokens.to(dev), caches, positions.to(dev), cfg, extra=extra,
                                                      widths=widths.to(dev))
        cols = []
        for j in range(C):
            pos = torch.where(j < widths, torch.clamp_max(positions + j, CACHE_LEN - 1), CACHE_LEN - 1)
            lg, seq = model_mod.decode_step(p, tokens[:, j : j + 1].to(dev), seq, pos.to(dev), cfg, extra=extra)
            cols.append(lg)
        assert torch.equal(logits, torch.stack(cols, dim=1))
        for k in caches:
            assert torch.equal(caches[k], seq[k]), k
        argmaxes.append([logits[b, : int(widths[b])].argmax(-1).tolist() for b in range(B)])
    assert argmaxes[0] == argmaxes[1]
