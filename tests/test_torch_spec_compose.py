"""The port's speculative decode on the disaggregated executor and composed
with the prefix cache, preemption and fault recovery, against the
reference's, on ``dsv2-lite-reduced`` in float32 (the cases and helpers of
``tests/test_torch_spec_decode.py``, which holds the verify step and the
mono engine; the two files split the reference's compile time).

The executor's ``decode_step_verify`` equals the reference's within
``TOL["f32_layer"]`` (its telemetry exactly) and ``c`` sequential decode
steps bit for bit.  The disagg engine (2 attention shards, 2 MoE instances
x 3 slots): streams equal the port's greedy streams and the reference's,
and ``spec``, ``amax_log``, ``regime_log`` and ``transfer_bytes_log`` equal
the reference's exactly.
With prefix hits (``tests/test_prefix_cache.py:313``), a preemption
mid-draft (``tests/test_preempt.py:167``) and an attention loss
(``tests/test_faults.py:204``), streams equal the non-speculative run's and
the whole outcome the reference's.  ``AutoScaler.actuate`` reads the
engine's tokens per verify step.
"""

import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close
from repro_torch.core import comm
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.disagg import DevicePools
from repro_torch.core.scaling import PerfModel
from repro_torch.serving.controller import AutoScaler
from repro_torch.serving.disagg import DisaggExecutor
from test_torch_spec_decode import (  # noqa: F401  (one_thread, weights: fixtures)
    B,
    C,
    CACHE_LEN,
    CASES,
    CPU,
    _outcome,
    _port_engine,
    _requests,
    _verify_inputs,
    check_spec_case,
    one_thread,
    port_outcomes,
    reference_outcomes,
    weights,
)

COMPOSED = ("disagg", "prefix", "preempt", "attn_loss")
TEL_KEYS = ("regime", "t_comm_pred", "a_max", "bytes_fast", "bytes_slow", "msgs_fast", "msgs_slow", "bytes_total")


@pytest.mark.parametrize("n_attn,ping_pong,page", [(2, False, None), (1, True, None), (2, False, 16)])
def test_executor_verify_equals_reference_and_sequential_steps(weights, n_attn, ping_pong, page):
    """``DisaggExecutor.decode_step_verify`` over the verify fixture's caches
    (3 slots; 4, 2 and 0 valid rows): valid rows' logits and the exported KV
    within ``TOL["f32_layer"]`` of the reference's verify, its telemetry
    (regime, bytes, messages, the ``a_max`` of every position) equal; and
    bit for bit ``c`` sequential decode steps of an executor over the same
    caches.  ``truncate_slot`` leaves the reference's lengths and pages."""
    import jax
    import jax.numpy as jnp

    from repro.core.aebs import ReplicaLayout as RefLayout
    from repro.core.disagg import DevicePools as RefPools
    from repro.serving.disagg import DisaggExecutor as RefExecutor

    ref_cfg, cfg, ref_caches, caches, tokens, positions, widths = _verify_inputs(weights, "contiguous")
    lengths = np.array([CACHE_LEN, CACHE_LEN, 0]) if page else None
    ref = RefExecutor(ref_cfg, weights["ref_params"], RefPools.split(n_attn, 2, [jax.devices()[0]], allow_reuse=True),
                      RefLayout.round_robin(cfg.num_experts, 2, 3), max_batch=B, cache_len=CACHE_LEN, capacity=64,
                      ping_pong=ping_pong, kv_page_size=page)
    ref.load_caches(ref_caches, lengths)
    ref_logits, ref_tel = ref.decode_step_verify(jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(widths))

    def executor():
        ex = DisaggExecutor(cfg, weights["params"], DevicePools.split(n_attn, 2, [CPU], allow_reuse=True),
                            ReplicaLayout.round_robin(cfg.num_experts, 2, 3), max_batch=B, cache_len=CACHE_LEN,
                            capacity=64, ping_pong=ping_pong, kv_page_size=page, hw=comm.TPU_V5E)
        ex.load_caches({k: v.clone() for k, v in caches.items()}, lengths)
        return ex

    t = torch.from_numpy
    ex, seq = executor(), executor()
    logits, tel = ex.decode_step_verify(t(tokens.astype(np.int64)), t(positions.astype(np.int64)),
                                        t(widths.astype(np.int64)))
    assert logits.shape == (B, C, cfg.vocab_size)
    for b in range(B):
        assert_close(logits[b, : widths[b]], np.asarray(ref_logits)[b, : widths[b]], TOL["f32_layer"])
    assert {k: tel[k] for k in TEL_KEYS} == {k: ref_tel[k] for k in TEL_KEYS}
    got, want = ex.export_caches(), ref.export_caches()
    for b, w in enumerate(widths):
        for k in got:
            assert_close(got[k][:, b, : positions[b] + w], np.asarray(want[k])[:, b, : positions[b] + w],
                         TOL["f32_layer"])
    cols, steps = [], []
    for j in range(C):
        pos = np.where(j < widths, np.minimum(positions + j, CACHE_LEN - 1), CACHE_LEN - 1)
        lg, st = seq.decode_step(t(tokens[:, j : j + 1].astype(np.int64)), t(pos.astype(np.int64)))
        cols.append(lg)
        steps.append(st)
    assert torch.equal(logits, torch.stack(cols, dim=1))
    assert tel["a_max"] == max(st["a_max"] for st in steps)
    assert tel["bytes_total"] == sum(st["bytes_total"] for st in steps)  # c rows a slot in each exchange
    for k, v in seq.export_caches().items():
        assert torch.equal(got[k], v), k
    for side in (ex, ref):
        side.ensure_slot_pages(0, 20)
        side.truncate_slot(0, 14)
        side.truncate_slot(1, 40)  # above the live length: unchanged
    assert ex.slot_lengths().tolist() == np.asarray(ref._slot_len).tolist()
    if page:
        assert [p.hiwater.tolist() for p in ex._pagers] == [p.hiwater.tolist() for p in ref._pagers]


@pytest.fixture(scope="module")
def engine_runs(weights):  # noqa: F811
    """(reference outcomes, port's speculative runs, port's greedy outcomes)."""
    return (reference_outcomes(weights, COMPOSED), port_outcomes(weights, COMPOSED),
            {n: o for n, (_, o) in port_outcomes(weights, COMPOSED, speculative=False).items()})


def test_disagg_spec_streams_and_exchange_equal_reference(engine_runs):
    """Every verify step is one entry of each log, its exchange carries
    every candidate row (more bytes a step than greedy's), and every slot
    is released at the end."""
    eng, got, base = check_spec_case("disagg", engine_runs)
    amax, regimes, nbytes = got["logs"]
    assert len(amax) == len(regimes) == len(nbytes) == got["spec"]["steps"] < base["tokens"]
    assert got["spec"]["acceptance_rate"] > 0.9
    assert np.mean(nbytes) > np.mean(base["logs"][2])
    assert not eng.disagg.slot_lengths().any()


@pytest.mark.parametrize("name", ["prefix", "preempt", "attn_loss"])
def test_spec_composes_with_prefix_preemption_and_faults(engine_runs, name):
    """Speculation with prefix hits (a spliced cache the draft rebuilds from
    the prompt), with a preemption mid-draft (the restored request's draft
    stream rebuilt from its history) and with an attention loss (the lost
    shard's slots replayed): streams equal the non-speculative run's, and
    the outcome equals the reference's."""
    eng, got, base = check_spec_case(name, engine_runs)
    if name == "prefix":
        assert got["prefix_cache"]["hits"] >= 4 and got["prefix_cache"]["saved_tokens"] > 0
        assert eng.paged.allocator.in_use == len({p for node in eng.prefix._nodes for p in node.pages})
    elif name == "preempt":
        assert base["preemptions"] == 0 and got["preemptions"] >= 1 and got["restores"] == got["preemptions"]
        assert got["kv_pages"]["pages_in_use"] == 0
    else:
        f = got["faults"]
        assert (f["injected"], f["recoveries"], f["degraded"]) == (1, 1, 0) and f["replayed_slots"] >= 1
        assert len(eng.disagg.pools.attn_devices) == 1


def test_autoscaler_reads_the_engines_accepted_per_step(weights):  # noqa: F811
    """``AutoScaler.actuate`` reads ``metrics()["spec"]["accepted_per_step"]``
    from a speculative disagg engine, and it deflates the decode demand."""
    deploy, mix, kw, _, _ = CASES["disagg"]
    eng = _port_engine(weights, deploy, kw)
    got = _outcome(eng, eng.run(_requests(weights["cfg"], mix), max_steps=4000))
    ctrl = AutoScaler(PerfModel(weights["cfg"], slots_per_instance=3, s_ctx=64), slo=0.2, n_max=4, window=10.0)
    ctrl.observe(0.0, 64.0)
    plain = ctrl.demand(1.0)
    ctrl.actuate(eng, now=1.0)
    rate = got["spec"]["accepted_per_step"]
    assert ctrl._spec_accept_rate == rate > 1.0
    assert ctrl.demand(1.0) == pytest.approx(plain / rate)
