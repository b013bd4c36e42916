"""The port's priority preemption (KV spill/restore in
``repro_torch.serving.kv_cache`` and ``serving/disagg.py``; the engine's
``sched="priority"``) against the reference's, on ``dsv2-lite-reduced`` in
float32 with the deployments of ``tests/test_preempt.py``.

A spill moves a slot's page list (and its refcounts) into a record and a
restore moves it back, state for state as the reference's; preempted
streams equal the reference's and the port's own uninterrupted FIFO
streams, and ``preemptions``, ``restores``, ``spill_replays``, ``slo`` and
``kv_pages`` equal the reference's, on mono and disagg, and when an
attention loss dissolves the spilled pages (the restore replays).  Weights
are drawn by the reference and carried across with ``repro_torch.bridge``.
JAX and ``repro`` are imported inside the tests: the card's machine, which
runs the ``gpu`` test, has no JAX.
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
from repro_torch.serving import faults
from repro_torch.serving import kv_cache
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request, WorkloadSpec, sample_requests

CPU = torch.device("cpu")
PS = 16
# tests/test_preempt.py's mono deployment, on dsv2-lite
MONO = dict(max_batch=2, cache_len=64, scheduler="aebs", step_time_fn=lambda n: 2e-3)
# its disagg deployment (`_disagg_engine`)
DISAGG = dict(max_batch=4, cache_len=64, scheduler="aebs", capacity_tokens=64, executor="disagg", n_attn=2,
              n_prefill=1, prefill_chunk=4, step_time_fn=lambda n: 2e-3, kv_page_size=PS)
ATTN_LOSS = [dict(kind="device_loss", pool="attn", index=1, at_step=12)]
# engine cases: (deployment, request mix, engine options, fault specs)
CASES = {
    "mono_priority": (MONO, "mono", dict(kv_page_size=PS, sched="priority"), None),
    "mono_priority_contiguous": (MONO, "mono", dict(sched="priority"), None),
    "deadline_drop": (dict(MONO, max_batch=1), "deadline", dict(kv_page_size=PS, sched="priority"), None),
    "disagg_priority": (DISAGG, "disagg", dict(sched="priority"), None),
    "disagg_attn_loss": (DISAGG, "disagg", dict(sched="priority"), ATTN_LOSS),
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
# (i) spill / restore and the slot manager
# ---------------------------------------------------------------------------


def _state(pager):
    return (pager.tables.tolist(), [pager.slot_pages(s) for s in range(pager.max_batch)], pager.hiwater.tolist(),
            dict(pager.allocator._refs), list(pager.allocator._free))


def _spill_script(mod):
    pager = mod.PagedKVCache(2, 64, PS, num_pages=9)
    pager.ensure(0, 35)
    log = [_state(pager)]
    rec = pager.spill(0)
    log += [(rec.pages, rec.tokens), _state(pager)]
    pager.restore(1, rec)  # another slot than the one spilled
    log += [_state(pager), pager.rows_of(1, 0, 36)[0].tolist()]
    pager.release(1)
    log.append(_state(pager))
    # a page the prefix index also pins: the spill moves the slot's pin only
    pager.ensure(0, 2 * PS - 1)
    p0 = pager.slot_pages(0)[0]
    pager.allocator.ref(p0)
    rec = pager.spill(0)
    log.append(pager.allocator.refcount(p0))
    pager.drop_spilled(rec)
    log += [(rec.pages, rec.tokens), pager.allocator.refcount(p0), _state(pager)]
    pager.allocator.free(p0)
    log.append(pager.allocator.in_use)
    return log


def test_spill_is_an_ownership_transfer_and_carries_prefix_pins():
    """tests/test_preempt.py's spill cases on both pagers: no refcount moves
    across a spill, the restore maps block b back to ``rec.pages[b]`` in
    another slot, a drop frees only the record's pins."""
    from repro.serving import kv_cache as ref_kv

    got = _spill_script(kv_cache)
    assert got == _spill_script(ref_kv)
    assert got[1] == (got[0][1][0], 36) and got[2][1][0] == [] and got[3][1][1] == got[1][0]
    assert got[6] == 2 and got[7] == ([], 0) and got[8] == 1 and got[-1] == 0


def test_restore_requires_fresh_slot():
    from repro.serving import kv_cache as ref_kv

    logs = []
    for mod in (kv_cache, ref_kv):
        pager = mod.PagedKVCache(2, 64, PS)
        empty = pager.spill(0)
        pager.ensure(0, 0)
        pager.ensure(1, 0)
        rec = pager.spill(0)
        try:
            pager.restore(1, rec)
            err = None
        except RuntimeError as e:
            err = str(e)
        pager.restore(0, rec)
        log = [(empty.pages, empty.tokens), err, _state(pager)]
        pager.release(0)
        pager.release(1)
        logs.append(log + [pager.allocator.in_use])
    assert logs[0] == logs[1]
    assert "fresh slot" in logs[0][1] and logs[0][-1] == 0


def test_slot_manager_reserve_at_and_resume_equal_reference():
    from repro.serving import kv_cache as ref_kv
    from repro.serving.request import Request as RefRequest

    logs = []
    for mod, R in ((kv_cache, Request), (ref_kv, RefRequest)):
        sm = mod.SlotManager(3, 64)
        req = R(rid=0, arrival=0.0, input_len=4, output_len=8)
        req.generated = 3
        log = [sm.reserve(req, slot=2), sm.state[2]]
        for op in (lambda: sm.resume(2), lambda: sm.reserve(R(rid=1, arrival=0.0, input_len=2, output_len=2), slot=2),
                   lambda: sm.resume(2), lambda: sm.reserve(R(rid=2, arrival=0.0, input_len=2, output_len=2))):
            try:
                log.append(op())
            except RuntimeError as e:
                log.append(str(e))
        log += [list(sm.state), sm.positions.tolist(), req.slot]
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][-2][2] == 7  # resumed at input_len + generated
    assert "not free" in logs[0][3] and "cannot resume" in logs[0][4]


# ---------------------------------------------------------------------------
# (ii) the engine: preempted = uninterrupted, and = the reference's
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


def _requests(cfg, mix, ref=False):
    """tests/test_preempt.py's workloads: low-priority batch requests fill
    every slot when a high-priority chat burst lands 10 ms in ("mono": 2 +
    2, "disagg": 4 + 2); "deadline": one batch request with a 20 ms
    deadline, spilled by a chat request at 5 ms."""
    if ref:
        from repro.serving.request import WorkloadSpec as Spec
        from repro.serving.request import sample_requests as sample
    else:
        Spec, sample = WorkloadSpec, sample_requests
    spec = Spec(mean_input=6, mean_output=24, vocab_size=cfg.vocab_size, max_input=12, max_output=30, seed=0)
    if mix == "deadline":
        rs = sample(spec, [0.0, 0.005], with_prompts=True)
        rs[0].priority, rs[0].deadline = 0, 0.02
        rs[1].priority = 5
        return rs
    n_low, n_high, ttft = (2, 2, 0.012) if mix == "mono" else (4, 2, 0.015)
    rs = sample(spec, np.linspace(0, 0.001, n_low + n_high), with_prompts=True)
    for r in rs[:n_low]:
        r.priority, r.tenant, r.ttft_slo = 0, "batch", 10.0
    for r in rs[n_low:]:
        r.priority, r.tenant, r.ttft_slo = 5, "chat", ttft
        r.arrival += 0.01
    return rs


def _outcome(eng, m):
    out = {k: m.get(k) for k in ("completed", "rejected", "preemptions", "restores", "spill_replays", "slo",
                                 "kv_pages")}
    out["streams"] = {r.rid: list(r.tokens_out) for r in eng.completed}
    out["preempted"] = {r.rid: r.preemptions for r in eng.completed + eng.rejected}
    out["wait_spans"] = {r.rid: r.wait_spans for r in eng.completed}
    if "faults" in m:
        out["faults"] = {k: v for k, v in m["faults"].items() if not k.startswith("recovery_latency")}
    return out


def _port_engine(setup, deploy, specs=None, device=CPU, params=None, **kw):
    plan = faults.FaultPlan([faults.FaultSpec(**s) for s in specs], seed=0) if specs else None
    return ServingEngine(setup["cfg"], setup["params"] if params is None else params, layout=setup["layout"],
                         device=device, fault_plan=plan, retry_policy=faults.RetryPolicy(recovery_charge_s=0.01),
                         **{**deploy, **kw})


def _run(eng, reqs):
    return _outcome(eng, eng.run(reqs, max_steps=4000))


@pytest.fixture(scope="module")
def reference(setup):
    """The reference engine's outcome of each case, each run once."""
    from repro.serving import faults as ref_faults
    from repro.serving.engine import ServingEngine as RefEngine

    out = {}
    for name, (deploy, mix, kw, specs) in CASES.items():
        plan = ref_faults.FaultPlan([ref_faults.FaultSpec(**s) for s in specs], seed=0) if specs else None
        eng = RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], fault_plan=plan,
                        retry_policy=ref_faults.RetryPolicy(recovery_charge_s=0.01), **{**deploy, **kw})
        out[name] = _run(eng, _requests(setup["ref_cfg"], mix, ref=True))
    return out


@pytest.fixture(scope="module")
def fifo(setup):
    """The port's uninterrupted runs: FIFO over paged KV, mono and disagg."""
    return {mix: _run(_port_engine(setup, deploy, kv_page_size=PS, sched="fifo"), _requests(setup["cfg"], mix))
            for mix, deploy in (("mono", MONO), ("disagg", DISAGG))}


def test_engine_rejects_unknown_sched(setup):
    from repro.serving.engine import ServingEngine as RefEngine

    with pytest.raises(ValueError) as got:
        ServingEngine(setup["cfg"], setup["params"], max_batch=2, cache_len=64, scheduler="none", device=CPU,
                      sched="sjf")
    with pytest.raises(ValueError) as want:
        RefEngine(setup["ref_cfg"], setup["ref_params"], max_batch=2, cache_len=64, scheduler="none", sched="sjf")
    assert str(got.value) == str(want.value) and "unknown admission scheduler" in str(got.value)


@pytest.mark.parametrize("name", ["mono_priority", "disagg_priority"])
def test_preempted_streams_equal_reference_and_uninterrupted(setup, reference, fifo, name):
    """The chat burst preempts batch slots (their pages spill and return):
    streams equal the uninterrupted FIFO run's and the reference's, and
    every count, the SLO block and the pool equal the reference's."""
    deploy, mix, kw, _ = CASES[name]
    got = _run(_port_engine(setup, deploy, **kw), _requests(setup["cfg"], mix))
    base = fifo[mix]
    assert got == reference[name]
    assert got["streams"] == base["streams"] and base["preemptions"] == 0
    assert got["preemptions"] >= 1 and got["restores"] == got["preemptions"]
    assert got["slo"]["per_tenant"]["chat"] > base["slo"]["per_tenant"]["chat"]
    assert got["slo"]["attainment"] > base["slo"]["attainment"]
    assert got["kv_pages"]["pages_in_use"] == 0
    assert all(len(w or []) == got["preempted"][rid] for rid, w in got["wait_spans"].items())


def test_priority_without_paged_kv_orders_but_never_preempts(setup, reference):
    """Contiguous KV cannot spill: the priority order still admits, nothing
    is preempted, everything completes (K4's path on the card)."""
    deploy, mix, kw, _ = CASES["mono_priority_contiguous"]
    got = _run(_port_engine(setup, deploy, **kw), _requests(setup["cfg"], mix))
    assert got == reference["mono_priority_contiguous"]
    assert got["completed"] == 4 and got["preemptions"] == 0 and got["kv_pages"] is None


def test_spilled_deadline_drop_frees_pages(setup, reference):
    """A spilled request whose deadline passes off-batch is rejected and its
    pages return to the pool; nothing is restored."""
    deploy, mix, kw, _ = CASES["deadline_drop"]
    eng = _port_engine(setup, deploy, **kw)
    reqs = _requests(setup["cfg"], mix)
    got = _run(eng, reqs)
    assert got == reference["deadline_drop"]
    assert (got["preemptions"], got["restores"], got["completed"], got["rejected"]) == (1, 0, 1, 1)
    assert reqs[0].rejected and reqs[0].preemptions == 1 and got["kv_pages"]["pages_in_use"] == 0


def test_attn_loss_while_spilled_replays(setup, reference, fifo):
    """An attention device is lost while requests sit spilled: the re-shard
    dissolves their pages, the restores replay (``spill_replays``), and the
    streams equal the uninterrupted run's; everything equals the
    reference's."""
    deploy, mix, kw, specs = CASES["disagg_attn_loss"]
    got = _run(_port_engine(setup, deploy, specs, **kw), _requests(setup["cfg"], mix))
    assert got == reference["disagg_attn_loss"]
    assert got["streams"] == fifo["disagg"]["streams"]
    assert got["preemptions"] >= 1 and got["restores"] >= 1 and got["spill_replays"] >= 1
    assert got["faults"]["detected"] == 1 and got["faults"]["recoveries"] == 1


def test_reconfigure_while_spilled_restores_by_replay(setup, fifo):
    """A ``reconfigure(n_attn=)`` re-shard while a request is spilled: its
    record falls back to replay, and the streams stay uninterrupted."""
    eng = _port_engine(setup, DISAGG, sched="priority")
    step = eng._decode_iteration

    def decode_iteration():
        if eng._spilled and len(eng.disagg.pools.attn_devices) == 2:
            eng.reconfigure(n_attn=1)  # dissolves every spilled record
            assert all(rec.payload is None for rec in eng._spilled)
        step()

    eng._decode_iteration = decode_iteration
    got = _run(eng, _requests(setup["cfg"], "disagg"))
    assert len(eng.disagg.pools.attn_devices) == 1
    assert got["streams"] == fifo["disagg"]["streams"]
    assert got["spill_replays"] >= 1 and got["restores"] == got["preemptions"] >= 1


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_preemption_on_card_matches_cpu(cuda_device):
    """The mono priority case on the card's kernels (K1 over restored tables
    whose slots and page order moved): outcome equal to the plain versions'
    on the CPU, streams equal the card's FIFO run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    setup = dict(cfg=cfg, layout=ReplicaLayout.round_robin(cfg.num_experts, 2, 3))
    sides = []
    for dev in (CPU, cuda_device):
        outs = [_run(_port_engine(setup, MONO, device=dev, params=tree_to(params, dev), kv_page_size=PS,
                                  sched=sched), _requests(cfg, "mono")) for sched in ("fifo", "priority")]
        assert outs[0]["streams"] == outs[1]["streams"] and outs[1]["preemptions"] >= 1
        sides.append(outs)
    assert sides[0] == sides[1]
