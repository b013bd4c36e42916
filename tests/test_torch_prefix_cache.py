"""The port's prefix cache (``repro_torch.serving.kv_cache``: the refcounted
``PageAllocator``, ``PagedKVCache.splice``, ``PrefixIndex``; the engine's
splice and publish on both executors) against the reference's, on
``dsv2-lite-reduced`` in float32.

Allocator state, block tables, copy-on-write triples, index matches, pages
and stats equal the reference's exactly.  Prefix-hit engine streams equal
the reference's token for token and the port's own prefix-off streams; the
``prefix_cache`` and ``kv_pages`` stats equal the reference's, and after a
drain the only live pages are the index's pins.  Weights are drawn by the
reference and carried across with ``repro_torch.bridge``.  JAX and ``repro``
are imported inside the tests: the card's machine, which runs the ``gpu``
test, has no JAX.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch
from _hypo import given, settings, st

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.core.scaling import PerfModel
from repro_torch.models import model as model_mod
from repro_torch.models.common import tree_to
from repro_torch.serving import faults
from repro_torch.serving import kv_cache
from repro_torch.serving.controller import AutoScaler
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests, shared_prefix_spec

CPU = torch.device("cpu")
PS = 16  # page size of the engine cases
# tests/test_prefix_cache.py's mono deployment (`_mono_engine`), on dsv2-lite
MONO = dict(max_batch=3, cache_len=64, scheduler="aebs", n_prefill=1, prefill_chunk=8, kv_page_size=PS,
            step_time_fn=lambda n: 2e-3, prefill_time_fn=lambda n: 1e-3 + n * 1e-3)
# its disagg deployment (`_disagg_engine`)
DISAGG = dict(max_batch=4, cache_len=64, scheduler="aebs", capacity_tokens=64, executor="disagg", n_attn=2,
              n_prefill=1, prefill_chunk=4, kv_page_size=PS, step_time_fn=lambda n: 2e-3,
              prefill_time_fn=lambda n: 1e-3 + n * 1e-3)
# disagg runs: (fault specs as kwargs, engine options)
DISAGG_RUNS = {
    "warm": (None, dict(prefix_cache=True)),
    "warm_attn_kill": ([dict(kind="device_loss", pool="attn", index=1, at_step=6)], dict(prefix_cache=True)),
    "warm_prefill_kill": ([dict(kind="device_loss", pool="prefill", index=0, at_step=14)],
                          dict(prefix_cache=True)),
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
# (i) the allocator's refcounts
# ---------------------------------------------------------------------------


def _drive_allocator(mod, ops, num_pages=8):
    """Apply ``ops`` (alloc / ref / free, picked by ``op % 3``) and log each
    outcome with the free list and refcounts after it."""
    alloc = mod.PageAllocator(num_pages)
    held = {}
    log = []
    for op in ops:
        kind = op % 3
        try:
            if kind == 0:
                out = alloc.alloc()
                held[out] = held.get(out, 0) + 1
            elif held:
                p = sorted(held)[op % len(held)]
                out = alloc.ref(p) if kind == 1 else alloc.free(p)
                held[p] += 1 if kind == 1 else -1
                if not held[p]:
                    del held[p]
            else:
                out = alloc.free(op % num_pages)
        except RuntimeError as e:
            out = str(e)
        log.append((out, list(alloc._free), dict(alloc._refs), alloc.in_use, alloc.num_free, alloc.peak_in_use,
                    [alloc.refcount(p) for p in range(num_pages)]))
    return log


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=99), min_size=1, max_size=120))
def test_page_allocator_ops_equal_reference(ops):
    """Any alloc / ref / free sequence: free lists, refcounts and errors equal
    the reference's after every op."""
    from repro.serving import kv_cache as ref_kv

    assert _drive_allocator(kv_cache, ops) == _drive_allocator(ref_kv, ops)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_allocator_seeded_ops_equal_reference(seed):
    """The property above on seeded sequences (it runs without hypothesis),
    exhausting the pool and freeing past zero on the way."""
    from repro.serving import kv_cache as ref_kv

    ops = np.random.default_rng(seed).integers(0, 100, size=150).tolist()
    got = _drive_allocator(kv_cache, ops)
    assert got == _drive_allocator(ref_kv, ops)
    assert any("out of KV pages" in str(g[0]) for g in got) or seed % 2  # exhaustion shows up


def test_page_allocator_ref_errors_equal_reference():
    from repro.serving import kv_cache as ref_kv

    outs = []
    for mod in (kv_cache, ref_kv):
        alloc = mod.PageAllocator(4)
        log = []
        for op, arg in (("ref", 1), ("alloc", None), ("ref", 1), ("free", 1), ("refcount", 1), ("free", 1),
                        ("free", 1), ("refcount", 1)):
            try:
                log.append(getattr(alloc, op)(*(() if arg is None else (arg,))))
            except RuntimeError as e:
                log.append(str(e))
        outs.append(log)
    assert outs[0] == outs[1]
    assert "unallocated" in outs[0][0] and "double free" in outs[0][6]


# ---------------------------------------------------------------------------
# (ii) splice and copy-on-write
# ---------------------------------------------------------------------------


def _pager_state(pager):
    return (pager.tables.tolist(), [pager.slot_pages(s) for s in range(pager.max_batch)], pager.hiwater.tolist(),
            dict(pager.allocator._refs), list(pager.allocator._free), pager.stats())


def test_splice_and_cow_equal_reference():
    """tests/test_prefix_cache.py's splice sequence on both pagers: the
    copy-on-write triples, tables, refcounts and errors equal."""
    from repro.serving import kv_cache as ref_kv

    outs = []
    for mod in (kv_cache, ref_kv):
        pager = mod.PagedKVCache(4, 64, 16)
        pager.ensure(0, 39)  # 3 pages, the last 8 rows deep
        src = pager.slot_pages(0)
        log = [pager.splice(1, src, 40), _pager_state(pager), pager.splice(2, src, 32), _pager_state(pager),
               pager.splice(3, src, 0)]
        pager.release(1)
        pager.release(2)
        log.append(_pager_state(pager))
        for slot, pages, n in ((0, src, 16), (3, src[:1], 40)):
            try:
                pager.splice(slot, pages, n)
            except (RuntimeError, ValueError) as e:
                log.append(str(e))
        outs.append(log)
    assert outs[0] == outs[1]
    cow = outs[0][0]
    assert cow is not None and cow[2] == 8 and cow[1] not in outs[0][1][1][0]
    assert "fresh slot" in outs[0][-2] and "need" in outs[0][-1]


def test_splice_cow_copies_every_layer_and_seeds_the_rows():
    """The engine's splice on a mono paged pool: the new slot's table shares
    the full pages, its private tail page holds the copied rows of every
    layer and key, and the seed is exactly the prefix's rows."""
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    eng = ServingEngine(cfg, model_mod.init_params(cfg, seed=0, device="cpu"), device=CPU, prefix_cache=True,
                        layout=ReplicaLayout.round_robin(cfg.num_experts, 2, 3),
                        **{**MONO, "n_prefill": 0, "prefill_chunk": 24})
    pool = eng.caches["kv_k"]
    pool.copy_(torch.randn(pool.shape))
    eng.caches["kv_v"].copy_(torch.randn(pool.shape))
    prompt = np.arange(60, dtype=np.int32)
    eng.paged.ensure(0, 47)
    eng.prefix.publish(prompt, 48, 0)  # chunks of 24: pages of blocks 0-2
    req = sample_requests(WorkloadSpec(vocab_size=cfg.vocab_size, seed=0), np.zeros(1), True)[0]
    req.prompt, req.input_len = prompt, len(prompt)
    eng.slots.reserve(req, slot=1)
    start, seed = eng._prefix_splice(req, req.slot)
    assert start == 48
    src, dst = eng.paged.slot_pages(0), eng.paged.slot_pages(req.slot)
    assert dst == src[:3]  # 48 rows = 3 full pages, no copy-on-write
    eng.paged.release(req.slot)
    # a 24-token match: one full page adopted, 8 rows copied into a private page
    eng.prefix.drop_all()
    eng.prefix = kv_cache.PrefixIndex(24, eng.paged)
    eng.prefix.publish(prompt, 24, 0)
    short = dataclasses.replace(req, prompt=prompt[:40], input_len=40)
    start, seed = eng._prefix_splice(short, req.slot)
    pages = eng.paged.slot_pages(req.slot)
    assert start == 24 and pages[0] == src[0] and pages[1] not in src
    assert eng.paged.allocator.refcount(src[0]) == 3 and eng.paged.allocator.refcount(pages[1]) == 1
    for k in ("kv_k", "kv_v"):
        assert torch.equal(eng.caches[k][:, pages[1], :8], eng.caches[k][:, src[1], :8])
        want = eng.caches[k][:, torch.tensor(src[:2])].reshape(pool.shape[0], 32, *pool.shape[3:])[:, :24]
        assert torch.equal(seed[k], want)
    assert torch.equal(eng.caches["block_tables"], torch.from_numpy(eng.paged.tables))


def test_prefill_never_writes_a_shared_page():
    """The chunk sink refuses to write rows into a page another holder
    shares (a replay or requeue that skipped the re-splice would)."""
    pager = kv_cache.PagedKVCache(2, 64, 16)
    pager.ensure(0, 31)
    pager.splice(1, pager.slot_pages(0), 32)
    caches = {"kv_k": torch.zeros((1, pager.num_pages, 16, 1, 2)), "kv_v": torch.zeros((1, pager.num_pages, 16, 1, 2))}
    one = {k: torch.ones((1, 1, 64, 1, 2)) for k in caches}
    with pytest.raises(RuntimeError, match="shared pages"):
        kv_cache.scatter_prefill_chunk_paged(caches, one, 1, 16, 16, pager)
    kv_cache.scatter_prefill_chunk_paged(caches, one, 1, 32, 16, pager)  # a fresh page is fine
    assert pager.allocator.refcount(pager.slot_pages(1)[2]) == 1


# ---------------------------------------------------------------------------
# (iii) the index: publish, lookup, LRU eviction
# ---------------------------------------------------------------------------


def _index_script(mod):
    """tests/test_prefix_cache.py's round trip and LRU cases on one side:
    every match, page list, added count and stats."""
    log = []
    pager = mod.PagedKVCache(2, 64, 16)
    index = mod.PrefixIndex(8, pager)
    tokens = np.arange(32, dtype=np.int32)
    pager.ensure(0, 31)
    log.append(index.publish(tokens, 32, 0))
    pager.release(0)
    fork = tokens.copy()
    fork[20:] += 1000
    for toks, limit in ((tokens, None), (fork, None), (tokens, 24), (tokens + 7, None)):
        log.append(index.lookup(toks, limit))
    log.append(index.stats())
    pager = mod.PagedKVCache(2, 16, 4, num_pages=40)
    index = mod.PrefixIndex(4, pager, max_pages=4)
    a, b = np.arange(16, dtype=np.int32), np.arange(16, dtype=np.int32) + 100
    for toks in (a, b):
        pager.ensure(0, 15)
        log.append(index.publish(toks, 16, 0))
        pager.release(0)
        if toks is a:
            match, pages = index.lookup(a)
            log.append((match, pages, pager.splice(1, pages, 16)))
    log += [index.stats(), index.lookup(a), index.lookup(b), _pager_state(pager)]
    pager.release(1)
    log.append(pager.allocator.in_use)
    index.drop_all()
    log += [index.stats(), _pager_state(pager)]
    return log


def test_prefix_index_publish_lookup_evict_equal_reference():
    from repro.serving import kv_cache as ref_kv

    got, want = _index_script(kv_cache), _index_script(ref_kv)
    assert got == want
    assert got[1][0] == 32 and got[2][0] == 16 and got[3][0] == 24 and got[4] == (0, [])
    assert got[5]["shared_pages"] == 4 and got[5]["hits"] == 3  # chunk 8 < page 16: pins, not pages
    assert got[9]["evicted_pages"] == 4 and got[10] == (0, []) and got[11][0] == 16
    assert got[13] == 4 and got[-2]["shared_pages"] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_longest_prefix_equals_reference(seed):
    """Prompts over a 2-token vocabulary (maximal prefix collisions) published
    one after another: every lookup's match and pages, and the allocator,
    equal the reference's; a budget evicts the same leaves."""
    from repro.serving import kv_cache as ref_kv

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 2, size=int(rng.integers(1, 25))).astype(np.int32) for _ in range(10)]
    logs = []
    for mod in (kv_cache, ref_kv):
        pager = mod.PagedKVCache(1, 32, 4, num_pages=257)
        index = mod.PrefixIndex(4, pager, max_pages=None if seed == 0 else 6 * seed)
        log = []
        for toks in prompts:
            log.append(index.lookup(toks))
            upto = (len(toks) // 4) * 4
            if upto:
                pager.ensure(0, upto - 1)
                log.append(index.publish(toks, upto, 0))
            pager.release(0)
            log.append((index.stats(), pager.allocator.in_use, index.held_pages))
        index.drop_all()
        log.append(pager.allocator.in_use)
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][-1] == 0


# ---------------------------------------------------------------------------
# (iv) the engine: warm = cold, and = the reference's
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


def _shared_reqs(cfg, ref=False, n=6, stagger=0.5, seed=123, shared=10):
    """tests/test_prefix_cache.py's workload: one shared head, tails of
    their own, staggered so that request i publishes before i+1 submits."""
    if ref:
        from repro.serving.request import WorkloadSpec as Spec
        from repro.serving.request import sample_requests as sample
    else:
        Spec, sample = WorkloadSpec, sample_requests
    spec = Spec(mean_input=6, mean_output=6, vocab_size=cfg.vocab_size, max_input=12, max_output=8, seed=seed)
    rs = sample(spec, np.arange(n) * stagger, with_prompts=True)
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, size=shared, dtype=np.int32)
    for i, r in enumerate(rs):
        tail = rng.integers(0, cfg.vocab_size, size=4 + i % 3, dtype=np.int32)
        r.prompt = np.concatenate([head, tail])
        r.input_len = len(r.prompt)
    return rs


def _disagg_reqs(cfg, ref=False):
    """Request 0 publishes the prefix and decodes long; 1-5 arrive at ~40 ms,
    splice and queue on the one prefill device (a prefill loss at step 14
    catches them prefilling)."""
    rs = _shared_reqs(cfg, ref, seed=9, stagger=0.0)
    rs[0].output_len = 40
    for i, r in enumerate(rs[1:]):
        r.arrival = 0.04 + 0.001 * i
    return rs


def _outcome(eng, m):
    out = dict(streams={r.rid: list(r.tokens_out) for r in eng.completed}, completed=m["completed"],
               rejected=m["rejected"], prefix_cache=m.get("prefix_cache"), kv_pages=m.get("kv_pages"),
               prefill_chunks=m["prefill_chunks"])
    if "faults" in m:
        out["faults"] = {k: v for k, v in m["faults"].items() if not k.startswith("recovery_latency")}
    return out


def _assert_no_leaks(eng):
    """After a drain the only live pages are the index's pins, each page's
    refcount the number of nodes pinning it."""
    pairs = zip(eng.disagg._indexes, eng.disagg._pagers) if eng.disagg is not None else [(eng.prefix, eng.paged)]
    for idx, pager in pairs:
        pins = Counter(p for node in idx._nodes for p in node.pages)
        assert pager.allocator.in_use == len(pins)
        for p, c in pins.items():
            assert pager.allocator.refcount(p) == c


def _port_engine(setup, deploy, specs=None, device=CPU, params=None, **kw):
    plan = faults.FaultPlan([faults.FaultSpec(**s) for s in specs]) if specs else None
    return ServingEngine(setup["cfg"], setup["params"] if params is None else params, layout=setup["layout"],
                         device=device, fault_plan=plan, retry_policy=faults.RetryPolicy(recovery_charge_s=0.01),
                         **{**deploy, **kw})


@pytest.fixture(scope="module")
def reference(setup):
    """The reference engine's outcome of each case, each run once."""
    from repro.serving import faults as ref_faults
    from repro.serving.engine import ServingEngine as RefEngine

    def run(deploy, reqs, specs=None, **kw):
        plan = ref_faults.FaultPlan([ref_faults.FaultSpec(**s) for s in specs]) if specs else None
        eng = RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], fault_plan=plan,
                        retry_policy=ref_faults.RetryPolicy(recovery_charge_s=0.01), **{**deploy, **kw})
        return _outcome(eng, eng.run(reqs, max_steps=4000))

    cfg = setup["ref_cfg"]
    out = {"mono_warm": run(MONO, _shared_reqs(cfg, True), prefix_cache=True),
           "storm": run(MONO, _storm_reqs(cfg, True), prefix_cache=True)}
    for name, (specs, kw) in DISAGG_RUNS.items():
        out[name] = run(DISAGG, _disagg_reqs(cfg, True), specs, **kw)
    return out


def test_mono_prefix_hit_streams_equal_reference(setup, reference):
    """Cold, warm and warm with 3-prompt batched prefill on the mono engine:
    equal streams (the port's own cold run and the reference's warm one),
    stats equal the reference's, a real hit rate, and only the index's pins
    live after the drain."""
    runs = {}
    for name, kw in (("cold", {}), ("warm", dict(prefix_cache=True)),
                     ("batched", dict(prefix_cache=True, prefill_batch=3))):
        eng = _port_engine(setup, MONO, **kw)
        m = eng.run(_shared_reqs(setup["cfg"]), max_steps=4000)
        runs[name] = (_outcome(eng, m), m)
        if name != "cold":
            _assert_no_leaks(eng)
    cold, warm, batched = (runs[n][0] for n in ("cold", "warm", "batched"))
    want = reference["mono_warm"]
    assert cold["completed"] == 6 and "prefix_cache" not in runs["cold"][1]
    assert warm == want and batched["streams"] == cold["streams"] == want["streams"]
    assert batched["prefix_cache"] == want["prefix_cache"]
    assert want["prefix_cache"]["hits"] >= 4 and want["prefix_cache"]["saved_tokens"] > 0
    assert warm["prefill_chunks"] < cold["prefill_chunks"]
    assert runs["warm"][1]["ttft_mean"] < runs["cold"][1]["ttft_mean"]


@pytest.fixture(scope="module")
def disagg_cold(setup):
    eng = _port_engine(setup, DISAGG)
    m = eng.run(_disagg_reqs(setup["cfg"]), max_steps=4000)
    assert m["completed"] == 6 and "prefix_cache" not in m
    return _outcome(eng, m)["streams"]


@pytest.mark.parametrize("name", list(DISAGG_RUNS))
def test_disagg_prefix_hit_streams_equal_reference(setup, reference, disagg_cold, name):
    """Per-shard indexes on the disagg executor, undisturbed, through an
    attention-device loss (re-shard, replay) and a prefill-device loss
    (requeue: release, re-splice): streams equal the cold run's, outcome
    (streams, stats, fault stats) equal the reference's."""
    specs, kw = DISAGG_RUNS[name]
    eng = _port_engine(setup, DISAGG, specs, **kw)
    got = _outcome(eng, eng.run(_disagg_reqs(setup["cfg"]), max_steps=4000))
    assert got["streams"] == disagg_cold
    assert got == reference[name]
    assert got["prefix_cache"]["hits"] >= 2
    if name == "warm_attn_kill":
        assert got["faults"]["recoveries"] == 1 and got["faults"]["degraded"] == 0
    if name == "warm_prefill_kill":
        assert got["faults"]["requeued"] >= 1 and got["faults"]["degraded"] == 0
    if specs is None or name == "warm_prefill_kill":
        _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# (v) page leaks, pool size, the operator surface
# ---------------------------------------------------------------------------


def _storm_reqs(cfg, ref=False):
    """Four of eight requests have long prompts and a deadline that passes
    mid-prefill, after their splice."""
    reqs = _shared_reqs(cfg, ref, n=8, stagger=0.1)
    rng = np.random.default_rng(7)
    for i, r in enumerate(reqs):
        if 2 <= i < 6:
            tail = rng.integers(0, cfg.vocab_size, size=30, dtype=np.int32)
            r.prompt = np.concatenate([reqs[0].prompt[:10], tail])
            r.input_len = len(r.prompt)
            r.deadline = r.arrival + 0.02
    return reqs


def test_cancel_reject_storm_releases_pages(setup, reference):
    """Requests cancelled mid-prefill release every page they reserved and
    every pin their splice took; the outcome equals the reference's."""
    eng = _port_engine(setup, MONO, prefix_cache=True)
    got = _outcome(eng, eng.run(_storm_reqs(setup["cfg"]), max_steps=6000))
    assert got == reference["storm"]
    assert got["completed"] == 4 and got["rejected"] == 4 and got["prefix_cache"]["hits"] >= 4
    _assert_no_leaks(eng)


def test_cancel_slot_api_releases_pages(setup):
    eng = _port_engine(setup, MONO, prefix_cache=True)
    r0, r1 = _shared_reqs(setup["cfg"], n=2, stagger=0.0)
    assert eng.run([r0], max_steps=2000)["completed"] == 1
    baseline = eng.paged.allocator.in_use  # the index's pins
    assert baseline > 0
    eng._submit_request(r1)  # reserves a slot, splices, queues the prompt
    assert eng.paged.allocator.in_use > baseline
    assert eng.cancel_slot(r1.slot) is r1
    _assert_no_leaks(eng)
    assert eng.slots.slot_req[r1.slot] is None


def test_prefix_cache_options_validate_as_reference(setup):
    """``prefix_cache`` without paged KV is refused with the reference's
    message; an undersized pool that the index's pins and a new prompt
    overflow fails with the allocator's "out of KV pages", on both sides."""
    from repro.serving.engine import ServingEngine as RefEngine

    kw = dict(max_batch=2, cache_len=64, scheduler="aebs")
    with pytest.raises(ValueError) as got:
        ServingEngine(setup["cfg"], setup["params"], layout=setup["layout"], device=CPU, prefix_cache=True, **kw)
    with pytest.raises(ValueError) as want:
        RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"], prefix_cache=True, **kw)
    assert str(got.value) == str(want.value) and "paged KV" in str(got.value)
    msgs = []
    for side in ("port", "ref"):
        cfg = setup["cfg"] if side == "port" else setup["ref_cfg"]
        reqs = _shared_reqs(cfg, side == "ref", n=3, stagger=0.5)
        if side == "port":
            eng = _port_engine(setup, MONO, prefix_cache=True, kv_num_pages=3)
        else:
            eng = RefEngine(cfg, setup["ref_params"], layout=setup["ref_layout"], prefix_cache=True,
                            kv_num_pages=3, **MONO)
        with pytest.raises(RuntimeError) as err:
            eng.run(reqs, max_steps=2000)
        msgs.append((str(err.value), len(eng.completed), eng.paged.allocator.in_use))
    assert msgs[0] == msgs[1] and "out of KV pages" in msgs[0][0]


def test_degrade_under_kv_num_pages_keeps_the_pool_size(setup):
    """A paged degrade to mono re-paginates into the operator's
    ``kv_num_pages`` (each attention shard held its share), not a
    full-backing pool; pages and streams equal the reference's."""
    from repro.serving import faults as ref_faults
    from repro.serving.engine import ServingEngine as RefEngine

    spec = [dict(kind="device_loss", pool="attn", index=0, at_step=5)]
    kw = dict(DISAGG, n_attn=1, kv_num_pages=40)
    eng = _port_engine(setup, kw, spec)
    got = _outcome(eng, eng.run(_shared_reqs(setup["cfg"], n=4, stagger=0.0), max_steps=2000))
    ref = RefEngine(setup["ref_cfg"], setup["ref_params"], layout=setup["ref_layout"],
                    fault_plan=ref_faults.FaultPlan([ref_faults.FaultSpec(**s) for s in spec]),
                    retry_policy=ref_faults.RetryPolicy(recovery_charge_s=0.01), **kw)
    want = _outcome(ref, ref.run(_shared_reqs(setup["ref_cfg"], True, n=4, stagger=0.0), max_steps=2000))
    assert eng.executor_name == "mono" and eng.paged.num_pages == 40
    assert got == want and got["kv_pages"]["num_pages"] == 40


def test_paginate_caches_num_pages_equals_reference():
    import jax.numpy as jnp

    from repro.serving import kv_cache as ref_kv

    rng = np.random.default_rng(4)
    caches = {k: rng.standard_normal((2, 4, 16, 2, 3)).astype(np.float32) for k in ("kv_k", "kv_v")}
    lengths = np.array([5, 0, 16, 9])
    pager, got = kv_cache.paginate_caches({k: torch.from_numpy(v) for k, v in caches.items()}, lengths, 4, 10)
    ref_pager, want = ref_kv.paginate_caches({k: jnp.asarray(v) for k, v in caches.items()}, lengths, 4, 10)
    assert pager.num_pages == 10 and pager.stats() == ref_pager.stats()
    for k in ("kv_k", "kv_v", "block_tables"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    with pytest.raises(RuntimeError, match="out of KV pages"):
        kv_cache.paginate_caches({k: torch.from_numpy(v) for k, v in caches.items()}, lengths, 4, 6)


def test_shared_prefix_workload_equals_reference():
    """``shared_prefix_spec`` draws the reference's requests (the shared head
    after the lengths, before the prompts); without a prefix the draws are
    the old ones."""
    from repro.serving import request as ref_request

    arrivals = np.linspace(0, 1, 6)
    for kw in (dict(vocab_size=100, seed=4), dict(vocab_size=102400, shared_prefix_len=192, mean_input=16,
                                                   max_input=48, mean_output=24, max_output=32)):
        got = sample_requests(shared_prefix_spec(**kw), arrivals, with_prompts=True)
        want = ref_request.sample_requests(ref_request.shared_prefix_spec(**kw), arrivals, with_prompts=True)
        assert [(r.rid, r.arrival, r.input_len, r.output_len, r.prompt.tolist()) for r in got] == [
            (r.rid, r.arrival, r.input_len, r.output_len, r.prompt.tolist()) for r in want]
        n = kw.get("shared_prefix_len", 48)
        assert len({tuple(r.prompt[:n]) for r in got}) == 1 and all(r.input_len == len(r.prompt) for r in got)
    plain = sample_requests(WorkloadSpec(vocab_size=100, seed=4), arrivals, with_prompts=True)
    old = ref_request.sample_requests(ref_request.WorkloadSpec(vocab_size=100, seed=4), arrivals, with_prompts=True)
    assert [r.prompt.tolist() for r in plain] == [r.prompt.tolist() for r in old]


def test_autoscaler_prefix_discount_shrinks_prefill_pool():
    """tests/test_prefix_cache.py's case: a warm cache's ``saved_frac`` (or
    saved tokens per request at ``observe``) shrinks the prefill pool, with
    the reference's decisions."""
    from repro.configs import get_config as ref_get_config
    from repro.core.scaling import PerfModel as RefPerfModel
    from repro.serving.controller import AutoScaler as RefAutoScaler

    decisions = []
    for cfg, PM, AS in ((get_config("dsv2-lite-reduced"), PerfModel, AutoScaler),
                        (ref_get_config("dsv2-lite-reduced"), RefPerfModel, RefAutoScaler)):
        out = []
        ctrl = AS(PM(cfg, slots_per_instance=3, s_ctx=64), slo=0.2, n_max=8, prefill_tok_rate=100.0, window=10.0)
        ctrl.observe(0.0, 16.0, input_tokens=4000.0)
        out.append(ctrl.decide_prefill(1.0))
        ctrl._prefix_saved_frac = 0.8
        out.append(ctrl.decide_prefill(1.0))
        ctrl2 = AS(PM(cfg, slots_per_instance=3, s_ctx=64), slo=0.2, n_max=8, prefill_tok_rate=100.0, window=10.0)
        ctrl2.observe(0.0, 16.0, input_tokens=4000.0, saved_input_tokens=3200.0)
        out.append(ctrl2.decide_prefill(1.0))
        decisions.append(out)
    assert decisions[0] == decisions[1] == [4, 1, 1]


def test_autoscaler_reads_the_engines_saved_frac(setup):
    """``AutoScaler.actuate`` reads ``metrics()["prefix_cache"]["saved_frac"]``
    from a warm disagg engine and discounts the prompt demand with it."""
    eng = _port_engine(setup, DISAGG, prefix_cache=True)
    eng.run(_disagg_reqs(setup["cfg"]), max_steps=4000)
    frac = eng.metrics()["prefix_cache"]["saved_frac"]
    assert frac > 0
    ctrl = AutoScaler(PerfModel(setup["cfg"], slots_per_instance=3, s_ctx=64), slo=0.2, n_max=4,
                      prefill_tok_rate=100.0, window=10.0, n_prefill_max=4)
    ctrl.observe(0.0, 16.0, input_tokens=4000.0)
    ctrl.actuate(eng, now=1.0)
    assert ctrl._prefix_saved_frac == frac


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_prefix_hits_on_card_match_cpu(cuda_device):
    """The mono prefix-hit case on the card's kernels (K1 over shared and
    copied-on-write tables): streams and stats equal the plain versions' on
    the CPU and the card's own prefix-off streams."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    setup = dict(cfg=cfg, layout=ReplicaLayout.round_robin(cfg.num_experts, 2, 3))
    sides = []
    for dev in (CPU, cuda_device):
        outs = []
        for kw in ({}, dict(prefix_cache=True)):
            eng = _port_engine(setup, MONO, device=dev, params=tree_to(params, dev), **kw)
            outs.append(_outcome(eng, eng.run(_shared_reqs(cfg), max_steps=4000)))
        assert outs[0]["streams"] == outs[1]["streams"] and outs[0]["completed"] == 6
        sides.append(outs)
    assert sides[0] == sides[1]
    assert sides[1][1]["prefix_cache"]["hits"] >= 4
