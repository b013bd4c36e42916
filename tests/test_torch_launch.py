"""The port's launch layer (``repro_torch.launch``) against the reference's:
``serving_layout`` exactly, the builders' pools and layouts, a disagg engine
built by ``build_serving_engine`` serving the reference's streams (float32),
and the ``serve`` CLI on ``--device cpu``: the reference CLI test's
arguments (tests/test_paged_kv.py:427) print the reference's metric keys,
and every request completes under each scheduler, both executors, a trace
file, a fault plan and a draft."""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro_torch.configs import REGISTRY, get_config
from repro_torch.launch import serve, steps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE = sorted(n for n, c in REGISTRY.items() if c.has_moe)


@pytest.mark.parametrize("n_e", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", MOE)
def test_serving_layout_equals_reference(name, n_e):
    got, want = steps.serving_layout(get_config(name), n_e), ref_steps.serving_layout(ref_get_config(name), n_e)
    for field in ("slot_to_expert", "expert_hosts", "replica_counts", "slot_of"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert (got.num_instances, got.capacity) == (want.num_instances, want.capacity)


CPU = torch.device("cpu")


def test_builders_split_the_callers_devices_as_reference():
    """Pools and layouts of the three builders over a universe the caller
    hands in (one device aliased, and enough devices for every pool)."""
    cfg = get_config("qwen2-moe-a2.7b-reduced")
    from repro_torch.models import model

    params = model.init_params(cfg, seed=0, device="cpu")
    ex = steps.build_disagg_executor(cfg, params, 2, 2, max_batch=4, cache_len=32, n_prefill=1, device="cpu")
    assert ex.pools.attn_devices == [CPU] * 2 and ex.pools.moe_devices == [CPU] * 2
    assert ex.pools.prefill_devices == [CPU]
    np.testing.assert_array_equal(ex.layout.slot_to_expert,
                                  ref_steps.serving_layout(ref_get_config(cfg.name), 2).slot_to_expert)
    eng = steps.build_serving_engine(cfg, params, 2, 4, max_batch=4, cache_len=32, n_prefill=1,
                                     kv_page_size=16, devices=["cpu"])
    assert eng.executor_name == "disagg" and eng.admission == "pipelined"
    assert eng.layout.num_instances == 4 and eng.disagg.n_moe == 4
    assert len(eng.disagg.pools.attn_devices) == 2 and len(eng.prefill_worker.devices) == 1
    # a worker composed with the deployment lands where its executor reserves prefill
    w = steps.build_prefill_worker(cfg, params, 1, cache_len=32, n_attn=2, n_moe=2, devices=[CPU] * 5)
    assert w.devices == [CPU] and w.cache_len == 32 and w.chunk == 64
    if not torch.cuda.is_available():  # the default device is the card: no quiet CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            steps.build_prefill_worker(cfg, params, 1, cache_len=32)


def test_build_serving_engine_streams_equal_reference():
    """``build_serving_engine`` (2 attention shards, the default layout over
    2 instances, paged KV) serves the float32 streams of the reference's
    ``build_serving_engine``."""
    from repro.models import model as ref_model
    from repro_torch import bridge
    from test_torch_configs import engine_requests, streams_of

    ref_cfg = dataclasses.replace(ref_get_config("qwen2-moe-a2.7b-reduced"), dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b-reduced"), dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    kw = dict(max_batch=4, cache_len=64, kv_page_size=16, prefill_chunk=16, capacity=64)
    ref_eng = ref_steps.build_serving_engine(ref_cfg, ref_params, 2, 2, **kw)
    eng = steps.build_serving_engine(cfg, params, 2, 2, device="cpu", **kw)
    ref_eng.run(engine_requests(cfg.vocab_size, False), max_steps=500)
    eng.run(engine_requests(cfg.vocab_size, True), max_steps=500)
    assert streams_of(eng) == streams_of(ref_eng) and len(eng.completed) > 0
    assert eng.amax_log == ref_eng.amax_log


PAGED_KV_ARGS = ["--arch", "phi4-mini-3.8b", "--scheduler", "none", "--rate", "50", "--duration", "0.04",
                 "--max-batch", "2", "--cache-len", "64", "--kv-page-size", "16"]


def _metric_keys(out):
    return [ln.split()[0] for ln in out.splitlines() if ln.startswith("  ")]


def test_cli_prints_the_references_metrics(monkeypatch, capsys):
    from repro.launch import serve as ref_serve

    monkeypatch.setattr(sys, "argv", ["serve"] + PAGED_KV_ARGS)
    ref_serve.main()
    ref_out = capsys.readouterr().out
    m = serve.main(PAGED_KV_ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _metric_keys(out) == _metric_keys(ref_out) and "kv_pages" in out
    assert m["completed"] == int(ref_out.split("completed")[1].split()[0]) > 0
    assert out.splitlines()[0].startswith("serving ") and "device=cpu" in out.splitlines()[0]


def test_cli_defaults_match_reference():
    """``serve.py:17-26`` of the reference, plus the port's ``--device``."""
    args = serve.parse_args([])
    assert (args.arch, args.scheduler, args.executor, args.device) == ("qwen2-moe-a2.7b", "aebs", "mono", "cuda")
    assert (args.rate, args.duration, args.max_batch, args.cache_len, args.n_instances) == (20.0, 2.0, 8, 256, 4)


def _trace_file(tmp_path):
    spec = {"duration": 0.3, "seed": 3, "tenants": [
        {"name": "chat", "klass": "chat", "rate": 10.0, "priority": 5, "ttft_slo": 0.5,
         "workload": {"mean_input": 8.0, "mean_output": 6.0, "max_input": 16, "max_output": 8}},
        {"name": "batch", "klass": "batch-offline", "rate": 10.0,
         "workload": {"mean_input": 8.0, "mean_output": 6.0, "max_input": 16, "max_output": 8}}]}
    p = tmp_path / "trace.json"
    p.write_text(json.dumps(spec))
    return str(p)


def _fault_file(tmp_path):
    from repro_torch.serving.faults import DEVICE_LOSS, FaultPlan, FaultSpec

    p = tmp_path / "faults.json"
    p.write_text(FaultPlan(faults=[FaultSpec(DEVICE_LOSS, pool="moe", index=0, at_step=3)]).to_json())
    return str(p)


CLI_CASES = {
    "disagg_paged": ["--executor", "disagg", "--n-attn", "2", "--kv-page-size", "16"],
    "random": ["--scheduler", "random"],
    "token_hash": ["--scheduler", "token_hash"],
    "dense_gqa": ["--arch", "phi4-mini-3.8b", "--scheduler", "none", "--kv-page-size", "16"],
    "trace_priority": ["--trace", "TRACE", "--sched", "priority", "--kv-page-size", "16"],
    "fault_plan": ["--executor", "disagg", "--fault-plan", "FAULTS"],
    "self_draft": ["--draft", "qwen2-moe-a2.7b", "--spec-k", "2"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_completes_every_request(case, tmp_path, capsys):
    argv = [a.replace("TRACE", _trace_file(tmp_path)) if a == "TRACE" else a for a in CLI_CASES[case]]
    argv = [_fault_file(tmp_path) if a == "FAULTS" else a for a in argv]
    m = serve.main(argv + ["--duration", "0.3", "--max-batch", "4", "--cache-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    n_req = int(out.split()[1])  # "serving N requests on ..."
    assert m["completed"] == n_req > 0 and not m["rejected"] and not m["truncated"]
    assert f"completed            {n_req}" in out
    if case == "fault_plan":
        assert m["faults"]["recoveries"] == 1
    if case == "self_draft":
        assert m["spec"]["acceptance_rate"] == 1.0
    if case.startswith("disagg"):
        assert m["amax_max"] >= 1


def test_cli_refuses_token_hash_on_disagg_as_reference():
    with pytest.raises(ValueError, match="single-active-replica"):
        serve.main(["--executor", "disagg", "--scheduler", "token_hash", "--duration", "0.1", "--device", "cpu"])
