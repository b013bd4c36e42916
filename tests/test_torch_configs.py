"""The port's dense and MoE configs against the reference's: every config
the port registers (``repro_torch.configs.REGISTRY``) and its ``-reduced``
variant, their parameter counts, the dense FFN activations (SwiGLU, GeGLU,
GELU), one-token decode after a prompt on each reduced config, and float32
engine streams on the reduced dense, GeGLU and shared-expert-free MoE
configs.  Weights are drawn by the reference and carried across with
``repro_torch.bridge``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, tol_for
from repro.configs import get_config as ref_get_config
from repro.models import ffn as ref_ffn
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models import ffn, model

NEW = ("dsv2", "scaled-ds-1", "scaled-ds-2", "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "yi-34b",
       "phi4-mini-3.8b", "gemma-7b", "gemma2-2b", "falcon-mamba-7b", "zamba2-2.7b")
FRONTENDS = ("whisper-tiny", "pixtral-12b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Engine runs in one torch thread: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_the_references_dense_and_moe_configs():
    from repro.configs import REGISTRY as REF_REGISTRY

    assert set(REGISTRY) == set(NEW) | set(FRONTENDS) | {"dsv2-lite"}
    assert list(REGISTRY) == list(REF_REGISTRY)


@pytest.mark.parametrize("name", [n + s for n in NEW + ("dsv2-lite",) for s in ("", "-reduced")])
def test_param_counts_equal_reference(name):
    assert get_config(name).param_counts() == ref_get_config(name).param_counts()
    assert get_config(name).kv_bytes_per_token() == ref_get_config(name).kv_bytes_per_token()


@pytest.mark.parametrize("name", [n + s for n in REGISTRY for s in ("", "-reduced")])
def test_total_params_and_expert_fraction_equal_reference(name):
    """``total_params`` (an integer, exact) and ``expert_param_fraction``
    (the same float division, exact) on every registered config."""
    port, ref = get_config(name), ref_get_config(name)
    assert port.total_params() == ref.total_params()
    assert type(port.total_params()) is int
    assert port.expert_param_fraction() == ref.expert_param_fraction()


@pytest.mark.parametrize("name", [n + s for n in FRONTENDS for s in ("", "-reduced")])
def test_frontend_configs_equal_reference(name):
    """The encoder-decoder and vision-patch configs, field for field, with
    the reference's parameter counts (the encoder's terms included)."""
    ref, port = ref_get_config(name), get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.param_counts() == ref.param_counts()
    assert port.kv_bytes_per_token() == ref.kv_bytes_per_token()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_reference(activation, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params = ref_ffn.init_ffn(64, 160, activation, jax.random.PRNGKey(0), jdt)
    params = {k: bridge.tensor_from_numpy(np.asarray(v)) for k, v in ref_params.items()}
    assert set(params) == set(ffn.init_ffn(64, 160, activation, torch.Generator(), torch.float32, "cpu"))
    x = np.random.default_rng(1).standard_normal((3, 5, 64)).astype(np.float32)
    want = ref_ffn.ffn(ref_params, jnp.asarray(x).astype(jdt), activation)
    got = ffn.ffn(params, torch.from_numpy(x).to(params["w_up"].dtype), activation)
    assert got.dtype == params["w_up"].dtype
    assert_close(got, want, tol_for(dtype))


def _bridged(name, dtype="float32"):
    ref_cfg = dataclasses.replace(ref_get_config(name), dtype=dtype)
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    ref_params = ref_model.init_params(ref_cfg, 0)
    return ref_cfg, cfg, ref_params, bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))


@pytest.mark.parametrize("name", [n + "-reduced" for n in NEW])
def test_prefill_then_decode_matches_reference(name):
    """A 24-token prompt then three decode steps (tests/test_decode_consistency.py
    :13-18), float32: every step's logits within ``TOL["f32_layer"]`` of the
    reference's.  MoE capacity is ample on both sides."""
    ref_cfg, cfg, ref_params, params = _bridged(name)
    B, S, D = 2, 24, 3
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + D)).astype(np.int32)
    ref_extra = {"moe_ctx": {"capacity": 512}} if cfg.has_moe else None
    extra = {"moe_ctx": {"capacity": 512}} if cfg.has_moe else None
    want, ref_caches = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :S]), ref_cfg, S + D + 8,
                                         extra=ref_extra)
    got, caches = model.prefill(params, torch.from_numpy(tokens[:, :S]), cfg, S + D + 8, extra=extra)
    assert_close(got, want, TOL["f32_layer"])
    for t in range(D):
        pos = S + t
        want, ref_caches = ref_model.decode_step(
            ref_params, jnp.asarray(tokens[:, pos:pos + 1]), ref_caches, jnp.full((B,), pos, jnp.int32),
            ref_cfg, extra=ref_extra)
        got, caches = model.decode_step(params, torch.from_numpy(tokens[:, pos:pos + 1]), caches,
                                        torch.full((B,), pos), cfg, extra=extra)
        assert_close(got, want, TOL["f32_layer"])


# ---------------------------------------------------------------------------
# float32 engine streams on the reduced dense, GeGLU and shared-expert-free
# MoE configs (tests/test_engine.py:18,65): mono, blocking, paged KV
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch=2, cache_len=64, kv_page_size=16, prefill_chunk=16)
N_REQ = 4


def engine_requests(vocab_size, torch_side: bool):
    """tests/test_engine.py's workload, arriving at once (admission does not
    follow the wall clock)."""
    if torch_side:
        from repro_torch.serving.request import WorkloadSpec, sample_requests
    else:
        from repro.serving.request import WorkloadSpec, sample_requests
    spec = WorkloadSpec(mean_input=6, mean_output=8, vocab_size=vocab_size, max_input=16,
                        max_output=10, seed=0)
    return sample_requests(spec, np.zeros(N_REQ), with_prompts=True)


def serve_both(name, engine_kw, layout_args=None):
    """Serve the workload on the reference's engine and the port's (bridged
    float32 weights); returns ``(ref_engine, engine)``."""
    from repro.core.placement import build_layout as ref_build_layout
    from repro.serving.engine import ServingEngine as RefEngine
    from repro_torch.core.amax import make_routing_trace
    from repro_torch.core.placement import build_layout
    from repro_torch.serving.engine import ServingEngine

    ref_cfg, cfg, ref_params, params = _bridged(name)
    ref_kw, kw = dict(engine_kw), dict(engine_kw)
    if layout_args is not None:
        n_e, C = layout_args
        trace = make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0)
        ref_kw["layout"] = ref_build_layout(trace, cfg.num_experts, n_e, C)
        kw["layout"] = build_layout(trace, cfg.num_experts, n_e, C)
    ref_eng = RefEngine(ref_cfg, ref_params, **ref_kw)
    ref_eng.run(engine_requests(cfg.vocab_size, False), max_steps=500)
    eng = ServingEngine(cfg, params, device="cpu", **kw)
    eng.run(engine_requests(cfg.vocab_size, True), max_steps=500)
    return ref_eng, eng


def streams_of(eng):
    return {r.rid: r.tokens_out for r in eng.completed}


ENGINE_CASES = {
    "phi4-mini-3.8b-reduced": (dict(ENGINE_KW, scheduler="none"), None),
    "gemma-7b-reduced": (dict(ENGINE_KW, scheduler="none"), None),
    "phi3.5-moe-42b-a6.6b-reduced": (dict(ENGINE_KW, scheduler="aebs"), (2, 3)),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_float32_streams_equal_reference(name):
    engine_kw, layout_args = ENGINE_CASES[name]
    ref_eng, eng = serve_both(name, engine_kw, layout_args)
    assert len(eng.completed) == N_REQ
    assert streams_of(eng) == streams_of(ref_eng)
    assert eng.metrics()["kv_pages"] == ref_eng.metrics()["kv_pages"]
