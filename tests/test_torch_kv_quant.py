"""int8 KV caches in the port against the reference: quantisation, the cache
layout, one-token decode (contiguous and paged), scalar-start chunked
prefill and the engine's token streams on ``dsv2-lite-reduced``.

Inputs are made from a seed with numpy and handed to both packages.  int8
values compare exactly.  Scales compare exactly where both packages quantise
the same input; where each first projects K/V itself, the f32 projections
may differ in the last bit (each framework sums the product in its own
order), so the scales of new rows take the f32 tolerance of
``_torch_parity.py``, like every float output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_equal_int, tol_for
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro_torch import bridge
from repro_torch.configs import cache_specs, get_config
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.models import attention as attn
from repro_torch.models import model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import make_paged_caches
from repro_torch.serving.request import WorkloadSpec, sample_requests

B, S, PS = 3, 32, 8  # slots, cache rows, page size
POSITIONS = np.array([4, 17, 31], np.int32)


def _cfgs(num_kv_heads=None):
    """The reduced config in float32 with int8 KV, in both packages."""
    change = dict(dtype="float32", kv_quant=True)
    if num_kv_heads:
        change["num_kv_heads"] = num_kv_heads
    return (dataclasses.replace(ref_get_config("dsv2-lite-reduced"), **change),
            dataclasses.replace(get_config("dsv2-lite-reduced"), **change))


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, nh, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {"wq": (d, nh, hd), "wk": (d, nkv, hd), "wv": (d, nkv, hd), "wo": (nh, hd, d)}
    return {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32) for k, s in shapes.items()}


def _int8_caches(cfg, seed, rows=S):
    """Random int8 K/V with positive f32 scales, ``[B, rows, nkv, (hd)]``."""
    rng = np.random.default_rng(seed)
    shape = (B, rows, cfg.num_kv_heads, cfg.resolved_head_dim)
    out = {k: rng.integers(-127, 128, size=shape).astype(np.int8) for k in ("k", "v")}
    for k in ("k_scale", "v_scale"):
        out[k] = (rng.random(shape[:-1]) * 0.05 + 1e-3).astype(np.float32)
    return out


def _paginate(c, seed):
    """Scatter ``[B, S, ...]`` arrays into shuffled pages; page 0 (null) and
    unused pages hold garbage of the same dtype."""
    rng = np.random.default_rng(seed)
    nblk = S // PS
    P = B * nblk + 2
    bt = (rng.permutation(P - 1)[: B * nblk] + 1).reshape(B, nblk).astype(np.int32)
    out = {"bt": bt}
    for k, v in c.items():
        pool = np.zeros((P, PS, *v.shape[2:]), v.dtype)
        pool[:] = v.reshape(B * nblk, PS, *v.shape[2:])[rng.integers(0, B * nblk, size=P)]
        pool[bt.reshape(-1)] = v.reshape(B * nblk, PS, *v.shape[2:])
        out[k] = pool
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference_exactly(dtype):
    """int8 values and f32 scales equal the reference's bit for bit, zero
    rows (the 1e-8 floor) and exact half-way quotients included."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 9, 2, 64)) * rng.random((4, 9, 2, 1)) * 8).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 1] = np.arange(64) - 31.5  # absmax 32 -> quotients at +-k.5 ties
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    q, scale = attn.quantize_kv(xt)
    q_ref, scale_ref = ref_attn.quantize_kv(xj)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert_equal_int(q, q_ref)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref))
    out_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = attn.dequantize_kv(q, scale, out_dt)
    want = ref_attn.dequantize_kv(q_ref, scale_ref, xj.dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_int8_cache_layout_matches_reference():
    """``kv_quant`` gives int8 K/V with f32 ``[L, B, S, nkv]`` scales, the
    reference's ``_cache_specs``; paging adds scale pools only where the
    config has scales."""
    from repro.configs.base import _cache_specs

    cfg = dataclasses.replace(get_config("dsv2-lite"), kv_quant=True)
    ref_cfg = dataclasses.replace(ref_get_config("dsv2-lite"), kv_quant=True)
    specs = cache_specs(cfg, 8, 512)
    ref_specs = _cache_specs(ref_cfg, 8, 512, jnp.bfloat16)
    assert set(specs) == set(ref_specs) == {"kv_k", "kv_v", "kv_k_scale", "kv_v_scale"}
    for k, (shape, dt) in specs.items():
        assert shape == ref_specs[k].shape
        assert str(dt).split(".")[-1] == ref_specs[k].dtype.name
    for quant in (False, True):
        rcfg = dataclasses.replace(get_config("dsv2-lite-reduced"), kv_quant=quant)
        caches = model.init_decode_caches(rcfg, 2, 32, device="cpu")
        _, paged = make_paged_caches(caches, 2, 32, 8)
        assert set(paged) == set(caches) | {"block_tables"}
        for k in caches:
            assert paged[k].dtype == caches[k].dtype
            assert paged[k].shape[1:3] == (2 * 4 + 1, 8)


def test_int8_caches_cross_the_bridge_exactly():
    rng = np.random.default_rng(0)
    c = {"kv_k": rng.integers(-127, 128, size=(2, 3, 5, 2, 8)).astype(np.int8),
         "kv_k_scale": rng.random((2, 3, 5, 2)).astype(np.float32)}
    t = bridge.caches_from_numpy(c)
    assert t["kv_k"].dtype == torch.int8 and t["kv_k_scale"].dtype == torch.float32
    back = bridge.caches_to_numpy(t)
    for k in c:
        assert back[k].dtype == c[k].dtype
        np.testing.assert_array_equal(back[k], c[k])


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_attention_decode_int8_matches_reference(paged, num_kv_heads):
    """One-token decode over an int8 cache: the quantised writes equal the
    reference's exactly, their scales and the output within f32 tolerance."""
    ref_cfg, cfg = _cfgs(num_kv_heads)
    p = _attn_params(cfg, 1)
    x = np.random.default_rng(2).standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    c = _int8_caches(cfg, 4)
    if paged:
        c = _paginate(c, 5)
    ref_out = ref_attn.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(c["k"]),
        jnp.asarray(c["v"]), jnp.asarray(POSITIONS), ref_cfg, k_scale=jnp.asarray(c["k_scale"]),
        v_scale=jnp.asarray(c["v_scale"]),
        block_tables=jnp.asarray(c["bt"]) if paged else None,
    )
    t = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    out = attn.attention_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), t["k"], t["v"],
        torch.from_numpy(POSITIONS), cfg, k_scale=t["k_scale"], v_scale=t["v_scale"],
        block_tables=t["bt"] if paged else None,
    )
    assert len(out) == len(ref_out) == 5
    assert_close(out[0], ref_out[0], tol_for("float32", "layer"))
    for got, want in zip(out[1:3], ref_out[1:3]):
        assert got.dtype == torch.int8
        assert_equal_int(got, want)
    for got, want in zip(out[3:], ref_out[3:]):
        assert_close(got, want, tol_for("float32"))


def test_attention_prefill_chunk_int8_matches_reference():
    """Two scalar-start chunks (8 then 5 tokens) into an int8 cache: the
    chunk is quantised once, written with its scales and attended through
    the round trip; int8 caches equal the reference's exactly."""
    ref_cfg, cfg = _cfgs()
    p = _attn_params(cfg, 6)
    x = np.random.default_rng(7).standard_normal((1, 13, cfg.d_model)).astype(np.float32)
    shape = (1, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    ref_c = [jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
             jnp.zeros(shape[:-1], jnp.float32), jnp.zeros(shape[:-1], jnp.float32)]
    c = [torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8),
         torch.zeros(shape[:-1]), torch.zeros(shape[:-1])]
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    for lo, hi in ((0, 8), (8, 13)):
        ref_y, *ref_c = ref_attn.attention_prefill_chunk(
            pj, jnp.asarray(x[:, lo:hi]), ref_c[0], ref_c[1], jnp.int32(lo), ref_cfg,
            k_scale=ref_c[2], v_scale=ref_c[3],
        )
        y, *c = attn.attention_prefill_chunk(
            pt, torch.from_numpy(x[:, lo:hi]), c[0], c[1], lo, cfg, k_scale=c[2], v_scale=c[3],
        )
        assert_close(y, ref_y, tol_for("float32", "layer"))
    for got, want in zip(c[:2], ref_c[:2]):
        assert_equal_int(got, want)
    for got, want in zip(c[2:], ref_c[2:]):
        assert_close(got, want, tol_for("float32"))


ENGINE_KW = dict(max_batch=4, cache_len=64, prefill_chunk=16, scheduler="aebs")
SPEC = dict(mean_input=8, mean_output=10, max_input=24, max_output=16, seed=1)
N_REQ = 6


def _streams(eng, reqs):
    m = eng.run(reqs, max_steps=500)
    assert m["completed"] == N_REQ
    return {r.rid: r.tokens_out for r in eng.completed}


def test_engine_int8_float32_streams_equal_reference():
    """float32 ``dsv2-lite-reduced`` with ``kv_quant``, contiguous KV: the
    port's streams equal the reference engine's token for token."""
    from repro.core.placement import build_layout as ref_build_layout
    from repro.models import model as ref_model
    from repro.serving.engine import ServingEngine as RefEngine
    from repro.serving.request import WorkloadSpec as RefSpec
    from repro.serving.request import sample_requests as ref_sample_requests

    ref_cfg, cfg = _cfgs()
    ref_params = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    trace = make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0)
    arrivals = np.zeros(N_REQ)
    ref_eng = RefEngine(ref_cfg, ref_params,
                        layout=ref_build_layout(trace, cfg.num_experts, 2, 3), **ENGINE_KW)
    eng = ServingEngine(cfg, params, layout=build_layout(trace, cfg.num_experts, 2, 3),
                        device="cpu", **ENGINE_KW)
    assert eng.caches["kv_k"].dtype == torch.int8
    want = _streams(ref_eng, ref_sample_requests(RefSpec(vocab_size=cfg.vocab_size, **SPEC),
                                                 arrivals, True))
    got = _streams(eng, sample_requests(WorkloadSpec(vocab_size=cfg.vocab_size, **SPEC),
                                        arrivals, True))
    assert got == want


def test_engine_int8_paged_equals_contiguous():
    """Inside the port, paged int8 KV serves the streams of contiguous int8
    KV (the reference's invariant, ``tests/test_paged_kv.py:399``)."""
    _, cfg = _cfgs()
    params = model.init_params(cfg, seed=0, device="cpu")
    layout = build_layout(make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0),
                          cfg.num_experts, 2, 3)
    runs = []
    for page in (16, None):
        eng = ServingEngine(cfg, params, layout=layout, kv_page_size=page, device="cpu",
                            **ENGINE_KW)
        assert {eng.caches[k].dtype for k in ("kv_k", "kv_v")} == {torch.int8}
        reqs = sample_requests(WorkloadSpec(vocab_size=cfg.vocab_size, **SPEC), np.zeros(N_REQ), True)
        runs.append(_streams(eng, reqs))
    assert runs[0] == runs[1]
