"""The sliding-window branches of the port's attention
(``repro_torch.models.attention``) against the reference's
(``repro.models.attention``) on gemma2-2b-reduced (window 64, attention
softcap 50) in float32: whole-sequence attention (also query-chunked past
2048 tokens), chunked prefill over the rolling buffer (past its wrap, bf16 /
f32 and int8) and one-token decode over it, plus the refusals.

The reference's chunked window path is among its known bitwise failures
(ROADMAP.md §3), so chunks are held within tolerance of its chunk outputs
and of its whole-prompt caches, never bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention as attn

NAME = "gemma2-2b-reduced"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(kv_quant=False):
    ref_cfg = dataclasses.replace(ref_get_config(NAME), dtype="float32", kv_quant=kv_quant)
    cfg = dataclasses.replace(get_config(NAME), dtype="float32", kv_quant=kv_quant)
    ref_p = ref_attn.init_attention(ref_cfg, jax.random.PRNGKey(5), jnp.float32)
    p = {k: bridge.tensor_from_numpy(np.asarray(v)) for k, v in ref_p.items()}
    return ref_cfg, cfg, ref_p, p


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("window", [None, 16, 64])
def test_attention_full_window_equals_reference(window):
    ref_cfg, cfg, ref_p, p = _setup()
    x = _x((2, 100, cfg.d_model), 1)
    want, (wk, wv) = ref_attn.attention_full(ref_p, jnp.asarray(x), ref_cfg, window=window, return_kv=True)
    got, (k, v) = attn.attention_full(p, torch.from_numpy(x), cfg, window=window, return_kv=True)
    assert_close(got, want, TOL["f32_layer"])
    assert_close(k, wk, TOL["f32_op"])
    assert_close(v, wv, TOL["f32_op"])


def test_attention_full_query_chunked_equals_reference():
    """Past 2048 tokens (a multiple of 256) both sides attend in 256-row
    query blocks, with the window mask of each block's rows."""
    ref_cfg, cfg, ref_p, p = _setup()
    ref_cfg = dataclasses.replace(ref_cfg, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16)
    cfg = dataclasses.replace(cfg, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16)
    ref_p = ref_attn.init_attention(ref_cfg, jax.random.PRNGKey(6), jnp.float32)
    p = {k: bridge.tensor_from_numpy(np.asarray(v)) for k, v in ref_p.items()}
    x = _x((1, 2304, cfg.d_model), 2)
    want = ref_attn.attention_full(ref_p, jnp.asarray(x), ref_cfg, window=64)
    got = attn.attention_full(p, torch.from_numpy(x), cfg, window=64)
    assert_close(got, want, TOL["f32_layer"])


def _empty_cache(cfg, S, quant):
    shape = (1, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    if quant:
        return [np.zeros(shape, np.int8), np.zeros(shape, np.int8), np.zeros(shape[:-1], np.float32),
                np.zeros(shape[:-1], np.float32)]
    return [np.zeros(shape, np.float32), np.zeros(shape, np.float32)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_prefill_chunk_window_past_wrap_equals_reference(chunk, quant):
    """A 150-token prompt through a 64-row rolling buffer in chunks: each
    chunk's output against the reference's chunk, and the final buffer
    (every row a position of the last window) against the reference's."""
    ref_cfg, cfg, ref_p, p = _setup(quant)
    W = cfg.sliding_window
    x = _x((1, 150, cfg.d_model), chunk)
    ref_c = [jnp.asarray(a) for a in _empty_cache(cfg, W, quant)]
    c = [torch.from_numpy(a) for a in _empty_cache(cfg, W, quant)]
    for lo in range(0, 150, chunk):
        xs = x[:, lo : lo + chunk]
        if quant:
            want, *ref_c = ref_attn.attention_prefill_chunk(
                ref_p, jnp.asarray(xs), ref_c[0], ref_c[1], jnp.int32(lo), ref_cfg, window=W,
                k_scale=ref_c[2], v_scale=ref_c[3])
            got, *c = attn.attention_prefill_chunk(p, torch.from_numpy(xs), c[0], c[1], lo, cfg, window=W,
                                                   k_scale=c[2], v_scale=c[3])
        else:
            want, *ref_c = ref_attn.attention_prefill_chunk(ref_p, jnp.asarray(xs), ref_c[0], ref_c[1],
                                                            jnp.int32(lo), ref_cfg, window=W)
            got, *c = attn.attention_prefill_chunk(p, torch.from_numpy(xs), c[0], c[1], lo, cfg, window=W)
        assert_close(got, want, TOL["f32_layer"])
    if quant:
        # one ulp of a scale may move a value by one quantisation step
        for g, w in zip(c[2:], ref_c[2:]):
            assert_close(g, w, TOL["f32_op"])
        for g, w in zip(c[:2], ref_c[:2]):
            assert np.abs(g.numpy().astype(np.int32) - np.asarray(w).astype(np.int32)).max() <= 1
    else:
        for g, w in zip(c, ref_c):
            assert_close(g, w, TOL["f32_op"])
        # the buffer holds the last W positions at rows p % W, as the
        # whole-sequence keys put in their rolling layout do
        _, (k, v) = attn.attention_full(p, torch.from_numpy(x), cfg, return_kv=True)
        rows = np.arange(150 - W, 150) % W
        assert_close(c[0][:, rows], k[:, 150 - W :], TOL["f32_op"])
        assert_close(c[1][:, rows], v[:, 150 - W :], TOL["f32_op"])


@pytest.mark.parametrize("quant", [False, True])
def test_attention_decode_window_past_wrap_equals_reference(quant):
    """One-token decode over a rolling buffer, each slot at its own position
    (before, at and past the wrap): the write at ``pos % W`` and the output
    against the reference's, step after step."""
    ref_cfg, cfg, ref_p, p = _setup(quant)
    W = cfg.sliding_window
    rng = np.random.default_rng(7)
    shape = (3, W, cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = _x(shape, 8), _x(shape, 9)
    if quant:
        (kq, ks), (vq, vs) = attn.quantize_kv(torch.from_numpy(k)), attn.quantize_kv(torch.from_numpy(v))
        arrays = [kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()]
    else:
        arrays = [k, v]
    ref_c = [jnp.asarray(a) for a in arrays]
    c = [torch.from_numpy(a.copy()) for a in arrays]
    pos = np.array([20, W - 1, 150])
    for step in range(4):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        kw_ref = dict(k_scale=ref_c[2], v_scale=ref_c[3]) if quant else {}
        kw = dict(k_scale=c[2], v_scale=c[3]) if quant else {}
        want, *ref_c = ref_attn.attention_decode(ref_p, jnp.asarray(x), ref_c[0], ref_c[1],
                                                 jnp.asarray(pos + step, jnp.int32), ref_cfg, window=W, **kw_ref)
        got, *c = attn.attention_decode(p, torch.from_numpy(x), c[0], c[1], torch.from_numpy(pos + step), cfg,
                                        window=W, **kw)
        assert_close(got, want, TOL["f32_layer"])
        for g, w in zip(c, ref_c):
            if g.dtype == torch.int8:
                assert np.abs(g.numpy().astype(np.int32) - np.asarray(w).astype(np.int32)).max() <= 1
            else:
                assert_close(g, w, TOL["f32_op"])


def test_window_refusals_equal_reference():
    """A vector-start (batched) chunk and a chunk longer than the buffer
    raise, as do a window over paged KV, each as the reference's does; the
    prefill worker clamps its chunk to the window."""
    from repro.models import model as ref_model
    from repro.serving.prefill import PrefillWorker as RefWorker
    from repro_torch.serving.prefill import PrefillWorker

    ref_cfg, cfg, ref_p, p = _setup()
    W = cfg.sliding_window
    cache = [torch.zeros((2, W, cfg.num_kv_heads, cfg.resolved_head_dim)) for _ in range(2)]
    ref_cache = [jnp.zeros((2, W, cfg.num_kv_heads, cfg.resolved_head_dim)) for _ in range(2)]
    x = _x((2, W + 1, cfg.d_model), 3)
    with pytest.raises(ValueError, match="must not exceed the window"):
        attn.attention_prefill_chunk(p, torch.from_numpy(x), *cache, 0, cfg, window=W)
    with pytest.raises(ValueError, match="must not exceed the window"):
        ref_attn.attention_prefill_chunk(ref_p, jnp.asarray(x), *ref_cache, jnp.int32(0), ref_cfg, window=W)
    starts, lens = torch.zeros(2, dtype=torch.int64), torch.full((2,), 4)
    with pytest.raises(ValueError, match="full-context layers"):
        attn.attention_prefill_chunk(p, torch.from_numpy(x[:, :4]), *cache, starts, cfg, window=W, lengths=lens)
    with pytest.raises(ValueError, match="full-context layers"):
        ref_attn.attention_prefill_chunk(ref_p, jnp.asarray(x[:, :4]), *ref_cache, jnp.zeros(2, jnp.int32),
                                         ref_cfg, window=W, lengths=jnp.full(2, 4))
    pool = torch.zeros((5, 16, cfg.num_kv_heads, cfg.resolved_head_dim))
    bt = torch.ones((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="rolling windows"):
        attn.attention_decode(p, torch.from_numpy(x[:, :1]), pool, pool, torch.zeros(2), cfg, window=W,
                              block_tables=bt)
    with pytest.raises(ValueError, match="rolling windows"):
        ref_attn.attention_decode(ref_p, jnp.asarray(x[:, :1]), jnp.zeros(pool.shape), jnp.zeros(pool.shape),
                                  jnp.zeros(2, jnp.int32), ref_cfg, window=W, block_tables=jnp.ones((2, 2), jnp.int32))
    full_ref = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, full_ref))
    for cache_len, chunk in ((128, 256), (32, 48), (256, 16)):
        ref_w = RefWorker(ref_cfg, full_ref, [], cache_len=cache_len, chunk=chunk)
        w = PrefillWorker(cfg, params, [], device="cpu", cache_len=cache_len, chunk=chunk)
        assert w.chunk == ref_w.chunk == min(chunk, cache_len, W)
