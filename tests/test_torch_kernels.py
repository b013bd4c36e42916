"""The port's kernel modules against the reference's ops.

On the CPU each wrapper runs its plain version, which is held here against
the reference's Pallas op (interpret mode, as ``tests/test_kernels.py`` and
``tests/test_paged_kv.py`` run it) on the same seeded numpy inputs.  The
``gpu``-marked test holds each CUDA kernel against its plain version on the
card.  This file imports the reference inside the tests, so the card's
machine, which has no JAX, can collect and run the ``gpu`` test alone.
"""

import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, assert_equal_int, tol_for
from repro_torch.core.aebs import aebs_numpy
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.kernels import cuda
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_int8,
    decode_attention_int8_ref,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
)
from repro_torch.kernels.expert_ffn.ops import expert_ffn_grouped, expert_ffn_grouped_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype=None, device="cpu"):
    """numpy -> torch; float arrays are cast to ``dtype`` (round to nearest
    even, as ``_j`` does on the reference side, so both see the same bits)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t.to(DTYPES[dtype]) if dtype and t.is_floating_point() else t


def _j(a, dtype=None):
    import jax.numpy as jnp

    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" and x.dtype == jnp.float32 else x


# ---------------------------------------------------------------------------
# K1 paged decode attention
# ---------------------------------------------------------------------------


def _paged_inputs(rng, B, nh, nkv, hd, ps, P, nblk):
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    bt = (rng.permutation(P - 1)[: B * nblk].reshape(B, nblk) + 1).astype(np.int32)
    return q, k, v, bt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
def test_paged_decode_plain_matches_reference(logit_cap, dtype):
    """G = 2 query heads per KV head, per-slot lengths ending mid page."""
    from repro.kernels.decode_attention.ops import paged_decode_attention as ref_op

    rng = np.random.default_rng(1)
    B, nh, nkv, hd, ps, P, nblk = 3, 4, 2, 8, 4, 13, 4
    q, k, v, bt = _paged_inputs(rng, B, nh, nkv, hd, ps, P, nblk)
    lens = np.array([1, 7, 16], np.int32)
    got = paged_decode_attention(*[_t(a, dtype) for a in (q, k, v, bt, lens)], logit_cap=logit_cap)
    want = ref_op(*[_j(a, dtype) for a in (q, k, v, bt, lens)], logit_cap=logit_cap)
    assert got.dtype == DTYPES[dtype]
    assert_close(got, want, tol_for(dtype))


def test_paged_decode_plain_ignores_unbacked_tail():
    """Rows past the lengths -- null-page blocks and backed tails -- never
    leak: pools differing only there give the same output, which matches the
    reference."""
    from repro.kernels.decode_attention.ops import paged_decode_attention as ref_op

    rng = np.random.default_rng(2)
    B, nh, nkv, hd, ps, P = 2, 2, 1, 8, 4, 6
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    bt = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    lens = np.array([6, 3], np.int32)
    base = paged_decode_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens))
    k2, v2 = k.copy(), v.copy()
    k2[0], v2[0] = 7.0, -7.0
    k2[2, 2:], v2[3, 3:] = 9.0, -9.0
    got = paged_decode_attention(_t(q), _t(k2), _t(v2), _t(bt), _t(lens))
    np.testing.assert_array_equal(base.numpy(), got.numpy())
    want = ref_op(*[_j(a) for a in (q, k2, v2, bt, lens)])
    assert_close(got, want, TOL["f32_op"])


# ---------------------------------------------------------------------------
# K4 / K5 decode attention over a contiguous (int8) cache
# ---------------------------------------------------------------------------


def _contiguous_inputs(rng, B, nh, nkv, hd, S):
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    return q, k, v


def _quantised(a):
    """numpy int8 values and f32 scales of ``a`` through the port's
    ``quantize_kv`` (equal to the reference's, ``test_torch_kv_quant.py``)."""
    from repro_torch.models.attention import quantize_kv

    vals, scale = quantize_kv(torch.from_numpy(a))
    return vals.numpy(), scale.numpy()


KV_SWEEP = [(1, 128), (2, 64), (4, 64)]  # (query heads per KV head, head_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
@pytest.mark.parametrize("G,hd", KV_SWEEP)
def test_decode_plain_matches_reference(G, hd, logit_cap, dtype):
    """K4's plain version against the reference's Pallas op (interpret
    mode) with a partial valid_len."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import decode_attention as ref_op

    rng = np.random.default_rng(G * hd)
    B, nkv, S = 2, 2, 48
    q, k, v = _contiguous_inputs(rng, B, G * nkv, nkv, hd, S)
    got = decode_attention(*[_t(a, dtype) for a in (q, k, v)], 29, logit_cap=logit_cap)
    want = ref_op(*[_j(a, dtype) for a in (q, k, v)], jnp.int32(29), logit_cap=logit_cap)
    assert got.dtype == DTYPES[dtype]
    assert_close(got, want, tol_for(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
@pytest.mark.parametrize("G,hd", KV_SWEEP)
def test_decode_int8_plain_matches_reference(G, hd, logit_cap, dtype):
    """K5's plain version against the reference's Pallas op (interpret
    mode).  The plain version rounds the dequantised rows to q's dtype, as
    the reference's oracle does; the TPU kernel keeps them in f32."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import decode_attention_int8 as ref_op

    rng = np.random.default_rng(G * hd + 1)
    B, nkv, S = 2, 2, 48
    q, k, v = _contiguous_inputs(rng, B, G * nkv, nkv, hd, S)
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    got = decode_attention_int8(_t(q, dtype), *[_t(a) for a in (kq, vq, ks, vs)], 17,
                                logit_cap=logit_cap)
    want = ref_op(_j(q, dtype), *[_j(a) for a in (kq, vq, ks, vs)], jnp.int32(17),
                  logit_cap=logit_cap)
    assert got.dtype == DTYPES[dtype]
    assert_close(got, want, tol_for(dtype))


def test_decode_plain_per_slot_lengths_match_reference_rows():
    """Per-slot ``[B]`` lengths (what the engine passes) give, row by row,
    the reference oracle's output at that slot's scalar valid_len; a scalar
    valid_len is broadcast."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ref import decode_attention_int8_ref as ref_int8
    from repro.kernels.decode_attention.ref import decode_attention_ref as ref_fp

    rng = np.random.default_rng(4)
    B, nh, nkv, hd, S = 3, 4, 2, 64, 40
    q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, S)
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    lens = np.array([1, 23, S], np.int32)
    got = decode_attention(_t(q), _t(k), _t(v), _t(lens))
    got8 = decode_attention_int8(*[_t(a) for a in (q, kq, vq, ks, vs, lens)])
    for b, n in enumerate(lens):
        row = slice(b, b + 1)
        want = ref_fp(*[_j(a[row]) for a in (q, k, v)], jnp.int32(n))
        assert_close(got[row], want, TOL["f32_op"])
        want8 = ref_int8(*[_j(a[row]) for a in (q, kq, vq, ks, vs)], jnp.int32(n))
        assert_close(got8[row], want8, TOL["f32_op"])
    full = decode_attention(_t(q), _t(k), _t(v), S)
    np.testing.assert_array_equal(full[2].numpy(), got[2].numpy())


# ---------------------------------------------------------------------------
# K2 AEBS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,n_e,C,T,k", [
    (16, 4, 5, 64, 2),
    (64, 8, 12, 300, 6),
    (60, 16, 4, 128, 4),
    (256, 16, 17, 512, 8),
])
def test_aebs_plain_matches_reference(E, n_e, C, T, k):
    from repro.core.aebs import aebs_numpy as ref_aebs_numpy
    from repro.core.amax import make_routing_trace as ref_trace
    from repro.core.placement import build_layout as ref_build_layout

    trace = make_routing_trace(max(T, 512), E, k, skew=0.8, seed=E)
    np.testing.assert_array_equal(trace, ref_trace(max(T, 512), E, k, skew=0.8, seed=E))
    layout = build_layout(trace, E, n_e, C)
    ref_layout = ref_build_layout(trace, E, n_e, C)
    for name in ("slot_to_expert", "expert_hosts", "replica_counts", "slot_of"):
        np.testing.assert_array_equal(getattr(layout, name), getattr(ref_layout, name))
    eids = torch.from_numpy(trace[:T])
    slot_ids, load, act_rep = aebs_schedule(eids, layout.device_tables("cpu"), n_e)
    s_n, load_n, rep_n = ref_aebs_numpy(trace[:T], ref_layout)
    assert slot_ids.dtype == load.dtype == act_rep.dtype == torch.int32
    assert_equal_int(slot_ids, s_n)
    assert_equal_int(load, load_n)
    assert_equal_int(act_rep, rep_n)
    # the port's own numpy copy agrees as well
    for a, b in zip(aebs_numpy(trace[:T], layout), (s_n, load_n, rep_n)):
        assert_equal_int(a, b)


def test_aebs_plain_padding_neutral():
    """Padded items (-1) activate nothing, add no load and map to -1."""
    from repro.core.aebs import aebs_numpy as ref_aebs_numpy

    E, n_e, C, k = 32, 4, 9, 4
    trace = make_routing_trace(512, E, k, skew=0.5, seed=9)
    layout = build_layout(trace, E, n_e, C)
    eids = np.full((128, k), -1, np.int32)
    eids[:100] = trace[:100]
    slot_ids, load, _ = aebs_schedule(torch.from_numpy(eids), layout.device_tables("cpu"), n_e)
    s_n, load_n, _ = ref_aebs_numpy(trace[:100], layout)
    assert_equal_int(load, load_n)
    assert_equal_int(slot_ids[:100], s_n)
    assert (slot_ids[100:] == -1).all()


# ---------------------------------------------------------------------------
# K3 grouped expert FFN
# ---------------------------------------------------------------------------


def _ffn_inputs(rng, S, E, CAP, d, f):
    x = (rng.standard_normal((S, CAP, d)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((E, d, f)) * 0.05).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) * 0.05).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) * 0.05).astype(np.float32)
    return x, wg, wu, wd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,CAP,d,f", [
    (4, 16, 128, 256),
    (8, 64, 256, 1024),
    (16, 8, 512, 1408),  # dsv2-lite's d_ff_expert (not a power of two)
    (3, 32, 256, 512),
])
def test_expert_ffn_plain_matches_reference(S, CAP, d, f, dtype):
    from repro.kernels.expert_ffn.ops import expert_ffn as ref_op

    rng = np.random.default_rng(S * f)
    x, wg, wu, wd = _ffn_inputs(rng, S, S, CAP, d, f)
    act = (rng.random(S) < 0.6).astype(np.int32)
    s2e = np.arange(S, dtype=np.int32)
    got = expert_ffn_grouped(*[_t(a, dtype) for a in (x, wg, wu, wd, s2e, act)])
    want = ref_op(*[_j(a, dtype) for a in (x, wg, wu, wd, act)])
    assert got.dtype == DTYPES[dtype]
    assert_close(got, want, tol_for(dtype))
    assert (got.float()[torch.from_numpy(act == 0)] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,E,CAP,d,f", [
    (6, 4, 16, 128, 256),  # replica slots > experts
    (10, 3, 8, 256, 512),  # heavy replication + empty slots
])
def test_expert_ffn_slot_indirect_plain_matches_reference(S, E, CAP, d, f, dtype):
    from repro.kernels.expert_ffn.ops import expert_ffn_grouped as ref_op

    rng = np.random.default_rng(S * f + 1)
    x, wg, wu, wd = _ffn_inputs(rng, S, E, CAP, d, f)
    m = np.arange(S) % (E + 1)
    s2e = np.where(m == E, -1, m).astype(np.int32)
    act = (rng.random(S) < 0.7).astype(np.int32)
    got = expert_ffn_grouped(*[_t(a, dtype) for a in (x, wg, wu, wd, s2e, act)])
    want = ref_op(*[_j(a, dtype) for a in (x, wg, wu, wd, s2e, act)])
    assert_close(got, want, tol_for(dtype))
    dead = torch.from_numpy((act == 0) | (s2e < 0))
    assert (got.float()[dead] == 0).all()


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device):
    dev = cuda_device
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    before = dict(cuda.LAUNCHES)

    # K1: every G and head_dim the kernel is built for, softcap on and off,
    # mid-page lengths; the second case is the serving path's shape
    for (B, nh, nkv, hd, ps, P, nblk), cap in (((3, 8, 2, 64, 4, 40, 8), 0.0),
                                               ((8, 16, 16, 128, 16, 257, 32), 30.0),
                                               ((4, 4, 2, 128, 16, 40, 8), 0.0),
                                               ((2, 16, 2, 256, 8, 12, 5), 30.0)):
        for dtype in ("float32", "bfloat16"):
            q, k, v, bt = _paged_inputs(rng, B, nh, nkv, hd, ps, P, nblk)
            lens = rng.integers(1, nblk * ps + 1, size=B).astype(np.int32)
            args = [_t(a, dtype, dev) for a in (q, k, v, bt, lens)]
            got = paged_decode_attention(*args, logit_cap=cap)
            want = paged_decode_attention_ref(*args, logit_cap=cap)
            assert_close(got, want, tol_for(dtype))

    # K4 and K5: every G and head_dim the kernels are built for, softcap on
    # and off, random per-slot lengths and a scalar valid_len; the second
    # case is the serving path's shape
    for (B, nh, nkv, hd, S), cap in (((3, 8, 2, 64, 40), 0.0),
                                     ((8, 16, 16, 128, 512), 30.0),
                                     ((4, 4, 2, 128, 100), 0.0),
                                     ((2, 16, 2, 256, 70), 30.0)):
        q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, S)
        (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
        lens = rng.integers(1, S + 1, size=B).astype(np.int32)
        for dtype in ("float32", "bfloat16"):
            for valid in (_t(lens, device=dev), S // 2):
                args = [_t(a, dtype, dev) for a in (q, k, v)] + [valid]
                got = decode_attention(*args, logit_cap=cap)
                assert_close(got, decode_attention_ref(*args, logit_cap=cap), tol_for(dtype))
                args = [_t(q, dtype, dev)] + [_t(a, device=dev) for a in (kq, vq, ks, vs)] + [valid]
                got = decode_attention_int8(*args, logit_cap=cap)
                want = decode_attention_int8_ref(*args, logit_cap=cap)
                assert_close(got, want, tol_for(dtype))

    # K2: the reference's sweep, padding included; integers exact
    for E, n_e, C, T, k in ((16, 4, 5, 64, 2), (64, 8, 12, 300, 6), (64, 4, 17, 8, 6),
                            (256, 16, 17, 512, 8)):
        trace = make_routing_trace(max(T, 512), E, k, skew=0.8, seed=E)
        layout = build_layout(trace, E, n_e, C)
        eids = trace[:T].copy()
        eids[-1] = -1
        got = aebs_schedule(_t(eids, device=dev), layout.device_tables(dev), n_e)
        want = aebs_schedule(_t(eids), layout.device_tables("cpu"), n_e)
        for a, b in zip(got, want):
            assert_equal_int(a, b)

    # K3: stacked and slot-indirect maps, with empty and inactive slots
    for S, E, CAP, d, f in ((6, 4, 16, 128, 256), (64, 64, 4, 2048, 1408), (10, 3, 64, 256, 160)):
        for dtype in ("float32", "bfloat16"):
            x, wg, wu, wd = _ffn_inputs(rng, S, E, CAP, d, f)
            m = np.arange(S) % (E + 1)
            s2e = np.where(m == E, -1, m).astype(np.int32)
            act = (rng.random(S) < 0.7).astype(np.int32)
            args = [_t(a, dtype, dev) for a in (x, wg, wu, wd, s2e, act)]
            got = expert_ffn_grouped(*args)
            want = expert_ffn_grouped_ref(*args)
            assert_close(got, want, tol_for(dtype))
    torch.cuda.synchronize()
    assert all(cuda.LAUNCHES[n] > before[n] for n in before)
