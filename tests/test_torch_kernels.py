"""The port's kernel modules against the reference's ops.

On the CPU each wrapper runs its plain version, which is held here against
the reference's Pallas op (interpret mode, as ``tests/test_kernels.py`` and
``tests/test_paged_kv.py`` run it) on the same seeded numpy inputs.  The
``gpu``-marked test holds each CUDA kernel against its plain version on the
card.  This file imports the reference inside the tests, so the card's
machine, which has no JAX, can collect and run the ``gpu`` test alone.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (
    TOL, assert_close, assert_equal_int, assert_one_rounding, rounding_excess, tol_for,
)
from repro_torch.core.aebs import aebs_numpy
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.kernels import cuda
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.kernels.decode_attention.ops import (
    KERNEL_GROUPS,
    KERNEL_HEAD_DIMS,
    decode_attention,
    decode_attention_int8,
    decode_attention_int8_ref,
    decode_attention_ref,
    decode_attention_split_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
    split_plan,
    split_rows,
)
from repro_torch.kernels.expert_ffn.ops import expert_ffn_grouped, expert_ffn_grouped_ref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
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


@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("n_split", [1, 2, 7, 64])
def test_decode_split_ref_matches_plain(n_split, G, logit_cap):
    """K4's split-KV decomposition (per-range partials merged in order)
    equals the one-pass plain version, with lengths on and beside the 16-row
    chunk edges and ranges wholly past a slot's length (or past S)."""
    rng = np.random.default_rng(n_split * 10 + G)
    B, nkv, hd, S = 5, 2, 32, 80
    q, k, v = _contiguous_inputs(rng, B, G * nkv, nkv, hd, S)
    lens = _t(np.array([1, 15, 16, 17, S], np.int32))
    got = decode_attention_split_ref(_t(q), _t(k), _t(v), lens, n_split, logit_cap=logit_cap)
    want = decode_attention_ref(_t(q), _t(k), _t(v), lens, logit_cap=logit_cap)
    assert_close(got, want, TOL["f32_op"])


def _paged_view(k, v, rng, ps):
    """Dense ``[B, S, nkv, hd]`` rows laid out as pages of a pool (page 0
    unused) in a random order: ``(k_pages, v_pages, block_tables)``."""
    B, S, nkv, hd = k.shape
    nblk = S // ps
    ids = torch.from_numpy(rng.permutation(B * nblk).astype(np.int64) + 1).to(k.device)
    kp = torch.zeros((B * nblk + 1, ps, nkv, hd), dtype=k.dtype, device=k.device)
    vp = torch.zeros_like(kp)
    kp[ids], vp[ids] = k.reshape(-1, ps, nkv, hd), v.reshape(-1, ps, nkv, hd)
    return kp, vp, ids.reshape(B, nblk).to(torch.int32)


@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("n_split", [1, 2, 7])
def test_paged_split_ref_matches_plain(n_split, G, ps):
    """K1's split (ranges of whole pages of the block table) in plain
    PyTorch over the gathered pages equals the paged plain version, with
    lengths on and beside page and range edges."""
    rng = np.random.default_rng(100 + n_split * 10 + G + ps)
    B, nkv, hd, nblk = 5, 2, 32, 12
    S = nblk * ps
    q, k, v = (_t(a) for a in _contiguous_inputs(rng, B, G * nkv, nkv, hd, S))
    kp, vp, bt = _paged_view(k, v, rng, ps)
    edge = split_rows(S, n_split, ps)
    lens = _t(np.array([1, ps, ps + 1, min(edge + 1, S), S], np.int32))
    got = decode_attention_split_ref(q, k, v, lens, n_split, chunk=ps)
    assert_close(got, paged_decode_attention_ref(q, kp, vp, bt, lens), TOL["f32_op"])


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("n_split", [1, 3])
def test_int8_split_ref_matches_f32_oracle(n_split, G):
    """K5's split over the int8 rows dequantised in f32 (as K5 keeps them)
    equals the one-pass f32 oracle on the same rows."""
    rng = np.random.default_rng(200 + n_split * 10 + G)
    B, nkv, hd, S = 4, 2, 64, 80
    q, k, v = _contiguous_inputs(rng, B, G * nkv, nkv, hd, S)
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    kd = _t(kq).float() * _t(ks)[..., None]
    vd = _t(vq).float() * _t(vs)[..., None]
    lens = _t(np.array([1, 16, 17, S], np.int32))
    got = decode_attention_split_ref(_t(q), kd, vd, lens, n_split)
    assert_close(got, decode_attention_ref(_t(q), kd, vd, lens), TOL["f32_op"])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
@pytest.mark.parametrize("G", [1, 4])
def test_one_rounding_limit_holds_split_and_catches_dropped_chunk(G, logit_cap, layout):
    """The limit K1, K4 and K5 are held to on the card at long S: the
    split-KV decomposition, rounded once to bf16, is within one rounding of
    the one-pass plain version; the same attention with the chunk after a
    range edge left out (16 rows, or for K1 that page of the block table)
    is not (outputs are ~0.03 here, so an absolute 3e-2 would not see it)."""
    rng = np.random.default_rng(G)
    B, nkv, hd, S, n_split, ps = 2, 2, 128, 4096, 4, 16
    q, k, v = (_t(a, "bfloat16") for a in _contiguous_inputs(rng, B, G * nkv, nkv, hd, S))
    lens = _t(np.array([S, S - 100], np.int32))
    edge = split_rows(S, n_split, ps)
    split = decode_attention_split_ref(q, k, v, lens, n_split, logit_cap=logit_cap, chunk=ps)
    if layout == "contiguous":
        want = decode_attention_ref(q, k, v, lens, logit_cap=logit_cap)
        keep = torch.cat([torch.arange(edge), torch.arange(edge + 16, S)])
        dropped = decode_attention_ref(q, k[:, keep], v[:, keep], lens - 16, logit_cap=logit_cap)
    else:
        kp, vp, bt = _paged_view(k, v, rng, ps)
        want = paged_decode_attention_ref(q, kp, vp, bt, lens, logit_cap=logit_cap)
        page = edge // ps
        bt_dropped = torch.cat([bt[:, :page], bt[:, page + 1:]], dim=1)
        dropped = paged_decode_attention_ref(q, kp, vp, bt_dropped, lens - ps, logit_cap=logit_cap)
    assert_one_rounding(split, want)
    assert rounding_excess(dropped, want) > 1.0


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm`` on uint32 arrays: byte n of the result is byte
    ``(s >> 4n) & 7`` of the eight bytes of ``y:x`` (x's bytes are 0-3)."""
    pool = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint32)
    for n in range(4):
        sel = np.uint64((s >> (4 * n)) & 7)
        out |= ((pool >> (np.uint64(8) * sel)) & np.uint64(0xFF)).astype(np.uint32) << np.uint32(8 * n)
    return out


def test_int8_conversion_is_exact_for_every_byte():
    """K5's int8 -> f32 conversion (a PRMT into the mantissa of 2^23, then
    one FADD), with the constants read from ``csrc/decode_attention.cu``,
    gives ``(float)v`` for all 256 byte values at each of a word's four
    byte positions."""
    src = (CSRC / "decode_attention.cu").read_text()

    def const(name):
        return re.search(rf"\b{name} = (0x[0-9A-Fa-f]+|[0-9.]+)[uf]?;", src).group(1)

    flip, magic, sel = (np.uint32(int(const(n), 16)) for n in ("kI8Flip", "kI8Magic", "kI8Sel"))
    bias = np.float32(const("kI8Bias"))
    vals = np.arange(-128, 128, dtype=np.int8)
    rng = np.random.default_rng(0)
    for i in range(4):
        words = rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
        words &= ~np.uint32(0xFF << (8 * i))
        words |= vals.view(np.uint8).astype(np.uint32) << np.uint32(8 * i)
        bits = _byte_perm(words ^ flip, np.full(256, magic, np.uint32), int(sel) + i)
        got = bits.view(np.float32) - bias
        np.testing.assert_array_equal(got, vals.astype(np.float32))


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
    (5, 1, 128, 256),  # one row per slot
    (4, 17, 128, 192),  # CAP no multiple of the kernel's 8-row MMA side
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

    # K1, K4 and K5 at decode_32k's S, lengths on and beside the split
    # boundaries each wrapper chooses, every G and head_dim the kernels are
    # built for; outputs are ~0.01 here, so TOL["bf16"] would pass a dropped
    # chunk: each is held within one bf16 rounding of its f32 oracle
    from repro_torch.models.attention import quantize_kv

    S, ps, B, nkv = 32768, 16, 4, 2
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for G in KERNEL_GROUPS:
        for hd in KERNEL_HEAD_DIMS:
            q = torch.from_numpy(rng.standard_normal((B, G * nkv, hd)).astype(np.float32))
            q = q.to(dev).to(torch.bfloat16)
            k = torch.randn((B, S, nkv, hd), device=dev).to(torch.bfloat16)
            v = torch.randn((B, S, nkv, hd), device=dev).to(torch.bfloat16)
            _, rows = split_plan(B, nkv, S, n_sms)
            lens = _t(np.array([rows, rows + 1, S, 17], np.int32), device=dev)
            assert_one_rounding(decode_attention(q, k, v, lens), decode_attention_ref(q, k, v, lens))
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            want = decode_attention_ref(q, k8.float() * ks[..., None], v8.float() * vs[..., None], lens)
            assert_one_rounding(decode_attention_int8(q, k8, v8, ks, vs, lens), want)
            del k8, ks, v8, vs, want
            # K1: the same rows as pages of a pool, in a random order
            kp, vp, bt = _paged_view(k, v, rng, ps)
            del k, v
            _, rows = split_plan(B, nkv, S, n_sms, ps)
            lens = _t(np.array([rows, rows + 1, S, 17], np.int32), device=dev)
            assert_one_rounding(paged_decode_attention(q, kp, vp, bt, lens),
                                paged_decode_attention_ref(q, kp, vp, bt, lens))
            del kp, vp

    # K3: stacked and slot-indirect maps, with empty and inactive slots; CAP
    # from one row to a prefill chunk, to the most the bf16 kernel holds in
    # a block (256) and past it (blocks of rows), at the serving widths and
    # at widths that are no multiple of the kernel's 64- and 128-wide tiles
    cases = [(6, 4, 16, 128, 256), (64, 64, 4, 2048, 1408), (10, 3, 64, 256, 160)]
    cases += [(6, 4, cap, 2048, 1408) for cap in (1, 4, 8, 17, 64)]
    cases += [(7, 3, cap, 200, 328) for cap in (1, 4, 8, 17, 64, 100, 256, 300)]
    rows3 = (4, 4, 520, 2048, 1408)  # three of the bf16 kernel's blocks of rows
    for S, E, CAP, d, f in cases + [rows3]:
        # blocks of rows are the bf16 path's; the f32 kernel has none
        for dtype in ("bfloat16",) if (S, E, CAP, d, f) == rows3 else ("float32", "bfloat16"):
            x, wg, wu, wd = _ffn_inputs(rng, S, E, CAP, d, f)
            m = np.arange(S) % (E + 1)
            s2e = np.where(m == E, -1, m).astype(np.int32)
            s2e[1] = s2e[0]  # two slots share one expert
            act = (rng.random(S) < 0.7).astype(np.int32)
            act[:2] = 1
            for a in (act, np.zeros_like(act)):  # and every slot inactive
                args = [_t(z, dtype, dev) for z in (x, wg, wu, wd, s2e, a)]
                got = expert_ffn_grouped(*args)
                want = expert_ffn_grouped_ref(*args)
                assert_close(got, want, tol_for(dtype))
                dead = torch.from_numpy((a == 0) | (s2e < 0)).to(dev)
                assert (got.float()[dead] == 0).all()
    torch.cuda.synchronize()
    assert all(cuda.LAUNCHES[n] > before[n] for n in before)
