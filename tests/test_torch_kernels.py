"""The port's kernel modules against the reference's ops.

On the CPU each wrapper runs its plain version, which is held here against
the reference's Pallas op (interpret mode, as ``tests/test_kernels.py`` and
``tests/test_paged_kv.py`` run it) on the same seeded numpy inputs.  The
``gpu``-marked test holds each CUDA kernel against its plain version on the
card.  This file imports the reference inside the tests, so the card's
machine, which has no JAX, can collect and run the ``gpu`` test alone.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (
    TOL, assert_close, assert_equal_int, assert_one_rounding, rounding_excess, tol_for,
)
from repro_torch.core.aebs import ReplicaLayout, aebs_numpy
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


KV_SWEEP = [(1, 128), (2, 64), (3, 128), (4, 64), (7, 128), (1, 80)]  # (query heads per KV head, head_dim)


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


def test_activated_mask_and_amax_of_equal_reference():
    """Step 1's activated set and a_max (``aebs.py:118,179``); a padding id
    (-1) activates nothing in the port, as in its ``aebs_assign``."""
    import jax.numpy as jnp

    from repro.core import aebs as ref_aebs
    from repro_torch.core.aebs import activated_mask, amax_of

    for E, k, seed in ((16, 2, 0), (64, 6, 1), (200, 8, 2)):
        eids = make_routing_trace(40, E, k, skew=0.8, seed=seed)
        got = activated_mask(torch.from_numpy(eids), E)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_aebs.activated_mask(jnp.asarray(eids), E)))
        layout = build_layout(eids, E, 4, -(-E // 4) + 1)
        load = aebs_schedule(torch.from_numpy(eids), layout.device_tables("cpu"), 4)[1]
        assert int(amax_of(load)) == int(ref_aebs.amax_of(jnp.asarray(load.numpy())))
    padded = np.array([[0, -1], [-1, -1]], np.int32)
    assert activated_mask(torch.from_numpy(padded), 4).tolist() == [True, False, False, False]


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


def _fig15(n_e):
    """The paper's Fig. 15 grid as ``benchmarks/fig15_overhead.py:20-36``
    builds it: 64 experts, top-6, 12 slots an instance, one skewed trace."""
    trace = make_routing_trace(8192, 64, 6, skew=1.0, seed=0)
    return trace, build_layout(trace, 64, n_e, 12)


@pytest.mark.parametrize("n_e", [8, 16])
def test_aebs_plain_matches_reference_fig15(n_e):
    import jax.numpy as jnp
    from repro.core.aebs import aebs_numpy as ref_aebs_numpy
    from repro.core.placement import build_layout as ref_build_layout
    from repro.kernels.aebs.ops import aebs_schedule as ref_aebs_schedule

    trace, layout = _fig15(n_e)
    ref_layout = ref_build_layout(trace, 64, n_e, 12)
    tables = layout.device_tables("cpu")
    # B = 256 through the reference's Pallas kernels (interpret mode)
    got = aebs_schedule(torch.from_numpy(trace[:256]), tables, n_e)
    want = ref_aebs_schedule(jnp.asarray(trace[:256]), ref_layout.device_tables(), n_e)
    for a, b in zip(got, want):
        assert_equal_int(a, np.asarray(b))
    # B = 4096 against the reference's host implementation
    got = aebs_schedule(torch.from_numpy(trace[:4096]), tables, n_e)
    for a, b in zip(got, ref_aebs_numpy(trace[:4096], ref_layout)):
        assert_equal_int(a, b)


_NO_KEY = 0xFFFFFFFF


def _aebs_kernel_model(eids, hosts, counts, slot_of, n_e, blocks=1):
    """``csrc/aebs.cu``'s ``aebs_schedule_kernel`` step for step in numpy:
    each block's bitmap over its range of 4-item units, ORed; pass 1 over the
    single-replica experts; warp 0's ballot-compacted list of the activated
    replicated experts; the chain over that list, each step the minimum of
    the packed keys -- ``(load << b) | r`` over 32-lane passes, and with
    8 <= n_e <= 32 ``(((load << b) | r) << gb) | g``, the winner's instance in
    the low bits -- leaving the chosen instance, which the staged
    ``slot_of`` turns into the slot; the rewrite."""
    E, R = hosts.shape
    flat = np.asarray(eids, np.int64).reshape(-1)
    n_units = -(-flat.size // 4)
    per = -(-n_units // blocks)
    act = np.zeros(E, bool)
    for rank in range(blocks):
        items = flat[4 * rank * per: 4 * min(n_units, (rank + 1) * per)]
        own = np.zeros(E, bool)
        own[items[(items >= 0) & (items < E)]] = True
        act |= own
    ld = np.zeros(n_e, np.int64)
    rep = -np.ones(E, np.int64)
    for e in range(E):  # pass 1: no order between these experts
        if act[e] and counts[e] == 1 and hosts[e, 0] >= 0:
            rep[e] = slot_of[e, hosts[e, 0]]
            ld[hosts[e, 0]] += 1
    listed, M = -np.ones(E, np.int64), 0
    for e0 in range(0, E, 32):  # one ballot per 32 experts
        flags = [e0 + t < E and act[e0 + t] and counts[e0 + t] >= 2 for t in range(32)]
        ballot = sum(1 << t for t, f in enumerate(flags) if f)
        for t, f in enumerate(flags):
            if f:
                listed[M + bin(ballot & ((1 << t) - 1)).count("1")] = e0 + t
        M += bin(ballot).count("1")
    b = (R - 1).bit_length() if R > 1 else 0
    gb = (n_e - 1).bit_length() if 8 <= n_e <= 32 else 0  # loads in registers: g in the key
    for e in listed[:M]:
        best = _NO_KEY
        for r0 in range(0, R, 32):  # lane passes
            keys = [(((int(ld[g]) << b) | r) << gb) | (g if gb else 0) if g >= 0 else _NO_KEY
                    for r, g in zip(range(r0, r0 + 32), hosts[e, r0:r0 + 32])]
            best = min(best, min(keys))
        assert best == _NO_KEY or best < 2**32  # the key is exact in 32 bits
        if best != _NO_KEY:
            r = (best >> gb) & ((1 << b) - 1)
            g = best & ((1 << gb) - 1) if gb else hosts[e, r]
            assert g == hosts[e, r]
            ld[g] = (best >> (b + gb)) + 1
            rep[e] = g
    for e in listed[:M]:  # the chosen instance -> its slot
        if rep[e] >= 0:
            rep[e] = slot_of[e, rep[e]]
    valid = (flat >= 0) & (flat < E)
    slot_ids = np.where(valid, rep[np.clip(flat, 0, E - 1)], -1).reshape(np.shape(eids))
    return slot_ids, ld, rep


def _tie_layout():
    """Every instance hosts all 8 experts, each row of hosts in descending
    instance order: loads tie at every step, and the first minimum is the
    lowest replica index, not the lowest instance id."""
    base = ReplicaLayout.build(np.tile(np.arange(8, dtype=np.int32), (4, 1)), 8)
    return dataclasses.replace(base, expert_hosts=base.expert_hosts[:, ::-1].copy())


_SWEEP = ((16, 4, 5, 64, 2), (64, 8, 12, 300, 6), (60, 16, 4, 128, 4), (256, 16, 17, 512, 8),
          (64, 4, 17, 8, 6))
_MODEL_CASES = ([f"sweep{i}" for i in range(len(_SWEEP))]
                + [f"fig15-{n_e}-{B}" for n_e in (8, 16) for B in (64, 256, 1024, 4096)]
                + ["ties", "ne40", "E512"])


def _aebs_model_case(name):
    """(eids, layout) of one named case of the kernel's numpy model."""
    if name.startswith("sweep"):
        E, n_e, C, T, k = _SWEEP[int(name[5:])]
        trace = make_routing_trace(max(T, 512), E, k, skew=0.8, seed=E)
        return trace[:T], build_layout(trace, E, n_e, C)
    if name.startswith("fig15"):
        _, n_e, B = name.split("-")
        trace, layout = _fig15(int(n_e))
        return trace[:int(B)], layout
    if name == "ties":
        return np.random.default_rng(5).integers(0, 8, size=(40, 3)).astype(np.int32), _tie_layout()
    if name == "ne40":  # more instances than lanes, and a row of 40 replicas
        trace = make_routing_trace(4096, 64, 6, skew=1.2, seed=3)
        return trace[:512], build_layout(trace, 64, 40, 8)
    trace = make_routing_trace(4096, 512, 8, skew=0.8, seed=3)  # E512
    return trace[:1024], build_layout(trace, 512, 16, 40)


@pytest.mark.parametrize("blocks", [1, 8])
@pytest.mark.parametrize("name", _MODEL_CASES)
def test_aebs_kernel_model_matches_numpy(name, blocks):
    """The kernel's algorithm (the numpy transcription above, in one block
    and in a cluster of 8) against ``aebs_numpy``: a check of the design,
    not of the CUDA code, which only the ``gpu`` test runs."""
    eids, layout = _aebs_model_case(name)
    if name == "ties":
        assert (layout.replica_counts == 4).all() and (np.diff(layout.expert_hosts, axis=1) < 0).all()
    if name == "ne40":
        assert layout.expert_hosts.shape[1] == 40  # two lane passes
    got = _aebs_kernel_model(eids, layout.expert_hosts, layout.replica_counts, layout.slot_of,
                             layout.num_instances, blocks)
    for a, b in zip(got, aebs_numpy(eids, layout)):
        assert_equal_int(a, b)


@pytest.mark.parametrize("T", [0, 1, 37])
def test_aebs_kernel_model_padding_matches_plain(T):
    """All padding, one token, and padding mixed in: the model against the
    plain ``aebs_assign`` (``aebs_numpy`` takes no padding)."""
    trace, layout = _fig15(16)
    eids = np.full((max(T, 4), 6), -1, np.int32)
    eids[:T] = trace[:T]
    eids[:T:5, 2] = -1
    eids[:T:7, 4] = 64  # out of range counts as padding
    got = _aebs_kernel_model(eids, layout.expert_hosts, layout.replica_counts, layout.slot_of, 16)
    want = aebs_schedule(torch.from_numpy(eids), layout.device_tables("cpu"), 16)
    for a, b in zip(got, want):
        assert_equal_int(a, b)


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

    # the G 3 and G 7 instances (phi4-mini, yi-34b) at every head_dim, softcap
    # on and off: their register share is rounded down to a power of two
    odd_groups = [(G, hd, cap) for G in (3, 7) for hd in KERNEL_HEAD_DIMS for cap in (0.0, 30.0)]

    # K1: every G and head_dim the kernel is built for, softcap on and off,
    # mid-page lengths; the second case is the serving path's shape
    k1_cases = [((3, 8, 2, 64, 4, 40, 8), 0.0), ((8, 16, 16, 128, 16, 257, 32), 30.0),
                ((4, 4, 2, 128, 16, 40, 8), 0.0), ((2, 16, 2, 256, 8, 12, 5), 30.0)]
    k1_cases += [((3, G * 2, 2, hd, 8, 16, 5), cap) for G, hd, cap in odd_groups]
    for (B, nh, nkv, hd, ps, P, nblk), cap in k1_cases:
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
    k4_cases = [((3, 8, 2, 64, 40), 0.0), ((8, 16, 16, 128, 512), 30.0),
                ((4, 4, 2, 128, 100), 0.0), ((2, 16, 2, 256, 70), 30.0)]
    k4_cases += [((3, G * 2, 2, hd, 70), cap) for G, hd, cap in odd_groups]
    for (B, nh, nkv, hd, S), cap in k4_cases:
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

    # K2, integers exact: the reference's sweep with padding; the Fig. 15
    # grid; all padding, one token, more instances than lanes (n_e 40, rows
    # of 40 replicas), E 512 (past 48 KB of shared memory), forced ties;
    # item counts on both sides of the cluster threshold, and ids that are
    # not 16-byte aligned, in one block and in a cluster
    from repro_torch.kernels.aebs.ops import CLUSTER_ITEMS

    def k2(eids, layout, offset=0):
        n_e = layout.num_instances
        flat = torch.full((eids.size + offset,), -1, dtype=torch.int32, device=dev)
        flat[offset:] = _t(eids, device=dev).reshape(-1)
        got = aebs_schedule(flat[offset:].view(eids.shape), layout.device_tables(dev), n_e)
        want = aebs_schedule(_t(eids), layout.device_tables("cpu"), n_e)
        for a, b in zip(got, want):
            assert_equal_int(a, b)

    def past_threshold(eids):
        """``eids`` repeated to just over CLUSTER_ITEMS ids: a cluster."""
        reps = CLUSTER_ITEMS // eids.size + 1
        return np.concatenate([eids] * reps)

    for E, n_e, C, T, k in _SWEEP:
        trace = make_routing_trace(max(T, 512), E, k, skew=0.8, seed=E)
        eids = trace[:T].copy()
        eids[-1] = -1
        k2(eids, build_layout(trace, E, n_e, C))
    for n_e in (8, 16):
        trace, layout = _fig15(n_e)
        for B in (64, 256, 1024, 4096):
            k2(trace[:B], layout)
        k2(np.full((64, 6), -1, np.int32), layout)
        k2(trace[:0], layout)
        k2(trace[:1], layout)
        k2(trace[:37], layout, offset=1)
        n_tok = CLUSTER_ITEMS // 6
        for T in (n_tok, n_tok + 1):  # one block (past its registers), then a cluster
            k2(trace[:T], layout)
        k2(trace[:n_tok + 3], layout, offset=3)  # a cluster over unaligned ids
        k2(np.concatenate([trace, trace]), layout)  # past the cluster's registers
    for name in ("ties", "ne40", "E512"):
        eids, layout = _aebs_model_case(name)
        k2(eids, layout)
        k2(past_threshold(eids), layout)

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


# ---------------------------------------------------------------------------
# head_dim 80 (zamba2's shared block) and the rolling window buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what,nh,nkv,contiguous", [
    ("paged_decode_attention", 32, 32, False),  # K1 has no head_dim-80 instance
    ("decode_attention", 64, 32, True),  # K4 at head_dim 80 only for G 1
    ("decode_attention_int8", 96, 32, True),
])
def test_launchers_refuse_unbuilt_head_dim_80(what, nh, nkv, contiguous):
    """An unbuilt (G, head_dim) raises before anything launches; nothing
    falls back to the plain version."""
    from repro_torch.kernels.decode_attention import ops

    with pytest.raises(ValueError, match="built for"):
        ops._check_launch(what, torch.zeros((2, nh, 80)), nkv, {}, contiguous=contiguous)


def test_decode_plain_over_wrapped_rolling_buffer():
    """K4's plain version over a wrapped rolling buffer (``valid_len = W``,
    row ``p % W`` holding position ``p``) equals it over the same keys in
    position order, and a window attention that masks by position: softmax
    does not depend on the rows' order."""
    rng = np.random.default_rng(3)
    B, nh, nkv, hd, W, pos = 2, 8, 4, 64, 24, 57
    q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, W)
    order = (np.arange(pos - W + 1, pos + 1)) % W  # rows of positions pos-W+1 .. pos
    got = decode_attention(_t(q), _t(k), _t(v), W, logit_cap=50.0)
    want = decode_attention(_t(q), _t(k[:, order]), _t(v[:, order]), W, logit_cap=50.0)
    assert_close(got, want, TOL["f32_op"])
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    got = decode_attention_int8(_t(q), *[_t(a) for a in (kq, vq, ks, vs)], W)
    want = decode_attention_int8(_t(q), *[_t(a[:, order]) for a in (kq, vq, ks, vs)], W)
    assert_close(got, want, TOL["f32_op"])


@pytest.mark.gpu
def test_cuda_head_dim_80_and_rolling_window(cuda_device):
    """K4 and K5 at head_dim 80 (G 1, zamba2's shared block: 32 heads over
    32) in f32 and bf16, softcap on and off, per-slot lengths (one past the
    16-row chunk edge) and a split launch; K4 and K5 over a wrapped rolling
    buffer (``valid_len = W``, gemma2's local layers: G 2, head_dim 256,
    softcap 50), each against its plain version."""
    dev = cuda_device
    rng = np.random.default_rng(80)
    before = dict(cuda.LAUNCHES)
    cases = [(3, 32, 32, 80, 70), (8, 32, 32, 80, 512), (1, 4, 4, 80, 2048)]
    n = 0
    for B, nh, nkv, hd, S in cases:
        q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, S)
        (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
        lens = rng.integers(1, S + 1, size=B).astype(np.int32)
        lens[0] = min(S, 17)
        for dtype in ("float32", "bfloat16"):
            for cap in (0.0, 30.0):
                args = [_t(a, dtype, dev) for a in (q, k, v)] + [_t(lens, device=dev)]
                got = decode_attention(*args, logit_cap=cap)
                assert_close(got, decode_attention_ref(*args, logit_cap=cap), tol_for(dtype))
                args = [_t(q, dtype, dev)] + [_t(a, device=dev) for a in (kq, vq, ks, vs)] + [_t(lens, device=dev)]
                got = decode_attention_int8(*args, logit_cap=cap)
                assert_close(got, decode_attention_int8_ref(*args, logit_cap=cap), tol_for(dtype))
                n += 1
    B, nh, nkv, hd, W = 4, 8, 4, 256, 4096
    q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, W)
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    for dtype in ("float32", "bfloat16"):
        args = [_t(a, dtype, dev) for a in (q, k, v)] + [W]
        assert_close(decode_attention(*args, logit_cap=50.0), decode_attention_ref(*args, logit_cap=50.0),
                     tol_for(dtype))
        args = [_t(q, dtype, dev)] + [_t(a, device=dev) for a in (kq, vq, ks, vs)] + [W]
        assert_close(decode_attention_int8(*args, logit_cap=50.0),
                     decode_attention_int8_ref(*args, logit_cap=50.0), tol_for(dtype))
    assert cuda.LAUNCHES["decode_attention"] - before["decode_attention"] == n + 2
    assert cuda.LAUNCHES["decode_attention_int8"] - before["decode_attention_int8"] == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("family,nh,nkv,hd,S", [("whisper-tiny", 6, 6, 64, 448), ("pixtral-12b", 32, 8, 128, 2048)])
def test_cuda_frontend_family_shapes(cuda_device, family, nh, nkv, hd, S):
    """K1, K4 and K5 at the encoder-decoder and vision-patch families'
    decode shapes (whisper: 6 heads of 64 over 448 rows, G 1; pixtral: 32
    query heads over 8 of 128 over 2048 rows, G 4), 8 slots at random
    lengths (one at the cache's end, one at 1), f32 and bf16, each against
    its plain version."""
    dev = cuda_device
    rng = np.random.default_rng(hd)
    before = dict(cuda.LAUNCHES)
    B, ps = 8, 16
    nblk = S // ps
    q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, S)
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    lens[0], lens[1] = S, 1
    bt = (rng.permutation(B * nblk).reshape(B, nblk) + 1).astype(np.int32)
    kp = np.zeros((B * nblk + 1, ps, nkv, hd), np.float32)
    vp = np.zeros_like(kp)
    kp[bt.reshape(-1)] = k.reshape(B * nblk, ps, nkv, hd)
    vp[bt.reshape(-1)] = v.reshape(B * nblk, ps, nkv, hd)
    for dtype in ("float32", "bfloat16"):
        args = [_t(a, dtype, dev) for a in (q, kp, vp)] + [_t(bt, device=dev), _t(lens, device=dev)]
        assert_close(paged_decode_attention(*args), paged_decode_attention_ref(*args), tol_for(dtype))
        args = [_t(a, dtype, dev) for a in (q, k, v)] + [_t(lens, device=dev)]
        assert_close(decode_attention(*args), decode_attention_ref(*args), tol_for(dtype))
        args = [_t(q, dtype, dev)] + [_t(a, device=dev) for a in (kq, vq, ks, vs)] + [_t(lens, device=dev)]
        assert_close(decode_attention_int8(*args), decode_attention_int8_ref(*args), tol_for(dtype))
    for name in ("paged_decode_attention", "decode_attention", "decode_attention_int8"):
        assert cuda.LAUNCHES[name] - before[name] == 2, name


@pytest.mark.gpu
def test_cuda_wrappers_refuse_autograd(cuda_device):
    """K1, K3, K4 and K5 raise when grad mode is on and an input requires
    grad (a ``ctypes`` launch gives a result with no ``grad_fn``), and
    launch nothing; the same calls run under ``torch.no_grad()``."""
    dev = cuda_device
    rng = np.random.default_rng(7)
    B, nh, nkv, hd, S, ps = 2, 8, 8, 64, 32, 16
    q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, S)
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    lens = np.asarray([S, 5], np.int32)
    bt = (np.arange(B * S // ps).reshape(B, S // ps) + 1).astype(np.int32)
    kp = np.concatenate([np.zeros((1, ps, nkv, hd), np.float32), k.reshape(-1, ps, nkv, hd)])
    vp = np.concatenate([np.zeros((1, ps, nkv, hd), np.float32), v.reshape(-1, ps, nkv, hd)])
    E, CAP, d, f = 4, 4, 64, 32
    x = _t(rng.standard_normal((E, CAP, d)).astype(np.float32), device=dev)
    w = [_t((rng.standard_normal(s) * 0.1).astype(np.float32), device=dev) for s in ((E, d, f), (E, d, f), (E, f, d))]
    s2e = torch.arange(E, dtype=torch.int32, device=dev)
    active = torch.ones(E, dtype=torch.int32, device=dev)
    calls = {
        "paged_decode_attention": lambda qq: paged_decode_attention(
            qq, _t(kp, device=dev), _t(vp, device=dev), _t(bt, device=dev), _t(lens, device=dev)),
        "decode_attention": lambda qq: decode_attention(qq, _t(k, device=dev), _t(v, device=dev), _t(lens, device=dev)),
        "decode_attention_int8": lambda qq: decode_attention_int8(
            qq, *(_t(a, device=dev) for a in (kq, vq, ks, vs)), _t(lens, device=dev)),
        "expert_ffn": lambda qq: expert_ffn_grouped(x, w[0].requires_grad_(qq.requires_grad), w[1], w[2], s2e, active),
    }
    for name, call in calls.items():
        before = cuda.LAUNCHES[name]
        q_grad = _t(q, device=dev).requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward pass"):
            call(q_grad)
        assert cuda.LAUNCHES[name] == before, name
        with torch.no_grad():
            call(q_grad)
        call(_t(q, device=dev).requires_grad_(False))
        assert cuda.LAUNCHES[name] == before + 2, name


@pytest.mark.gpu
def test_custom_ops_under_fake_tensors_launch_nothing(cuda_device):
    """K2, K3, K4 and K5 are custom ops (``repro_torch::*``): under a
    ``FakeTensorMode`` their fake implementations give the real launches'
    shapes and dtypes (and K3's and K4's FLOP formulas count), and nothing
    launches; the same calls on real tensors launch once each."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.aebs import ReplicaLayout

    dev = cuda_device
    rng = np.random.default_rng(11)
    B, nh, nkv, hd, S = 2, 8, 4, 64, 64
    q, k, v = _contiguous_inputs(rng, B, nh, nkv, hd, S)
    (kq, ks), (vq, vs) = _quantised(k), _quantised(v)
    E, CAP, d, f = 4, 4, 64, 32
    x = (rng.standard_normal((E, CAP, d)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in ((E, d, f), (E, d, f), (E, f, d))]
    tables_np = {n: t.numpy() for n, t in ReplicaLayout.round_robin(E, 2, 3).device_tables("cpu").items()}
    eids = np.array([[0, 1], [2, 3], [1, 0]], np.int32)

    def calls(to):
        tables = {n: to(t) for n, t in tables_np.items()}
        lens = to(np.asarray([S, 5], np.int32))
        s2e = to(np.arange(E, dtype=np.int32))
        return {
            "decode_attention": lambda: decode_attention(to(q), to(k), to(v), lens),
            "decode_attention_int8": lambda: decode_attention_int8(to(q), to(kq), to(vq), to(ks), to(vs), lens),
            "expert_ffn": lambda: expert_ffn_grouped(to(x), *(to(w) for w in ws), s2e, to(np.ones(E, np.int32))),
            "aebs_schedule": lambda: aebs_schedule(to(eids), tables, 2),
        }

    with torch.no_grad():
        real = {name: call() for name, call in calls(lambda a: _t(a, device=dev)).items()}
        torch.cuda.synchronize()
        before = dict(cuda.LAUNCHES)
        fake_mode = FakeTensorMode()
        with fake_mode:
            fakes = calls(lambda a: torch.empty(a.shape, dtype=_t(a).dtype, device=dev))
            with FlopCounterMode(display=False) as counter:
                out = {name: call() for name, call in fakes.items()}
    assert cuda.LAUNCHES == before
    for name, got in out.items():
        want = real[name]
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape and g.dtype == w.dtype and g.device == w.device, name
    # every slot of the fake K3 call counts; K4 and K5 count S rows a slot
    assert counter.get_total_flops() == 6 * E * CAP * d * f + 2 * 4 * nh * hd * B * S
