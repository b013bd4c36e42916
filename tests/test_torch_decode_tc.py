"""K4's and K5's Hopper body, modelled on the CPU.

``decode_attention_tiled_ref`` and ``decode_attention_int8_tiled_ref``
repeat the kernel's arithmetic in plain PyTorch over a contiguous cache read
in chunks of ``tc_rows`` rows (an implicit block table): 16-row tiles, a KV
group's heads padded to 8, the mask as a select before the max, the weights
as two bf16 terms (for int8, ``P' = p * s_v`` once a row against exact int8
values), the warps' and the ranges' merges in order.  Here they are held
against the reference's Pallas ops (interpret mode) on the same seeded
inputs, bf16 crossing through ``repro_torch.bridge``; within one bf16
rounding of the f32 oracle at 4 x 32768 rows; against themselves with NaN
past every slot's length (K4's rows, K5's scales); and the plan, the stage
sizing and the dispatch rule are checked.  The kernels on the card are held
to their plain versions by ``tests/test_torch_kernels.py``'s ``gpu`` tests
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, assert_one_rounding, rounding_excess
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.decode_attention.ops import (
    CONTIGUOUS_ONLY,
    KERNEL_GROUPS,
    KERNEL_HEAD_DIMS,
    TC_G1_MIN_ROWS,
    TC_RING_BYTES,
    TC_SMEM_LIMIT,
    TC_TILE,
    TC_WARPS,
    decode_attention_int8_tiled_ref,
    decode_attention_ref,
    decode_attention_tiled_ref,
    decode_body,
    decode_plan,
    tc_rows,
    tc_smem_bytes,
)
from repro_torch.models.attention import quantize_kv

H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the emulation runs many small ops, which the
    workers that share the machine's cores would otherwise oversubscribe
    many times over (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """numpy f32 -> bf16 the way the reference sees it, and the same bits
    as a torch tensor (through the bridge)."""
    import jax.numpy as jnp

    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j))


def _inputs(rng, B, G, nkv, hd, S):
    """q, K and V in bf16 (reference and port), and K and V quantised to
    int8 with their f32 scales (numpy, the same for both)."""
    q = rng.standard_normal((B, G * nkv, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (k, v))
    return _bf16(q), _bf16(k), _bf16(v), tuple(x.numpy() for x in (k8, ks, v8, vs))


_GH = [(G, hd) for G in KERNEL_GROUPS if G >= 2 for hd in KERNEL_HEAD_DIMS]


@pytest.mark.parametrize("G,hd", _GH)
def test_tiled_emulations_match_reference(G, hd):
    """Every (G >= 2, head_dim) the Hopper body is built for, K4 and K5
    against the reference's Pallas ops in bf16: softcap on and off, one
    range or the plan's; a slot of one row, one on a chunk's edge (one
    past it for K5, whose chunks are longer) and one holding the whole
    cache, whose last chunk runs past S (into the next slot's rows, or past
    the cache: zeros).  The reference takes one scalar length, so it runs
    a call a slot."""
    from repro.kernels.decode_attention.ops import decode_attention as ref_op
    from repro.kernels.decode_attention.ops import decode_attention_int8 as ref_int8

    i = _GH.index((G, hd))
    cap = 30.0 if i % 2 else 0.0
    B, nkv, S = 3, 2, 40
    rng = np.random.default_rng(400 + i)
    (qj, qt), (kj, kt), (vj, vt), (k8, ks, v8, vs) = _inputs(rng, B, G, nkv, hd, S)
    for int8 in (False, True):
        R = tc_rows(hd, int8)
        assert S % R  # the last chunk runs past each slot's rows
        lens = np.array([1, min(R, S) + int8, S], np.int32)
        n_split = decode_plan(B, nkv, S, hd, H100_SMS, int8).n_split if i % 3 else 1
        lt = torch.from_numpy(lens)
        if int8:
            got = decode_attention_int8_tiled_ref(qt, *(torch.from_numpy(x) for x in (k8, v8, ks, vs)), lt,
                                                  logit_cap=cap, n_split=n_split)
            want = [ref_int8(qj[b:b + 1], k8[b:b + 1], v8[b:b + 1], ks[b:b + 1], vs[b:b + 1], int(lens[b]),
                             logit_cap=cap) for b in range(B)]
        else:
            got = decode_attention_tiled_ref(qt, kt, vt, lt, logit_cap=cap, n_split=n_split)
            want = [ref_op(qj[b:b + 1], kj[b:b + 1], vj[b:b + 1], int(lens[b]), logit_cap=cap) for b in range(B)]
        assert got.dtype == torch.bfloat16
        assert_close(got, np.concatenate([np.asarray(w, np.float32) for w in want]), TOL["bf16"])


def test_tiled_emulations_one_rounding_at_32k():
    """At decode_32k's context (4 slots x 32768 rows, 32 query heads over 8
    scaled down to 4 over 1, the plan's ranges at 132 SMs), K4's and K5's
    emulations are within one bf16 rounding of the f32 oracle (K5's: the
    dequantised rows in f32), lengths on a range's edge and one past it,
    the whole cache, and 17 (a tile and one row); P' as one bf16 term (p
    times the row's V scale, rounded once) does not hold that limit."""
    from repro.kernels.decode_attention.ref import decode_attention_ref as oracle

    B, G, nkv, hd, S = 4, 4, 1, 128, 32768
    rng = np.random.default_rng(32)
    (qj, qt), (kj, kt), (vj, vt), (k8, ks, v8, vs) = _inputs(rng, B, G, nkv, hd, S)
    q32 = np.asarray(qj, np.float32)
    for int8 in (False, True):
        plan = decode_plan(B, nkv, S, hd, H100_SMS, int8)
        assert plan.n_split > 1
        edge = plan.pages * tc_rows(hd, int8)
        lens = np.array([edge, edge + 1, S, 17], np.int32)
        if int8:
            kd, vd = k8.astype(np.float32) * ks[..., None], v8.astype(np.float32) * vs[..., None]
            args = (qt, *(torch.from_numpy(x) for x in (k8, v8, ks, vs)), torch.from_numpy(lens))
            run = decode_attention_int8_tiled_ref
        else:
            kd, vd = np.asarray(kj, np.float32), np.asarray(vj, np.float32)
            args = (qt, kt, vt, torch.from_numpy(lens))
            run = decode_attention_tiled_ref
        want = np.concatenate([np.asarray(oracle(q32[b:b + 1], kd[b:b + 1], vd[b:b + 1], int(lens[b])))
                               for b in range(B)])
        assert_one_rounding(run(*args, n_split=plan.n_split), want)
        if int8:
            assert rounding_excess(run(*args, n_split=plan.n_split, p_terms=1), want) > 1.0


@pytest.mark.parametrize("G,hd", [(2, 256), (3, 64), (4, 128), (7, 128), (8, 256)])
def test_tiled_emulations_ignore_garbage_past_lengths(G, hd):
    """NaN in every K and V row past each slot's length (K4) and NaN or inf
    in every scale past it (K5; int8 values are always finite) reach no
    output: the results are finite and equal the clean caches' bit for bit,
    which match the f32 oracle within TOL["bf16"]."""
    rng = np.random.default_rng(G * 1000 + hd)
    B, nkv, S = 4, 2, 96
    (_, qt), (_, kt), (_, vt), (k8, ks, v8, vs) = _inputs(rng, B, G, nkv, hd, S)
    k8, ks, v8, vs = (torch.from_numpy(x) for x in (k8, ks, v8, vs))
    for int8 in (False, True):
        R = tc_rows(hd, int8)
        lens = torch.tensor([1, R - 1, R + 3, S - 1], dtype=torch.int32)
        n_split = decode_plan(B, nkv, S, hd, H100_SMS, int8).n_split
        if int8:
            clean = decode_attention_int8_tiled_ref(qt, k8, v8, ks, vs, lens, n_split=n_split)
            ksn, vsn = ks.clone(), vs.clone()
            for b, n in enumerate(lens.tolist()):
                ksn[b, n:] = float("nan")
                vsn[b, n:] = float("inf") if b % 2 else float("nan")
            got = decode_attention_int8_tiled_ref(qt, k8, v8, ksn, vsn, lens, n_split=n_split)
            want = decode_attention_ref(qt, k8.float() * ks[..., None], v8.float() * vs[..., None], lens)
        else:
            clean = decode_attention_tiled_ref(qt, kt, vt, lens, n_split=n_split)
            kn, vn = kt.clone(), vt.clone()
            for b, n in enumerate(lens.tolist()):
                kn[b, n:] = float("nan")
                vn[b, n:] = float("nan")
            got = decode_attention_tiled_ref(qt, kn, vn, lens, n_split=n_split)
            want = decode_attention_ref(qt, kt, vt, lens)
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, clean)
        assert_close(got, want, TOL["bf16"])


@pytest.mark.parametrize("B,nkv,S,hd", [
    (8, 8, 512, 128),  # G 3, 4, 7 serving rows
    (8, 8, 2048, 128),  # pixtral
    (8, 4, 8192, 256),  # gemma2's global layers
    (8, 4, 4096, 256),  # gemma2's local rolling buffer
    (4, 8, 32768, 128),  # decode_32k, 32 heads over 8
    (8, 16, 512, 64),
    (4, 16, 512, 128),  # the disagg shard
    (1, 2, 40, 64),
])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_plan_covers_the_cache_and_fits(B, nkv, S, hd, int8):
    """K4's and K5's plan: chunks of ``tc_rows`` rows (a multiple of 16,
    16-256, int8 at least 32), ranges of whole chunks that cover the slot's S rows, planned
    from S (never the lengths), the last range not empty; at least one
    block an SM where the cache has chunks enough; a ring within
    TC_RING_BYTES (or one stage) and the block's shared memory, fewer
    stages than consumer warps or a multiple of them."""
    R = tc_rows(hd, int8)
    assert R % TC_TILE == 0 and (32 if int8 else 16) <= R <= 256
    nblk = -(-S // R)
    plan = decode_plan(B, nkv, S, hd, H100_SMS, int8)
    assert plan.n_split * plan.pages >= nblk > (plan.n_split - 1) * plan.pages
    assert B * nkv * plan.n_split >= min(H100_SMS, B * nkv * nblk)
    assert plan.stages >= 1 and (plan.stages <= TC_WARPS or plan.stages % TC_WARPS == 0)
    stage_bytes = 2 * R * hd * (1 if int8 else 2)  # a chunk's K and V rows of one head
    assert plan.stages == 1 or plan.stages * stage_bytes <= TC_RING_BYTES
    assert plan.stages >= min(plan.pages, TC_WARPS)
    assert tc_smem_bytes(hd, R, plan.stages, int8) <= TC_SMEM_LIMIT


def test_decode_body_dispatch():
    """K4 and K5 take the Hopper body in bf16 at G >= 2 query heads a KV
    head, at every head_dim it is built for, and at G = 1 only over a long
    cache (TC_G1_MIN_ROWS rows or more) at most an eighth of the SMs'
    (slot, KV head) pairs (1 x 32768 at 16 KV heads), or over at least four
    times the SMs' pairs (dsv2's 128 KV heads at 8 slots); not one or two
    slots of short rows (dsv2-lite's one slot, whisper's 2 x 448),
    dsv2-lite's 8 serving slots, 8 x 32768 or the 2-row disagg shard;
    float32 and head_dim 80 (zamba2) take the CUDA-core body; by shape
    alone."""
    for G in KERNEL_GROUPS:
        for hd in KERNEL_HEAD_DIMS:
            for pairs in (12, 16, 32, 128, 1024):
                for S in (448, 512, TC_G1_MIN_ROWS - 1, TC_G1_MIN_ROWS, 32768):
                    long_few = pairs <= 16 and S >= TC_G1_MIN_ROWS
                    want = "tc" if G >= 2 or pairs == 1024 or long_few else "attend"
                    assert decode_body(torch.bfloat16, G, hd, pairs, S, H100_SMS) == want
                    assert decode_body(torch.float32, G, hd, pairs, S, H100_SMS) == "attend"
    for hd, groups in CONTIGUOUS_ONLY.items():
        for G in groups:
            assert decode_body(torch.bfloat16, G, hd, 16, 32768, H100_SMS) == "attend"
