"""K1's bf16 Hopper kernel, modelled on the CPU.

``paged_decode_attention_tiled_ref`` repeats the kernel's arithmetic in
plain PyTorch: 16-row tiles of each page, a KV group's heads padded to 8,
the mask as a select before the max, ``P`` as two bf16 terms, the warps'
and the ranges' merges in order.  Here it is held against the reference's
paged op (Pallas, interpret mode) on the same seeded inputs, bf16 crossing
through ``repro_torch.bridge``; within one bf16 rounding of the f32 oracle
at 4 x 32768 rows; and against itself with NaN past every slot's length.
The kernel on the card is held to its plain version by
``tests/test_torch_kernels.py``'s ``gpu`` tests and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, assert_one_rounding, nan_past_lengths, rounding_excess
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.decode_attention.ops import (
    KERNEL_GROUPS,
    KERNEL_HEAD_DIMS,
    TC_HEADS,
    TC_RING_BYTES,
    TC_SMEM_LIMIT,
    TC_WARPS,
    decode_attention_split_ref,
    k1_body,
    k1_plan,
    paged_decode_attention_ref,
    paged_decode_attention_tiled_ref,
    split_rows,
    tc_smem_bytes,
    tc_stages,
)

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


def _pool(rng, B, nh, nkv, hd, ps, nblk):
    P = B * nblk + 1  # page 0 stays the engine's null page
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    bt = (rng.permutation(P - 1)[: B * nblk].reshape(B, nblk) + 1).astype(np.int32)
    return q, k, v, bt


_GH = [(G, hd) for G in KERNEL_GROUPS for hd in KERNEL_HEAD_DIMS]


@pytest.mark.parametrize("G,hd", _GH)
def test_tiled_emulation_matches_reference(G, hd):
    """Every (G, head_dim) the kernel is built for, against the reference's
    paged op in bf16: page sizes 4, 8 and 16 (a tile of 16 rows pads the
    smaller ones), softcap on and off, one range or several (the plan's),
    lengths of one row, a page edge and the whole table."""
    from repro.kernels.decode_attention.ops import paged_decode_attention as ref_op

    i = _GH.index((G, hd))
    ps = (4, 8, 16)[i % 3]
    cap = 30.0 if i % 2 else 0.0
    rng = np.random.default_rng(300 + i)
    B, nkv, nblk = 3, 2, 5
    q, k, v, bt = _pool(rng, B, G * nkv, nkv, hd, ps, nblk)
    lens = np.array([1, ps + (i % 2), nblk * ps], np.int32)
    n_split = (1, 2, k1_plan(B, nkv, nblk, ps, hd, H100_SMS).n_split)[i % 3]
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    got = paged_decode_attention_tiled_ref(qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(lens),
                                           logit_cap=cap, n_split=n_split)
    want = ref_op(qj, kj, vj, bt, lens, logit_cap=cap)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, TOL["bf16"])


@pytest.mark.parametrize("G,ps", [(1, 16), (4, 32), (7, 16)])
def test_tiled_emulation_one_rounding_at_32k(G, ps):
    """At decode_32k's context (4 slots x 32768 rows, the 64 ranges of the
    plan at 132 SMs), the emulation is within one bf16 rounding of the
    reference's f32 oracle, with lengths on a range's edge and one past it,
    the whole cache, and 17 (a tile of 16 plus one row; at ps 32 inside a
    page's second tile).  Outputs are ~0.01 here, so TOL["bf16"] could not
    tell; P as a single bf16 term does not hold this limit."""
    from repro.kernels.decode_attention.ops import paged_decode_attention as ref_op

    B, nkv, hd, S = 4, 1, 128, 32768
    nblk = S // ps
    rng = np.random.default_rng(G)
    q, k, v, bt = _pool(rng, B, G * nkv, nkv, hd, ps, nblk)
    plan = k1_plan(B, nkv, nblk, ps, hd, H100_SMS)
    assert plan.n_split > 1
    lens = np.array([plan.pages * ps, plan.pages * ps + 1, S, 17], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    want = ref_op(qj.astype(np.float32), kj.astype(np.float32), vj.astype(np.float32), bt, lens, backend="jnp")
    args = (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(lens))
    assert_one_rounding(paged_decode_attention_tiled_ref(*args, n_split=plan.n_split), want)
    assert rounding_excess(paged_decode_attention_tiled_ref(*args, n_split=plan.n_split, p_terms=1), want) > 1.0


@pytest.mark.parametrize("G,hd,ps", [(1, 64, 4), (4, 128, 16), (7, 128, 8), (8, 256, 16), (3, 256, 32)])
def test_tiled_emulation_ignores_nan_past_lengths(G, hd, ps):
    """NaN in every row past each slot's length (its last page's tail and
    the stale pages after it) reaches no output: the result is finite and
    equals the clean pools' bit for bit, which match the reference."""
    from repro.kernels.decode_attention.ops import paged_decode_attention as ref_op

    rng = np.random.default_rng(G * 1000 + hd + ps)
    B, nkv, nblk = 4, 2, 6
    q, k, v, bt = _pool(rng, B, G * nkv, nkv, hd, ps, nblk)
    lens = np.array([1, ps - 1, 2 * ps + 3, nblk * ps - 1], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    bt_t, lens_t = torch.from_numpy(bt), torch.from_numpy(lens)
    n_split = k1_plan(B, nkv, nblk, ps, hd, H100_SMS).n_split
    clean = paged_decode_attention_tiled_ref(qt, kt, vt, bt_t, lens_t, n_split=n_split)
    kn, vn = nan_past_lengths(kt, vt, bt_t, lens_t)
    assert torch.isnan(kn.float()).any() and torch.isnan(vn.float()).any()
    got = paged_decode_attention_tiled_ref(qt, kn, vn, bt_t, lens_t, n_split=n_split)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, clean)
    assert_close(got, ref_op(qj, kj, vj, bt, lens), TOL["bf16"])


@pytest.mark.parametrize("B,nkv,nblk,ps,hd", [
    (8, 16, 32, 16, 128),  # dsv2-lite serving
    (8, 8, 32, 16, 128),  # G 3, 4, 7 serving
    (8, 128, 32, 16, 128),  # dsv2's 128 heads
    (8, 16, 32, 16, 256),  # gemma-7b
    (8, 4, 512, 16, 256),  # gemma2's global layers, 8 x 8192
    (8, 6, 28, 16, 64),  # whisper, 8 x 448
    (4, 16, 2048, 16, 128),  # decode_32k
    (2, 16, 32, 16, 128),  # the ping-pong shard
    (3, 2, 5, 4, 64),
])
def test_k1_plan_covers_the_table_and_fits(B, nkv, nblk, ps, hd):
    """K1's plan: ranges of whole pages that cover the block table, the
    last range not empty; the serving rows split too, so the grid holds
    at least one block an SM wherever the table has pages enough; a ring
    within TC_RING_BYTES (or one stage) and the block's shared memory,
    fewer stages than consumer warps or a multiple of them; and
    its ranges are :func:`split_rows`'s, so ``decode_attention_split_ref``
    models them with ``chunk`` = the page size."""
    plan = k1_plan(B, nkv, nblk, ps, hd, H100_SMS)
    assert plan.n_split * plan.pages >= nblk > (plan.n_split - 1) * plan.pages
    assert B * nkv * plan.n_split >= min(H100_SMS, B * nkv * nblk)
    assert plan.stages >= 1 and (plan.stages <= TC_WARPS or plan.stages % TC_WARPS == 0)
    assert plan.stages >= min(plan.pages, TC_WARPS) or plan.stages == tc_stages(hd, ps, 1)
    stage_bytes = 2 * (hd // 64) * 16 * -(-ps // 16) * 128  # a page's K and V rows of one head
    assert plan.stages == 1 or plan.stages * stage_bytes <= TC_RING_BYTES
    assert tc_smem_bytes(hd, ps, plan.stages) <= TC_SMEM_LIMIT
    assert split_rows(nblk * ps, plan.n_split, ps) == plan.pages * ps


@pytest.mark.parametrize("n_sms", [132, 16])
def test_split_ref_follows_k1_plan(n_sms):
    """The split decomposition at K1's plan (ranges of ``pages`` pages)
    equals the paged plain version, lengths on and beside range edges."""
    rng = np.random.default_rng(n_sms)
    B, nkv, hd, ps, nblk, G = 3, 2, 32, 4, 12, 4
    S = nblk * ps
    plan = k1_plan(B, nkv, nblk, ps, 64, n_sms)
    q, k, v, bt = (torch.from_numpy(a) for a in _pool(rng, B, G * nkv, nkv, hd, ps, nblk))
    edge = plan.pages * ps
    lens = torch.tensor([1, min(edge + 1, S), S], dtype=torch.int32)
    dense_k = k[bt.long()].reshape(B, S, nkv, hd)
    dense_v = v[bt.long()].reshape(B, S, nkv, hd)
    got = decode_attention_split_ref(q, dense_k, dense_v, lens, plan.n_split, chunk=ps)
    assert_close(got, paged_decode_attention_ref(q, k, v, bt, lens), TOL["f32_op"])


def test_k1_body_dispatch():
    """bf16 at G >= 2 runs the Hopper body wherever a page of one head fits
    a ring stage (pages up to 256 rows; at head_dim 256 up to 224); G = 1,
    float32 and larger bf16 pages run the CUDA-core body that K4 and K5
    share."""
    for G in KERNEL_GROUPS:
        for hd in KERNEL_HEAD_DIMS:
            for ps in (4, 8, 16, 32, 64):
                assert k1_body(torch.bfloat16, G, hd, ps) == ("tc" if G >= 2 else "attend")
                assert k1_body(torch.float32, G, hd, ps) == "attend"
    assert k1_body(torch.bfloat16, 4, 128, 256) == "tc"
    assert k1_body(torch.bfloat16, 2, 256, 224) == "tc"
    assert k1_body(torch.bfloat16, 2, 256, 232) == "attend"
    assert k1_body(torch.bfloat16, 7, 64, 257) == "attend"
    assert TC_HEADS >= max(KERNEL_GROUPS)


@pytest.mark.parametrize("hd,ps", [(64, 4), (64, 16), (128, 8), (128, 16), (256, 16), (256, 32), (256, 224)])
def test_k1_stages_keep_each_stage_one_warps(hd, ps):
    """The consumer warps are min(TC_WARPS, stages) and warp w takes pages
    w, w + nw, ...; the page that used a stage before page i must be the
    same warp's earlier page (a parity wait on a stage whose earlier page
    has not landed would pass at once), which holds when stages is below
    TC_WARPS or a multiple of it, for any range length."""
    for pages in range(1, 40):
        stages = tc_stages(hd, ps, pages)
        assert 1 <= stages and tc_smem_bytes(hd, ps, stages) <= TC_SMEM_LIMIT
        nw = min(TC_WARPS, stages)
        for i in range(stages, pages):
            assert (i - stages) % nw == i % nw
        assert stages >= min(pages, tc_stages(hd, ps, 10**6))  # the whole range in flight where it fits
