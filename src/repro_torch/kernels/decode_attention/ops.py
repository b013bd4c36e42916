"""One-token decode attention: CUDA kernel wrappers and their plain versions.

Three kernels of ``csrc/decode_attention.cu``:

* K1 ``paged_decode_attention``: rows reached through per-slot block tables;
* K4 ``decode_attention``: a contiguous ``[B, S, nkv, hd]`` cache;
* K5 ``decode_attention_int8``: K4 over an int8 cache with f32 scales.

Two bodies.  In bf16 at G >= 2 query heads a KV head all three run the
Hopper body (``tc``; :func:`k1_body` and :func:`decode_body` name the
shapes, K4's and K5's also a few at G = 1): each block streams a range of
chunks through a TMA ring (K1: the block table's pages; K4 and K5: runs of
:func:`tc_rows` rows of a slot, the contiguous cache read as a pool with an
implicit block table) and runs
the scores and the weighted sum of a KV group's query heads on tensor
cores; K5's int8 rows are converted to bf16 exactly in registers and their
f32 scales applied once a row; the last of a head's ranges to finish merges
them, in range order, in the same launch (:func:`k1_plan`,
:func:`decode_plan`).  Otherwise (G = 1, float32, head_dim 80) they run the
CUDA-core body (``attend``), split-KV: :func:`split_plan` cuts a slot's rows
into ranges of whole chunks (16 rows, or a page for K1), one block each,
and a second kernel merges the ranges' partials.
:func:`paged_decode_attention_tiled_ref`, :func:`decode_attention_tiled_ref`
and :func:`decode_attention_int8_tiled_ref` are the Hopper body's
arithmetic in plain PyTorch (tiles, the two-term P, masking, split and
merge order), and :func:`decode_attention_split_ref` the CUDA-core body's
split.  Each wrapper launches its kernel for CUDA tensors and runs its
plain version (``*_ref``, a copy of ``repro.kernels.decode_attention.ref``)
for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple, Union

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cuda

NEG_INF = -1.0e30  # the reference kernel's mask constant (kernel.py:25)
KERNEL_GROUPS = (1, 2, 3, 4, 7, 8)  # template instances of csrc/decode_attention.cu
KERNEL_HEAD_DIMS = (64, 128, 256)
# K4 and K5 also at head_dim 80 for one query head per KV head (zamba2's
# shared block); K1 has no such instance
CONTIGUOUS_ONLY = {80: (1,)}
_ALIGN = 32  # bytes: a lane loads its head_dim columns of a row as one vector
_K1_ARGS = [cuda.PTR] * 7 + [cuda.INT] * 8 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]
_K1_TC_ARGS = [cuda.PTR] * 8 + [cuda.INT] * 10 + [cuda.FLOAT] * 2 + [cuda.INT] + [cuda.PTR]
_K4_ARGS = [cuda.PTR] * 6 + [cuda.INT] * 7 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]
_K5_ARGS = [cuda.PTR] * 8 + [cuda.INT] * 7 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]
_K45_TC_ARGS = [cuda.PTR] * 9 + [cuda.INT] * 9 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]

ValidLen = Union[int, torch.Tensor]

# The split-KV plan of K1, K4 and K5: SPLIT_BLOCKS_PER_SM blocks for every
# SM (one block is resident at a time; four short ranges an SM even out the
# waves, and measured faster than two for all three kernels), but at most
# ceil(S / SPLIT_MIN_ROWS) ranges of whole chunks (16 rows for K4 and K5, a
# page for K1): a cache of up to 512 rows (the serving engine's) is not
# split, since its second launch and scratch would cost more than the split
# saves (S = 513 gives two ranges, of 272 and 241 rows).
SPLIT_CHUNK = 16
SPLIT_MIN_ROWS = 512
SPLIT_BLOCKS_PER_SM = 4

# The Hopper body (``tc`` in csrc/decode_attention.cu; K1 at bf16 G >= 2,
# and K4 and K5 at the shapes :func:`decode_body` gives it): TC_WARPS
# consumer warps take a range's chunks (K1: pages; K4/K5: runs of
# :func:`tc_rows` rows) in turn; each product is TC_TILE rows by TC_HEADS
# query heads (a KV group's G <= 8, padded).  K1's split plan
# (:func:`k1_plan`) aims at K1_BLOCKS_PER_SM blocks an SM whatever the
# cache's rows (the serving cache's 512 rows too: the last range of a head
# to finish merges them inside the launch), K4's and K5's
# (:func:`decode_plan`) at one wave of the card's resident blocks; a block
# has a ring of at most TC_RING_BYTES of K and V.  A K4/K5 chunk holds
# TC_CHUNK_BYTES of one head's K rows.  The two plans of the one kernel
# differ (K1's ceil over two blocks an SM, K4/K5's floor over the measured
# occupancy); K1 takes decode_plan once an A/B of K1 in turns shows no loss.
TC_WARPS = 4
TC_TILE = 16
TC_HEADS = 8
K1_BLOCKS_PER_SM = 2
TC_RING_BYTES = 64 * 1024
TC_MAX_STAGES = 16
TC_SMEM_LIMIT = 232448  # bytes of shared memory a block may have (227 KB)
TC_CHUNK_BYTES = 4096
TC_G1_MIN_ROWS = 8192  # the fewest cache rows at which K4/K5 take ``tc`` at G = 1 over few pairs


class TcPlan(NamedTuple):
    n_split: int  # ranges of a slot (blocks of a (slot, KV head))
    pages: int  # pages a range
    stages: int  # ring depth, in pages


def _lengths(valid_len: ValidLen, B: int, device) -> torch.Tensor:
    """A scalar ``valid_len`` (the reference's contract) broadcast to per-slot
    int32 lengths ``[B]``; a ``[B]`` tensor passes through as int32."""
    t = torch.as_tensor(valid_len, device=device)
    if t.dim() == 0:
        t = t.expand(B)
    if t.shape != (B,):
        raise ValueError(f"valid_len must be a scalar or [{B}], got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def decode_attention_ref(
    q: torch.Tensor,  # [B, nh, hd]
    k_cache: torch.Tensor,  # [B, S, nkv, hd]
    v_cache: torch.Tensor,
    valid_len: ValidLen,  # scalar, or [B] per-slot lengths
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Masked f32 attention of one query token over rows ``< valid_len``
    (``decode_attention/ref.py:9``)."""
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, nkv, nh // nkv, hd).float()
    s = torch.einsum("bngh,bsnh->bngs", qg, k_cache.float()) * (hd**-0.5)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    lengths = _lengths(valid_len, B, q.device)
    mask = torch.arange(S, device=q.device)[None, :] < lengths.long()[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngs,bsnh->bngh", p, v_cache.float())
    return o.reshape(B, nh, hd).to(q.dtype)


def split_rows(S: int, n_split: int, chunk: int = SPLIT_CHUNK) -> int:
    """Rows per range when ``S`` rows are cut into ``n_split`` ranges of
    whole ``chunk``-row chunks (the last ranges may lie past ``S``)."""
    return chunk * -(-S // (chunk * n_split))


def split_plan(B: int, nkv: int, S: int, num_sms: int, chunk: int = SPLIT_CHUNK,
               blocks_per_sm: int = SPLIT_BLOCKS_PER_SM, min_rows: int = SPLIT_MIN_ROWS) -> Tuple[int, int]:
    """``(n_split, rows per range)`` of a launch from what the host knows
    without a device sync: the (slot, KV head) count, the cache's rows ``S``
    (K1: the block table's width times the page size, never the lengths),
    the chunk (K1: the page size) and the SM count; about ``blocks_per_sm``
    blocks an SM, but at most ``ceil(S / min_rows)`` ranges."""
    want = -(-blocks_per_sm * num_sms // (B * nkv))
    n = max(1, min(want, -(-S // min_rows)))
    rows = split_rows(S, n, chunk)
    return -(-S // rows), rows


def _tc_stage_bytes(hd: int, ps: int, int8: bool = False) -> int:
    """Ring bytes of one stage: a chunk's K and V rows of one head, padded
    to whole TC_TILE-row tiles (bf16: 64-column boxes of 128-byte rows;
    int8: one byte a value)."""
    return 2 * TC_TILE * -(-ps // TC_TILE) * hd * (1 if int8 else 2)


def tc_smem_bytes(hd: int, ps: int, stages: int, int8: bool = False) -> int:
    """Dynamic shared memory of a block of the Hopper body
    (``tc::smem_bytes``): the ring, or the warps' merge arrays that reuse
    it, aligned to 1024 bytes, K5's f32 row scales of each stage (K and V),
    two barriers a stage, and at head_dim 256 K5's q fragments."""
    merge = TC_WARPS * TC_HEADS * (hd + 6) * 4
    scales = stages * 2 * TC_TILE * -(-ps // TC_TILE) * 4 if int8 else 0
    q_frags = hd // 16 * 256 if int8 and hd == 256 else 0
    return 1024 + max(stages * _tc_stage_bytes(hd, ps, int8), merge) + scales + 16 * stages + q_frags


@functools.lru_cache(maxsize=256)
def k1_body(dtype: torch.dtype, G: int, hd: int, ps: int) -> str:
    """Which body K1 runs: ``"tc"`` (the Hopper kernel) for bf16 at G >= 2
    query heads a KV head where one page of a head fits a ring stage (pages
    of up to 256 rows, the TMA box's limit; at head_dim 256 up to 224, the
    shared memory's), else ``"attend"`` (the CUDA-core body).  At G = 1 a
    product of ``tc`` carries one real head of TC_HEADS, and on the H100
    ``attend`` measured as fast or faster at the serving rows and at
    4 x 32768 (PERF.md §6); float32 is the parity phases' (held to the CPU
    at ``TOL["f32_op"]``)."""
    if dtype == torch.bfloat16 and G >= 2 and ps <= 256 and tc_smem_bytes(hd, ps, 1) <= TC_SMEM_LIMIT:
        return "tc"
    return "attend"


@functools.lru_cache(maxsize=256)
def decode_body(dtype: torch.dtype, G: int, hd: int, pairs: int, S: int, num_sms: int) -> str:
    """Which body K4 and K5 run, by shape alone (``dtype`` is q's, ``pairs``
    the launch's B * nkv (slot, KV head) pairs, ``S`` the cache's rows):
    ``"tc"`` (the Hopper kernel, K1's, over chunks of :func:`tc_rows` rows)
    for bf16 at a head_dim of 64, 128 or 256 and G >= 2 query heads a KV
    head; at G = 1 (a product of ``tc`` then carries one real head of
    TC_HEADS) only where it measured faster for both kernels in turns
    (PERF.md §6): a long cache (at least TC_G1_MIN_ROWS rows) over pairs at
    most an eighth of the SMs (1 x 32768: the CUDA-core body fills the card
    only by a long split and a second launch to merge it), or at least four
    times the SMs' pairs (dsv2's 128 KV heads at 8 slots).  Else
    ``"attend"``: G = 1 elsewhere (dsv2-lite's serving rows, one or two
    slots of short rows, 8 x 32768, whisper, gemma-7b, where K5 on ``tc``
    was slower), float32 (the parity phases') and head_dim 80 (zamba2),
    which has no ``tc`` instance."""
    if dtype == torch.bfloat16 and hd in KERNEL_HEAD_DIMS and (
            G >= 2 or (8 * pairs <= num_sms and S >= TC_G1_MIN_ROWS) or pairs >= 4 * num_sms):
        return "tc"
    return "attend"


def tc_rows(hd: int, int8: bool = False) -> int:
    """Rows of a K4/K5 chunk on the Hopper body: TC_CHUNK_BYTES of one
    head's K rows, a multiple of TC_TILE up to 256 (a TMA box's most rows),
    at least one tile, and for int8 at least two: a chunk's barrier round
    trip and its scales' copies then carry 8 KB of K and V at head_dim 256
    (measured 10% faster there than one tile, PERF.md §6)."""
    least = 2 * TC_TILE if int8 else TC_TILE
    return min(256, max(least, TC_CHUNK_BYTES // (hd * (1 if int8 else 2)) // TC_TILE * TC_TILE))


def tc_stages(hd: int, ps: int, pages: int, int8: bool = False) -> int:
    """The Hopper body's ring depth for ranges of ``pages`` chunks: as many
    as a range holds within TC_RING_BYTES (at least one), and where that is
    more than TC_WARPS a multiple of it (rounded up while it fits, so a
    range that holds a few more chunks than the warps still has them all
    in flight): the kernel's consumers are min(TC_WARPS, stages) warps,
    and a stage's chunks must all be one warp's."""
    fit = max(1, min(TC_MAX_STAGES, TC_RING_BYTES // _tc_stage_bytes(hd, ps, int8)))
    stages = min(pages, fit)
    if stages > TC_WARPS:
        up = -(-stages // TC_WARPS) * TC_WARPS
        stages = up if up <= fit else stages - stages % TC_WARPS
    return stages


@functools.lru_cache(maxsize=1024)
def k1_plan(B: int, nkv: int, nblk: int, ps: int, hd: int, num_sms: int) -> TcPlan:
    """K1's bf16 plan from what the host knows without a device sync
    (cached: the wrapper runs on a host-bound step): :func:`split_plan` at
    K1_BLOCKS_PER_SM blocks an SM over the (slot, KV head) pairs, in ranges
    of whole pages of the block table (``nblk`` wide, as short as one page;
    the ranges past a slot's length launch and return at once), and a ring
    of :func:`tc_stages` pages."""
    n_split, rows = split_plan(B, nkv, nblk * ps, num_sms, ps, K1_BLOCKS_PER_SM, ps)
    return TcPlan(n_split, rows // ps, tc_stages(hd, ps, rows // ps))


@functools.lru_cache(maxsize=1024)
def decode_plan(B: int, nkv: int, S: int, hd: int, num_sms: int, int8: bool = False,
                blocks_per_sm: int = K1_BLOCKS_PER_SM) -> TcPlan:
    """K4's (K5's with ``int8``) plan on the Hopper body, from the cache's
    rows ``S``, never the lengths: ranges of whole chunks of R =
    :func:`tc_rows` rows, as many a slot as one wave of the card's resident
    blocks holds (``blocks_per_sm`` an SM, the instance's occupancy on the
    card), at least one, and a ring of :func:`tc_stages` chunks.  A slot
    whose rows all live then takes one wave, not one and a sliver."""
    R = tc_rows(hd, int8)
    nblk = -(-S // R)
    n = max(1, min(blocks_per_sm * num_sms // (B * nkv), nblk))
    pages = -(-nblk // n)
    return TcPlan(-(-nblk // pages), pages, tc_stages(hd, R, pages, int8))


def decode_attention_split_ref(
    q: torch.Tensor,  # [B, nh, hd]
    k_cache: torch.Tensor,  # [B, S, nkv, hd]
    v_cache: torch.Tensor,
    valid_len: ValidLen,
    n_split: int,
    logit_cap: float = 0.0,
    chunk: int = SPLIT_CHUNK,
) -> torch.Tensor:
    """The split-KV decomposition of K1, K4 and K5 in plain PyTorch: f32
    partials ``(m, l, acc)`` over ``n_split`` ranges of :func:`split_rows`
    rows (whole chunks of ``chunk`` rows), merged in range order.  It takes
    the dense view: K1's pages gathered (``chunk`` = the page size; in bf16
    ``n_split`` from :func:`k1_plan`, whose ranges of ``pages`` pages are
    the same rows), K5's int8 rows dequantised in f32.  Equal to
    :func:`decode_attention_ref` up to f32 rounding; nothing on the serving
    path calls it."""
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, nkv, nh // nkv, hd).float()
    s = torch.einsum("bngh,bsnh->bngs", qg, k_cache.float()) * (hd**-0.5)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    lengths = _lengths(valid_len, B, q.device).long()
    live = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    s = torch.where(live, s, NEG_INF)
    rows = split_rows(S, n_split, chunk)
    m, l, acc = [], [], []
    for z in range(n_split):
        lo, hi = min(z * rows, S), min((z + 1) * rows, S)
        sz, lz = s[..., lo:hi], live[..., lo:hi]
        # -1e30 for a range wholly past the length (or past S)
        mz = sz.amax(dim=-1) if hi > lo else torch.full(s.shape[:-1], NEG_INF, device=q.device)
        p = torch.where(lz, torch.exp(sz - mz[..., None]), 0.0)
        m.append(mz)
        l.append(p.sum(-1))
        acc.append(torch.einsum("bngs,bsnh->bngh", p, v_cache[:, lo:hi].float()))
    mx = torch.stack(m).amax(dim=0)
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for mz, lz, az in zip(m, l, acc):
        c = torch.exp(mz - mx)
        num = num + az * c[..., None]
        den = den + lz * c
    o = num / den.clamp(min=1e-30)[..., None]
    return o.reshape(B, nh, hd).to(q.dtype)


def _tiled_ref(q, k_rows, v_rows, first_row, lens, ps, logit_cap, n_split, p_terms, k_scale=None, v_scale=None):
    """The Hopper body's arithmetic over chunks of ``ps`` rows of one head
    (see :func:`paged_decode_attention_tiled_ref`): ``k_rows`` and ``v_rows``
    ``[N, nkv, hd]`` (bf16, or int8 with f32 ``k_scale`` and ``v_scale``
    ``[N, nkv]``), chunk j of slot b from row ``first_row[b, j]`` (rows at or
    past N read as zeros, as TMA fills them), ``lens`` the slots' lengths
    within their chunks."""
    B, nh, hd = q.shape
    N, nkv = k_rows.shape[:2]
    nblk = first_row.shape[1]
    int8 = k_scale is not None
    G, H, T = nh // nkv, TC_HEADS, TC_TILE
    pages = -(-nblk // n_split)
    n_split = -(-nblk // pages)
    W = min(TC_WARPS, tc_stages(hd, ps, pages, int8))
    rows_pad = T * -(-ps // T)
    dev = q.device
    live_pages = -(-lens // ps)
    qn = torch.zeros((B, nkv, H, hd), device=dev)
    qn[:, :, :G] = q.reshape(B, nkv, G, hd).float()
    m = torch.full((B, nkv, n_split, W, H), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nkv, n_split, W, H, hd), device=dev)
    z_idx = torch.arange(n_split, device=dev)[:, None]
    rows = torch.arange(rows_pad, device=dev)

    def gather(x, idx, inside, pad):
        """x's rows idx (zero past N), padded to rows_pad rows with ``pad``,
        the head axis moved after the slot's: [B, nkv, Z, W, rows_pad, ...]."""
        out = torch.full(idx.shape[:3] + (rows_pad,) + x.shape[1:], pad, device=dev)
        shape = inside.shape + (1,) * (x.dim() - 1)
        out[:, :, :, :ps] = torch.where(inside.reshape(shape), x[idx.clamp(0, N - 1)].float(), 0.0)
        return out.movedim(4, 1)

    for r in range(-(-pages // W)):
        i = r * W + torch.arange(W, device=dev)[None, :]  # [1, W] the range's chunk index
        j = z_idx * pages + i  # [n_split, W] the slot's chunk index
        jj = j.clamp(max=nblk - 1)
        live = ((i < pages) & (j < nblk))[None] & (jj[None] < live_pages[:, None, None])  # [B, n_split, W]
        valid = (lens[:, None, None] - jj[None] * ps).clamp(0, ps) * live  # live rows of each chunk
        idx = first_row[:, jj][..., None] + torch.arange(ps, device=dev)  # [B, n_split, W, ps]
        inside = idx < N
        kr, vr = gather(k_rows, idx, inside, float("nan")), gather(v_rows, idx, inside, 0.0)
        row_ok = (rows < valid[..., None])[:, None, :, :, :, None]  # [B, 1, n_split, W, rows_pad, 1]
        if int8:  # the rows' scales, once a row; past the length they may be anything
            ks, vs = gather(k_scale, idx, inside, float("nan")), gather(v_scale, idx, inside, float("nan"))
        else:  # the kernel zeroes the V rows past the length (int8 V rows are finite)
            vr = torch.where(row_ok, vr, 0.0)
        for r0 in range(0, rows_pad, T):
            s = torch.einsum("bhzwrd,bhnd->bhzwrn", kr[..., r0:r0 + T, :], qn)
            if int8:
                s = s * ks[..., r0:r0 + T, None]
            s = s * (hd**-0.5)
            if logit_cap > 0.0:
                s = logit_cap * torch.tanh(s / logit_cap)
            ok = row_ok[..., r0:r0 + T, :]
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-2))
            c = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new[..., None, :]), 0.0)
            m, l = m_new, l * c + p.sum(dim=-2)
            w = torch.where(ok, p * vs[..., r0:r0 + T, None], 0.0) if int8 else p
            hi = w.to(torch.bfloat16).float()
            lo = (w - hi).to(torch.bfloat16).float() if p_terms == 2 else torch.zeros_like(w)
            vt = vr[..., r0:r0 + T, :]
            acc = acc * c[..., None] + torch.einsum("bhzwrn,bhzwrd->bhzwnd", hi, vt)
            acc = acc + torch.einsum("bhzwrn,bhzwrd->bhzwnd", lo, vt)

    def merge(m, l, acc, dim):
        mx = m.amax(dim=dim, keepdim=True)
        c = torch.exp(m - mx)  # 0 for a part that read no row
        return mx.squeeze(dim), (l * c).sum(dim), (acc * c[..., None]).sum(dim)

    m, l, acc = merge(m, l, acc, 3)  # the warps of a range
    _, l, acc = merge(m, l, acc, 2)  # the ranges
    o = acc / l.clamp(min=1e-30)[..., None]
    return o[:, :, :G].reshape(B, nh, hd).to(q.dtype)


def paged_decode_attention_tiled_ref(
    q: torch.Tensor,  # [B, nh, hd]
    k_pages: torch.Tensor,  # [P, ps, nkv, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, nblk] int32
    lengths: torch.Tensor,  # [B] int32
    logit_cap: float = 0.0,
    n_split: int = 1,
    p_terms: int = 2,
) -> torch.Tensor:
    """K1's bf16 kernel's arithmetic in plain PyTorch (f32): ranges of
    ``ceil(nblk / n_split)`` pages; in a range, warp ``w`` of ``W =
    min(TC_WARPS, tc_stages(...))`` takes pages ``w, w + W, ...``; a page is read in TC_TILE-row tiles
    (rows past the page's end pad the last tile: K NaN, V zero), each tile's
    scores are ``TC_TILE`` rows by TC_HEADS heads (past G: q zero), masked
    by a select before the max (rows at or past the length, and pad rows),
    and folded in with one online-softmax update; ``P`` enters the weighted
    sum as two bf16 terms (``P`` rounded, then the rest rounded; with
    ``p_terms=1`` the first alone, a one-product design the tests show
    falls short of one bf16 rounding at long context) over V
    whose rows at or past the length are zero; warps merge in warp order,
    then ranges in range order, and the result is rounded once.  Rows past
    a slot's length never reach the output, whatever they hold (NaN too).
    Nothing on the serving path calls it."""
    P, ps, nkv, hd = k_pages.shape
    nblk = block_tables.shape[1]
    first = block_tables.long().clamp(0, P - 1) * ps
    lens = lengths.long().clamp(0, nblk * ps)
    return _tiled_ref(q, k_pages.reshape(P * ps, nkv, hd), v_pages.reshape(P * ps, nkv, hd), first, lens, ps,
                      logit_cap, n_split, p_terms)


def _contiguous_chunks(B: int, S: int, R: int, device) -> torch.Tensor:
    """First rows of each slot's R-row chunks in the ``[B * S, ...]`` view
    (the last may run into the next slot's rows, or past the cache)."""
    return (torch.arange(B, device=device)[:, None] * S + torch.arange(-(-S // R), device=device)[None, :] * R)


def decode_attention_tiled_ref(
    q: torch.Tensor,  # [B, nh, hd]
    k_cache: torch.Tensor,  # [B, S, nkv, hd]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
    logit_cap: float = 0.0,
    n_split: int = 1,
    p_terms: int = 2,
) -> torch.Tensor:
    """K4's Hopper body in plain PyTorch: :func:`paged_decode_attention_tiled_ref`'s
    arithmetic over chunks of :func:`tc_rows` rows of each slot (chunk j of
    slot b is rows ``b * S + j * R`` of the cache seen as ``[B * S, nkv,
    hd]``: past S the next slot's rows, masked; past ``B * S`` zeros, as
    TMA fills them), ``n_split`` ranges of whole chunks
    (:func:`decode_plan`'s).  Nothing on the serving path calls it."""
    B, S, nkv, hd = k_cache.shape
    R = tc_rows(hd)
    return _tiled_ref(q, k_cache.reshape(B * S, nkv, hd), v_cache.reshape(B * S, nkv, hd),
                      _contiguous_chunks(B, S, R, q.device), lengths.long().clamp(0, S), R, logit_cap, n_split,
                      p_terms)


def decode_attention_int8_tiled_ref(
    q: torch.Tensor,  # [B, nh, hd]
    k_cache: torch.Tensor,  # [B, S, nkv, hd] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [B, S, nkv] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
    logit_cap: float = 0.0,
    n_split: int = 1,
    p_terms: int = 2,
) -> torch.Tensor:
    """K5's Hopper body in plain PyTorch: :func:`decode_attention_tiled_ref`
    over int8 rows (exact in bf16) in chunks of ``tc_rows(hd, int8=True)``
    rows; a row's score is ``q . k`` times its K scale and ``hd^-0.5``, and
    the weighted sum takes ``P' = p * s_v``, once a row, as two bf16 terms
    against the exact V values (``l`` sums ``p``), ``P'`` set to 0 past the
    length by a select, whatever the scales hold there (NaN, inf).  It keeps
    the dequantised rows in f32, as the kernel does; nothing on the serving
    path calls it."""
    B, S, nkv, hd = k_cache.shape
    R = tc_rows(hd, int8=True)
    return _tiled_ref(q, k_cache.reshape(B * S, nkv, hd), v_cache.reshape(B * S, nkv, hd),
                      _contiguous_chunks(B, S, R, q.device), lengths.long().clamp(0, S), R, logit_cap, n_split,
                      p_terms, k_scale.reshape(B * S, nkv), v_scale.reshape(B * S, nkv))


def decode_attention_int8_ref(q, k_cache, v_cache, k_scale, v_scale, valid_len, logit_cap: float = 0.0):
    """Dequantise the int8 cache, round it to q's dtype, then
    :func:`decode_attention_ref` (``decode_attention/ref.py:29``)."""
    k = k_cache.float() * k_scale[..., None].float()
    v = v_cache.float() * v_scale[..., None].float()
    return decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype), valid_len, logit_cap)


def paged_decode_attention_ref(
    q: torch.Tensor,  # [B, nh, hd]
    k_pages: torch.Tensor,  # [P, ps, nkv, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, nblk] int32
    lengths: torch.Tensor,  # [B] int32
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Gather each slot's pages into the dense ``[B, S, nkv, hd]`` view and
    run :func:`decode_attention_ref` (``decode_attention/ref.py:38``)."""
    B = q.shape[0]
    ps, nkv, hd = k_pages.shape[1:]
    S = block_tables.shape[1] * ps
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, S, nkv, hd)
    v = v_pages[bt].reshape(B, S, nkv, hd)
    return decode_attention_ref(q, k, v, lengths, logit_cap)


_SMS: Dict[int, int] = {}
_TC_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _num_sms(device: torch.device) -> int:
    """The card's SM count (a host query, cached per device)."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _tc_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The Hopper body's per-(slot, KV head) counts of finished ranges on
    ``device`` for ``stream``, one buffer that K1, K4 and K5 share: zeroed
    once and left at zero by every launch (the last range of a head resets
    its count), so a call adds no memset; a stream has its own, so
    launches on two streams never share one.  A launch captured into a
    CUDA graph keeps the capture stream's counts: two replays of graphs
    that hold any of the three kernels must not overlap (replay them on one
    stream, or order them with events), or their merges corrupt each
    other."""
    key = (device.index, stream)
    buf = _TC_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TC_COUNTERS[key] = buf
    return buf


@functools.lru_cache(maxsize=64)
def tc_blocks_per_sm(device_index: int, hd: int, int8: bool) -> int:
    """Resident blocks an SM of K4's (K5's) Hopper body at head_dim ``hd``
    with its deepest ring (the card's occupancy, cached)."""
    R = tc_rows(hd, int8)
    out = ctypes.c_int(0)
    fn = cuda.function("decode_attention", "decode_attention_tc_blocks_per_sm", [cuda.INT] * 5 + [cuda.PTR])
    err = fn(hd, R, tc_stages(hd, R, 1 << 20, int8), int(int8), device_index, ctypes.addressof(out))
    cuda.check("decode_attention", err, "decode_attention_tc_blocks_per_sm")
    return max(1, out.value)


def _tc_part(q: torch.Tensor, n_split: int) -> torch.Tensor:
    """f32 scratch for the ranges' partials of a Hopper-body launch (none
    unsplit)."""
    B, nh, hd = q.shape
    return torch.empty(B * nh * n_split * (hd + 2) if n_split > 1 else 0, dtype=torch.float32, device=q.device)


def _check_launch(what: str, q: torch.Tensor, nkv: int, tensors, contiguous: bool = True) -> int:
    """Checks shared by the three launchers; returns the kernel's dtype code.
    ``contiguous`` launchers (K4, K5) also take :data:`CONTIGUOUS_ONLY`'s
    head_dims at their groups."""
    B, nh, hd = q.shape
    G = nh // nkv if nh % nkv == 0 else 0
    built = G in KERNEL_GROUPS and hd in KERNEL_HEAD_DIMS
    if contiguous and hd in CONTIGUOUS_ONLY:
        built = G in CONTIGUOUS_ONLY[hd]
    if not built:
        extra = f", or (head_dim: groups) {CONTIGUOUS_ONLY}" if contiguous else ""
        raise ValueError(
            f"{what}: the kernel is built for query heads per KV head in {KERNEL_GROUPS} and "
            f"head_dim in {KERNEL_HEAD_DIMS}{extra}, got nh={nh}, nkv={nkv}, hd={hd}"
        )
    cuda.check_tensors(tensors, q.device)
    for name, t in tensors.items():
        if t.dim() == 4 and t.data_ptr() % _ALIGN:
            raise ValueError(f"{what}: {name} must be {_ALIGN}-byte aligned")
    return cuda.dtype_code(q, what)


def _split_launch(q: torch.Tensor, nkv: int, S: int, chunk: int) -> Tuple[int, int, torch.Tensor]:
    """``(n_split, chunks per range, f32 scratch for the partials)`` of a
    launch over ``S`` rows of ``chunk``-row chunks (no scratch unsplit)."""
    B, nh, hd = q.shape
    n_split, rows = split_plan(B, nkv, S, _num_sms(q.device), chunk)
    part = torch.empty(B * nh * n_split * (hd + 2) if n_split > 1 else 0,
                       dtype=torch.float32, device=q.device)
    return n_split, rows // chunk, part


def _check_cache(what: str, q, k, v, kv_dtype) -> None:
    B, nh, hd = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(
            f"{what}: q {tuple(q.shape)} does not fit caches {tuple(k.shape)} / {tuple(v.shape)}"
        )
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{what}: K/V caches must be {kv_dtype}, got {k.dtype} / {v.dtype}")


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """K1, split-KV paged flash decode: ``[B, nh, hd]`` attention output in
    q's dtype.  The ranges are runs of whole pages of each slot's block
    table, planned from the table's width (``nblk * ps`` rows): in bf16 the
    Hopper body over :func:`k1_plan`'s ranges, merged in the same launch
    (:func:`k1_body` names the shapes it leaves to the other body), and
    at G = 1, in float32 and for those shapes the CUDA-core body over
    :func:`split_plan`'s."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    cuda.refuse_autograd("paged_decode_attention", q, k_pages, v_pages)
    B, nh, hd = q.shape
    P, ps, nkv, hd_k = k_pages.shape
    nblk = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}"
            f" / {tuple(v_pages.shape)}"
        )
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q and the page pools must share one dtype")
    if block_tables.shape != (B, nblk) or lengths.shape != (B,):
        raise ValueError("paged_decode_attention: block_tables must be [B, nblk], lengths [B]")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and lengths must be int32")
    code = _check_launch(
        "paged_decode_attention", q, nkv,
        {"q": q, "k_pages": k_pages, "v_pages": v_pages, "block_tables": block_tables,
         "lengths": lengths}, contiguous=False,
    )
    out = torch.empty_like(q)
    stream = cuda.stream_of(q)
    if k1_body(q.dtype, nh // nkv, hd, ps) == "tc":
        plan = k1_plan(B, nkv, nblk, ps, hd, _num_sms(q.device))
        part = _tc_part(q, plan.n_split)
        counters = _tc_counters(q.device, stream, B * nkv)
        fn = cuda.function("decode_attention", "paged_decode_attention_bf16", _K1_TC_ARGS)
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, nh, nkv, hd,
            ps, P, nblk, plan.n_split, plan.pages, plan.stages, hd**-0.5, float(logit_cap),
            q.device.index, stream,
        )
    else:
        n_split, cps, part = _split_launch(q, nkv, nblk * ps, ps)
        fn = cuda.function("decode_attention", "paged_decode_attention", _K1_ARGS)
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(), B, nh, nkv, hd, ps, nblk,
            n_split, cps, hd**-0.5, float(logit_cap), code, q.device.index, stream,
        )
    cuda.check("decode_attention", err, "paged_decode_attention")
    cuda.count("paged_decode_attention")
    return out


def decode_attention(
    q: torch.Tensor,  # [B, nh, hd]
    k_cache: torch.Tensor,  # [B, S, nkv, hd], q's dtype
    v_cache: torch.Tensor,
    valid_len: ValidLen,  # scalar, or [B] int32 per-slot lengths
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """K4, split-KV flash decode over a contiguous cache: ``[B, nh, hd]`` in
    q's dtype.

    Rows ``p < valid_len`` (per slot when ``valid_len`` is ``[B]``) attend.
    The slot's rows are cut into ranges, one block each, planned from the
    cache's rows: on the Hopper body (:func:`decode_body`) :func:`decode_plan`'s
    ranges of whole chunks, merged in the same launch; on the CUDA-core body
    :func:`split_plan`'s, merged by a second kernel.
    The reference op's ``block_kv`` is a TPU tiling choice with no effect on
    the result, so it is left out; lengths must be >= 1 (the kernel reads no
    row of an empty slot)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, valid_len, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    cuda.refuse_autograd("decode_attention", q, k_cache, v_cache)
    _check_cache("decode_attention", q, k_cache, v_cache, q.dtype)
    lengths = _lengths(valid_len, q.shape[0], q.device)
    return torch.ops.repro_torch.decode_attention(q, k_cache, v_cache, lengths, float(logit_cap))


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor,
                         logit_cap: float) -> torch.Tensor:
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    code = _check_launch("decode_attention", q, nkv,
                         {"q": q, "k_cache": k_cache, "v_cache": v_cache, "lengths": lengths})
    out = torch.empty_like(q)
    if decode_body(q.dtype, nh // nkv, hd, B * nkv, S, _num_sms(q.device)) == "tc":
        err = _tc_launch(q, k_cache, v_cache, None, None, lengths, out, logit_cap)
    else:
        n_split, cps, part = _split_launch(q, nkv, S, SPLIT_CHUNK)
        fn = cuda.function("decode_attention", "decode_attention", _K4_ARGS)
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part.data_ptr(), B, nh, nkv, hd, S, n_split, cps,
            hd**-0.5, logit_cap, code, q.device.index, cuda.stream_of(q),
        )
    cuda.check("decode_attention", err, "decode_attention")
    cuda.count("decode_attention")
    return out


def _tc_launch(q, k_cache, v_cache, k_scale, v_scale, lengths, out, logit_cap) -> int:
    """K4 (``k_scale`` None) or K5 on the Hopper body over :func:`decode_plan`'s
    ranges; returns the launcher's error code."""
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    int8 = k_scale is not None
    plan = decode_plan(B, nkv, S, hd, _num_sms(q.device), int8, tc_blocks_per_sm(q.device.index, hd, int8))
    part = _tc_part(q, plan.n_split)
    stream = cuda.stream_of(q)
    fn = cuda.function("decode_attention", "decode_attention_tc", _K45_TC_ARGS)
    return fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        _tc_counters(q.device, stream, B * nkv).data_ptr(), B, nh, nkv, hd, S, tc_rows(hd, int8), plan.n_split,
        plan.pages, plan.stages, hd**-0.5, logit_cap, int(int8), q.device.index, stream,
    )


def decode_attention_int8(
    q: torch.Tensor,  # [B, nh, hd]
    k_cache: torch.Tensor,  # [B, S, nkv, hd] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [B, S, nkv] f32
    v_scale: torch.Tensor,
    valid_len: ValidLen,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """K5, split-KV :func:`decode_attention` over an int8 cache dequantised
    by its per-(row, head) scales inside the kernel (in f32, as the TPU
    kernel does: on the Hopper body the int8 values enter the products
    exactly and each row's scales multiply its score and its weight once;
    the plain version rounds the dequantised rows to q's dtype first, as
    the reference's oracle does).  ``block_kv`` is left out as in K4."""
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, k_cache, v_cache, k_scale, v_scale, valid_len, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: unsupported device {q.device}")
    cuda.refuse_autograd("decode_attention_int8", q, k_cache, v_cache, k_scale, v_scale)
    _check_cache("decode_attention_int8", q, k_cache, v_cache, torch.int8)
    B = q.shape[0]
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    if k_scale.shape != (B, S, nkv) or v_scale.shape != (B, S, nkv):
        raise ValueError(f"decode_attention_int8: scales must be [{B}, {S}, {nkv}]")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("decode_attention_int8: scales must be float32")
    lengths = _lengths(valid_len, B, q.device)
    return torch.ops.repro_torch.decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                                       float(logit_cap))


@torch.library.custom_op("repro_torch::decode_attention_int8", mutates_args=())
def _decode_attention_int8_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, lengths: torch.Tensor, logit_cap: float) -> torch.Tensor:
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    code = _check_launch("decode_attention_int8", q, nkv,
                         {"q": q, "k_cache": k_cache, "v_cache": v_cache, "k_scale": k_scale,
                          "v_scale": v_scale, "lengths": lengths})
    out = torch.empty_like(q)
    if decode_body(q.dtype, nh // nkv, hd, B * nkv, S, _num_sms(q.device)) == "tc":
        err = _tc_launch(q, k_cache, v_cache, k_scale, v_scale, lengths, out, logit_cap)
    else:
        n_split, cps, part = _split_launch(q, nkv, S, SPLIT_CHUNK)
        fn = cuda.function("decode_attention", "decode_attention_int8", _K5_ARGS)
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(), B, nh, nkv,
            hd, S, n_split, cps, hd**-0.5, logit_cap, code, q.device.index,
            cuda.stream_of(q),
        )
    cuda.check("decode_attention", err, "decode_attention_int8")
    cuda.count("decode_attention_int8")
    return out


@_decode_attention_op.register_fake
def _(q, k_cache, v_cache, lengths, logit_cap):
    return torch.empty_like(q)


@_decode_attention_int8_op.register_fake
def _(q, k_cache, v_cache, k_scale, v_scale, lengths, logit_cap):
    return torch.empty_like(q)


def _attended_rows(lengths: torch.Tensor, S: int) -> int:
    """Rows the slots attend: ``S`` each for a fake tensor (its lengths are
    unknown), else the sum of ``min(length, S)``."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(lengths):
        return lengths.shape[0] * S
    return int(lengths.clamp(max=S).sum())


@register_flop_formula([torch.ops.repro_torch.decode_attention, torch.ops.repro_torch.decode_attention_int8],
                       get_raw=True)
def _decode_attention_flops(q, k_cache, *args, out_val=None, **kwargs) -> int:
    """Scores and the weighted sum: 2 * 2 * nh * hd per attended row of a
    slot (a slot's rows are read once for all its query heads)."""
    lengths = args[-2]
    _, nh, hd = q.shape
    return 4 * nh * hd * _attended_rows(lengths, k_cache.shape[1])
