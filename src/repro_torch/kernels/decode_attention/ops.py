"""One-token decode attention: CUDA kernel wrappers and their plain versions.

Three kernels of ``csrc/decode_attention.cu`` share one body:

* K1 ``paged_decode_attention``: rows reached through per-slot block tables;
* K4 ``decode_attention``: a contiguous ``[B, S, nkv, hd]`` cache;
* K5 ``decode_attention_int8``: K4 over an int8 cache with f32 scales.

All three are split-KV on the card: :func:`split_plan` cuts a slot's rows
into ranges of whole chunks (16 rows, or a page for K1), one block each, and
a second kernel merges the ranges' partials; :func:`decode_attention_split_ref`
is that decomposition in plain PyTorch.  Each wrapper launches its kernel for
CUDA tensors and runs its plain version (``*_ref``, a copy of
``repro.kernels.decode_attention.ref``) for CPU tensors; any other device
raises.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

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
_K4_ARGS = [cuda.PTR] * 6 + [cuda.INT] * 7 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]
_K5_ARGS = [cuda.PTR] * 8 + [cuda.INT] * 7 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]

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


def split_plan(B: int, nkv: int, S: int, num_sms: int, chunk: int = SPLIT_CHUNK) -> Tuple[int, int]:
    """``(n_split, rows per range)`` of a launch from what the host knows
    without a device sync: the (slot, KV head) count, the cache's rows ``S``
    (K1: the block table's width times the page size, never the lengths),
    the chunk (K1: the page size) and the SM count."""
    want = -(-SPLIT_BLOCKS_PER_SM * num_sms // (B * nkv))
    n = max(1, min(want, -(-S // SPLIT_MIN_ROWS)))
    rows = split_rows(S, n, chunk)
    return -(-S // rows), rows


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
    the dense view: K1's pages gathered (``chunk`` = the page size), K5's
    int8 rows dequantised in f32.  Equal to :func:`decode_attention_ref` up
    to f32 rounding; nothing on the serving path calls it."""
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


def _num_sms(device: torch.device) -> int:
    """The card's SM count (a host query, cached per device)."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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
    table, planned from the table's width (``nblk * ps`` rows)."""
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
    n_split, cps, part = _split_launch(q, nkv, nblk * ps, ps)
    out = torch.empty_like(q)
    fn = cuda.function("decode_attention", "paged_decode_attention", _K1_ARGS)
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part.data_ptr(), B, nh, nkv, hd, ps, nblk,
        n_split, cps, hd**-0.5, float(logit_cap), code, q.device.index, cuda.stream_of(q),
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
    The slot's rows are cut into :func:`split_plan`'s ranges, one block each,
    and the ranges' partials are merged by a second kernel.
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
    n_split, cps, part = _split_launch(q, nkv, S, SPLIT_CHUNK)
    out = torch.empty_like(q)
    fn = cuda.function("decode_attention", "decode_attention", _K4_ARGS)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, nh, nkv, hd, S, n_split, cps,
        hd**-0.5, logit_cap, code, q.device.index, cuda.stream_of(q),
    )
    cuda.check("decode_attention", err, "decode_attention")
    cuda.count("decode_attention")
    return out


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
    kernel does; the plain version rounds the dequantised rows to q's dtype
    first, as the reference's oracle does).  ``block_kv`` is left out as in
    K4."""
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
    n_split, cps, part = _split_launch(q, nkv, S, SPLIT_CHUNK)
    out = torch.empty_like(q)
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
