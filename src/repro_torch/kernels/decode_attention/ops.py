"""One-token decode attention: CUDA kernel wrappers and their plain versions.

Three kernels of ``csrc/decode_attention.cu`` share one body:

* K1 ``paged_decode_attention``: rows reached through per-slot block tables;
* K4 ``decode_attention``: a contiguous ``[B, S, nkv, hd]`` cache;
* K5 ``decode_attention_int8``: K4 over an int8 cache with f32 scales.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(``*_ref``, a copy of ``repro.kernels.decode_attention.ref``) for CPU
tensors; any other device raises.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import cuda

NEG_INF = -1.0e30  # the reference kernel's mask constant (kernel.py:25)
KERNEL_GROUPS = (1, 2, 4, 8)  # template instances of csrc/decode_attention.cu
KERNEL_HEAD_DIMS = (64, 128, 256)
_ALIGN = 32  # bytes: a lane loads its head_dim columns of a row as one vector
_K1_ARGS = [cuda.PTR] * 6 + [cuda.INT] * 6 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]
_K4_ARGS = [cuda.PTR] * 5 + [cuda.INT] * 5 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]
_K5_ARGS = [cuda.PTR] * 7 + [cuda.INT] * 5 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]

ValidLen = Union[int, torch.Tensor]


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


def _check_launch(what: str, q: torch.Tensor, nkv: int, tensors) -> int:
    """Checks shared by the three launchers; returns the kernel's dtype code."""
    B, nh, hd = q.shape
    if nh % nkv or nh // nkv not in KERNEL_GROUPS or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{what}: the kernel is built for query heads per KV head in {KERNEL_GROUPS} and "
            f"head_dim in {KERNEL_HEAD_DIMS}, got nh={nh}, nkv={nkv}, hd={hd}"
        )
    cuda.check_tensors(tensors, q.device)
    for name, t in tensors.items():
        if t.dim() == 4 and t.data_ptr() % _ALIGN:
            raise ValueError(f"{what}: {name} must be {_ALIGN}-byte aligned")
    return cuda.dtype_code(q, what)


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
    """K1, paged flash decode: ``[B, nh, hd]`` attention output in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
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
         "lengths": lengths},
    )
    out = torch.empty_like(q)
    fn = cuda.function("decode_attention", "paged_decode_attention", _K1_ARGS)
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, nh, nkv, hd, ps, nblk,
        hd**-0.5, float(logit_cap), code, q.device.index, cuda.stream_of(q),
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
    """K4, flash decode over a contiguous cache: ``[B, nh, hd]`` in q's dtype.

    Rows ``p < valid_len`` (per slot when ``valid_len`` is ``[B]``) attend.
    The reference op's ``block_kv`` is a TPU tiling choice with no effect on
    the result, so it is left out; lengths must be >= 1 (the kernel reads no
    row of an empty slot)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, valid_len, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_cache("decode_attention", q, k_cache, v_cache, q.dtype)
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    lengths = _lengths(valid_len, B, q.device)
    code = _check_launch("decode_attention", q, nkv,
                         {"q": q, "k_cache": k_cache, "v_cache": v_cache, "lengths": lengths})
    out = torch.empty_like(q)
    fn = cuda.function("decode_attention", "decode_attention", _K4_ARGS)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, nh, nkv, hd, S, hd**-0.5, float(logit_cap), code,
        q.device.index, cuda.stream_of(q),
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
    """K5, :func:`decode_attention` over an int8 cache dequantised by its
    per-(row, head) scales inside the kernel (in f32, as the TPU kernel does;
    the plain version rounds the dequantised rows to q's dtype first, as the
    reference's oracle does).  ``block_kv`` is left out as in K4."""
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, k_cache, v_cache, k_scale, v_scale, valid_len, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: unsupported device {q.device}")
    _check_cache("decode_attention_int8", q, k_cache, v_cache, torch.int8)
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    if k_scale.shape != (B, S, nkv) or v_scale.shape != (B, S, nkv):
        raise ValueError(f"decode_attention_int8: scales must be [{B}, {S}, {nkv}]")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("decode_attention_int8: scales must be float32")
    lengths = _lengths(valid_len, B, q.device)
    code = _check_launch("decode_attention_int8", q, nkv,
                         {"q": q, "k_cache": k_cache, "v_cache": v_cache, "k_scale": k_scale,
                          "v_scale": v_scale, "lengths": lengths})
    out = torch.empty_like(q)
    fn = cuda.function("decode_attention", "decode_attention_int8", _K5_ARGS)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, nh, nkv, hd, S,
        hd**-0.5, float(logit_cap), code, q.device.index, cuda.stream_of(q),
    )
    cuda.check("decode_attention", err, "decode_attention_int8")
    cuda.count("decode_attention_int8")
    return out
