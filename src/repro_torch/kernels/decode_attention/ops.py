"""K1 paged decode attention: CUDA kernel wrapper and its plain version.

``paged_decode_attention`` launches ``csrc/paged_decode_attention.cu`` for
CUDA tensors and runs :func:`paged_decode_attention_ref` for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda

NEG_INF = -1.0e30  # the reference kernel's mask constant (kernel.py:25)
KERNEL_GROUPS = (1, 2, 4, 8)  # template instances of csrc/paged_decode_attention.cu
KERNEL_HEAD_DIMS = (64, 128, 256)
_ARGS = [cuda.PTR] * 6 + [cuda.INT] * 6 + [cuda.FLOAT] * 2 + [cuda.INT] * 2 + [cuda.PTR]


def paged_decode_attention_ref(
    q: torch.Tensor,  # [B, nh, hd]
    k_pages: torch.Tensor,  # [P, ps, nkv, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, nblk] int32
    lengths: torch.Tensor,  # [B] int32
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Gather each slot's pages into the dense ``[B, S, nkv, hd]`` view and
    run masked f32 attention (``decode_attention/ref.py:38``)."""
    B, nh, hd = q.shape
    ps, nkv = k_pages.shape[1], k_pages.shape[2]
    nblk = block_tables.shape[1]
    S = nblk * ps
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, S, nkv, hd).float()
    v = v_pages[bt].reshape(B, S, nkv, hd).float()
    qg = q.reshape(B, nkv, nh // nkv, hd).float()
    s = torch.einsum("bngh,bsnh->bngs", qg, k) * (hd**-0.5)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = torch.arange(S, device=q.device)[None, :] < lengths.long()[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngs,bsnh->bngh", p, v)
    return o.reshape(B, nh, hd).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Paged flash decode: ``[B, nh, hd]`` attention output in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    B, nh, hd = q.shape
    P, ps, nkv, hd_k = k_pages.shape
    nblk = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if hd_k != hd or v_pages.shape != k_pages.shape or nh % nkv:
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
    cuda.check_tensors(
        {"q": q, "k_pages": k_pages, "v_pages": v_pages, "block_tables": block_tables,
         "lengths": lengths},
        q.device,
    )
    code = cuda.dtype_code(q, "paged_decode_attention")
    if nh // nkv not in KERNEL_GROUPS or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged_decode_attention: the kernel is built for {nh // nkv} query heads per KV "
            f"head in {KERNEL_GROUPS} and head_dim in {KERNEL_HEAD_DIMS}, got hd={hd}"
        )
    out = torch.empty_like(q)
    fn = cuda.function("paged_decode_attention", "paged_decode_attention", _ARGS)
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, nh, nkv, hd, ps, nblk,
        hd**-0.5, float(logit_cap), code, q.device.index, cuda.stream_of(q),
    )
    cuda.check("paged_decode_attention", err, "paged_decode_attention")
    cuda.count("paged_decode_attention")
    return out
