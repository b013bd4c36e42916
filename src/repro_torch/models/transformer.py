"""Decoder stack for the attention + FFN/MoE families (``repro.models
.transformer``).

Parameters are ``{"embed": [V, d], "final_norm": {...}, "layers": [...]}``
with one dict per layer; the reference's period-stacked ``lax.scan`` becomes
a plain loop over layers.  Caches keep the reference's stacked layout
(``kv_k``/``kv_v`` ``[L, B, S, nkv, hd]``, or ``[L, P, ps, nkv, hd]`` page
pools plus ``block_tables``; int8 caches beside ``kv_k_scale``/``kv_v_scale``
``[L, B, S, nkv]`` or ``[L, P, ps, nkv]``) and are updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import check_supported
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Params, embed_init, init_rmsnorm, rmsnorm, softcap
from repro_torch.models.ffn import ffn, init_ffn


def _init_layer(kind: str, cfg, gen, dtype, device) -> Params:
    d = cfg.d_model
    lp = {
        "ln1": init_rmsnorm(d, device),
        "attn": attn_mod.init_attention(cfg, gen, dtype, device),
        "ln2": init_rmsnorm(d, device),
    }
    if kind == "moe":
        lp["moe"] = moe_mod.init_moe(cfg, gen, dtype, device)
    else:
        lp["ffn"] = init_ffn(d, cfg.d_ff, cfg.ffn_activation, gen, dtype, device)
    return lp


def init_params(cfg, gen: torch.Generator, device) -> Params:
    """Random weights of the reference's distributions, drawn from ``gen``."""
    check_supported(cfg)
    dtype = cfg.torch_dtype
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": [_init_layer(kind, cfg, gen, dtype, device) for kind in cfg.layer_kinds()],
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }


def embed_tokens(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    return x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)


def lm_head(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Tied head: logits in the activation dtype, then cast to f32."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x @ params["embed"].T).float()
    return softcap(logits, cfg.final_logit_softcap)


def attention_stage(lp, x, kv: Dict[str, torch.Tensor], cache_index, cfg):
    """ln1 -> one-token attention (in-place cache write) -> residual -> ln2.
    ``kv`` holds the layer's ``k``/``v`` caches, ``k_scale``/``v_scale``
    when they are int8, and ``bt`` block tables when they are paged.
    Returns ``(x_resid, h_ffn)``."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    h = attn_mod.attention_decode(
        lp["attn"], h, kv["k"], kv["v"], cache_index, cfg,
        k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"), block_tables=kv.get("bt"),
    )[0]
    x = x + h
    return x, rmsnorm(lp["ln2"], x, cfg.norm_eps)


def attention_stage_full(lp, x, cfg, positions=None, return_kv: bool = False):
    """Whole-sequence analogue of :func:`attention_stage` (``transformer.py:210``).
    Returns ``(x_resid, h_ffn, (k, v) or None)``."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    kv = None
    if return_kv:
        h, kv = attn_mod.attention_full(lp["attn"], h, cfg, positions=positions, return_kv=True)
    else:
        h = attn_mod.attention_full(lp["attn"], h, cfg, positions=positions)
    x = x + h
    return x, rmsnorm(lp["ln2"], x, cfg.norm_eps), kv


def attention_stage_chunk(lp, x, kv: Dict[str, torch.Tensor], start, cfg, lengths=None):
    """Chunked-prefill analogue of :func:`attention_stage`; a vector
    ``start`` with ``lengths`` is the batched multi-prompt chunk."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    h = attn_mod.attention_prefill_chunk(
        lp["attn"], h, kv["k"], kv["v"], start, cfg,
        k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"), lengths=lengths,
    )[0]
    x = x + h
    return x, rmsnorm(lp["ln2"], x, cfg.norm_eps)


def _layer_kv(caches: Dict[str, torch.Tensor], l: int, cfg) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s views of the stacked caches (``transformer.py:458``)."""
    kv = {"k": caches["kv_k"][l], "v": caches["kv_v"][l]}
    if cfg.kv_quant:
        kv["k_scale"] = caches["kv_k_scale"][l]
        kv["v_scale"] = caches["kv_v_scale"][l]
    return kv


def moe_stage(lp, x, h, cfg, moe_ctx: Optional[Dict[str, Any]] = None):
    """MoE (or dense) FFN on the normalised input ``h``, added to ``x``."""
    if "moe" in lp:
        return x + moe_mod.moe_layer(lp["moe"], h, cfg, **(moe_ctx or {}))
    return x + ffn(lp["ffn"], h, cfg.ffn_activation)


def _layer_full(kind, lp, x, cfg, positions, moe_ctx, collect: bool):
    """One layer over a whole sequence (``transformer.py:322``, dense and
    MoE kinds).  Returns ``(x, (k, v) or None)``."""
    x, h2, kv = attention_stage_full(lp, x, cfg, positions, return_kv=collect)
    return moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None), kv


def forward(params: Params, tokens: torch.Tensor, cfg, extra: Optional[Dict[str, Any]] = None,
            collect_caches: bool = False):
    """Whole-sequence pass (``transformer.py:359``) over the dense/MoE
    stacks the port runs.  Returns ``(hidden [b, s, d], kv)``, ``kv`` a list
    of each layer's post-rope ``(k, v)`` with ``collect_caches`` (else
    empty).  The reference's load-balance loss (training) is not ported."""
    check_supported(cfg)
    moe_ctx = (extra or {}).get("moe_ctx")
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    kvs = []
    for kind, lp in zip(cfg.layer_kinds(), params["layers"]):
        x, kv = _layer_full(kind, lp, x, cfg, positions, moe_ctx, collect_caches)
        if kv is not None:
            kvs.append(kv)
    return x, kvs


def prefill(params: Params, tokens: torch.Tensor, cfg, cache_len: int,
            extra: Optional[Dict[str, Any]] = None):
    """Whole-prompt prefill (``transformer.py:606``): one :func:`forward`,
    then decode-format caches ``[L, b, cache_len, nkv, hd]`` (int8 with
    scales under ``kv_quant``, quantised once from the raw keys).  Returns
    ``(last-token logits [b, V] f32, caches)``."""
    b, s = tokens.shape
    x, kvs = forward(params, tokens, cfg, extra=extra, collect_caches=True)
    logits = lm_head(params, x[:, -1, :], cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, i in (("k", 0), ("v", 1)):
        full = torch.stack([kv[i] for kv in kvs])  # [L, b, s, nkv, hd]
        pad = torch.zeros((full.shape[0], b, cache_len, *full.shape[3:]), dtype=full.dtype, device=full.device)
        pad[:, :, : min(s, cache_len)] = full[:, :, :cache_len]
        if cfg.kv_quant:
            out[f"kv_{name}"], out[f"kv_{name}_scale"] = attn_mod.quantize_kv(pad)
        else:
            out[f"kv_{name}"] = pad
    return logits, out


def decode_step(
    params: Params,
    tokens: torch.Tensor,  # [b, 1]
    caches: Dict[str, torch.Tensor],
    cache_index: torch.Tensor,  # [b] per-slot positions
    cfg,
    extra: Optional[Dict[str, Any]] = None,
):
    """One-token decode (``transformer.py:415``).  Returns ``(logits [b, V]
    f32, caches)``; the caches are updated in place."""
    moe_ctx = (extra or {}).get("moe_ctx")
    x = embed_tokens(params, tokens, cfg)
    bt = caches.get("block_tables")
    for l, (kind, lp) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        kv = _layer_kv(caches, l, cfg)
        if bt is not None:
            kv["bt"] = bt
        x, h2 = attention_stage(lp, x, kv, cache_index, cfg)
        x = moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None)
    return lm_head(params, x[:, 0, :], cfg), caches


def supports_chunked_prefill(cfg) -> bool:
    """Chunked prefill covers attention + FFN/MoE stacks without windows,
    with bf16/f32 or int8 KV -- everything the port runs so far."""
    try:
        check_supported(cfg)
    except NotImplementedError:
        return False
    return True


def prefill_chunk(
    params: Params,
    tokens: torch.Tensor,  # [b, c], one prompt chunk
    caches: Dict[str, torch.Tensor],  # contiguous decode-format caches
    start: int,
    cfg,
    extra: Optional[Dict[str, Any]] = None,
):
    """One prompt chunk against partially filled caches (``transformer.py:705``).
    Returns ``(last-token logits [b, V], caches)``, caches updated in place."""
    if not supports_chunked_prefill(cfg):
        raise NotImplementedError(f"{cfg.name}: chunked prefill is not ported for this architecture")
    moe_ctx = (extra or {}).get("moe_ctx")
    x = embed_tokens(params, tokens, cfg)
    for l, (kind, lp) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        kv = _layer_kv(caches, l, cfg)
        x, h2 = attention_stage_chunk(lp, x, kv, start, cfg)
        x = moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None)
    return lm_head(params, x[:, -1, :], cfg), caches


def supports_batched_prefill(cfg) -> bool:
    """Batched multi-prompt chunks need full-context layers only
    (``transformer.py:780``); every stack the port runs qualifies."""
    return supports_chunked_prefill(cfg)


def prefill_chunk_batched(
    params: Params,
    tokens: torch.Tensor,  # [b, c_max], one chunk per prompt, zero-padded
    caches: Dict[str, torch.Tensor],  # contiguous decode-format caches, batch axis b
    starts: torch.Tensor,  # [b] absolute position of each row's chunk
    lengths: torch.Tensor,  # [b] valid tokens per row (<= c_max)
    cfg,
    extra: Optional[Dict[str, Any]] = None,
):
    """Multi-prompt :func:`prefill_chunk` (``transformer.py:793``): row ``i``
    prefills ``lengths[i]`` tokens from position ``starts[i]``; padding adds
    query rows, never keys (its cache writes are dropped).  Returns
    ``(each row's last-valid-token logits [b, V], caches)``, caches updated
    in place."""
    if not supports_batched_prefill(cfg):
        raise NotImplementedError(f"{cfg.name}: batched prefill is not ported for this architecture")
    moe_ctx = (extra or {}).get("moe_ctx")
    x = embed_tokens(params, tokens, cfg)
    for l, (kind, lp) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        kv = _layer_kv(caches, l, cfg)
        x, h2 = attention_stage_chunk(lp, x, kv, starts, cfg, lengths=lengths)
        x = moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None)
    last = torch.clamp_min(lengths.long() - 1, 0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]  # each row's own tail
    return lm_head(params, x_last, cfg), caches
