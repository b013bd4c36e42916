"""Decoder stack for every family (``repro.models.transformer``): attention +
FFN/MoE layers, sliding-window layers, Mamba layers, the hybrid stack's
Mamba layers behind a shared attention block, the encoder-decoder stack's
layers with cross attention over an encoder's output (whisper), and patch
embeddings spliced over a prompt's first rows (pixtral).

Parameters are ``{"embed": [V, d], "final_norm": {...}, "layers": [...]}``
with one dict per layer, plus the hybrid stack's weight-tied
``"shared_attn"`` block and the encoder-decoder stack's ``"encoder"`` (one
dict per encoder layer) and ``"enc_norm"``; the reference's period-stacked
``lax.scan`` becomes a plain loop over layers.  Caches keep the reference's
stacked layout, one stack per kind (``configs.base.cache_specs``):
full-attention ``kv_k``/
``kv_v`` ``[L, B, S, nkv, hd]`` (or ``[L, P, ps, nkv, hd]`` page pools plus
``block_tables``), the sliding-window layers' rolling ``kv_k_local``/
``kv_v_local`` ``[L, B, W, nkv, hd]``, the shared block's ``kv_k_hybrid``/
``kv_v_hybrid``, int8 caches beside their ``*_scale`` arrays, and the Mamba
layers' ``ssm_state`` and ``conv_state``, and the encoder's output ``enc_out``
``[B, encoder_seq, d]`` (batch axis 0).  Layer ``l`` of a kind uses entry
``i`` of its stack, ``i`` counting that kind's layers before it (the
reference's per-period counters, ``transformer.py:451``).  Caches are
updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Params, embed_init, init_rmsnorm, is_dtensor, rmsnorm, sinusoidal_at, softcap
from repro_torch.models.ffn import ffn, init_ffn


def period_pattern(cfg) -> Tuple[Tuple[str, ...], int]:
    """``(kinds within one period, number of periods)`` (``transformer.py:45``):
    the hybrid stack's period is its shared-block interval, a local/global
    stack's 2, every other stack's 1."""
    kinds = cfg.layer_kinds()
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        p = cfg.hybrid_attn_every
    elif cfg.attn_pattern == "local_global":
        p = 2
    else:
        p = 1
    if cfg.num_layers % p or kinds != kinds[:p] * (cfg.num_layers // p):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole periods of {p}")
    return kinds[:p], cfg.num_layers // p


def decoder_kinds(cfg) -> Tuple[str, ...]:
    """Each decoder layer's kind: ``cfg.layer_kinds()``, with every layer an
    ``encdec`` one (a dense layer with cross attention) when the config has
    an encoder (``transformer.py:103``)."""
    return tuple("encdec" if cfg.encoder_layers else k for k in cfg.layer_kinds())


def layer_plan(cfg) -> List[Tuple[str, Dict[str, int]]]:
    """Each layer's kind and its entries in the cache stacks: ``""`` (full
    attention), ``"_local"`` (sliding window), ``"_hybrid"`` (the shared
    block before it) and ``"ssm"`` (its Mamba state)."""
    counters = {"": 0, "_local": 0, "_hybrid": 0, "ssm": 0}
    plan = []
    for kind in decoder_kinds(cfg):
        if kind in ("dense", "moe", "encdec"):
            uses = ("",)
        elif kind == "dense_local":
            uses = ("_local",)
        elif kind == "ssm_hybrid":
            uses = ("_hybrid", "ssm")
        else:
            uses = ("ssm",)
        plan.append((kind, {u: counters[u] for u in uses}))
        for u in uses:
            counters[u] += 1
    return plan


def _init_layer(kind: str, cfg, gen, dtype, device) -> Params:
    d = cfg.d_model
    if kind in ("ssm", "ssm_hybrid"):
        return {"ln1": init_rmsnorm(d, device), "mamba": ssm_mod.init_mamba(cfg, gen, dtype, device)}
    lp = {"ln1": init_rmsnorm(d, device), "attn": attn_mod.init_attention(cfg, gen, dtype, device)}
    if kind == "encdec":
        lp["ln_x"] = init_rmsnorm(d, device)
        lp["xattn"] = attn_mod.init_attention(cfg, gen, dtype, device)
    lp["ln2"] = init_rmsnorm(d, device)
    if kind == "moe":
        lp["moe"] = moe_mod.init_moe(cfg, gen, dtype, device)
    else:
        lp["ffn"] = init_ffn(d, cfg.d_ff, cfg.ffn_activation, gen, dtype, device)
    return lp


def init_params(cfg, gen: torch.Generator, device) -> Params:
    """Random weights of the reference's distributions, drawn from ``gen``."""
    period_pattern(cfg)
    dtype = cfg.torch_dtype
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": [_init_layer(kind, cfg, gen, dtype, device) for kind in decoder_kinds(cfg)],
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    if cfg.family == "hybrid":
        # zamba2's shared (weight-tied) attention block: attention + dense FFN
        params["shared_attn"] = _init_layer("dense", cfg, gen, dtype, device)
    if cfg.encoder_layers:
        params["encoder"] = [_init_layer("dense", cfg, gen, dtype, device) for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = init_rmsnorm(cfg.d_model, device)
    return params


def embed_tokens(params: Params, tokens: torch.Tensor, cfg, extra: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Token embeddings (``transformer.py:131``), scaled by ``sqrt(d)`` except
    for the audio family; a ``vision_patches`` config given
    ``extra["patch_embeds"]`` ``[b, n_p, d]`` takes those rows in place of
    the first ``n_p`` positions' (a prompt shorter than ``n_p`` raises)."""
    if is_dtensor(params["embed"]):
        from repro_torch.models import spmd

        x = spmd.embed_lookup(params["embed"], tokens)
    else:
        x = params["embed"][tokens.long()]
    if cfg.family != "audio":
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    if extra and cfg.frontend == "vision_patches" and "patch_embeds" in extra:
        p = extra["patch_embeds"]
        if x.shape[1] < p.shape[1]:
            raise ValueError(f"{cfg.name}: a prompt of {x.shape[1]} tokens is shorter than its "
                             f"{p.shape[1]} patch rows")
        x = torch.cat([p.to(x.dtype), x[:, p.shape[1]:]], dim=1)
    return x


def lm_head(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Tied head: logits in the activation dtype, then cast to f32."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if is_dtensor(x):
        from repro_torch.models import spmd

        return softcap(spmd.lm_logits(x, params["embed"]).float(), cfg.final_logit_softcap)
    logits = (x @ params["embed"].T).float()
    return softcap(logits, cfg.final_logit_softcap)


def run_encoder(params: Params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames ``[b, encoder_seq, d]`` (the stubbed conv/mel frontend's
    output) -> the encoder's states (``transformer.py:153``): sinusoidal
    positions, then dense layers of bidirectional attention, then
    ``enc_norm``."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames + sinusoidal_at(pos, cfg.d_model).to(frames.dtype)
    for lp in params["encoder"]:
        x = x + attn_mod.attention_full(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg, causal=False)
        x = x + ffn(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.ffn_activation)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _encoder_output(params: Params, cfg, extra: Optional[Dict[str, Any]]) -> Optional[torch.Tensor]:
    """The encoder's output a decoder pass attends: ``extra["enc_out"]``, or
    :func:`run_encoder` over ``extra["encoder_frames"]``; None without an
    encoder (``transformer.py:379-381``)."""
    if not cfg.encoder_layers:
        return None
    extra = extra or {}
    if "enc_out" in extra:
        return extra["enc_out"]
    if "encoder_frames" not in extra:
        raise ValueError(f"{cfg.name}: an encoder-decoder pass needs extra['encoder_frames'] "
                         "(or extra['enc_out']); pass an extra_builder to the engine")
    return run_encoder(params, extra["encoder_frames"], cfg)


def _cross(lp, x, enc_out, cfg):
    """ln_x -> cross attention over ``enc_out`` -> residual (no-op without
    an encoder's output)."""
    if enc_out is None:
        return x
    return x + attn_mod.attention_cross(lp["xattn"], rmsnorm(lp["ln_x"], x, cfg.norm_eps), enc_out, cfg)


def attention_stage(lp, x, kv: Dict[str, torch.Tensor], cache_index, cfg, window=None, enc_out=None):
    """ln1 -> one-token attention (in-place cache write) -> residual [->
    cross attention over ``enc_out``] -> ln2.  ``kv`` holds the layer's
    ``k``/``v`` caches, ``k_scale``/``v_scale`` when they are int8, and
    ``bt`` block tables when they are paged; ``window`` makes them a rolling
    buffer.  Returns ``(x_resid, h_ffn)``."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    h = attn_mod.attention_decode(
        lp["attn"], h, kv["k"], kv["v"], cache_index, cfg, window=window,
        k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"), block_tables=kv.get("bt"),
    )[0]
    x = _cross(lp, x + h, enc_out, cfg)
    return x, rmsnorm(lp["ln2"], x, cfg.norm_eps)


def _verify_positions(cache_index: torch.Tensor, c: int, cache_len: int, widths=None):
    """Each verify row's write positions: row ``j`` of slot ``b`` at
    ``cache_index[b] + j``, clamped to the cache; a parked row (``j >=
    widths[b]``) at the last row, as parked slots decode
    (``transformer.py:585-590``)."""
    last = cache_len - 1
    rows = []
    for j in range(c):
        pos = torch.clamp_max(cache_index + j, last)
        if widths is not None:
            pos = torch.where(j < widths, pos, last)
        rows.append(pos)
    return rows


def attention_stage_verify(lp, x, kv: Dict[str, torch.Tensor], cache_index, cfg, widths=None):
    """Speculative-verify analogue of :func:`attention_stage`
    (``transformer.py:262``): ``x`` holds ``c`` candidate rows per slot, and
    row ``j`` writes and attends at ``cache_index[b] + j``.  It unrolls ``c``
    one-token stages, so every op runs at decode's shapes and a row's
    numbers are those of the decode step it stands for (a batched ``[b, c,
    .]`` form rounds otherwise).  Returns ``(x_resid, h_ffn)`` ``[b, c, d]``."""
    bt = kv.get("bt")
    cache_len = bt.shape[1] * kv["k"].shape[1] if bt is not None else kv["k"].shape[1]
    xs, h2s = [], []
    for j, pos in enumerate(_verify_positions(cache_index, x.shape[1], cache_len, widths)):
        xj, h2j = attention_stage(lp, x[:, j : j + 1].contiguous(), kv, pos, cfg)
        xs.append(xj)
        h2s.append(h2j)
    return torch.cat(xs, dim=1), torch.cat(h2s, dim=1)


def attention_stage_full(lp, x, cfg, positions=None, window=None, enc_out=None, return_kv: bool = False):
    """Whole-sequence analogue of :func:`attention_stage` (``transformer.py:210``).
    Returns ``(x_resid, h_ffn, (k, v) or None)``."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    kv = None
    if return_kv:
        h, kv = attn_mod.attention_full(lp["attn"], h, cfg, positions=positions, window=window, return_kv=True)
    else:
        h = attn_mod.attention_full(lp["attn"], h, cfg, positions=positions, window=window)
    x = _cross(lp, x + h, enc_out, cfg)
    return x, rmsnorm(lp["ln2"], x, cfg.norm_eps), kv


def attention_stage_chunk(lp, x, kv: Dict[str, torch.Tensor], start, cfg, window=None, lengths=None):
    """Chunked-prefill analogue of :func:`attention_stage`; a vector
    ``start`` with ``lengths`` is the batched multi-prompt chunk, a
    ``window`` the rolling buffer's chunk."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    h = attn_mod.attention_prefill_chunk(
        lp["attn"], h, kv["k"], kv["v"], start, cfg, window=window,
        k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"), lengths=lengths,
    )[0]
    x = x + h
    return x, rmsnorm(lp["ln2"], x, cfg.norm_eps)


def _layer_kv(caches: Dict[str, torch.Tensor], i: int, cfg, suffix: str = "") -> Dict[str, torch.Tensor]:
    """Entry ``i`` of the ``suffix`` attention cache stack, as views
    (``transformer.py:458``); the full-attention stack's block tables when
    it is paged."""
    kv = {"k": caches[f"kv_k{suffix}"][i], "v": caches[f"kv_v{suffix}"][i]}
    if cfg.kv_quant:
        kv["k_scale"] = caches[f"kv_k{suffix}_scale"][i]
        kv["v_scale"] = caches[f"kv_v{suffix}_scale"][i]
    if suffix == "" and "block_tables" in caches:
        kv["bt"] = caches["block_tables"]
    return kv


def moe_stage(lp, x, h, cfg, moe_ctx: Optional[Dict[str, Any]] = None, with_aux: bool = False):
    """MoE (or dense) FFN on the normalised input ``h``, added to ``x``
    (``transformer.py:300``).  With ``with_aux`` it returns ``(x, aux)``:
    the MoE layer's aux (``load``, ``a_max``, ``lb_loss``), or ``{}`` on a
    dense layer."""
    if "moe" in lp:
        if with_aux:
            y, aux = moe_mod.moe_layer(lp["moe"], h, cfg, with_aux=True, **(moe_ctx or {}))
            return x + y, aux
        return x + moe_mod.moe_layer(lp["moe"], h, cfg, **(moe_ctx or {}))
    y = x + ffn(lp["ffn"], h, cfg.ffn_activation)
    return (y, {}) if with_aux else y


def _window(kind: str, cfg) -> Optional[int]:
    return cfg.sliding_window if kind == "dense_local" else None


def _layer_full(kind, lp, x, cfg, positions, shared_attn, enc_out, moe_ctx, collect: bool,
                with_aux: bool = False):
    """One layer over a whole sequence (``transformer.py:322``).  Returns
    ``(x, cache, lb_loss or None)``; with ``collect``, ``cache`` holds
    ``"kv"``, the post-rope ``(k, v)`` of its attention (the shared block's
    for ``ssm_hybrid``), and for Mamba layers ``"ssm"`` (the final state) and
    ``"conv"`` (the conv tail); with ``with_aux`` an ``moe`` layer gives its
    load-balance loss."""
    cache: Dict[str, Any] = {}
    if kind in ("ssm", "ssm_hybrid"):
        if kind == "ssm_hybrid":
            x, h2, kv = attention_stage_full(shared_attn, x, cfg, positions, return_kv=collect)
            x = moe_stage(shared_attn, x, h2, cfg)
            if collect:
                cache["kv"] = kv
        y, state, tail = ssm_mod.mamba_seq(lp["mamba"], rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg)
        if collect:
            cache["ssm"], cache["conv"] = state, tail
        return x + y, cache, None
    x, h2, kv = attention_stage_full(lp, x, cfg, positions, window=_window(kind, cfg),
                                     enc_out=enc_out if kind == "encdec" else None, return_kv=collect)
    if collect:
        cache["kv"] = kv
    if kind != "moe" or not with_aux:
        return moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None), cache, None
    x, aux = moe_stage(lp, x, h2, cfg, moe_ctx, with_aux=True)
    return x, cache, aux["lb_loss"]


def forward(params: Params, tokens: torch.Tensor, cfg, extra: Optional[Dict[str, Any]] = None,
            collect_caches: bool = False, remat: bool = False, with_aux: bool = False):
    """Whole-sequence pass (``transformer.py:359``).  Returns ``(hidden [b,
    s, d], caches)``, ``caches`` a list of each layer's :func:`_layer_full`
    cache with ``collect_caches`` (else of empty dicts); ``with_aux`` adds the
    reference's aux, ``{"lb_loss": the MoE layers' load-balance losses summed
    and divided by max(1, num_layers), "enc_out": the encoder's output or
    None}``.  The audio family adds sinusoidal positions to its embeddings,
    and its layers attend the encoder's output (:func:`_encoder_output`).
    ``remat`` runs each layer period under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scan body), so a backward pass
    keeps one period's activations at a time and recomputes the rest.
    ``extra["act_constraint"]`` (optional) is applied to the residual after
    each period (``transformer.py:369``): the sharded train step lays the
    residual out sequence-parallel with it."""
    moe_ctx = (extra or {}).get("moe_ctx")
    act_constraint = (extra or {}).get("act_constraint")
    x = embed_tokens(params, tokens, cfg, extra)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "audio":
        x = x + sinusoidal_at(positions, cfg.d_model).to(x.dtype)
    enc_out = _encoder_output(params, cfg, extra)
    shared_attn = params.get("shared_attn")
    kinds = decoder_kinds(cfg)
    period = len(period_pattern(cfg)[0])

    def body(x, lb, lo):
        caches = []
        for kind, lp in zip(kinds[lo : lo + period], params["layers"][lo : lo + period]):
            x, cache, layer_lb = _layer_full(kind, lp, x, cfg, positions, shared_attn, enc_out, moe_ctx,
                                             collect_caches, with_aux)
            caches.append(cache)
            if layer_lb is not None:
                lb = lb + layer_lb
        if act_constraint is not None:
            x = act_constraint(x)
        return x, lb, caches

    lb = torch.zeros((), dtype=torch.float32, device=x.device) if with_aux else None
    out = []
    for lo in range(0, len(kinds), period):
        if remat:
            x, lb, caches = torch.utils.checkpoint.checkpoint(body, x, lb, lo, use_reentrant=False)
        else:
            x, lb, caches = body(x, lb, lo)
        out.extend(caches)
    if not with_aux:
        return x, out
    return x, out, {"lb_loss": lb / max(1, cfg.num_layers), "enc_out": enc_out}


def prefill(params: Params, tokens: torch.Tensor, cfg, cache_len: int,
            extra: Optional[Dict[str, Any]] = None):
    """Whole-prompt prefill (``transformer.py:606``): one :func:`forward`,
    then decode-format caches (``configs.base.cache_specs``): full-attention
    and shared-block KV padded to ``cache_len`` rows, the sliding-window
    layers' keys in their rolling layout (position ``p`` at row ``p % W``,
    the last ``W`` positions kept), the Mamba layers' final states; int8
    with scales under ``kv_quant``, quantised once from the raw keys; an
    encoder-decoder config's ``enc_out`` beside them.  Returns ``(last-token
    logits [b, V] f32, caches)``."""
    b, s = tokens.shape
    enc_out = _encoder_output(params, cfg, extra)
    if enc_out is not None:
        extra = {**extra, "enc_out": enc_out}
    x, layer_caches = forward(params, tokens, cfg, extra=extra, collect_caches=True)
    logits = lm_head(params, x[:, -1, :], cfg)
    out: Dict[str, torch.Tensor] = {}
    plan = layer_plan(cfg)

    def emit(suffix: str, rows: int, place) -> None:
        kvs = [c["kv"] for (kind, uses), c in zip(plan, layer_caches) if suffix in uses]
        if not kvs:
            return
        for name, i in (("k", 0), ("v", 1)):
            full = torch.stack([kv[i] for kv in kvs])  # [n, b, s, nkv, hd]
            if is_dtensor(full):
                from repro_torch.models import spmd

                buf = spmd.assemble_cache(full, rows, place)
            else:
                buf = torch.zeros((full.shape[0], b, rows, *full.shape[3:]), dtype=full.dtype, device=full.device)
                place(buf, full)
            if cfg.kv_quant:
                out[f"kv_{name}{suffix}"], out[f"kv_{name}{suffix}_scale"] = attn_mod.quantize_kv(buf)
            else:
                out[f"kv_{name}{suffix}"] = buf

    def padded(buf, full):
        buf[:, :, : min(s, buf.shape[2])] = full[:, :, : buf.shape[2]]

    def rolling(buf, full):
        W = buf.shape[2]
        take = min(W, s)
        slots = (torch.arange(take, device=full.device) + (s - take)) % W
        buf[:, :, slots] = full[:, :, s - take :]

    emit("", cache_len, padded)
    emit("_local", min(cache_len, cfg.sliding_window or cache_len), rolling)
    emit("_hybrid", cache_len, padded)
    ssm = [c for (kind, uses), c in zip(plan, layer_caches) if "ssm" in uses]
    if ssm:
        out["ssm_state"] = torch.stack([c["ssm"] for c in ssm]).float()
        out["conv_state"] = torch.stack([c["conv"] for c in ssm]).to(x.dtype)
    if enc_out is not None:
        out["enc_out"] = enc_out
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
    f32, caches)``; the caches are updated in place.  A hybrid layer runs
    the shared block (its own ``_hybrid`` cache entry) before its Mamba
    block.  The audio family adds each slot's sinusoidal position at its
    ``cache_index``, and its layers attend ``caches["enc_out"]``."""
    moe_ctx = (extra or {}).get("moe_ctx")
    x = embed_tokens(params, tokens, cfg, extra)
    if cfg.family == "audio":
        x = x + sinusoidal_at(cache_index.reshape(-1), cfg.d_model).to(x.dtype)[:, None, :]
    enc_out = caches.get("enc_out")
    for (kind, uses), lp in zip(layer_plan(cfg), params["layers"]):
        if "_hybrid" in uses:
            shared = params["shared_attn"]
            x, h2 = attention_stage(shared, x, _layer_kv(caches, uses["_hybrid"], cfg, "_hybrid"), cache_index, cfg)
            x = moe_stage(shared, x, h2, cfg)
        if "ssm" in uses:
            i = uses["ssm"]
            y, conv, state = ssm_mod.mamba_step(lp["mamba"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                                                caches["conv_state"][i], caches["ssm_state"][i], cfg)
            caches["conv_state"][i] = conv
            caches["ssm_state"][i] = state
            x = x + y
            continue
        suffix = "_local" if kind == "dense_local" else ""
        x, h2 = attention_stage(lp, x, _layer_kv(caches, uses[suffix], cfg, suffix), cache_index, cfg,
                                window=_window(kind, cfg), enc_out=enc_out if kind == "encdec" else None)
        x = moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None)
    return lm_head(params, x[:, 0, :], cfg), caches


def supports_speculative_decode(cfg) -> bool:
    """The verify step covers dense/MoE stacks with full-context attention,
    as batched prefill does (``transformer.py:545``)."""
    return supports_batched_prefill(cfg)


def decode_step_verify(
    params: Params,
    tokens: torch.Tensor,  # [b, c]: the last accepted token, then c - 1 drafts
    caches: Dict[str, torch.Tensor],
    cache_index: torch.Tensor,  # [b] per-slot positions of row 0
    cfg,
    extra: Optional[Dict[str, Any]] = None,
    widths: Optional[torch.Tensor] = None,  # [b] valid rows per slot (<= c)
):
    """Speculative verify (``transformer.py:553``): scores ``c`` candidate
    positions per slot.  Returns ``(logits [b, c, V] f32, caches)``, the
    caches updated in place.  Row ``j``'s logits are those :func:`decode_step`
    gives after rows ``0 .. j-1`` were appended, bit for bit: the verify is
    ``c`` unrolled decode steps at decode's shapes.  A parked row (``j >=
    widths[b]``) writes at the cache's last row, which no live context
    reads, so a rejected candidate needs no rollback; a retried verify
    writes the same rows with the same values."""
    if not supports_speculative_decode(cfg):
        raise ValueError(f"{cfg.name}: architecture does not support speculative decode")
    bt = caches.get("block_tables")
    cache_len = bt.shape[1] * caches["kv_k"].shape[2] if bt is not None else caches["kv_k"].shape[2]
    rows = [decode_step(params, tokens[:, j : j + 1], caches, pos, cfg, extra=extra)[0]
            for j, pos in enumerate(_verify_positions(cache_index, tokens.shape[1], cache_len, widths))]
    return torch.stack(rows, dim=1), caches


def supports_chunked_prefill(cfg) -> bool:
    """Chunked prefill covers pure attention + FFN/MoE stacks (``dense``,
    ``dense_local``, ``moe``), with bf16/f32 or int8 KV
    (``transformer.py:684``).  Recurrent stacks consume the prompt through a
    state :func:`prefill_chunk` does not carry, and encoder-decoder and
    frontend stacks need their encoder first: they take whole-prompt
    :func:`prefill`."""
    if cfg.encoder_layers or cfg.frontend or cfg.family in ("audio", "ssm", "hybrid"):
        return False
    period, _ = period_pattern(cfg)
    return all(k in ("dense", "dense_local", "moe") for k in period)


def prefill_chunk(
    params: Params,
    tokens: torch.Tensor,  # [b, c], one prompt chunk
    caches: Dict[str, torch.Tensor],  # contiguous decode-format caches
    start: int,
    cfg,
    extra: Optional[Dict[str, Any]] = None,
):
    """One prompt chunk against partially filled caches (``transformer.py:705``);
    sliding-window layers attend and write their rolling buffers.
    Returns ``(last-token logits [b, V], caches)``, caches updated in place."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"{cfg.name}: architecture does not support chunked prefill")
    moe_ctx = (extra or {}).get("moe_ctx")
    x = embed_tokens(params, tokens, cfg, extra)
    for (kind, uses), lp in zip(layer_plan(cfg), params["layers"]):
        suffix = "_local" if kind == "dense_local" else ""
        x, h2 = attention_stage_chunk(lp, x, _layer_kv(caches, uses[suffix], cfg, suffix), start, cfg,
                                      window=_window(kind, cfg))
        x = moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None)
    return lm_head(params, x[:, -1, :], cfg), caches


def supports_batched_prefill(cfg) -> bool:
    """Batched multi-prompt chunks (and the prefix cache, which shares their
    uniform chunk grid) need full-context ``dense``/``moe`` layers only
    (``transformer.py:780``): a rolling window stores position ``p`` at row
    ``p % W``, so rows of different histories share no write grid."""
    if not supports_chunked_prefill(cfg):
        return False
    period, _ = period_pattern(cfg)
    return all(k in ("dense", "moe") for k in period)


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
        raise ValueError(f"{cfg.name}: architecture does not support batched prefill")
    moe_ctx = (extra or {}).get("moe_ctx")
    x = embed_tokens(params, tokens, cfg, extra)
    for l, (kind, lp) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        kv = _layer_kv(caches, l, cfg)
        x, h2 = attention_stage_chunk(lp, x, kv, starts, cfg, lengths=lengths)
        x = moe_stage(lp, x, h2, cfg, moe_ctx if kind == "moe" else None)
    last = torch.clamp_min(lengths.long() - 1, 0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]  # each row's own tail
    return lm_head(params, x_last, cfg), caches
