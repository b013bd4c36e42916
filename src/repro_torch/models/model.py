"""Model facade consumed by serving and training (``repro.models.model``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import cache_specs
from repro_torch.models import transformer
from repro_torch.models.common import Params, is_dtensor, resolve_device


def init_params(cfg, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (other numbers than the reference's JAX PRNG; parity runs
    convert its weights with :mod:`repro_torch.bridge` instead)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return transformer.init_params(cfg, gen, dev)


def _training_extra(extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``extra`` with the MoE layers on the einsum dispatch unless its
    ``moe_ctx`` names another: the reference's ``loss_fn`` passes no context,
    so its ``moe_layer`` runs its default, the einsum oracle
    (``moe.py:408``).  The port's default, ``grouped``, launches K3 on the
    card, which has no backward pass."""
    extra = dict(extra or {})
    extra["moe_ctx"] = {"dispatch": "einsum", **(extra.get("moe_ctx") or {})}
    return extra


def logits_fn(params, tokens, cfg, extra=None, remat: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``(logits [b, s, V] f32, aux)`` of a whole-sequence pass
    (``model.py:19``)."""
    x, _, aux = transformer.forward(params, tokens, cfg, extra=_training_extra(extra), remat=remat,
                                    with_aux=True)
    return transformer.lm_head(params, x, cfg), aux


def _xent_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` at every position."""
    if is_dtensor(logits):
        from repro_torch.models import spmd

        return spmd.xent_terms(logits, labels)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (``model.py:25``); logits ``[b, s, v]``
    f32, labels ``[b, s]``."""
    return _xent_terms(logits, labels).mean()


def chunked_xent(params, x, labels, cfg, chunk: int = 512) -> torch.Tensor:
    """Next-token cross entropy without the whole ``[B, S, V]`` logits
    (``model.py:32``): the sequence in chunks of ``chunk`` positions (all
    of it when ``chunk`` does not divide it), each chunk's logits recomputed
    in the backward pass (``torch.utils.checkpoint``), the sum over chunks
    divided by ``B * S``."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # the reference's fallback at smoke-test sizes

    def per_chunk(xi, li):
        return _xent_terms(transformer.lm_head(params, xi, cfg), li).sum()

    totals = [
        torch.utils.checkpoint.checkpoint(per_chunk, x[:, lo : lo + chunk], labels[:, lo : lo + chunk],
                                          use_reentrant=False)
        for lo in range(0, S, chunk)
    ]
    return torch.stack(totals).sum() / (B * S)


def loss_fn(params, tokens, labels, cfg, extra=None, remat: bool = False, lb_coef: float = 0.01,
            xent_chunk: int = 0):
    """``(loss, aux)`` (``model.py:53``): mean cross entropy (chunked when
    ``xent_chunk``) plus ``lb_coef`` times the load-balance loss on MoE
    configs; MoE layers on the einsum dispatch (:func:`_training_extra`)."""
    extra = _training_extra(extra)
    if xent_chunk:
        x, _, aux = transformer.forward(params, tokens, cfg, extra=extra, remat=remat, with_aux=True)
        loss = chunked_xent(params, x, labels, cfg, xent_chunk)
    else:
        logits, aux = logits_fn(params, tokens, cfg, extra=extra, remat=remat)
        loss = cross_entropy(logits, labels)
    if cfg.has_moe:
        loss = loss + lb_coef * aux["lb_loss"]
    return loss, aux


def decode_step(params, tokens, caches, cache_index, cfg, extra=None):
    return transformer.decode_step(params, tokens, caches, cache_index, cfg, extra=extra)


def decode_step_verify(params, tokens, caches, cache_index, cfg, extra=None, widths=None):
    return transformer.decode_step_verify(params, tokens, caches, cache_index, cfg, extra=extra, widths=widths)


def supports_speculative_decode(cfg) -> bool:
    return transformer.supports_speculative_decode(cfg)


def prefill_chunk(params, tokens, caches, start, cfg, extra=None):
    return transformer.prefill_chunk(params, tokens, caches, start, cfg, extra=extra)


def prefill(params, tokens, cfg, cache_len, extra=None):
    return transformer.prefill(params, tokens, cfg, cache_len, extra=extra)


def prefill_chunk_batched(params, tokens, caches, starts, lengths, cfg, extra=None):
    return transformer.prefill_chunk_batched(params, tokens, caches, starts, lengths, cfg, extra=extra)


def supports_chunked_prefill(cfg) -> bool:
    return transformer.supports_chunked_prefill(cfg)


def supports_batched_prefill(cfg) -> bool:
    return transformer.supports_batched_prefill(cfg)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def init_decode_caches(cfg, batch: int, cache_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Zero caches in the reference's ``_cache_specs`` layout."""
    dev = resolve_device(device)
    return {
        name: torch.zeros(shape, dtype=dtype, device=dev)
        for name, (shape, dtype) in cache_specs(cfg, batch, cache_len).items()
    }
