"""Model facade consumed by serving (``repro.models.model``)."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import cache_specs
from repro_torch.models import transformer
from repro_torch.models.common import Params, resolve_device


def init_params(cfg, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (other numbers than the reference's JAX PRNG; parity runs
    convert its weights with :mod:`repro_torch.bridge` instead)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return transformer.init_params(cfg, gen, dev)


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
