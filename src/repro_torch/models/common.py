"""Shared model components: norms, rotary and sinusoidal positions, init
helpers (``repro.models.common``).  Parameters are nested dicts of tensors."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch

Params = Dict[str, Any]


def resolve_device(device="cuda") -> torch.device:
    """The port's entry points default to the card; asking for it without one
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
    return dev


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (the sharded steps' tensors): the layers
    then run their SPMD version (:mod:`repro_torch.models.spmd`)."""
    return hasattr(t, "placements")


def tree_to(tree, dev: torch.device):
    """``tree`` (dicts and lists of tensors, ``None`` leaves) on ``dev``; a
    tensor already there is returned as is, so a pool that aliases a device
    shares its tensors instead of copying them."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    if tree is None:
        return None
    return tree.to(dev)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor, its dicts and lists kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_unflatten(tree, leaves: Sequence[torch.Tensor]):
    """A tree of ``tree``'s structure over ``leaves`` (in :func:`tree_leaves`
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 math, ``(1 + scale)`` parameterisation, cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + params["scale"])).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, hd]; positions broadcastable to [..., seq]."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * inv  # [..., seq, hd/2]
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """The classic sinusoidal encoding of integer ``positions``, ``[...,
    d_model]`` f32: sin and cos interleaved (``common.py:91``)."""
    pos = positions.float()[..., None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=positions.device)
                    * (-math.log(10000.0) / d_model))
    return torch.stack([torch.sin(pos * div), torch.cos(pos * div)], dim=-1).reshape(*positions.shape, d_model)


def sinusoidal_positions(num_pos: int, d_model: int, offset: int = 0, device=None) -> torch.Tensor:
    """The table of :func:`sinusoidal_at` over ``[offset, offset + num_pos)``,
    ``[num_pos, d_model]`` f32 (``common.py:79``)."""
    return sinusoidal_at(torch.arange(offset, offset + num_pos, device=device), d_model)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def dense_init(
    gen: torch.Generator,
    shape: Sequence[int],
    fan_in: Optional[int] = None,
    dtype=torch.bfloat16,
    device=None,
) -> torch.Tensor:
    """Normal(0, 1/fan_in) draw, as ``common.dense_init`` (``common.py:113``).
    torch's generator gives other numbers than JAX's PRNG for the same seed;
    parity tests convert the reference's weights instead."""
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)
