"""Exact conversion between the reference's numpy trees and the port's tensors.

Parity tests draw weights with the reference's ``transformer.init_params``
(JAX's PRNG, which torch cannot reproduce), convert the tree with
``jax.tree.map(np.asarray, ...)`` and hand it to :func:`params_from_jax`.
bf16 crosses as a 16-bit integer view, so every conversion is bit-exact.

Layout: the reference stacks each period position's layer params over
periods (``blocks/pos{p}/...`` with a leading ``[n_periods]`` axis; period 1
for the dense and MoE stacks, 2 for gemma2's local/global pair, 6 for
zamba2's shared-attention period); the port keeps one dict per layer, layer
``l = period_index * period + p``.  The hybrid stack's weight-tied
``shared_attn`` block crosses over as one dict; the encoder-decoder stack's
``encoder`` (its layers stacked over a leading ``[encoder_layers]`` axis)
becomes one dict per encoder layer, and ``enc_norm`` one dict.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 dtype, only needed on this path

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacked: Dict[str, Any], n: int, device) -> List[Dict[str, Any]]:
    """A tree stacked over a leading axis of ``n`` -> ``n`` trees."""
    return [_map(stacked, lambda a, i=i: tensor_from_numpy(np.asarray(a)[i], device)) for i in range(n)]


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Reference param tree (numpy leaves) -> port params."""
    blocks = tree["blocks"]
    period = len(blocks)
    n_periods = len(np.asarray(blocks["pos0"]["ln1"]["scale"]))
    by_pos = [_unstack(blocks[f"pos{p}"], n_periods, device) for p in range(period)]
    out = {
        "embed": tensor_from_numpy(tree["embed"], device),
        "layers": [by_pos[l % period][l // period] for l in range(period * n_periods)],
        "final_norm": _map(tree["final_norm"], lambda a: tensor_from_numpy(a, device)),
    }
    for name in ("shared_attn", "enc_norm"):
        if name in tree:
            out[name] = _map(tree[name], lambda a: tensor_from_numpy(a, device))
    if "encoder" in tree:
        out["encoder"] = _unstack(tree["encoder"], len(np.asarray(tree["encoder"]["ln1"]["scale"])), device)
    return out


def params_to_numpy(params: Dict[str, Any], period: int = 1) -> Dict[str, Any]:
    """Port params -> the reference's tree layout with numpy leaves, for a
    layer pattern of ``period`` (``transformer.period_pattern``)."""

    def stack(*leaves):
        return np.stack([tensor_to_numpy(t) for t in leaves])

    def zip_layers(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: zip_layers([lp[k] for lp in layers]) for k in first}
        return stack(*layers)

    layers = params["layers"]
    out = {
        "embed": tensor_to_numpy(params["embed"]),
        "blocks": {f"pos{p}": zip_layers(layers[p::period]) for p in range(period)},
        "final_norm": _map(params["final_norm"], tensor_to_numpy),
    }
    for name in ("shared_attn", "enc_norm"):
        if name in params:
            out[name] = _map(params[name], tensor_to_numpy)
    if "encoder" in params:
        out["encoder"] = zip_layers(params["encoder"])
    return out


def caches_from_numpy(caches: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    return {k: tensor_from_numpy(v, device) for k, v in caches.items()}


def caches_to_numpy(caches: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: tensor_to_numpy(v) for k, v in caches.items()}
