"""Exact conversion between the reference's numpy trees and the port's tensors.

Parity tests draw weights with the reference's ``transformer.init_params``
(JAX's PRNG, which torch cannot reproduce), convert the tree with
``jax.tree.map(np.asarray, ...)`` and hand it to :func:`params_from_jax`.
bf16 crosses as a 16-bit integer view, so every conversion is bit-exact.

Layout: the reference stacks each period position's layer params over
periods (``blocks/pos0/...`` with a leading ``[n_periods]`` axis, period 1
for every family this port runs); the port keeps one dict per layer.
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


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Reference param tree (numpy leaves) -> port params."""
    blocks = tree["blocks"]
    if set(blocks) != {"pos0"}:
        raise NotImplementedError("only period-1 layer patterns are ported")
    stacked = blocks["pos0"]
    n_layers = len(np.asarray(stacked["ln1"]["scale"]))
    layers: List[Dict[str, Any]] = [
        _map(stacked, lambda a, i=i: tensor_from_numpy(np.asarray(a)[i], device))
        for i in range(n_layers)
    ]
    return {
        "embed": tensor_from_numpy(tree["embed"], device),
        "layers": layers,
        "final_norm": _map(tree["final_norm"], lambda a: tensor_from_numpy(a, device)),
    }


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params -> the reference's tree layout with numpy leaves."""

    def stack(*leaves):
        return np.stack([tensor_to_numpy(t) for t in leaves])

    def zip_layers(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: zip_layers([lp[k] for lp in layers]) for k in first}
        return stack(*layers)

    return {
        "embed": tensor_to_numpy(params["embed"]),
        "blocks": {"pos0": zip_layers(params["layers"])},
        "final_norm": _map(params["final_norm"], tensor_to_numpy),
    }


def caches_from_numpy(caches: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    return {k: tensor_from_numpy(v, device) for k, v in caches.items()}


def caches_to_numpy(caches: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: tensor_to_numpy(v) for k, v in caches.items()}
