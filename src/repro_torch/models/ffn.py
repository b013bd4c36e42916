"""Dense feed-forward blocks: SwiGLU, GeGLU and plain GELU
(``repro.models.ffn``).  The MoE layer's shared experts run through the
SwiGLU one; GELU is the tanh approximation, as the reference's
``jax.nn.gelu(approximate=True)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, is_dtensor

ACTIVATIONS = ("swiglu", "geglu", "gelu")


def _check(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown ffn activation {activation!r}; choose from {ACTIVATIONS}")


def init_ffn(d_model: int, d_ff: int, activation: str, gen, dtype, device) -> Params:
    """Weights in the reference's draw order: ``w_up``, ``w_down``, then
    ``w_gate`` for the gated kinds."""
    _check(activation)
    params = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), fan_in=d_ff, dtype=dtype, device=device),
    }
    if activation in ("swiglu", "geglu"):
        params["w_gate"] = dense_init(gen, (d_model, d_ff), dtype=dtype, device=device)
    return params


def ffn(params: Params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    _check(activation)
    if is_dtensor(x):
        from repro_torch.models import spmd

        return spmd.ffn(params, x, activation)
    up = x @ params["w_up"]
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif activation == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"]
