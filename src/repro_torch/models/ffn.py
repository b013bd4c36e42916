"""Dense SwiGLU feed-forward (``repro.models.ffn``); the MoE layer's shared
experts run through it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init


def init_ffn(d_model: int, d_ff: int, activation: str, gen, dtype, device) -> Params:
    if activation != "swiglu":
        raise NotImplementedError(f"ffn activation {activation!r} is not ported yet")
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), fan_in=d_ff, dtype=dtype, device=device),
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
    }


def ffn(params: Params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    if activation != "swiglu":
        raise NotImplementedError(f"ffn activation {activation!r} is not ported yet")
    up = x @ params["w_up"]
    gate = x @ params["w_gate"]
    return (F.silu(gate) * up) @ params["w_down"]
