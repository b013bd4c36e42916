"""K3 grouped expert FFN: CUDA kernel wrapper and its plain versions.

``expert_ffn_grouped`` launches ``csrc/expert_ffn.cu`` for CUDA tensors,
through the custom op ``repro_torch::expert_ffn`` (its fake implementation
gives the output's shape, so fake tensors reach it and launch nothing; its
FLOP formula is the bound's count), and runs :func:`expert_ffn_grouped_ref`
for CPU tensors.  The model's CPU path
with bucket-stacked weights uses :func:`expert_ffn_einsum` instead, as the
reference does (``moe.py:306-309``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cuda

_ARGS = [cuda.PTR] * 8 + [cuda.INT] * 6 + [cuda.PTR]


def expert_ffn_einsum(w: Dict[str, torch.Tensor], xe: torch.Tensor) -> torch.Tensor:
    """xe [S, C, d] with stacked weights [S, d, f] -> [S, C, d] in xe's dtype
    at every step (``moe.expert_ffn``, ``moe.py:97``)."""
    g = torch.einsum("scd,sdf->scf", xe, w["w_gate"])
    u = torch.einsum("scd,sdf->scf", xe, w["w_up"])
    return torch.einsum("scf,sfd->scd", F.silu(g) * u, w["w_down"])


def expert_ffn_ref(x, w_gate, w_up, w_down, active) -> torch.Tensor:
    """Stacked-weights oracle (``expert_ffn/ref.py:9``): f32 products, h
    rounded to x's dtype, zeros for inactive slots."""
    g = torch.einsum("scd,sdf->scf", x.float(), w_gate.float())
    u = torch.einsum("scd,sdf->scf", x.float(), w_up.float())
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.einsum("scf,sfd->scd", h.float(), w_down.float())
    mask = (active.int() > 0)[:, None, None]
    return torch.where(mask, y, 0.0).to(x.dtype)


def expert_ffn_grouped_ref(x, w_gate, w_up, w_down, slot_to_expert, active) -> torch.Tensor:
    """Slot-indirect oracle (``expert_ffn/ref.py:24``): gathers each slot's
    expert weights, which the kernel never does."""
    idx = slot_to_expert.long().clamp(min=0)
    act = active.int() * (slot_to_expert >= 0).int()
    return expert_ffn_ref(x, w_gate[idx], w_up[idx], w_down[idx], act)


def expert_ffn_grouped(
    x: torch.Tensor,  # [S, CAP, d] capacity-packed tokens per slot
    w_gate: torch.Tensor,  # [E, d, f] logical weights
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # [E, f, d]
    slot_to_expert: torch.Tensor,  # [S] int32, -1 = empty slot
    active: torch.Tensor,  # [S] bool or int
) -> torch.Tensor:
    """SwiGLU per slot with slot-indirect weight reads; inactive or empty
    slots give zeros and read no weights."""
    if x.device.type == "cpu":
        return expert_ffn_grouped_ref(x, w_gate, w_up, w_down, slot_to_expert, active)
    if x.device.type != "cuda":
        raise ValueError(f"expert_ffn_grouped: unsupported device {x.device}")
    cuda.refuse_autograd("expert_ffn_grouped", x, w_gate, w_up, w_down)
    return torch.ops.repro_torch.expert_ffn(x, w_gate, w_up, w_down, slot_to_expert, active)


@torch.library.custom_op("repro_torch::expert_ffn", mutates_args=())
def _expert_ffn_op(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   slot_to_expert: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    S, CAP, d = x.shape
    E, d_w, f = w_gate.shape
    if d_w != d or w_up.shape != w_gate.shape or w_down.shape != (E, f, d):
        raise ValueError(
            f"expert_ffn_grouped: x {tuple(x.shape)} does not fit weights "
            f"{tuple(w_gate.shape)} / {tuple(w_up.shape)} / {tuple(w_down.shape)}"
        )
    if slot_to_expert.shape != (S,) or active.shape != (S,):
        raise ValueError("expert_ffn_grouped: slot_to_expert and active must be [S]")
    if slot_to_expert.dtype != torch.int32:
        raise TypeError("expert_ffn_grouped: slot_to_expert must be int32")
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if w.dtype != x.dtype:
            raise TypeError(f"expert_ffn_grouped: {name} is {w.dtype}, x is {x.dtype}")
    active = active.to(torch.int32)
    floats = {"x": x, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    cuda.check_tensors({**floats, "slot_to_expert": slot_to_expert, "active": active}, x.device)
    code = cuda.dtype_code(x, "expert_ffn_grouped")
    if x.dtype == torch.bfloat16:  # the tensor-core path copies 16 bytes at a time
        if d % 8 or f % 8:
            raise ValueError(
                f"expert_ffn_grouped: the bf16 kernel takes d and f multiples of 8, "
                f"got d={d}, f={f}"
            )
        for name, t in floats.items():
            if t.data_ptr() % 16:
                raise ValueError(f"expert_ffn_grouped: {name} must be 16-byte aligned")
    h = torch.empty((S, CAP, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = cuda.function("expert_ffn", "expert_ffn", _ARGS)
    err = fn(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        slot_to_expert.data_ptr(), active.data_ptr(), h.data_ptr(), out.data_ptr(),
        S, CAP, d, f, code, x.device.index, cuda.stream_of(x),
    )
    cuda.check("expert_ffn", err, "expert_ffn")
    cuda.count("expert_ffn")
    return out


@_expert_ffn_op.register_fake
def _(x, w_gate, w_up, w_down, slot_to_expert, active):
    return torch.empty_like(x)


def _active_slots(slot_to_expert: torch.Tensor, active: torch.Tensor) -> int:
    """Slots that read weights: every slot of a fake tensor (its values are
    unknown), else the active ones with an expert."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(active):
        return int(active.shape[0])
    return int(((active.int() > 0) & (slot_to_expert >= 0)).sum())


@register_flop_formula(torch.ops.repro_torch.expert_ffn, get_raw=True)
def _expert_ffn_flops(x, w_gate, w_up, w_down, slot_to_expert, active, out_val=None, **kwargs) -> int:
    """SwiGLU's three products per active slot: 2 * 3 * CAP * d * f."""
    _, cap, d = x.shape
    return 6 * _active_slots(slot_to_expert, active) * cap * d * w_gate.shape[2]
