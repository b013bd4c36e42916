"""K3 grouped expert FFN: CUDA kernel wrapper and its plain versions.

``expert_ffn_grouped`` launches ``csrc/expert_ffn.cu`` for CUDA tensors,
through the custom op ``repro_torch::expert_ffn`` (its fake implementation
gives the output's shape, so fake tensors reach it and launch nothing; its
FLOP formula is the bound's count), and runs :func:`expert_ffn_grouped_ref`
for CPU tensors.  The bf16 kernel's tile, ring depth, shared memory and
grid come from :func:`bf16_plan`; :func:`work_items` is the plain model of
the work list the kernel builds on the device.  The model's CPU path
with bucket-stacked weights uses :func:`expert_ffn_einsum` instead, as the
reference does (``moe.py:306-309``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cuda

_ARGS = [cuda.PTR] * 8 + [cuda.INT] * 6 + [cuda.PTR]
_ARGS_BF16 = [cuda.PTR] * 9 + [cuda.INT] * 13 + [cuda.PTR]

ROW_TILES = (8, 16, 32, 64, 128)  # wgmma's n: the kernel's instances (csrc/expert_ffn.cu)
BOX = 64  # a TMA box: 64 columns x 64 reduction rows of bf16
BOX_BYTES = BOX * BOX * 2
SMEM_LIMIT = 232448  # shared memory a block can use on the H100 (227 KB)
MAX_STAGES = 12


class Bf16Plan(NamedTuple):
    """How the bf16 kernel cuts one call: N token rows a consumer warpgroup
    (wgmma's n), R warpgroups over the rows and C over the columns, row
    blocks of R * N rows (n_rb a slot), items of 64 * C columns of h
    (tiles_a a row block) and 128 * C of out (tiles_b), the ring's depth and
    stage bytes, the shared memory a block asks for, and the grid."""

    n_rows: int
    row_wgs: int
    col_wgs: int
    n_rb: int
    tiles_a: int
    tiles_b: int
    stage_bytes: int
    stages: int
    smem: int
    grid: int


@functools.lru_cache(maxsize=1024)
def bf16_plan(S: int, CAP: int, d: int, f: int, n_sms: int) -> Bf16Plan:
    """The bf16 kernel's plan for ``S`` slots of ``CAP`` rows at widths ``d``
    and ``f`` on a card of ``n_sms`` SMs (cached: the wrapper runs on a
    host-bound step).  Rows pad to the next of :data:`ROW_TILES`; above 128
    two warpgroups split them (row blocks of 256); at 33-128 two split the
    columns, so a token box serves 128 columns of h and the weights stream
    in 256-byte (phase A) and 512-byte (phase B) runs of a row; below, one
    warpgroup keeps items small, for balance over few live slots.  The ring
    takes as many stages as fit beside the barriers and the live-slot list, up to
    :data:`MAX_STAGES`; the grid is one block an SM, fewer if there are
    fewer items than SMs at the most."""
    if S < 1 or CAP < 1 or d < 8 or f < 8 or d % 8 or f % 8 or CAP * max(d, f) >= 2**31:
        raise ValueError(f"expert_ffn_grouped: no bf16 plan for S={S}, CAP={CAP}, d={d}, f={f} "
                         "(d and f multiples of 8, a slot's rows under 2**31 values)")
    rows = min(CAP, 256)
    if rows > 128:
        n, r, c = 128, 2, 1
    else:
        n, r = next(t for t in ROW_TILES if t >= rows), 1
        c = 2 if n >= 64 else 1
    stage = 2 * c * BOX_BYTES + r * n * 2 * BOX
    fixed = 1024 + 4 * (S + 9 + 16)  # alignment slack, the live slots, a count a warp, the item queue
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (stage + 16))
    if stages < 2:
        raise ValueError(f"expert_ffn_grouped: {S} slots leave no room for the bf16 kernel's ring")
    n_rb = -(-CAP // (r * n))
    tiles_a, tiles_b = -(-f // (64 * c)), -(-d // (128 * c))
    grid = max(1, min(n_sms, S * n_rb * (tiles_a + tiles_b)))
    return Bf16Plan(n, r, c, n_rb, tiles_a, tiles_b, stage, stages, fixed + stages * (stage + 16), grid)


def work_items(plan: Bf16Plan, live: Sequence[int]) -> List[Tuple[str, int, int, int]]:
    """The kernel's work list: the live slots in order, each in
    ``plan.n_rb`` row blocks, first every row block's ``tiles_a`` phase-A
    items, then every row block's ``tiles_b`` phase-B items, each
    ``(phase, slot, row block, column tile)`` (``expert_ffn_wgmma``'s
    ``item_at``).  The blocks take items in this order (from one counter
    at 33+ rows; block b items b, b + G, ... below), so every phase-A item
    is taken before any phase-B item."""
    units = [(s, rb) for s in live for rb in range(plan.n_rb)]
    items = [("a", s, rb, ct) for s, rb in units for ct in range(plan.tiles_a)]
    return items + [("b", s, rb, ct) for s, rb in units for ct in range(plan.tiles_b)]


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The kernel's counters on ``device`` for ``stream`` (per row block:
    phase-A items done, phase-B items started; then the next item of the
    list and the blocks that found it spent): zeroed once, and left at zero
    by every launch (the last phase-B item of a row block and the last
    block out reset them), so a call adds no memset."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


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
    if x.dtype == torch.bfloat16:  # TMA: row strides and addresses in 16-byte units
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
    stream = cuda.stream_of(x)
    if S == 0 or CAP == 0:
        err = 0
    elif x.dtype == torch.bfloat16:
        plan = bf16_plan(S, CAP, d, f, _n_sms(x.device.index))
        counters = _counters(x.device, stream, 2 * S * plan.n_rb + 2)
        fn = cuda.function("expert_ffn", "expert_ffn_bf16", _ARGS_BF16)
        err = fn(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            slot_to_expert.data_ptr(), active.data_ptr(), h.data_ptr(), out.data_ptr(),
            counters.data_ptr(), S, CAP, d, f, E, plan.n_rows, plan.row_wgs, plan.col_wgs,
            plan.n_rb, plan.stages, plan.smem, plan.grid, x.device.index, stream,
        )
    else:
        fn = cuda.function("expert_ffn", "expert_ffn", _ARGS)
        err = fn(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            slot_to_expert.data_ptr(), active.data_ptr(), h.data_ptr(), out.data_ptr(),
            S, CAP, d, f, code, x.device.index, stream,
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
