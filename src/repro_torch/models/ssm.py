"""Mamba-1 (falcon-mamba) and Mamba-2 (zamba2) blocks (``repro.models.ssm``).

Sequence mode (whole-prompt prefill) runs the recurrence one token at a time
over the sequence; decode mode is one step against the carried
``(conv_state, ssm_state)``.  States are float32; activations follow the
model dtype.  The reference computes these with ``jnp`` outside any Pallas
kernel, so the port's versions are plain PyTorch on every device: the scan
is a Python loop over tokens, the projections ``torch.matmul``.

Layouts (the reference's):
  Mamba-1 state: ``[batch, d_inner, state]``
  Mamba-2 state: ``[batch, heads, head_dim, state]``
  conv state:    ``[batch, conv_k - 1, conv_dim]`` (the last inputs, oldest first)
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, is_dtensor, resolve_device
from repro_torch.roofline.analysis import repeat


def init_mamba(cfg, gen, dtype, device) -> Params:
    """Random weights of the reference's distributions (``ssm.py:29``),
    drawn from ``gen`` in the reference's order."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    K = cfg.ssm_conv
    f32 = torch.float32
    if cfg.ssm_version == 1:
        dt_rank = max(1, math.ceil(d / 16))
        return {
            "in_proj": dense_init(gen, (d, 2 * di), dtype=dtype, device=device),
            "conv_w": dense_init(gen, (K, di), fan_in=K, dtype=dtype, device=device),
            "conv_b": torch.zeros(di, dtype=dtype, device=device),
            "x_proj": dense_init(gen, (di, dt_rank + 2 * N), fan_in=di, dtype=dtype, device=device),
            "dt_proj": dense_init(gen, (dt_rank, di), fan_in=dt_rank, dtype=f32, device=device),
            "dt_bias": torch.zeros(di, dtype=f32, device=device),
            # log(1..N) in float64, rounded once to float32: the host's libm
            # float32 log is one ulp off at some n (XLA's and torch's differ)
            "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float64)).to(f32).to(device).expand(di, N).contiguous(),
            "D": torch.ones(di, dtype=f32, device=device),
            "out_proj": dense_init(gen, (di, d), fan_in=di, dtype=dtype, device=device),
        }
    nh, cd = cfg.ssm_num_heads, cfg.conv_dim  # Mamba-2, one group
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * N + nh), dtype=dtype, device=device),
        "conv_w": dense_init(gen, (K, cd), fan_in=K, dtype=dtype, device=device),
        "conv_b": torch.zeros(cd, dtype=dtype, device=device),
        "A_log": torch.zeros(nh, dtype=f32, device=device),
        "dt_bias": torch.zeros(nh, dtype=f32, device=device),
        "D": torch.ones(nh, dtype=f32, device=device),
        "norm_scale": torch.zeros(di, dtype=f32, device=device),
        "out_proj": dense_init(gen, (di, d), fan_in=di, dtype=dtype, device=device),
    }


def init_ssm_state(cfg, batch: int, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ssm_state f32, conv_state in the model dtype)`` zeros for decode,
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    conv = torch.zeros((batch, cfg.ssm_conv - 1, cfg.conv_dim), dtype=cfg.torch_dtype, device=device)
    if cfg.ssm_version == 1:
        shape = (batch, cfg.d_inner, cfg.ssm_state)
    else:
        shape = (batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return torch.zeros(shape, dtype=torch.float32, device=device), conv


# ---------------------------------------------------------------------------
# depthwise causal conv
# ---------------------------------------------------------------------------


def _causal_conv_seq(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x [b, s, c]``, ``w [K, c]``: depthwise causal conv as K shifted f32
    products (``ssm.py:82``)."""
    K, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + pad[:, i : i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _causal_conv_step(x_new: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x_new [b, c]``, ``conv_state [b, K - 1, c]`` (oldest first) ->
    ``(y [b, c], new state)`` (``ssm.py:96``)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # [b, K, c]
    y = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return (y + b.float()).to(x_new.dtype), window[:, 1:]


def _conv_tail(x_pre: torch.Tensor, K: int) -> torch.Tensor:
    """The last ``K - 1`` pre-conv inputs, zero-padded at the front: ``[b, K
    - 1, c]`` (``ssm.py:125``), in storage of their own (a slice would keep
    the whole padded sequence alive with the cache)."""
    s = x_pre.shape[1]
    return F.pad(x_pre, (0, 0, max(0, K - 1 - s), 0))[:, -(K - 1):].clone()


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def _m1_core_step(p: Params, x_t: torch.Tensor, h: torch.Tensor, N: int, dt_rank: int):
    """``x_t [b, di]`` post-conv, ``h [b, di, N]`` -> ``(y [b, di] f32, h')``
    (``ssm.py:109``)."""
    dbc = x_t.float() @ p["x_proj"].float()
    dt_in, B, C = torch.split(dbc, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])  # [b, di]
    A = -torch.exp(p["A_log"])  # [di, N]
    dA = torch.exp(dt[:, :, None] * A[None])
    dBx = (dt * x_t.float())[:, :, None] * B[:, None, :]
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, C) + p["D"] * x_t.float()
    return y, h


def _scan(step, h: torch.Tensor, xs, p: Params):
    """The recurrence over time: ``step(p, h, inputs at t) -> (y_t, h)`` for
    each ``t`` of the ``[b, s, ...]`` inputs ``xs``.  Returns ``(final h,
    ys [b, s, ...])``.  The reference scans in checkpointed chunks of 128
    tokens (``ssm.py:132``), a memory bound for training's backward pass
    with the same values; here autograd keeps every step's state, and
    training bounds it by recomputing each layer period (``remat``).  On
    the dry run's fake tensors the loop is counted, not run
    (:class:`_CountedScan`)."""
    if _counts_only(xs[0]):
        names = sorted(p)
        return _CountedScan.apply(step, names, len(xs), h, *xs, *(p[k] for k in names))
    ys = []
    for t in range(xs[0].shape[1]):
        y, h = step(p, h, *(a[:, t] for a in xs))
        ys.append(y)
    return h, torch.stack(ys, dim=1)


def _counts_only(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shapes only), whose ops the dry run
    counts and never computes."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _storage_id(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _CountedScan(torch.autograd.Function):
    """:func:`_scan`'s loop as the dry run records it, at a cost that does
    not grow with the sequence: one step runs inside
    ``roofline.analysis.repeat(s)``, so the FLOP counter and the op recorder
    count it ``s`` times, and tensors the size of what the loop holds are
    allocated where the loop holds it, so the memory tracker's peak is the
    loop's.  Forward: the ``s`` outputs before they are stacked, and under
    autograd the ``s`` steps' saved tensors (measured on the one step: its
    saved storages other than its inputs), held until backward, and each
    input the step saves a slice of.  Backward: the step's gradient ``s``
    times, the select-backward and out-of-place sum autograd runs for each
    token's slice of each input (it sums into a fake tensor out of place),
    and the ``s`` contributions summed into each weight's gradient.  Shapes
    only: the values are not the loop's."""

    @staticmethod
    def forward(ctx, step, names, n_x, h, *rest):
        xs, ws = rest[:n_x], rest[n_x:]
        s = xs[0].shape[1]
        x_ts = [a[:, 0] for a in xs]
        train = any(ctx.needs_input_grad)
        ctx.set_materialize_grads(False)
        held, x_saved = 0, set()
        with repeat(s):
            if train:
                saved = []  # kept here, not in the graph; emptied below (the hook outlives the step)
                with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(saved.append, _never):
                    y, h_out = step(*_leaves(names, h, x_ts, ws))
                y, h_out = y.detach(), h_out.detach()
                inputs = {_storage_id(t) for t in (h, *ws)}
                x_ids = {_storage_id(a) for a in xs}
                new = {}
                for t in saved:
                    sid = _storage_id(t)
                    if sid in x_ids:
                        x_saved.add(sid)
                    elif sid not in inputs:
                        new[sid] = t.untyped_storage().nbytes()
                saved.clear()
                held = (s - 1) * sum(new.values())
            else:
                y, h_out = step(dict(zip(names, ws)), h, *x_ts)
        with repeat(0):
            kept = y.new_empty((max(0, s - 1) * y.numel(),))  # the loop's outputs before the stack
            saved_states = y.new_empty((held,), dtype=torch.uint8)
        ys = y.unsqueeze(1).expand(y.shape[0], s, *y.shape[1:]).contiguous()  # the stack's bytes
        del kept
        if train:
            ctx.save_for_backward(saved_states, h, *ws, *(a for a in xs if _storage_id(a) in x_saved))
            ctx.step, ctx.names, ctx.s = step, names, s
            ctx.x_specs = [(a.shape, a.dtype) for a in xs]
        return h_out, ys

    @staticmethod
    def backward(ctx, g_h, g_ys):
        h, *ws = ctx.saved_tensors[1:1 + 1 + len(ctx.names)]
        s = ctx.s
        with repeat(0), torch.enable_grad():
            x_ts = [h.new_empty((shape[0], *shape[2:]), dtype=dtype) for shape, dtype in ctx.x_specs]
            args = _leaves(ctx.names, h, x_ts, ws)
            y, h_out = ctx.step(*args)
            if g_h is None:
                g_h = torch.zeros_like(h_out)
        # the state's gradient too: every step but the first passes one on
        leaves = [args[1], *args[2:], *(args[0][k] for k in ctx.names)]
        need = (True, *ctx.needs_input_grad[4:])
        with repeat(s):
            grads = torch.autograd.grad((y, h_out), [t for t, n in zip(leaves, need) if n],
                                        (g_ys[:, 0], g_h), allow_unused=True)
        it = iter(grads)
        out = [next(it) if n else None for n in need]
        if not ctx.needs_input_grad[3]:
            out[0] = None
        for i, (shape, _) in enumerate(ctx.x_specs):
            g = out[1 + i]
            if g is not None:
                with repeat(s):
                    g = torch.ops.aten.select_backward(g, shape, 1, 0)
                with repeat(0):
                    other = torch.empty_like(g)
                with repeat(s - 1):
                    g = g + other
                out[1 + i] = g
        for i in range(1 + len(ctx.x_specs), len(out)):
            if out[i] is not None:
                with repeat(s - 1):
                    out[i] = out[i] + out[i]
        return (None, None, None, *out)


def _never(_):
    raise RuntimeError("the measured step is never differentiated")


def _leaves(names, h, x_ts, ws):
    """``(p, h, *x_ts)`` for one step, as detached leaves that require grad,
    so the step builds a graph of its own."""
    p = {k: w.detach().requires_grad_() for k, w in zip(names, ws)}
    return (p, h.detach().requires_grad_(), *(x.detach().requires_grad_() for x in x_ts))


def mamba1_seq(p: Params, u: torch.Tensor, cfg):
    """``u [b, s, d]`` -> ``(y [b, s, d], final ssm state, conv tail)``
    (``ssm.py:156``)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    x, z = torch.split(u @ p["in_proj"], [di, di], dim=-1)
    tail = _conv_tail(x, cfg.ssm_conv)
    x = F.silu(_causal_conv_seq(x, p["conv_w"], p["conv_b"]))
    h0 = torch.zeros((u.shape[0], di, N), dtype=torch.float32, device=u.device)
    h, ys = _scan(lambda q, h, x_t: _m1_core_step(q, x_t, h, N, dt_rank), h0, (x,), p)
    y = ys.to(u.dtype) * F.silu(z)
    return y @ p["out_proj"], h, tail


def mamba1_step(p: Params, u: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor, cfg):
    """``u [b, 1, d]`` -> ``(y [b, 1, d], conv_state', ssm_state')``
    (``ssm.py:177``)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    x, z = torch.split((u @ p["in_proj"])[:, 0], [di, di], dim=-1)
    x_c, conv_state = _causal_conv_step(x, conv_state, p["conv_w"], p["conv_b"])
    y, ssm_state = _m1_core_step(p, F.silu(x_c), ssm_state, N, dt_rank)
    y = y.to(u.dtype) * F.silu(z)
    return (y @ p["out_proj"])[:, None], conv_state, ssm_state


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, one group, scalar A per head)
# ---------------------------------------------------------------------------


def _m2_split(cfg, proj: torch.Tensor):
    """``in_proj``'s output -> ``(z, xBC, dt)`` (``ssm.py:201``)."""
    di, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads
    z, xBC, dt = torch.split(proj, [di, di + 2 * N, nh], dim=-1)
    return z, xBC, dt


def _m2_core_step(p: Params, xBC_t: torch.Tensor, dt_t: torch.Tensor, h: torch.Tensor, cfg):
    """``xBC_t [b, conv_dim]`` post-conv, ``dt_t [b, nh]``, ``h [b, nh, hd,
    N]`` -> ``(y [b, di] f32, h')`` (``ssm.py:210``)."""
    di, N, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    x, B, C = torch.split(xBC_t.float(), [di, N, N], dim=-1)
    dt = F.softplus(dt_t.float() + p["dt_bias"])  # [b, nh]
    dA = torch.exp(dt * -torch.exp(p["A_log"]))  # [b, nh]
    xh = x.reshape(*x.shape[:-1], nh, hd)
    h = dA[..., None, None] * h + (dt[..., None] * xh)[..., None] * B[:, None, None, :]
    y = torch.einsum("bhdn,bn->bhd", h, C) + p["D"][:, None] * xh
    return y.reshape(*y.shape[:-2], di), h


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Mamba-2's gated RMSNorm, ``norm(y * silu(z)) * (1 + scale)`` in f32
    (``ssm.py:253``)."""
    g = y.float() * F.silu(z)
    var = g.square().mean(dim=-1, keepdim=True)
    return g * torch.rsqrt(var + eps) * (1.0 + scale)


def mamba2_seq(p: Params, u: torch.Tensor, cfg):
    """``u [b, s, d]`` -> ``(y [b, s, d], final ssm state, conv tail)``
    (``ssm.py:224``)."""
    z, xBC, dt = _m2_split(cfg, u @ p["in_proj"])
    tail = _conv_tail(xBC, cfg.ssm_conv)
    xBC = F.silu(_causal_conv_seq(xBC, p["conv_w"], p["conv_b"]))
    h0 = torch.zeros((u.shape[0], cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                     device=u.device)
    h, ys = _scan(lambda q, h, x_t, dt_t: _m2_core_step(q, x_t, dt_t, h, cfg), h0, (xBC, dt), p)
    y = _gated_rmsnorm(ys, z.float(), p["norm_scale"], cfg.norm_eps)
    return y.to(u.dtype) @ p["out_proj"], h, tail


def mamba2_step(p: Params, u: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor, cfg):
    """``u [b, 1, d]`` -> ``(y [b, 1, d], conv_state', ssm_state')``
    (``ssm.py:242``)."""
    z, xBC, dt = _m2_split(cfg, (u @ p["in_proj"])[:, 0])
    xBC_c, conv_state = _causal_conv_step(xBC, conv_state, p["conv_w"], p["conv_b"])
    y, ssm_state = _m2_core_step(p, F.silu(xBC_c), dt, ssm_state, cfg)
    y = _gated_rmsnorm(y[:, None], z[:, None].float(), p["norm_scale"], cfg.norm_eps)[:, 0]
    return (y.to(u.dtype) @ p["out_proj"])[:, None], conv_state, ssm_state


def mamba_seq(p: Params, u: torch.Tensor, cfg):
    if is_dtensor(u):
        from repro_torch.models import spmd

        return spmd.mamba_seq(p, u, cfg)
    return (mamba1_seq if cfg.ssm_version == 1 else mamba2_seq)(p, u, cfg)


def mamba_step(p: Params, u: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor, cfg):
    if is_dtensor(u):
        from repro_torch.models import spmd

        return spmd.mamba_step(p, u, conv_state, ssm_state, cfg)
    return (mamba1_step if cfg.ssm_version == 1 else mamba2_step)(p, u, conv_state, ssm_state, cfg)
