"""Mamba-1 (falcon-mamba) and Mamba-2 (zamba2) blocks (``repro.models.ssm``).

Sequence mode (whole-prompt prefill, training) runs the recurrence one token
at a time over the sequence, in checkpointed chunks of ``SSM_CHUNK`` tokens
under autograd; decode mode is one step against the carried ``(conv_state,
ssm_state)``.  States are float32; activations follow the model dtype.  The
reference computes these with ``jnp`` outside any Pallas kernel, so the
port's versions are plain PyTorch on every device: the scan is a Python loop
over tokens, the projections ``torch.matmul``.

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

from repro_torch.models.common import Params, checkpointed, dense_init, is_dtensor, resolve_device
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


def _conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``silu(conv(x))`` of the sequence blocks (under autograd recomputed in
    backward: each of the conv's ``K`` float32 products keeps a copy of the
    input otherwise)."""
    return F.silu(_causal_conv_seq(x, w, b))


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


SSM_CHUNK = 128  # the reference's time chunk for the scan under autograd (``ssm.py:129``)


def _scan(step, h: torch.Tensor, xs, p: Params):
    """The recurrence over time: ``step(p, h, inputs at t) -> (y_t, h)`` for
    each ``t`` of the ``[b, s, ...]`` inputs ``xs``.  Returns ``(final h,
    ys [b, s, ...])``.  Under autograd a sequence of two or more whole
    chunks runs as the reference's ``_chunked_scan`` (``ssm.py:132``): each
    ``SSM_CHUNK`` tokens under a non-reentrant checkpoint, so backward keeps
    the carry at each chunk's start and recomputes one chunk's steps at a
    time, where the token loop would keep every step's saved state; values
    and gradients are the loop's, bit for bit (the autograd graph is the
    loop's).  Inside a recomputed layer period (``remat``) the chunks nest
    as ``jax.checkpoint`` does.  Without autograd (prefill, decode) the loop
    runs as it is.  On the dry run's fake tensors the scan is counted, not
    run (:class:`_CountedScan`)."""
    s = xs[0].shape[1]
    chunked = (s > SSM_CHUNK and s % SSM_CHUNK == 0 and torch.is_grad_enabled()
               and any(t.requires_grad for t in (h, *xs, *p.values())))
    if _counts_only(xs[0]):
        names = sorted(p)
        return _CountedScan.apply(step, names, len(xs), SSM_CHUNK if chunked else s, h, *xs,
                                  *(p[k] for k in names))
    if not chunked:
        return _loop(step, h, xs, p)
    names, ys = sorted(p), []
    for lo in range(0, s, SSM_CHUNK):
        h, y = checkpointed(_chunk, step, names, len(xs), h, *(a[:, lo : lo + SSM_CHUNK] for a in xs),
                            *(p[k] for k in names))
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def _chunk(step, names, n_x, h, *rest):
    return _loop(step, h, rest[:n_x], dict(zip(names, rest[n_x:])))


def _loop(step, h: torch.Tensor, xs, p: Params):
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
    """:func:`_scan` as the dry run records it, at a cost that does not
    grow with the sequence: one step runs inside
    ``roofline.analysis.repeat(s)``, so the FLOP counter and the op recorder
    count it ``s`` times, and tensors the size of what the scan holds are
    allocated where the scan holds it, so the memory tracker's peak is the
    scan's.  Forward: the ``s`` outputs before they are stacked (by chunk,
    then concatenated, when ``chunk < s``), and under autograd what is held
    until backward: the token loop's ``s`` steps' saved tensors (measured on
    the one step: its saved storages other than its inputs), or the chunked
    scan's carries at the chunks' starts; and each input the step saves a
    slice of (every input, when chunked).  Backward: when chunked, each
    chunk's recompute (``s`` more steps, one chunk's saved tensors held);
    the step's gradient ``s`` times, the select-backward and out-of-place
    sum autograd runs for each token's slice of each input (it sums into a
    fake tensor out of place), and the ``s`` contributions summed into each
    weight's gradient.  Shapes only: the values are not the scan's."""

    @staticmethod
    def forward(ctx, step, names, n_x, chunk, h, *rest):
        xs, ws = rest[:n_x], rest[n_x:]
        s = xs[0].shape[1]
        n_chunks = s // chunk
        x_ts = [a[:, 0] for a in xs]
        train = any(ctx.needs_input_grad)
        ctx.set_materialize_grads(False)
        held, per_step, x_saved = 0, 0, set()
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
                per_step = sum(new.values())
                if n_chunks > 1:
                    held, x_saved = (n_chunks - 1) * h.untyped_storage().nbytes(), x_ids
                else:
                    held = (s - 1) * per_step
            else:
                y, h_out = step(dict(zip(names, ws)), h, *x_ts)
        with repeat(0):
            kept = y.new_empty(((s - chunk if n_chunks > 1 else max(0, s - 1)) * y.numel(),))  # outputs before a stack
            saved_states = y.new_empty((held,), dtype=torch.uint8)
        with repeat(n_chunks):  # the stacks' bytes
            ys = y.unsqueeze(1).expand(y.shape[0], chunk, *y.shape[1:]).contiguous()
        if n_chunks > 1:
            ys = torch.cat([ys] * n_chunks, dim=1)
        del kept
        if train:
            ctx.save_for_backward(saved_states, h, *ws, *(a for a in xs if _storage_id(a) in x_saved))
            ctx.step, ctx.names, ctx.s, ctx.chunk, ctx.per_step = step, names, s, chunk, per_step
            ctx.y_bytes = y.numel() * y.element_size()
            ctx.x_specs = [(a.shape, a.dtype) for a in xs]
        return h_out, ys

    @staticmethod
    def backward(ctx, g_h, g_ys):
        s, chunk = ctx.s, ctx.chunk
        n_chunks = s // chunk
        saved = ctx.saved_tensors  # chunked: the carries and inputs stay until the chunks have run
        h, *ws = saved[1:1 + 1 + len(ctx.names)]
        if n_chunks == 1:
            del saved
        with repeat(0):
            x_ts = [h.new_empty((shape[0], *shape[2:]), dtype=dtype) for shape, dtype in ctx.x_specs]
            # chunked: the later chunks' gradient of each input, then one
            # chunk's recompute (its saved tensors and outputs)
            later = [h.new_empty(shape, dtype=dtype) for (shape, dtype), need_x in zip(
                ctx.x_specs, ctx.needs_input_grad[5:]) if n_chunks > 1 and need_x]
            recomputed = h.new_empty(((chunk - 1) * (ctx.per_step + ctx.y_bytes) if n_chunks > 1 else 0,),
                                     dtype=torch.uint8)
        with repeat(s if n_chunks > 1 else 0), torch.enable_grad():  # each chunk's recompute
            args = _leaves(ctx.names, h, x_ts, ws)
            y, h_out = ctx.step(*args)
        if g_h is None:
            with repeat(0):
                g_h = torch.zeros_like(h_out)
        # the state's gradient too: every step but the first passes one on
        leaves = [args[1], *args[2:], *(args[0][k] for k in ctx.names)]
        need = (True, *ctx.needs_input_grad[5:])
        with repeat(s):
            grads = torch.autograd.grad((y, h_out), [t for t, n in zip(leaves, need) if n],
                                        (g_ys[:, 0], g_h), allow_unused=True)
        it = iter(grads)
        out = [next(it) if n else None for n in need]
        if not ctx.needs_input_grad[4]:
            out[0] = None
        # each input's gradient: its tokens' summed, then (chunked) the chunks'
        del recomputed
        for i, (shape, _) in enumerate(ctx.x_specs):
            g = out[1 + i]
            if g is not None:
                with repeat(s):
                    g = torch.ops.aten.select_backward(g, (shape[0], chunk, *shape[2:]), 1, 0)
                with repeat(0):
                    other = torch.empty_like(g)
                with repeat(s - n_chunks):
                    out[1 + i] = g + other
        del later
        if n_chunks > 1:
            del saved
        for i, (shape, _) in enumerate(ctx.x_specs):
            g = out[1 + i]
            if g is not None and n_chunks > 1:
                with repeat(n_chunks):
                    g = torch.ops.aten.slice_backward(g, shape, 1, 0, chunk, 1)
                with repeat(0):
                    other = torch.empty_like(g)
                with repeat(n_chunks - 1):
                    out[1 + i] = g + other
        for i in range(1 + len(ctx.x_specs), len(out)):
            if out[i] is not None:
                with repeat(s - 1):
                    out[i] = out[i] + out[i]
        return (None, None, None, None, *out)


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
    x = checkpointed(_conv_silu, x, p["conv_w"], p["conv_b"])
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
    xBC = checkpointed(_conv_silu, xBC, p["conv_w"], p["conv_b"])
    h0 = torch.zeros((u.shape[0], cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                     device=u.device)
    h, ys = _scan(lambda q, h, x_t, dt_t: _m2_core_step(q, x_t, dt_t, h, cfg), h0, (xBC, dt), p)

    def out(ys, z, scale, w):
        return _gated_rmsnorm(ys, z.float(), scale, cfg.norm_eps).to(u.dtype) @ w

    return checkpointed(out, ys, z, p["norm_scale"], p["out_proj"]), h, tail


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
