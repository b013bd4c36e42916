"""Training loop (``repro.training.train_loop``): a train step of the loss,
autograd's backward pass and the in-place AdamW update, and the loop
that feeds it from the token pipeline and checkpoints.

The step runs eagerly (the reference jits it) with every layer period
recomputed in the backward pass (``remat``, ``torch.utils.checkpoint``).
The MoE layers run the einsum dispatch (``model.loss_fn``), plain PyTorch,
so no kernel of ``csrc/`` runs on this path: the kernels have no backward
pass, and their wrappers refuse a tensor that requires grad.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.common import resolve_device, tree_leaves, tree_unflatten
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, TokenPipeline
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update, init_opt_state


def make_train_step(cfg, opt_cfg: AdamWConfig, remat: bool = True, extra=None) -> Callable:
    """``train_step(params, opt_state, tokens, labels) -> (params, opt_state,
    info)``: ``model.loss_fn`` (``extra`` passed to it), its gradient with
    respect to every leaf by ``torch.autograd.grad`` (nothing accumulates in
    ``.grad``; a leaf the loss does not reach raises, where JAX would give
    zeros: every config's loss reaches every leaf), then
    :func:`adamw_update`, which overwrites the leaves of ``params`` and the
    moments in place.  ``info`` holds ``lr``, ``grad_norm``, ``loss`` and
    ``lb_loss`` as device tensors."""

    def train_step(params, opt_state: OptState, tokens, labels):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, aux = model_mod.loss_fn(params, tokens, labels, cfg, extra=extra, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        params, opt_state, info = adamw_update(opt_cfg, params, tree_unflatten(params, grads), opt_state)
        info = dict(info, loss=loss.detach(), lb_loss=aux["lb_loss"].detach())
        return params, opt_state, info

    return train_step


def train(
    cfg,
    steps: int = 100,
    batch_size: int = 8,
    seq_len: int = 128,
    seed: int = 0,
    opt_cfg: Optional[AdamWConfig] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    log_every: int = 10,
    log_fn=print,
    device="cuda",
) -> Dict:
    """``steps`` train steps on ``device`` from weights drawn in torch from
    ``seed`` (``model.init_params``; other numbers than the reference's JAX
    draw) over :class:`TokenPipeline` batches of that seed.  Returns the
    reference's ``history`` ((step, loss) at each logged step), ``first_loss``,
    ``final_loss``, ``wall_s`` and ``params``."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    params = model_mod.init_params(cfg, seed, device=dev)
    opt_state = init_opt_state(params)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, seq_len, batch_size, seed))
    step_fn = make_train_step(cfg, opt_cfg)

    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        toks, labels = (torch.from_numpy(a).to(dev) for a in pipe.batch(step))
        params, opt_state, info = step_fn(params, opt_state, toks, labels)
        if step % log_every == 0 or step == steps - 1:
            loss = float(info["loss"])
            history.append((step, loss))
            log_fn(
                f"step {step:5d}  loss {loss:.4f}  lr {float(info['lr']):.2e}  "
                f"gnorm {float(info['grad_norm']):.2f}"
            )
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, params, opt_state)
    wall = time.perf_counter() - t0
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, params, opt_state)
    return {
        "history": history,
        "final_loss": history[-1][1] if history else float("nan"),
        "first_loss": history[0][1] if history else float("nan"),
        "wall_s": wall,
        "params": params,
    }
