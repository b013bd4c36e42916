"""AdamW with float32 moments and a cosine learning-rate schedule
(``repro.training.optimizer``), as plain functions over the port's
parameter tree.

``torch.optim.AdamW`` is not used: it keeps its moments in the parameters'
dtype and rounds otherwise.  Here, as in the reference, the moments are
float32 for every leaf, the gradient is clipped by its global norm first,
and the weight decay is decoupled inside the step.  The step counter is an
int32 tensor, and the learning rate and bias corrections are float32
tensors computed from it (Python floats would be float64 and part from the
reference in the last bit); nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


def init_opt_state(params) -> OptState:
    """Zero float32 moments for every leaf, on the leaf's device; step 0."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), zeros, tree_map(torch.clone, zeros))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then a cosine decay to 10% of ``cfg.lr`` at
    ``total_steps`` (``optimizer.py:36``); float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp_max((step + 1) / max(1, cfg.warmup_steps), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.  The leaves are
    summed in the tree's insertion order, not JAX's sorted flattening of
    stacked blocks, so it equals the reference's to float32 rounding."""
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step (``optimizer.py:52``): clip ``grads`` to ``grad_clip``
    by their global norm, update the moments, then each parameter by the
    bias-corrected step plus the decoupled weight decay, in float32, cast
    back to the parameter's dtype.

    It works leaf by leaf and **in place**: the leaves of ``params`` and of
    ``state.mu`` and ``state.nu`` are overwritten, so a full-width run never
    holds two copies of the parameters.  Returns ``(params, new state,
    {"lr", "grad_norm"})``, the same ``params`` and moment trees."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        pf = p.float()  # p itself when p is float32
        upd.add_(cfg.weight_decay * pf).mul_(lr)
        p.copy_(pf.sub_(upd))
    return params, OptState(step, state.mu, state.nu), {"lr": lr, "grad_norm": gnorm}
