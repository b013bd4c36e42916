"""Dependency-free checkpoints in the reference's format
(``repro.training.checkpoint``): one ``ckpt_%08d.npz`` of flat ``/``-joined
keys, ``params/...`` and ``opt/{step,mu,nu}/...``, bfloat16 leaves stored as
float32 under a ``::bf16`` suffix (exact both ways).

The port's tree is its own: one dict per layer under ``layers/<i>/``, where
the reference stacks them under ``blocks/pos<p>/``, so a checkpoint moves
between the two packages only through :mod:`repro_torch.bridge`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[prefix[:-1] + "::bf16"] = t.float().numpy()
        else:
            out[prefix[:-1]] = t.numpy()
    return out


def _unflatten(flat: Dict[str, np.ndarray], device: torch.device):
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        t = torch.from_numpy(arr).to(device)
        if key.endswith("::bf16"):
            key = key[: -len("::bf16")]
            t = t.to(torch.bfloat16)
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return _listify(root)


def _listify(node):
    """``{"0": .., "1": ..}`` dicts back to lists (the reference makes tuples)."""
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_listify(node[str(i)]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def save_checkpoint(path: str, step: int, params, opt_state=None) -> str:
    """Write ``params`` (and ``opt_state``'s step and moments) to
    ``path/ckpt_<step>.npz``; returns the file name."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    flat = _flatten({"params": params})
    if opt_state is not None:
        flat.update(_flatten({"opt": {"step": opt_state.step, "mu": opt_state.mu, "nu": opt_state.nu}}))
    np.savez(fname, **flat)
    return fname


def load_checkpoint(fname: str, device="cuda") -> Tuple[Any, Optional[Dict[str, Any]]]:
    """``(params, {"step", "mu", "nu"} or None)`` on ``device``."""
    dev = resolve_device(device)
    with np.load(fname) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat, dev)
    return tree["params"], tree.get("opt")


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    cands = sorted(f for f in os.listdir(path) if f.startswith("ckpt_"))
    return os.path.join(path, cands[-1]) if cands else None
