"""Roofline terms of a traced dry-run step (``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = flops_per_device            / peak FLOP/s
    memory     = bytes_per_device            / HBM bytes/s
    collective = collective_bytes_per_device / link bytes/s

The reference reads them off XLA's compiled executable (``cost_analysis``,
the partitioned HLO text).  Here the step runs once on fake tensors under
the dry run's recorders (``launch/dryrun.py``): ``flops_per_device`` is
``torch.utils.flop_counter.FlopCounterMode``'s count of one rank's local ops
(:class:`LocalFlopCounter`; the kernels' custom ops count by their
registered formulas);
``bytes_per_device`` is **unfused** traffic, the inputs and outputs of every
aten op one rank runs (:class:`OpRecorder`), not XLA's post-fusion "bytes
accessed", so it is an upper bound of what a fused program moves;
``collective_bytes`` sums the result bytes of each functional collective by
kind, as the reference sums the result shapes of the HLO collectives.

``loop_scale`` stays for the record's keys but is always 1.0: XLA counts a
loop body once and the reference scaled by the period count, while an eager
trace counts every layer.  A loop whose steps are alike may instead run one
step inside :func:`repeat` (the Mamba scan on fake tensors,
``models/ssm.py``): both recorders count what runs there that many times.

Hardware constants default to one NVIDIA H100 (``core.comm.H100``): bf16
peak, HBM, and the inter-node link, since a 16-rank model axis spans two
8-GPU nodes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Dict, Iterable, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.comm import H100

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# functional collectives (``torch.ops._c10d_functional``) -> the HLO kinds
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# how many times what runs now is counted: the product of the open repeat scopes
_REPEAT: List[int] = [1]


@contextlib.contextmanager
def repeat(n: int) -> Iterator[None]:
    """Inside, :class:`LocalFlopCounter` and :class:`OpRecorder` count each op
    ``n`` times (0: not at all), so one step of a loop of ``n`` like steps
    records as the loop.  Scopes nest by multiplying."""
    _REPEAT.append(_REPEAT[-1] * n)
    try:
        yield
    finally:
        _REPEAT.pop()


def _local_nbytes(t) -> int:
    return t.numel() * t.element_size()


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` over one rank's local ops (an op on DTensors is
    left to DTensor, whose local ops come here), each counted as often as
    the open :func:`repeat` scopes say."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            flops = self.flop_registry[func_packet](*args, **kwargs, out_val=out) * _REPEAT[-1]
            for par in set(self.mod_tracker.parents):
                self.flop_counts[par][func_packet] += flops
        return out


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(t is DTensor for t in types)


class OpRecorder(TorchDispatchMode):
    """Counts, per rank, the bytes every aten op reads and writes (views and
    collectives excluded) and records each functional collective as
    ``(kind, result bytes)``, as often as the open :func:`repeat` scopes
    say.  An op on DTensors is left to DTensor, which runs it as local ops
    (and collectives) that come here one by one, so the counts are one
    rank's."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: List[Tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        n = _REPEAT[-1]
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            kind = _FUNCOL_KINDS.get(name)
            if kind is not None:
                self.collectives.extend([(kind, sum(_local_nbytes(t) for t in _tensors(out)))] * n)
        elif ns != "prim" and not func.is_view and n:  # prim: metadata queries (``prim.device``)
            flat = list(_tensors(args)) + list(_tensors(kwargs or {})) + list(_tensors(out))
            self.bytes += n * sum(_local_nbytes(t) for t in flat)
        return out


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Per-device bytes moved by each collective kind (result-shape basis)
    and their ``count``."""
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for kind, nbytes in records:
        out[kind] += int(nbytes)
        out["count"] += 1
    return out


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, int]
    peak_memory_per_device: float
    model_flops: float  # 6 N_active D analytic
    loop_scale: float = 1.0  # always 1.0: an eager trace counts every layer
    peak_flops: float = H100.peak_flops
    hbm_bw: float = H100.hbm_bw
    link_bw: float = H100.slow_bw

    @property
    def t_compute(self) -> float:
        return self.flops_per_device * self.loop_scale / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device * self.loop_scale / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device * self.loop_scale / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.loop_scale * self.chips
        return self.model_flops / total if total > 0 else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "loop_scale": self.loop_scale,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops_estimate(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6 N D (dense) / 6 N_active D (MoE) for training;
    2 N D for a forward-only step (prefill), 2 N_active per decoded token."""
    pc = cfg.param_counts()
    n_dense = pc["attn"] + pc["ffn"] + pc["ssm"] + pc["norm"] + pc["embed"]
    if cfg.has_moe:
        active_frac = cfg.top_k / max(1, cfg.num_experts)
        n_active = n_dense + pc["expert"] * active_frac
    else:
        n_active = n_dense
    if shape.kind == "train":
        per_tok = 6.0 * n_active
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        per_tok = 2.0 * n_active
        tokens = shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        per_tok = 2.0 * n_active
        tokens = shape.global_batch
    return per_tok * tokens


def analyze(
    arch: str,
    shape_name: str,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    collectives: Iterable[Tuple[str, int]],
    peak_memory: float,
    model_flops: float,
    loop_scale: float = 1.0,
    **hardware,
) -> RooflineTerms:
    """``cost`` holds ``flops`` and ``bytes accessed`` per device,
    ``collectives`` the :class:`OpRecorder`'s records, ``peak_memory`` the
    step's peak bytes per device; ``hardware`` overrides ``peak_flops``,
    ``hbm_bw`` or ``link_bw``."""
    coll = collective_bytes(collectives)
    return RooflineTerms(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=float(cost.get("flops", 0.0)),
        bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        collective_bytes_per_device=float(sum(v for k, v in coll.items() if k != "count")),
        collective_breakdown=coll,
        peak_memory_per_device=float(peak_memory),
        model_flops=model_flops,
        loop_scale=loop_scale,
        **hardware,
    )


def save(terms: RooflineTerms, path: str) -> None:
    with open(path, "w") as f:
        json.dump(terms.to_dict(), f, indent=1)
