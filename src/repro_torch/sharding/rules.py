"""Partition-spec rules for every parameter and input of every architecture
(``repro.sharding.rules``), rule for rule.

Strategy (the reference's):
  * batch-like axes -> the data axes ("pod", "data") when divisible;
  * Megatron-style tensor parallelism over the "model" axis for dense layers:
    shard the widest weight axis that divides by the model-axis size,
    preferring structured axes (heads, d_ff, experts, vocab) and falling back
    to the contraction axis (input d_model -> partial sums) or replication;
  * expert weights shard on the expert / slot axis when divisible (expert
    parallelism, the MoE pool), else on d_ff;
  * decode caches shard batch over the data axes and KV heads over "model"
    when divisible, else the sequence axis (context parallelism, the
    long_500k path where batch = 1).

A spec is a :class:`P`, a tuple of one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names (the dimension
split over those axes, major first).  :func:`to_placements` turns one into
DTensor placements over a ``DeviceMesh``; ``launch/steps.py`` binds them.

The port's parameters are one dict per layer (``layers/<i>/...``), not the
reference's period-stacked ``blocks``, so no spec here carries the leading
``n_periods`` entry the reference adds for stacked leaves; every other entry
is the reference's.  The functions take a ``DeviceMesh`` or anything with a
``.shape`` mapping of axis sizes, so the rules need no process group.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

from repro_torch.configs.base import InputShape, ModelConfig

MODEL = "model"


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dimension 0 over the
    model axis and replicates dimension 1 (``jax.sharding.PartitionSpec``);
    a one-axis tuple entry is that axis, as ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of an object whose
    ``.shape`` is already such a mapping."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _prod(sizes: Mapping[str, int], axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def param_pspec(
    names: Tuple[str, ...],
    shape: Tuple[int, ...],
    cfg: ModelConfig,
    n_model: int,
    model_axis: str,
    fsdp_axes: Tuple[str, ...] = (),
    n_fsdp: int = 1,
) -> P:
    """PartitionSpec for one parameter leaf (``rules.py:43``).

    With ``fsdp_axes`` (training), a second weight axis is sharded over the
    data axes so parameters and optimizer moments scale with the cluster.
    Serving passes no fsdp axes: weights are replicated across the data axes
    for latency (Janus attention instances hold full replicas)."""
    name = names[-1]
    dims = shape
    m = model_axis
    f_ = fsdp_axes if fsdp_axes else None

    def fs(dim):  # fsdp spec entry if divisible
        return f_ if f_ and _div(dim, n_fsdp) else None

    # --- embeddings ---------------------------------------------------------
    if name == "embed":
        if _div(shape[0], n_model):
            return P(m, fs(shape[1]))
        return P(None, fs(shape[1]))
    # --- norms / small vectors ----------------------------------------------
    if name in ("scale", "bias", "conv_b", "dt_bias", "A_log", "D", "norm_scale", "router"):
        return P(*((None,) * len(shape)))
    # --- attention ------------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        if _div(dims[1], n_model):
            return P(fs(dims[0]), m, None)
        return P(m, None, None)  # row-parallel on d_model (partial sums)
    if name == "wo":
        nh, hd = dims[0], dims[1]
        if _div(nh, n_model):
            return P(m, None, fs(dims[2]))
        if _div(hd, n_model):
            return P(None, m, fs(dims[2]))
        return P(None, None, fs(dims[2]))
    # --- MoE expert weights (3D) / dense FFN (2D) -----------------------------
    if name in ("w_gate", "w_up"):
        if len(dims) == 3:  # [E or S_slots, d, f]
            if _div(dims[0], n_model):
                return P(m, fs(dims[1]), None)
            return P(None, fs(dims[1]), m)
        return P(fs(dims[0]), m)  # [d, f]
    if name == "w_down":
        if len(dims) == 3:  # [E, f, d]
            if _div(dims[0], n_model):
                return P(m, None, fs(dims[2]))
            return P(None, m, fs(dims[2]))
        return P(m, fs(dims[1]))  # [f, d]
    # --- mamba ------------------------------------------------------------------
    if name == "in_proj":  # [d, proj_out]
        return P(fs(dims[0]), m) if _div(dims[1], n_model) else P(fs(dims[0]), None)
    if name == "out_proj":  # [di, d]
        return P(m, fs(dims[1])) if _div(dims[0], n_model) else P(None, fs(dims[1]))
    if name == "x_proj":  # [di, dt_rank + 2N]
        return P(m, None) if _div(dims[0], n_model) else P(None, None)
    return P(*((None,) * len(shape)))


def _tree_with_names(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _tree_with_names(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_with_names(fn, v, names + (str(i),)) for i, v in enumerate(tree)]
    return fn(names, tree)


def param_pspecs(cfg: ModelConfig, params_tree, mesh, fsdp: bool = False) -> Any:
    """A :class:`P` for every leaf of ``params_tree`` (tensors, fake tensors or
    anything with a ``.shape``), in the tree's structure (``rules.py:135``)."""
    sizes = axis_sizes(mesh)
    fsdp_axes = batch_axes(mesh) if fsdp else ()
    n_fsdp = _prod(sizes, fsdp_axes)
    n_model = sizes.get(MODEL, 1)
    return _tree_with_names(
        lambda names, leaf: param_pspec(names, tuple(leaf.shape), cfg, n_model, MODEL, fsdp_axes, n_fsdp),
        params_tree,
    )


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def input_pspecs(cfg: ModelConfig, shape: InputShape, specs: Dict[str, Tuple[tuple, Any]], mesh) -> Dict[str, P]:
    """PartitionSpecs of ``configs.base.input_specs(cfg, shape)``
    (``{name: (shape, dtype)}``) on ``mesh`` (``rules.py:151``)."""
    sizes = axis_sizes(mesh)
    dp = batch_axes(mesh)
    n_dp = _prod(sizes, dp)
    n_model = sizes.get(MODEL, 1)
    B = shape.global_batch
    bspec = dp if _div(B, n_dp) and n_dp > 1 else None

    out: Dict[str, P] = {}
    for name, (s, _) in specs.items():
        if name in ("tokens", "labels"):
            out[name] = P(bspec, None)
        elif name == "cache_index":
            out[name] = P()
        elif name.startswith("kv_") and name.endswith("_scale"):
            # [L, B, S, nkv]: the int8 cache's sharding minus head_dim
            nkv, S = s[3], s[2]
            if _div(nkv, n_model):
                out[name] = P(None, bspec, None, MODEL)
            elif bspec is None and _div(S, n_dp * n_model):
                out[name] = P(None, None, dp + (MODEL,), None)
            elif bspec is None and _div(S, n_dp):
                out[name] = P(None, None, dp, None)
            elif _div(S, n_model):
                out[name] = P(None, bspec, MODEL, None)
            else:
                out[name] = P(None, bspec, None, None)
        elif name.startswith("kv_"):
            # [L, B, S, nkv, hd]
            nkv, S = s[3], s[2]
            if _div(nkv, n_model):
                out[name] = P(None, bspec, None, MODEL, None)
            elif bspec is None and _div(S, n_dp * n_model):
                # context parallelism for batch-1 long-context decode
                out[name] = P(None, None, dp + (MODEL,), None, None)
            elif bspec is None and _div(S, n_dp):
                out[name] = P(None, None, dp, None, None)
            elif _div(S, n_model):
                # KV heads do not divide the model axis: context-parallel
                # within the model group instead (sequence axis)
                out[name] = P(None, bspec, MODEL, None, None)
            else:
                out[name] = P(None, bspec, None, None, None)
        elif name == "ssm_state":
            # [L, B, di, N] (v1) or [L, B, H, hd, N] (v2)
            ispec = MODEL if _div(s[2], n_model) else None
            out[name] = P(None, bspec, ispec, *((None,) * (len(s) - 3)))
        elif name == "conv_state":
            # [L, B, K-1, conv_dim]
            out[name] = P(None, bspec, None, MODEL if _div(s[3], n_model) else None)
        elif name in ("enc_out", "encoder_frames", "patch_embeds"):
            out[name] = P(bspec, None, None)
        else:
            out[name] = P(*((None,) * len(s)))
    return out


def activation_pspec(cfg: ModelConfig, mesh, batch: int) -> P:
    sizes = axis_sizes(mesh)
    dp = batch_axes(mesh)
    return P(dp if _div(batch, _prod(sizes, dp)) and _prod(sizes, dp) > 1 else None, None, None)


def to_placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh`` with
    named dims): ``Shard(d)`` on each mesh dim that names tensor dim ``d``, in
    the entry's order, ``Replicate()`` on the rest.  An entry's axes must
    follow the mesh's order (DTensor splits a dim over mesh dims major
    first, as a ``PartitionSpec`` tuple does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} does not follow the mesh's axis order {names}")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dimensions in {spec}")
            placements[i] = Shard(dim)
    return placements


def from_placements(placements: Sequence, mesh, ndim: int) -> P:
    """The :class:`P` of ``ndim`` entries that :func:`to_placements` maps to
    ``placements`` (a single axis as its name, several as a tuple)."""
    from torch.distributed.tensor import Shard

    entries: list = [() for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            entries[pl.dim] = entries[pl.dim] + (name,)
    return P(*(e or None for e in entries))
