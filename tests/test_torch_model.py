"""The port's decode step and chunked prefill against the reference on
``dsv2-lite-reduced`` with AEBS-scheduled grouped MoE, plus the port's own
paged == contiguous invariant."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tol_for
from repro.configs import get_config as ref_get_config
from repro.core.aebs import aebs_assign as ref_aebs_assign
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.amax import make_routing_trace
from repro_torch.core.placement import build_layout
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.models import model

B, S, PS = 3, 32, 8  # slots, cache rows, page size


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    dtype = request.param
    ref_cfg = dataclasses.replace(ref_get_config("dsv2-lite-reduced"), dtype=dtype)
    cfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype=dtype)
    ref_params = ref_model.init_params(ref_cfg, 0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    trace = make_routing_trace(512, cfg.num_experts, cfg.top_k, skew=0.8, seed=0)
    layout = build_layout(trace, cfg.num_experts, 2, 3)
    s2e = layout.slot_to_expert.reshape(-1).astype(np.int32)
    ref_extra = {"moe_ctx": dict(
        dispatch="grouped", layout_tables={k: jnp.asarray(v) for k, v in (
            ("expert_hosts", layout.expert_hosts), ("replica_counts", layout.replica_counts),
            ("slot_of", layout.slot_of))},
        slot_to_expert=jnp.asarray(s2e), num_instances=2, scheduler=ref_aebs_assign,
    )}
    extra = {"moe_ctx": dict(
        layout_tables=layout.device_tables("cpu"),
        slot_to_expert=torch.from_numpy(s2e), num_instances=2, scheduler=aebs_schedule,
    )}
    return dtype, ref_cfg, cfg, ref_params, params, ref_extra, extra


def _filled_caches(cfg, seed=0):
    """Contiguous caches with random rows (as numpy float32)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("kv_k", "kv_v")}


def _paginate(dense, seed=1):
    """Scatter contiguous caches into shuffled pages + block tables (page 0
    stays the null page, filled with garbage)."""
    rng = np.random.default_rng(seed)
    nblk = S // PS
    P = B * nblk + 1
    bt = (rng.permutation(P - 1) + 1).reshape(B, nblk).astype(np.int32)
    out = {"block_tables": bt}
    for k, v in dense.items():
        pool = rng.standard_normal((v.shape[0], P, PS, *v.shape[3:])).astype(np.float32)
        pool[:, bt.reshape(-1)] = v.reshape(v.shape[0], B * nblk, PS, *v.shape[3:])
        out[k] = pool
    return out


def _to_port(arrs, dtype):
    out = {k: torch.from_numpy(v) for k, v in arrs.items()}
    if dtype == "bfloat16":  # KV arrays only; block tables stay int32
        out.update({k: out[k].to(torch.bfloat16) for k in ("kv_k", "kv_v")})
    return out


def _to_ref(arrs, dtype):
    out = {k: jnp.asarray(v) for k, v in arrs.items()}
    if dtype == "bfloat16":
        out.update({k: out[k].astype(jnp.bfloat16) for k in ("kv_k", "kv_v")})
    return out


TOKENS = np.array([[5], [77], [301]], np.int32)
POSITIONS = np.array([4, 17, 28], np.int32)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_matches_reference(setup, paged):
    dtype, ref_cfg, cfg, ref_params, params, ref_extra, extra = setup
    arrs = _filled_caches(cfg)
    if paged:
        arrs = _paginate(arrs)
    ref_logits, ref_caches = ref_model.decode_step(
        ref_params, jnp.asarray(TOKENS), _to_ref(arrs, dtype), jnp.asarray(POSITIONS), ref_cfg,
        extra=ref_extra,
    )
    logits, caches = model.decode_step(
        params, torch.from_numpy(TOKENS), _to_port(arrs, dtype), torch.from_numpy(POSITIONS), cfg,
        extra=extra,
    )
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab_size)
    assert_close(logits, ref_logits, tol_for(dtype, "layer"))
    for k in ("kv_k", "kv_v"):
        assert_close(caches[k], ref_caches[k], tol_for(dtype, "layer"))


def test_paged_decode_equals_contiguous_bitwise(setup):
    dtype, _, cfg, _, params, _, extra = setup
    dense = _filled_caches(cfg, seed=3)
    outs = []
    for arrs in (dense, _paginate(dense, seed=4)):
        caches = _to_port(arrs, dtype)
        toks = torch.from_numpy(TOKENS)
        for step in range(3):
            logits, caches = model.decode_step(
                params, toks, caches, torch.from_numpy(POSITIONS + step), cfg, extra=extra
            )
            toks = model.greedy_token(logits)[:, None]
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])


def test_prefill_chunk_matches_reference(setup):
    dtype, ref_cfg, cfg, ref_params, params, _, _ = setup
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 13)).astype(np.int32)
    ref_caches = ref_model.init_decode_caches(ref_cfg, 1, S)
    caches = model.init_decode_caches(cfg, 1, S, device="cpu")
    for lo in (0, 8):  # chunks of 8 and 5 tokens
        hi = min(lo + 8, prompt.shape[1])
        ref_logits, ref_caches = ref_model.prefill_chunk(
            ref_params, jnp.asarray(prompt[:, lo:hi]), ref_caches, jnp.int32(lo), ref_cfg,
            extra={"moe_ctx": {"capacity": hi - lo, "dispatch": "grouped"}},
        )
        logits, caches = model.prefill_chunk(
            params, torch.from_numpy(prompt[:, lo:hi]), caches, lo, cfg,
            extra={"moe_ctx": {"capacity": hi - lo}},
        )
        assert_close(logits, ref_logits, tol_for(dtype, "layer"))
    for k in ("kv_k", "kv_v"):
        assert_close(caches[k], ref_caches[k], tol_for(dtype, "layer"))
