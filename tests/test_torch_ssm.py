"""The port's Mamba blocks (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), function by function, in float32 on the
reduced falcon-mamba (Mamba-1) and zamba2 (Mamba-2) configs, with weights
drawn by the reference and inputs made from a seed with numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import ssm

CONFIGS = ("falcon-mamba-7b-reduced", "zamba2-2.7b-reduced")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, dtype="float32"):
    ref_cfg = dataclasses.replace(ref_get_config(name), dtype=dtype)
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_p = ref_ssm.init_mamba(ref_cfg, jax.random.PRNGKey(3), jdt)
    # the reference's zero biases and A_log: draw them, so every term counts
    rng = np.random.default_rng(4)
    ref_p = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.3, v.dtype)
                 if k in ("conv_b", "dt_bias", "norm_scale") or (k == "A_log" and cfg.ssm_version == 2) else v)
             for k, v in ref_p.items()}
    p = {k: bridge.tensor_from_numpy(np.asarray(v)) for k, v in ref_p.items()}
    return ref_cfg, cfg, ref_p, p


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_init_mamba_layout_equals_reference(name, dtype):
    """Same keys, shapes and dtypes as the reference's ``init_mamba``; the
    deterministic leaves ``D`` and the zero biases equal exactly.  Mamba-1's
    ``A_log`` is ``log(1..N)`` correctly rounded to float32 (float64 ``log``
    rounded once) exactly, and within one float32 ulp of the reference's,
    which is the host's float32 ``log`` (one ulp off at some ``n``)."""
    ref_cfg, cfg, _, _ = _setup(name, dtype)
    ref_p = ref_ssm.init_mamba(ref_cfg, jax.random.PRNGKey(0), jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    p = ssm.init_mamba(cfg, torch.Generator().manual_seed(0), cfg.torch_dtype, "cpu")
    assert set(p) == set(ref_p)
    for k, v in ref_p.items():
        got = bridge.tensor_to_numpy(p[k])
        assert got.shape == v.shape and got.dtype == np.asarray(v).dtype, k
        if k == "A_log" and cfg.ssm_version == 1:
            want = np.broadcast_to(np.log(np.arange(1, cfg.ssm_state + 1, dtype=np.float64)).astype(np.float32),
                                   got.shape)
            np.testing.assert_array_equal(got, want, err_msg=k)
            np.testing.assert_array_max_ulp(got, np.asarray(v), maxulp=1)
        elif k in ("A_log", "D", "conv_b", "dt_bias", "norm_scale"):
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", CONFIGS)
def test_init_ssm_state_equals_reference(name):
    ref_cfg, cfg, _, _ = _setup(name)
    want = ref_ssm.init_ssm_state(ref_cfg, 3)
    got = ssm.init_ssm_state(cfg, 3, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).endswith(str(w.dtype))
        assert not g.any()


@pytest.mark.parametrize("s", [1, 2, 7])
def test_causal_conv_and_tail_equal_reference(s):
    """The sequential conv, one conv step, and the K - 1 tail (zero-padded
    when the sequence is shorter)."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    assert_close(ssm._causal_conv_seq(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
                 ref_ssm._causal_conv_seq(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), TOL["f32_op"])
    np.testing.assert_array_equal(ssm._conv_tail(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(ref_ssm._conv_tail(jnp.asarray(x), 4)))
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    got = ssm._causal_conv_step(torch.from_numpy(x[:, 0]), torch.from_numpy(state), torch.from_numpy(w),
                                torch.from_numpy(b))
    want = ref_ssm._causal_conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state), jnp.asarray(w), jnp.asarray(b))
    for g, wv in zip(got, want):
        assert_close(g, wv, TOL["f32_op"])


@pytest.mark.parametrize("s", [2, 7, 300])
def test_conv_tail_owns_its_storage(s):
    """The tail the prefill caches holds ``K - 1`` rows of storage of its
    own, not a view that keeps the whole padded sequence alive."""
    x = torch.zeros(2, s, 12)
    tail = ssm._conv_tail(x, 4)
    assert tail.shape == (2, 3, 12)
    assert tail.untyped_storage().nbytes() == tail.numel() * tail.element_size()


def test_mamba1_core_step_equals_reference():
    ref_cfg, cfg, ref_p, p = _setup("falcon-mamba-7b-reduced")
    dt_rank = max(1, -(-cfg.d_model // 16))
    x = _x((2, cfg.d_inner), 1)
    h = _x((2, cfg.d_inner, cfg.ssm_state), 2)
    got = ssm._m1_core_step(p, torch.from_numpy(x), torch.from_numpy(h), cfg.ssm_state, dt_rank)
    want = ref_ssm._m1_core_step(ref_p, jnp.asarray(x), jnp.asarray(h), cfg.ssm_state, dt_rank)
    for g, w in zip(got, want):
        assert_close(g, w, TOL["f32_op"])


def test_mamba2_split_core_step_and_norm_equal_reference():
    ref_cfg, cfg, ref_p, p = _setup("zamba2-2.7b-reduced")
    proj = _x((2, 5, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_num_heads), 3)
    for g, w in zip(ssm._m2_split(cfg, torch.from_numpy(proj)), ref_ssm._m2_split(ref_cfg, jnp.asarray(proj))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    xBC, dt = _x((2, cfg.conv_dim), 4), _x((2, cfg.ssm_num_heads), 5)
    h = _x((2, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state), 6)
    got = ssm._m2_core_step(p, torch.from_numpy(xBC), torch.from_numpy(dt), torch.from_numpy(h), cfg)
    want = ref_ssm._m2_core_step(ref_p, jnp.asarray(xBC), jnp.asarray(dt), jnp.asarray(h), ref_cfg)
    for g, w in zip(got, want):
        assert_close(g, w, TOL["f32_op"])
    y, z = _x((2, 3, cfg.d_inner), 7), _x((2, 3, cfg.d_inner), 8)
    assert_close(ssm._gated_rmsnorm(torch.from_numpy(y), torch.from_numpy(z), p["norm_scale"], cfg.norm_eps),
                 ref_ssm._gated_rmsnorm(jnp.asarray(y), jnp.asarray(z), ref_p["norm_scale"], cfg.norm_eps),
                 TOL["f32_op"])


@pytest.mark.parametrize("s", [1, 3, 40, 256])
@pytest.mark.parametrize("name", CONFIGS)
def test_mamba_seq_equals_reference(name, s):
    """The whole-sequence block: output, final state and conv tail.  At 256
    tokens the reference scans in checkpointed chunks of 128
    (``ssm.py:132``), the port token by token."""
    ref_cfg, cfg, ref_p, p = _setup(name)
    u = _x((2, s, cfg.d_model), s)
    got = ssm.mamba_seq(p, torch.from_numpy(u), cfg)
    want = ref_ssm.mamba_seq(ref_p, jnp.asarray(u), ref_cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_close(g, w, TOL["f32_layer"])


@pytest.mark.parametrize("name", CONFIGS)
def test_mamba_step_equals_reference_and_continues_seq(name):
    """Decode steps against the reference's, from the state a sequence
    left; and inside the port, steps from zero state give the sequence
    block's outputs and final state."""
    ref_cfg, cfg, ref_p, p = _setup(name)
    u = _x((2, 9, cfg.d_model), 11)
    _, ref_state, ref_tail = ref_ssm.mamba_seq(ref_p, jnp.asarray(u[:, :6]), ref_cfg)
    _, state, tail = ssm.mamba_seq(p, torch.from_numpy(u[:, :6]), cfg)
    for t in range(6, 9):
        want, ref_tail, ref_state = ref_ssm.mamba_step(ref_p, jnp.asarray(u[:, t : t + 1]), ref_tail, ref_state,
                                                       ref_cfg)
        got, tail, state = ssm.mamba_step(p, torch.from_numpy(u[:, t : t + 1]), tail, state, cfg)
        assert_close(got, want, TOL["f32_layer"])
        assert_close(state, ref_state, TOL["f32_layer"])
        assert_close(tail, ref_tail, TOL["f32_op"])
    ys, want_state, _ = ssm.mamba_seq(p, torch.from_numpy(u), cfg)
    state, conv = ssm.init_ssm_state(cfg, 2, device="cpu")
    for t in range(9):
        y, conv, state = ssm.mamba_step(p, torch.from_numpy(u[:, t : t + 1]), conv, state, cfg)
        assert_close(y, ys[:, t : t + 1], TOL["f32_layer"])
    assert_close(state, want_state, TOL["f32_layer"])
