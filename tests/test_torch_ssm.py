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
import torch.utils.checkpoint

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


# ---------------------------------------------------------------------------
# the chunked, checkpointed scan under autograd (the reference's
# ``_chunked_scan``, ``ssm.py:132``)
# ---------------------------------------------------------------------------


def _leaf_params(p):
    return {k: v.clone().requires_grad_() for k, v in p.items()}


def _seq_loss_and_grads(p, u, cfg, remat=False):
    """``mamba_seq``'s outputs, and the gradients of a loss over its output
    and final state with respect to the input and every weight."""
    leaves, uu = _leaf_params(p), torch.from_numpy(u).requires_grad_()

    def f(x):
        return ssm.mamba_seq(leaves, x, cfg)

    y, h, tail = torch.utils.checkpoint.checkpoint(f, uu, use_reentrant=False) if remat else f(uu)
    r_y, r_h = _loss_weights(y.shape, h.shape)
    loss = (y * torch.from_numpy(r_y)).sum() + (h * torch.from_numpy(r_h)).sum()
    return (y, h, tail), torch.autograd.grad(loss, [uu, *leaves.values()])


def _loss_weights(y_shape, h_shape):
    """Fixed random weights of a linear loss over the output and the final
    state, small enough that the gradients stay of order one."""
    rng = np.random.default_rng(17)
    return tuple((rng.standard_normal(tuple(shape)) * 0.01).astype(np.float32) for shape in (y_shape, h_shape))


@pytest.mark.parametrize("name", CONFIGS)
def test_chunked_scan_equals_token_loop_bitwise(name, monkeypatch):
    """At 256 tokens under autograd the scan runs two checkpointed chunks of
    ``SSM_CHUNK`` (and the conv and the Mamba-2 output block their own
    checkpoints); the outputs and every gradient equal the plain token
    loop's bit for bit in float32, and nested inside a non-reentrant
    checkpoint (a layer period under ``remat``) they equal the unnested
    ones."""
    _, cfg, _, p = _setup(name)
    u = _x((2, 256, cfg.d_model), 21)
    lengths = []
    loop = ssm._loop

    def spy(step, h, xs, q):
        lengths.append(xs[0].shape[1])
        return loop(step, h, xs, q)

    monkeypatch.setattr(ssm, "_loop", spy)
    outs, grads = _seq_loss_and_grads(p, u, cfg)
    assert ssm.SSM_CHUNK == ref_ssm.SSM_CHUNK == 128
    assert lengths and set(lengths) == {ssm.SSM_CHUNK}  # forward and recompute, chunk by chunk
    nested_outs, nested_grads = _seq_loss_and_grads(p, u, cfg, remat=True)
    monkeypatch.setattr(ssm, "_scan", lambda step, h, xs, q: loop(step, h, xs, q))
    monkeypatch.setattr(ssm, "checkpointed", lambda fn, *args: fn(*args))  # the conv and the output too
    flat_outs, flat_grads = _seq_loss_and_grads(p, u, cfg)
    for a, b, c in zip((*outs, *grads), (*flat_outs, *flat_grads), (*nested_outs, *nested_grads)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.fixture(scope="module")
def reference_seq_grads():
    """The reference's ``mamba_seq`` loss and gradients (input and every
    weight) through ``jax.value_and_grad``, per config and length."""
    cache = {}

    def get(name, s):
        if (name, s) not in cache:
            ref_cfg, cfg, ref_p, p = _setup(name)
            u = _x((2, s, cfg.d_model), s + 1)

            def loss(u, q):
                y, h, _ = ref_ssm.mamba_seq(q, u, ref_cfg)
                r_y, r_h = _loss_weights(y.shape, h.shape)
                return jnp.sum(y * r_y) + jnp.sum(h * r_h)

            val, (gu, gp) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(u), ref_p)
            cache[name, s] = cfg, p, u, val, [gu, *(gp[k] for k in p)]
        return cache[name, s]

    return get


@pytest.mark.parametrize("s", [200, 256])
@pytest.mark.parametrize("name", CONFIGS)
def test_mamba_seq_grads_equal_reference(name, s, reference_seq_grads):
    """The gradients of the block against ``jax.value_and_grad`` of the
    reference's: at 256 tokens both packages scan in checkpointed chunks of
    128, at 200 (not a whole number of chunks) both run the flat loop.  (The
    nested checkpoint is bitwise the unnested one, above; the whole model
    under ``remat`` is in ``tests/test_torch_train_archs.py``.)"""
    cfg, p, u, want, want_grads = reference_seq_grads(name, s)
    (y, h, _), grads = _seq_loss_and_grads(p, u, cfg)
    r_y, r_h = _loss_weights(y.shape, h.shape)
    assert_close((y * torch.from_numpy(r_y)).sum() + (h * torch.from_numpy(r_h)).sum(), want, TOL["f32_layer"])
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert tuple(g.shape) == w.shape
        assert_close(g, w, TOL["f32_layer"])


def _scan_inputs(name, s):
    """``(step, h0, xs as leaves that require grad, weights as leaves)``:
    what ``mamba_seq`` hands the scan, at ``s`` tokens."""
    _, cfg, _, p = _setup(name)
    got = {}

    def grab(step, h, xs, q):
        got.update(step=step, h=h, xs=xs)
        return ssm._loop(step, h, xs, q)

    scan = ssm._scan
    ssm._scan = grab
    try:
        with torch.no_grad():
            ssm.mamba_seq(p, torch.from_numpy(_x((2, s, cfg.d_model), 5)), cfg)
    finally:
        ssm._scan = scan
    return got["step"], got["h"], [a.clone().requires_grad_() for a in got["xs"]], _leaf_params(p)


def _nbytes(tensors):
    return sum(t.untyped_storage().nbytes() for t in tensors)


def _saved_bytes(step, h0, xs, p):
    """The bytes of the storages autograd saves for backward over a run of
    the token loop, other than its inputs (``saved_tensors_hooks``)."""
    inputs = {t.untyped_storage()._cdata for t in (h0, *xs, *p.values())}
    saved = {}

    def pack(t):
        if t.untyped_storage()._cdata not in inputs:
            saved[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _, ys = ssm._loop(step, h0, xs, p)
    return sum(saved.values()), ys


@pytest.mark.parametrize("name", CONFIGS)
def test_scan_holds_carries_and_one_chunk(name):
    """What the scan of ``mamba1_seq`` (falcon-mamba) and ``mamba2_seq``
    (zamba2) holds for backward, at 256 and 512 tokens.  The token loop
    saves every step's tensors (``saved_tensors_hooks``: the storages
    autograd keeps other than the loop's inputs), so what it holds doubles
    with the sequence.  The chunked scan's peak over forward and backward
    (``MemTracker``), less its sequence-sized tensors (inputs, outputs and
    their gradients), is at most the carries at the chunks' starts, one
    chunk's saved steps and two chunks of sequence-sized transients, and
    grows under 1.25x from 256 to 512 tokens; the loop's saved bytes alone
    pass that bound."""
    from torch.distributed._tools.mem_tracker import MemTracker

    one_chunk, ys = _saved_bytes(*_scan_inputs(name, ssm.SSM_CHUNK))
    step, h0, xs, _ = _scan_inputs(name, ssm.SSM_CHUNK)
    chunk_io = 2 * (_nbytes(xs) + _nbytes([ys]))

    held, loop_saved = {}, {}
    for s in (256, 512):
        step, h0, xs, p = _scan_inputs(name, s)
        loop_saved[s], ys = _saved_bytes(step, h0, xs, p)
        mt = MemTracker()
        mt.track_external(*xs, *p.values())
        with mt:
            h, ys = ssm._scan(step, h0, xs, p)
            torch.autograd.grad(ys.square().sum() + h.sum(), [*xs, *p.values()], allow_unused=True)
        peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
        held[s] = peak - 2 * (_nbytes(xs) + _nbytes([ys]))
        bound = (s // ssm.SSM_CHUNK) * _nbytes([h0]) + one_chunk + 2 * chunk_io
        assert 0 < held[s] <= bound < loop_saved[s], (s, held[s], bound, loop_saved[s])
    assert held[512] < 1.25 * held[256]
    assert loop_saved[512] > 1.9 * loop_saved[256]


@pytest.mark.parametrize("name", CONFIGS)
def test_serving_prefill_runs_the_token_loop(name, monkeypatch):
    """Without autograd (the engine's prefill) a 256-token block launches
    the token loop's ops, one for one, as before the scan chunked: under
    ``torch.no_grad()``, and with grad mode on over weights that do not
    require grad."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, cfg, _, p = _setup(name)
    u = torch.from_numpy(_x((2, 256, cfg.d_model), 9))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def ops_of(no_grad):
        with Ops() as rec, (torch.no_grad() if no_grad else torch.enable_grad()):
            ssm.mamba_seq(p, u, cfg)
        return rec.ops

    got = [ops_of(True), ops_of(False)]
    loop = ssm._loop
    monkeypatch.setattr(ssm, "_scan", lambda step, h, xs, q: loop(step, h, xs, q))
    want = ops_of(True)
    assert got[0] == want and got[1] == want
    assert len(want) > 256 * 10
