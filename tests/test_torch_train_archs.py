"""Training on every assigned config's ``-reduced`` variant, in float32,
against the reference (``tests/test_arch_smoke.py::test_one_train_step``'s
case in the port): ``loss_fn``'s loss and every gradient leaf against
``jax.value_and_grad``'s with the reference's weights carried over by
``repro_torch.bridge``, and one ``adamw_update`` moving every parameter.

The families' own paths are on it: GQA, GeGLU and GELU FFNs, MoE layers on
the einsum dispatch with their load-balance loss, gemma2's window and
softcaps, the Mamba token loop (falcon-mamba), zamba2's weight-tied shared
block (one leaf used by every hybrid layer: its gradient is the sum over
its uses), whisper's encoder and cross attention over the stub frames, and
pixtral's patch rows spliced over a prompt's first positions.
``dsv2-lite-reduced`` is ``tests/test_torch_training.py``'s."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close
from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.models import model
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.training import optimizer

ARCHS = sorted(ASSIGNED)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_assigned_configs_are_the_references():
    assert ARCHS == sorted(REF_ASSIGNED)


def _extra(cfg):
    """``tests/test_arch_smoke.py:16``'s frontend stubs (0.01 everywhere,
    rounded to bf16 as there), in the config's dtype, as numpy arrays."""
    extra = {}
    if cfg.frontend == "audio_frames":
        extra["encoder_frames"] = (B, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend == "vision_patches":
        extra["patch_embeds"] = (B, cfg.num_patch_tokens, cfg.d_model)
    return {k: np.asarray(jnp.full(shape, 0.01, jnp.bfloat16)).astype(np.float32) for k, shape in extra.items()}


@functools.lru_cache(maxsize=None)
def reference_case(name):
    """``(ref_params, cfg, tokens, labels, extra, loss, lb_loss, grads)``:
    the reference's loss and gradients, once per config."""
    ref_cfg = dataclasses.replace(ref_get_config(name + "-reduced"), dtype="float32")
    cfg = dataclasses.replace(get_config(name + "-reduced"), dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, 0)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    extra = _extra(cfg)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, jnp.asarray(tokens), jnp.asarray(labels), ref_cfg,
                                    extra={k: jnp.asarray(v) for k, v in extra.items()} or None),
        has_aux=True,
    )(ref_params)
    return ref_params, cfg, tokens, labels, extra, loss, aux["lb_loss"], grads


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_grads_and_update_equal_reference(name, remat):
    """With ``remat`` each layer period (gemma2's local/global pair,
    zamba2's shared-block period) is recomputed in the backward pass."""
    ref_params, cfg, tokens, labels, extra, want, want_lb, ref_grads = reference_case(name)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = model.loss_fn(params, torch.from_numpy(tokens), torch.from_numpy(labels), cfg,
                              extra={k: torch.from_numpy(v) for k, v in extra.items()} or None, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)

    assert_close(loss, want, TOL["f32_layer"])
    assert_close(aux["lb_loss"], want_lb, TOL["f32_op"])
    assert cfg.has_moe or float(aux["lb_loss"]) == 0.0
    want_grads = tree_leaves(bridge.params_from_jax(jax.tree.map(np.asarray, ref_grads)))
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert_close(g, w, TOL["f32_layer"])

    before = [p.clone() for p in leaves]
    _, state, info = optimizer.adamw_update(optimizer.AdamWConfig(), params, tree_unflatten(params, grads),
                                            optimizer.init_opt_state(params))
    assert np.isfinite(float(info["grad_norm"])) and float(info["grad_norm"]) > 0
    assert int(state.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves))
