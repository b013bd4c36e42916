"""The expert-parallel MoE layer (``repro_torch.models.moe_ep``) against the
reference's single-device layer: ``tests/test_moe_ep.py`` ported.

The reference's weights and ``x`` (``qwen2-moe-a2.7b-reduced``, 4 experts
top-2, float32) cross to the port through the bridge; the port's layer runs
over 8 ``gloo`` ranks (2 data x 4 model) in a subprocess
(``tests/_torch_spmd.py``), and the reference's single-device
``moe_layer(..., capacity=64)`` runs here.  At ``capacity_factor=8`` no
bucket drops an item, so every mode and body computes the single-device
layer: logical and scheduled, scatter and grouped bodies, pinned slot
weights; ``aux["load"]`` is the reference AEBS's load of each data shard's
tokens, max'd over the shards, exactly; and the logical layer's gradients
are ``jax.grad``'s of the single-device layer."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import TOL
from _torch_spmd import flatten, unflatten
from repro.configs import get_config as ref_get_config
from repro.core.aebs import ReplicaLayout, aebs_assign
from repro.models import moe as ref_moe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.subprocess


def run_ranks(case, world, inputs, tmp_path, timeout=300):
    """Run ``case`` of ``tests/_torch_spmd.py`` over ``world`` gloo ranks."""
    src, out = tmp_path / f"{case}_in.npz", tmp_path / f"{case}_{world}_out.npz"
    np.savez(src, **inputs)
    cmd = [sys.executable, "-c", "import _torch_spmd; _torch_spmd.main()", case, str(world), str(src), str(out)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def wait_ranks(proc, out, timeout=300):
    log, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, log[-6000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    cfg = ref_get_config("qwen2-moe-a2.7b-reduced")
    params = ref_moe.init_moe(cfg, jax.random.PRNGKey(0), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model), jnp.float32) * 0.3
    inputs = {"x": np.asarray(x), **{f"p/{k}": np.asarray(v) for k, v in flatten(params).items()}}
    proc, out = run_ranks("moe_ep", 8, inputs, tmp_path_factory.mktemp("moe_ep"))
    y_ref = ref_moe.moe_layer(params, x, cfg, capacity=64)
    grads = jax.grad(lambda p: jnp.sum(ref_moe.moe_layer(p, x, cfg, capacity=64) ** 2))(params)
    # the reference AEBS over each data shard's tokens, max'd over the shards
    layout = ReplicaLayout.round_robin(cfg.num_experts, 4, 2)
    loads = []
    for shard in (x[:2], x[2:]):
        _, eids, _ = ref_moe.route(params["router"], shard.reshape(-1, cfg.d_model), cfg.top_k)
        loads.append(np.asarray(aebs_assign(eids, layout.device_tables(), 4)[1]))
    got = wait_ranks(proc, out)
    return got, np.asarray(y_ref), np.max(loads, axis=0), {k: np.asarray(v) for k, v in flatten(grads).items()}


@pytest.mark.parametrize("case", ["logical_scatter", "logical_grouped", "scheduled_scatter", "scheduled_grouped",
                                  "pinned"])
def test_ep_matches_single_device_layer(ep_run, case):
    got, y_ref, _, _ = ep_run
    assert got[case].shape == y_ref.shape
    np.testing.assert_allclose(got[case], y_ref, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("body", ["scatter", "grouped", "pinned"])
def test_ep_load_equals_reference_aebs(ep_run, body):
    got, _, load_ref, _ = ep_run
    np.testing.assert_array_equal(got[f"load_{body}"], load_ref)


def test_ep_gradients_equal_jax_grad(ep_run):
    got, _, _, grads_ref = ep_run
    grads = {k[len("grad/"):]: v for k, v in got.items() if k.startswith("grad/")}
    assert set(grads) == set(grads_ref)
    for k, g in grads_ref.items():
        assert np.abs(g).sum() > 0, k
        np.testing.assert_allclose(grads[k], g, atol=TOL["f32_layer"], rtol=TOL["f32_layer"], err_msg=k)


def test_unflatten_inverts_flatten():
    tree = {"a": {"b": np.zeros(2), "c": {"d": np.ones(1)}}, "e": np.arange(3)}
    assert flatten(unflatten(flatten(tree))).keys() == flatten(tree).keys()
