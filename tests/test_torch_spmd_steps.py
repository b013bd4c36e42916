"""The port's sharded steps (``repro_torch.launch.steps.build_{train,prefill,
serve}_step``) against the reference's own sharded steps.

One JAX subprocess with 8 forced host devices runs the reference's builders
on a 2 x 4 ``("data", "model")`` mesh; one torch subprocess runs the port's
over 8 ``gloo`` ranks on the same mesh (``tests/_torch_spmd.py``), and
another over one rank (a 1 x 1 mesh); all three start together.  The
reference's weights (float32, drawn here) cross through the bridge, as do
the tokens and the decode caches (seeded normals, every slot decoding from
row 20 of 32).  The weights are seeded normals (x 0.1) in the reference's
tree.  ``dsv2-lite-reduced`` runs all three steps (its MoE layers
on logical expert parallelism for train and prefill, AEBS over pinned slots
for decode; its KV heads split over the model axis); the serve step also
runs ``phi4-mini-3.8b-reduced``, whose 2 KV heads do not divide the model
axis, so its caches split over their rows (context parallelism).

Held to ``TOL["f32_layer"]``: caches, train loss, grad norm and the
updated weights; next tokens and prefill tokens equal.  The 1 x 1 mesh
gives the 2 x 4 mesh's prefill tokens, decode tokens and caches.  Its
training step is held to the reference's on a 1 x 1 mesh instead: the MoE
capacity is a budget per data shard (``moe_ep.py:123-127``), and at these
sizes an expert of a 2 x 4 shard overflows where the whole batch's does not
(losses part by 4.6e-4), in the reference as in the port.

The reference's steps run on a mesh of ``Auto`` axes: under this JAX's
default explicit axes its training step's layer scan refuses the sharded
residual its expert-parallel layer returns (the carry's type changes)."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_parity import TOL
from _torch_spmd import flatten
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.subprocess

MOE, DENSE = "dsv2-lite-reduced", "phi4-mini-3.8b-reduced"
CASES = [f"{MOE}/train", f"{MOE}/prefill", f"{MOE}/decode", f"{DENSE}/decode"]
B, S, ROWS, INDEX, STEPS = 4, 32, 32, 20, 3

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, numpy as np
sys.path.insert(0, os.path.join(sys.argv[3], "tests"))
from _torch_spmd import flatten, unflatten
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import steps
from repro.launch.mesh import use_mesh
from repro.training.optimizer import init_opt_state

d = dict(np.load(sys.argv[1]))
B, S = d["train_tokens"].shape
auto = (jax.sharding.AxisType.Auto,) * 2
meshes = {8: jax.make_mesh((2, 4), ("data", "model"), axis_types=auto),
          1: jax.make_mesh((1, 1), ("data", "model"), axis_types=auto, devices=jax.devices()[:1])}
out = {}


def params(arch):
    # host arrays: each jitted step places them by its own in_shardings
    return unflatten({k[len(f"p/{arch}/"):]: v for k, v in d.items() if k.startswith(f"p/{arch}/")})


def train(arch, cfg, mesh, tag):
    step, _ = steps.build_train_step(cfg, mesh, InputShape("train", S, B, "train"))
    p = params(arch)
    st = jax.tree.map(np.asarray, init_opt_state(p))
    batch = {"tokens": d["train_tokens"], "labels": d["train_labels"]}
    for i in range(2):
        p, st, info = step(p, st, batch)
        out[f"{tag}/train/loss{i}"] = np.asarray(info["loss"])
        out[f"{tag}/train/grad_norm{i}"] = np.asarray(info["grad_norm"])
    out.update(flatten({f"{tag}/train/params": jax.tree.map(np.asarray, p)}))


def prefill(arch, cfg, mesh):
    step, _ = steps.build_prefill_step(cfg, mesh, InputShape("prefill", S, B, "prefill"))
    tok, caches = step(params(arch), {"tokens": d["prefill_tokens"]})
    out[f"{arch}/prefill/tok"] = np.asarray(tok)
    out.update(flatten({f"{arch}/prefill/caches": jax.tree.map(np.asarray, caches)}))


def decode(arch, cfg, mesh):
    step, _ = steps.build_serve_step(cfg, mesh, InputShape("decode", int(d["cache_rows"]), B, "decode"))
    p = params(arch)
    if cfg.has_moe:
        stx = steps.serving_layout(cfg, 4).slot_to_expert.reshape(-1)
        p = jax.tree.map(np.asarray, steps.materialize_slot_params(p, cfg, stx))
    caches = {k[len(f"c/{arch}/"):]: v for k, v in d.items() if k.startswith(f"c/{arch}/")}
    tok, toks = d["decode_tokens"], []
    for i in range(int(d["decode_steps"])):
        nxt, caches = step(p, tok, np.int32(int(d["cache_index"]) + i), caches)
        tok = np.asarray(nxt)[:, None]
        toks.append(tok)
    out[f"{arch}/decode/tokens"] = np.concatenate(toks, axis=1)
    out.update(flatten({f"{arch}/decode/caches": jax.tree.map(np.asarray, caches)}))


for case in d["cases"]:
    arch, kind = str(case).split("/")
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    with use_mesh(meshes[8]):
        {"train": lambda: train(arch, cfg, meshes[8], arch), "prefill": lambda: prefill(arch, cfg, meshes[8]),
         "decode": lambda: decode(arch, cfg, meshes[8])}[kind]()
    if kind == "train":
        # training's capacity is per data shard, so the 1 x 1 mesh has its own step
        with use_mesh(meshes[1]):
            train(arch, cfg, meshes[1], f"1x1/{arch}")
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    d = {"cases": np.array(CASES), "cache_rows": np.int64(ROWS), "cache_index": np.int64(INDEX),
         "decode_steps": np.int64(STEPS)}
    for arch in (MOE, DENSE):
        cfg = dataclasses.replace(ref_get_config(arch), dtype="float32")
        # the reference's tree (eval_shape of its init_params), seeded normals
        params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                              ref_steps.abstract_params(cfg))
        d.update({f"p/{arch}/{k}": v for k, v in flatten(params).items()})
        from repro.configs.base import _cache_specs

        for k, s in _cache_specs(cfg, B, ROWS, np.float32).items():
            d[f"c/{arch}/{k}"] = (rng.standard_normal(s.shape) * 0.5).astype(np.float32)
    vocab = min(ref_get_config(a).vocab_size for a in (MOE, DENSE))
    d["train_tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    d["train_labels"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    d["prefill_tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    d["decode_tokens"] = rng.integers(0, vocab, (B, 1)).astype(np.int32)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_steps")
    src = tmp / "in.npz"
    np.savez(src, **_inputs())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]),
               JAX_PLATFORMS="cpu")
    procs = {"ref": (subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(src), str(tmp / "ref.npz"), ROOT],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True), tmp / "ref.npz")}
    for world in (8, 1):
        out = tmp / f"port{world}.npz"
        cmd = [sys.executable, "-c", "import _torch_spmd; _torch_spmd.main()", "steps", str(world), str(src), str(out)]
        procs[world] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), out)
    res = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}:\n{log[-6000:]}"
        res[name] = dict(np.load(out))
    return res


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL["f32_layer"], rtol=TOL["f32_layer"], err_msg=what)


def _group(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("world", [8, 1])
def test_train_step_equals_reference(runs, world):
    """Two steps: loss, grad norm, and every updated weight, against the
    reference's step on the same mesh shape."""
    got, want, ref = runs[world], runs["ref"], MOE if world == 8 else f"1x1/{MOE}"
    for i in range(2):
        _close(got[f"{MOE}/train/loss{i}"], want[f"{ref}/train/loss{i}"], f"loss {i}")
        _close(got[f"{MOE}/train/grad_norm{i}"], want[f"{ref}/train/grad_norm{i}"], f"grad_norm {i}")
    gp, wp = _group(got, f"{MOE}/train/params/"), _group(want, f"{ref}/train/params/")
    assert set(gp) == set(wp) and len(wp) > 10
    for k in wp:
        _close(gp[k], wp[k], k)


@pytest.mark.parametrize("world", [8, 1])
def test_prefill_step_equals_reference(runs, world):
    got, want = runs[world], runs["ref"]
    np.testing.assert_array_equal(got[f"{MOE}/prefill/tok"], want[f"{MOE}/prefill/tok"])
    gc, wc = _group(got, f"{MOE}/prefill/caches/"), _group(want, f"{MOE}/prefill/caches/")
    assert set(gc) == set(wc) == {"kv_k", "kv_v"}
    for k in wc:
        assert gc[k].shape == wc[k].shape
        _close(gc[k], wc[k], k)


@pytest.mark.parametrize("arch", [MOE, DENSE])
@pytest.mark.parametrize("world", [8, 1])
def test_serve_step_equals_reference(runs, world, arch):
    got, want = runs[world], runs["ref"]
    np.testing.assert_array_equal(got[f"{arch}/decode/tokens"], want[f"{arch}/decode/tokens"])
    gc, wc = _group(got, f"{arch}/decode/caches/"), _group(want, f"{arch}/decode/caches/")
    assert set(gc) == set(wc)
    for k in wc:
        _close(gc[k], wc[k], k)


@pytest.mark.parametrize("case", ["straddle", "cross"])
def test_head_parallel_cases_equal_one_rank(runs, case):
    """Head-parallel attention the reference cases above do not reach, 2 x 4
    against 1 x 1: ``straddle``, a dense config whose ranks' query heads
    straddle KV groups (12 heads over 3 KV heads, 3 a rank: one KV head a
    query head), train and prefill steps; ``cross``, whisper-tiny-reduced's
    prefill step over its encoder's output (cross attention)."""
    got, want = runs[8], runs[1]
    if case == "straddle":
        _close(got["straddle/train/loss"], want["straddle/train/loss"], "loss")
    np.testing.assert_array_equal(got[f"{case}/prefill/tok"], want[f"{case}/prefill/tok"])
    for prefix in (("straddle/train/params/",) if case == "straddle" else ()) + (f"{case}/prefill/caches/",):
        g, w = _group(got, prefix), _group(want, prefix)
        assert set(g) == set(w) and g
        for k in w:
            _close(g[k], w[k], prefix + k)
