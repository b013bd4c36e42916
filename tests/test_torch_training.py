"""The port's training path (``repro_torch.training``, ``models/model.py``'s
loss, ``moe.load_balance_loss``, ``transformer.forward``'s aux and remat,
``launch/train.py``) against the reference's, on the CPU.

Covered: ``TokenPipeline`` batches bit for bit; ``lr_schedule`` (bit for
bit through the warmup);
``global_norm`` and ``adamw_update`` on small float32 and bfloat16 trees,
clipped and not; ``load_balance_loss``; on ``dsv2-lite-reduced`` in float32
with the reference's weights carried over by ``repro_torch.bridge``: the
loss, ``lb_loss`` and every gradient leaf against ``jax.value_and_grad``,
remat on = off, ``chunked_xent`` = ``cross_entropy`` = the reference's, and
three ``make_train_step`` steps against the reference's params, moments and
``info``; bridged bfloat16 leaves through a train step; the checkpoint
round trip and resume (six steps = three, save, load, three); ``train``
lowering the loss; and the CLI on ``--device cpu``."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, assert_one_rounding
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training.train_loop import make_train_step as ref_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import model, moe
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.training import checkpoint, data, optimizer
from repro_torch.training.train_loop import make_train_step, train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data, schedule, optimizer, load-balance loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (1000, 64, 4, 3, 17), (1000, 64, 4, 3, 0), (512, 32, 2, 0, 5), (102400, 16, 3, 7, 123), (97, 8, 1, 11, 2),
])
def test_token_pipeline_bitwise(vocab, seq, batch, seed, step):
    want = ref_data.TokenPipeline(ref_data.DataConfig(vocab, seq, batch, seed)).batch(step)
    got = data.TokenPipeline(data.DataConfig(vocab, seq, batch, seed)).batch(step)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cfg", [
    dict(), dict(lr=1e-3, warmup_steps=10, total_steps=100), dict(warmup_steps=0, total_steps=1),
    dict(warmup_steps=100, total_steps=8),
], ids=["default", "short", "no-warmup", "warmup-past-end"])
def test_lr_schedule_equals_reference(cfg):
    """Every step of warmup and 20 past the end (the default config's 10,000
    decay steps every 37th), each a scalar call as ``adamw_update`` makes:
    float32 throughout, bit for bit through the warmup; in the decay XLA's
    and torch's float32 ``cos`` part in the last bit at a few steps."""
    ref_cfg, port_cfg = ref_opt.AdamWConfig(**cfg), optimizer.AdamWConfig(**cfg)
    end = port_cfg.total_steps + 20
    steps = np.unique(np.concatenate([np.arange(0, min(end, 150)), np.arange(0, end, 37), [end - 1]]))
    want = np.stack([np.asarray(ref_opt.lr_schedule(ref_cfg, jnp.int32(s))) for s in steps])
    got = np.stack([optimizer.lr_schedule(port_cfg, torch.tensor(int(s), dtype=torch.int32)).numpy()
                    for s in steps])
    assert got.dtype == np.float32
    warm = steps < port_cfg.warmup_steps
    np.testing.assert_array_equal(got[warm], want[warm])
    np.testing.assert_allclose(got, want, rtol=TOL["f32_op"], atol=0)


def _small_tree(rng, dtype, scale=1.0):
    """A nested tree of dicts and lists with one float32 leaf beside ``dtype``
    ones, as numpy arrays."""
    def leaf(shape, dt=dtype):
        return (rng.standard_normal(shape) * scale).astype(dt)

    return {"a": leaf((5, 3)), "b": [leaf((4,)), leaf((2, 2, 2), np.float32)], "c": {"d": leaf((3, 7))}}


def _to_torch(tree):
    return tree_map(bridge.tensor_from_numpy, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 100.0], ids=["unclipped", "clipped"])
def test_global_norm_and_adamw_equal_reference(dtype, grad_scale):
    """Four AdamW steps: params, moments and ``info`` against the reference's
    (``TOL["f32_op"]``; bf16 params within one rounding of the reference's
    f32 result).  The larger gradients are clipped (``grad_norm`` > 1)."""
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(0)
    p_np = _small_tree(rng, npdt)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1)
    ref_cfg, port_cfg = ref_opt.AdamWConfig(**cfg), optimizer.AdamWConfig(**cfg)
    rp = jax.tree.map(jnp.asarray, p_np)
    rs = ref_opt.init_opt_state(rp)
    tp = _to_torch(p_np)
    ts = optimizer.init_opt_state(tp)
    assert all(m.dtype == torch.float32 for m in tree_leaves(ts.mu) + tree_leaves(ts.nu))
    for _ in range(4):
        g_np = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * grad_scale).astype(a.dtype), p_np)
        assert_close(optimizer.global_norm(_to_torch(g_np)), ref_opt.global_norm(jax.tree.map(jnp.asarray, g_np)),
                     TOL["f32_op"])
        rp, rs, rinfo = ref_opt.adamw_update(ref_cfg, rp, jax.tree.map(jnp.asarray, g_np), rs)
        before = [t.clone() for t in tree_leaves(tp)]
        out, ts, info = optimizer.adamw_update(port_cfg, tp, _to_torch(g_np), ts)
        assert out is tp and any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))  # in place
        assert (float(info["grad_norm"]) > 1.0) == (grad_scale > 1.0)
        assert_close(info["grad_norm"], rinfo["grad_norm"], TOL["f32_op"])
        assert_close(info["lr"], rinfo["lr"], TOL["f32_op"])
        assert int(ts.step) == int(rs.step)
        # the reference flattens dicts by sorted key: map its leaves by path
        for path in (("a",), ("b", 0), ("b", 1), ("c", "d")):
            def at(tree):
                for k in path:
                    tree = tree[k]
                return tree

            for mine, ref in ((at(ts.mu), at(rs.mu)), (at(ts.nu), at(rs.nu))):
                assert_close(mine, ref, TOL["f32_op"])
            if at(tp).dtype == torch.bfloat16:
                assert_one_rounding(at(tp), np.asarray(at(rp)).astype(np.float32))
            else:
                assert_close(at(tp), at(rp), TOL["f32_op"])


def test_load_balance_loss_equals_reference():
    rng = np.random.default_rng(4)
    for T, k, E in ((16, 2, 4), (48, 6, 64), (5, 1, 3)):
        logits = rng.standard_normal((T, E)).astype(np.float32)
        probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        eids = np.argsort(-probs, axis=-1)[:, :k].astype(np.int32)
        want = ref_moe.load_balance_loss(jnp.asarray(probs), jnp.asarray(eids), E)
        got = moe.load_balance_loss(torch.from_numpy(probs), torch.from_numpy(eids), E)
        assert_close(got, want, TOL["f32_op"])


# ---------------------------------------------------------------------------
# dsv2-lite-reduced in float32 with the reference's weights
# ---------------------------------------------------------------------------

B, S = 2, 16


def bridged(name, dtype="float32", seed=0):
    """``(ref_cfg, cfg, reference params, port params)`` from the reference's
    draw of ``seed``."""
    ref_cfg = dataclasses.replace(ref_get_config(name), dtype=dtype)
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    ref_params = ref_model.init_params(ref_cfg, seed)
    return ref_cfg, cfg, ref_params, bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))


def batch_of(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def port_value_and_grad(params, tokens, labels, cfg, **kw):
    """``(loss, aux, grads)`` with grads in ``params``' tree."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = model.loss_fn(params, torch.from_numpy(tokens), torch.from_numpy(labels), cfg, **kw)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), aux, tree_unflatten(params, grads)


def assert_grads_close(grads, ref_grads, tol):
    """Every gradient leaf of the port's tree against the reference's
    (converted with ``bridge.params_from_jax``)."""
    want = bridge.params_from_jax(jax.tree.map(np.asarray, ref_grads))
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        assert_close(g, w, tol)


@pytest.fixture(scope="module")
def dsv2():
    ref_cfg, cfg, ref_params, params = bridged("dsv2-lite-reduced")
    tokens, labels = batch_of(cfg)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, jnp.asarray(tokens), jnp.asarray(labels), ref_cfg), has_aux=True
    )(ref_params)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params, params=params, tokens=tokens, labels=labels,
                ref_loss=loss, ref_lb=aux["lb_loss"], ref_grads=grads)


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
def test_loss_and_grads_equal_reference(dsv2, remat):
    loss, aux, grads = port_value_and_grad(dsv2["params"], dsv2["tokens"], dsv2["labels"], dsv2["cfg"], remat=remat)
    assert_close(loss, dsv2["ref_loss"], TOL["f32_layer"])
    assert_close(aux["lb_loss"], dsv2["ref_lb"], TOL["f32_op"])
    assert aux["enc_out"] is None
    assert_grads_close(grads, dsv2["ref_grads"], TOL["f32_layer"])


def test_remat_equals_no_remat(dsv2):
    """Recomputing each layer in the backward pass changes no number beyond
    f32 noise (a tied leaf such as ``embed`` may sum its uses in another
    order)."""
    on = port_value_and_grad(dsv2["params"], dsv2["tokens"], dsv2["labels"], dsv2["cfg"], remat=True)
    off = port_value_and_grad(dsv2["params"], dsv2["tokens"], dsv2["labels"], dsv2["cfg"], remat=False)
    assert_close(on[0], off[0], TOL["f32_op"])
    for a, b in zip(tree_leaves(on[2]), tree_leaves(off[2])):
        assert_close(a, b, TOL["f32_op"])


def test_training_runs_the_einsum_dispatch_unless_asked(dsv2, monkeypatch):
    """``loss_fn`` passes ``dispatch="einsum"`` to every MoE layer (the
    reference's default), and a caller's ``moe_ctx`` overrides it."""
    seen = []
    real = moe.moe_layer

    def spy(*args, **kwargs):
        seen.append(kwargs.get("dispatch"))
        return real(*args, **kwargs)

    monkeypatch.setattr(moe, "moe_layer", spy)
    cfg, t = dsv2["cfg"], torch.from_numpy(dsv2["tokens"])
    model.loss_fn(dsv2["params"], t, torch.from_numpy(dsv2["labels"]), cfg)
    assert seen == ["einsum"] * cfg.num_layers
    seen.clear()
    model.logits_fn(dsv2["params"], t, cfg, extra={"moe_ctx": {"dispatch": "scatter"}})
    assert seen == ["scatter"] * cfg.num_layers


@pytest.mark.parametrize("chunk", [4, 8, 5, 64], ids=["4", "8", "fallback-5", "past-S"])
def test_chunked_xent_equals_cross_entropy_and_reference(dsv2, chunk):
    cfg, ref_cfg = dsv2["cfg"], dsv2["ref_cfg"]
    tokens, labels = dsv2["tokens"], dsv2["labels"]
    from repro.models import transformer as ref_transformer
    from repro_torch.models import transformer

    x, _, _ = transformer.forward(dsv2["params"], torch.from_numpy(tokens), cfg,
                                  extra=model._training_extra(None), with_aux=True)
    got = model.chunked_xent(dsv2["params"], x, torch.from_numpy(labels), cfg, chunk)
    whole = model.cross_entropy(transformer.lm_head(dsv2["params"], x, cfg), torch.from_numpy(labels))
    rx, _, _ = ref_transformer.forward(dsv2["ref_params"], jnp.asarray(tokens), ref_cfg)
    want = ref_model.chunked_xent(dsv2["ref_params"], rx, jnp.asarray(labels), ref_cfg, chunk)
    assert_close(got, whole, TOL["f32_op"])
    assert_close(got, want, TOL["f32_layer"])


def test_loss_fn_with_xent_chunk_equals_reference(dsv2):
    """``loss_fn(xent_chunk=4)``: loss and every gradient (the chunks'
    logits recomputed in the backward pass) against the reference's."""
    tokens, labels, ref_cfg = dsv2["tokens"], dsv2["labels"], dsv2["ref_cfg"]
    (want, _), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, jnp.asarray(tokens), jnp.asarray(labels), ref_cfg, xent_chunk=4),
        has_aux=True,
    )(dsv2["ref_params"])
    loss, _, grads = port_value_and_grad(dsv2["params"], tokens, labels, dsv2["cfg"], xent_chunk=4, remat=True)
    assert_close(loss, want, TOL["f32_layer"])
    assert_grads_close(grads, ref_grads, TOL["f32_layer"])


def test_three_train_steps_equal_reference():
    """Three ``make_train_step`` steps on the reference's data pipeline:
    params, moments and ``info`` after each step against the reference's
    step (run eagerly)."""
    ref_cfg, cfg, ref_params, params = bridged("dsv2-lite-reduced")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    ref_step = ref_make_train_step(ref_cfg, ref_opt.AdamWConfig(**opt), remat=False)
    step = make_train_step(cfg, optimizer.AdamWConfig(**opt))
    rs, ts = ref_opt.init_opt_state(ref_params), optimizer.init_opt_state(params)
    pipe = data.TokenPipeline(data.DataConfig(cfg.vocab_size, S, B, seed=5))
    for i in range(3):
        tokens, labels = pipe.batch(i)
        ref_params, rs, rinfo = ref_step(ref_params, rs, jnp.asarray(tokens), jnp.asarray(labels))
        params, ts, info = step(params, ts, torch.from_numpy(tokens), torch.from_numpy(labels))
        assert not any(p.requires_grad for p in tree_leaves(params))
        for key in ("loss", "grad_norm", "lr"):
            assert_close(info[key], rinfo[key], TOL["f32_layer"])
        assert_close(info["lb_loss"], rinfo["lb_loss"], TOL["f32_op"])
        assert int(ts.step) == int(rs.step) == i + 1
        for mine, ref in ((params, ref_params), (ts.mu, rs.mu), (ts.nu, rs.nu)):
            want = bridge.params_from_jax(jax.tree.map(np.asarray, ref))
            for a, b in zip(tree_leaves(mine), tree_leaves(want)):
                assert_close(a, b, TOL["f32_layer"])


def test_bridged_bfloat16_leaves_train():
    """``bridge.params_from_jax`` makes bf16 leaves as dtype views of int16
    tensors (not autograd views: no ``_base``); a train step sets
    ``requires_grad`` on them and updates them in place, and every one
    moves."""
    _, cfg, _, params = bridged("dsv2-lite-reduced", dtype="bfloat16")
    assert params["embed"].dtype == torch.bfloat16 and params["embed"]._base is None
    before = [p.clone() for p in tree_leaves(params)]
    step = make_train_step(cfg, optimizer.AdamWConfig(lr=1e-2, warmup_steps=1))
    tokens, labels = batch_of(cfg)
    params, state, info = step(params, optimizer.init_opt_state(params), torch.from_numpy(tokens),
                               torch.from_numpy(labels))
    assert np.isfinite(float(info["loss"])) and float(info["grad_norm"]) > 0
    # router and norm scales are float32; everything else is bf16 and moved
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))


# ---------------------------------------------------------------------------
# checkpoints, the loop, the CLI
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_exact(tmp_path):
    """Params (bf16 and f32 leaves, a list of layers) and the optimizer state
    come back bit for bit, in the port's tree; the file uses the
    reference's keys."""
    cfg = get_config("dsv2-lite-reduced")
    params = model.init_params(cfg, 3, device="cpu")
    state = optimizer.init_opt_state(params)
    tokens, labels = batch_of(cfg)
    params, state, _ = make_train_step(cfg, optimizer.AdamWConfig(warmup_steps=1))(
        params, state, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    checkpoint.save_checkpoint(str(tmp_path), 1, params)
    f = checkpoint.save_checkpoint(str(tmp_path), 12, params, state)
    assert f.endswith("ckpt_00000012.npz") and checkpoint.latest_checkpoint(str(tmp_path)) == f
    with np.load(f) as z:
        assert "params/embed::bf16" in z.files and "params/layers/0/moe/router" in z.files
        assert z["params/embed::bf16"].dtype == np.float32 and "opt/step" in z.files
    p2, opt = checkpoint.load_checkpoint(f, device="cpu")
    assert isinstance(p2["layers"], list) and len(p2["layers"]) == cfg.num_layers
    for mine, back in ((params, p2), (state.mu, opt["mu"]), (state.nu, opt["nu"])):
        a, b = tree_leaves(mine), tree_leaves(back)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1
    assert checkpoint.load_checkpoint(str(tmp_path / "ckpt_00000001.npz"), device="cpu")[1] is None


def test_checkpoint_resume_exact(tmp_path):
    """``test_training.py``'s resume case inside the port, on
    ``gemma2-2b-reduced``: six steps equal three, save, load, three more,
    bit for bit."""
    cfg = get_config("gemma2-2b-reduced")
    pipe = data.TokenPipeline(data.DataConfig(cfg.vocab_size, 32, 2, seed=7))
    step_fn = make_train_step(cfg, optimizer.AdamWConfig(total_steps=10), remat=False)

    def run(params, opt, lo, hi):
        for s in range(lo, hi):
            t, l = pipe.batch(s)
            params, opt, _ = step_fn(params, opt, torch.from_numpy(t), torch.from_numpy(l))
        return params, opt

    p0 = model.init_params(cfg, 0, device="cpu")
    p_full, o_full = run(p0, optimizer.init_opt_state(p0), 0, 6)
    p1 = model.init_params(cfg, 0, device="cpu")
    p_half, o_half = run(p1, optimizer.init_opt_state(p1), 0, 3)
    f = checkpoint.save_checkpoint(str(tmp_path), 3, p_half, o_half)
    p_load, o = checkpoint.load_checkpoint(f, device="cpu")
    p_resumed, o_resumed = run(p_load, optimizer.OptState(o["step"], o["mu"], o["nu"]), 3, 6)
    for mine, back in ((p_full, p_resumed), (o_full.mu, o_resumed.mu), (o_full.nu, o_resumed.nu)):
        for a, b in zip(tree_leaves(mine), tree_leaves(back)):
            assert torch.equal(a, b), "checkpoint resume diverged from continuous training"
    assert int(o_resumed.step) == 6


def test_train_loop_reduces_loss_dense():
    """``test_training.py::test_train_loop_reduces_loss_dense`` in the port."""
    cfg = get_config("phi4-mini-3.8b-reduced")
    logged = []
    res = train(cfg, steps=40, batch_size=4, seq_len=48, log_every=39, log_fn=logged.append, device="cpu")
    assert res["final_loss"] < res["first_loss"]
    assert [h[0] for h in res["history"]] == [0, 39] and len(logged) == 2
    assert set(res) == {"history", "final_loss", "first_loss", "wall_s", "params"}


def test_train_checkpoints_where_the_reference_does(tmp_path):
    cfg = get_config("dsv2-lite-reduced")
    train(cfg, steps=4, batch_size=2, seq_len=8, ckpt_dir=str(tmp_path), ckpt_every=2, log_fn=lambda *_: None,
          device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"ckpt_{s:08d}.npz" for s in (2, 4)]


def test_cli_prints_done_line(capsys):
    res = train_cli.main(["--arch", "dsv2-lite", "--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
                          "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done: loss ") and " → " in out[-1] and out[-1].endswith("s")
    assert f"{res['first_loss']:.4f} → {res['final_loss']:.4f}" in out[-1]
    assert out[0].startswith("step     0  loss ")


def test_cli_flags_follow_reference_and_dry_run_raises(tmp_path):
    """The reference's flags and defaults; ``--dry-run`` traces the step on
    the 16 x 16 fake mesh in its own process (the fake group of 256 ranks is
    per process) and writes the reference's record under
    ``results/dryrun``; the default device is the card."""
    args = train_cli.parse_args(["--arch", "yi-34b"])
    assert (args.steps, args.batch, args.seq, args.seed, args.ckpt_dir, args.shape, args.device) == (
        100, 8, 128, 0, None, "train_4k", "cuda")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "dsv2-lite-reduced",
                          "--shape", "decode_32k", "--dry-run"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "[dryrun] dsv2-lite-reduced × decode_32k × 16x16:" in run.stdout
    with open(tmp_path / "results" / "dryrun" / "dsv2-lite-reduced__decode_32k__16x16.json") as f:
        rec = json.load(f)
    assert rec["chips"] == 256 and rec["peak_memory_per_device"] > 0 and rec["flops_per_device"] > 0
    if not torch.cuda.is_available():  # the default device is the card: no quiet CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(["--arch", "dsv2-lite", "--reduced", "--steps", "1"])
