"""The encoder-decoder family (``whisper-tiny``) through the port's entry
points, against the reference, on its reduced config (1 encoder layer of 64
frames, 2 decoder layers, d 256): sinusoidal positions, the encoder's
bidirectional attention, cross attention, ``run_encoder``, the unscaled
audio embedding, prefill + decode (float32, bf16 and int8 KV), the bridge
of the ``encoder`` tree, engine streams on mono (contiguous, paged, int8,
pipelined admission, priority preemption) through ``extra_builder``, and the
refusals the reference makes (disagg, speculative decode, the CLI without a
frontend).  Weights are drawn by the reference and carried across with
``repro_torch.bridge``; the frontend stub's frames are made from a seed with
numpy and given to both sides.  ``tests/test_torch_vision.py`` reuses the
engine helpers for the vision-patch family."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, tol_for
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention, common, model, transformer

NAME = "whisper-tiny-reduced"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Engine runs in one torch thread: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged(name, dtype="float32", **changes):
    ref_cfg = dataclasses.replace(ref_get_config(name), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(name), dtype=dtype, **changes)
    ref_params = ref_model.init_params(ref_cfg, 0)
    return ref_cfg, cfg, ref_params, bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))


def frontend_stub(cfg, batch, seed=3):
    """The frontend's tensors as numpy: whisper's ``encoder_frames`` ``[batch,
    encoder_seq, d]`` or pixtral's ``patch_embeds`` ``[batch, num_patch_tokens,
    d]``, f32 draws of scale 0.1 (``tests/test_decode_consistency.py:30-38``)."""
    key, rows = (("encoder_frames", cfg.encoder_seq) if cfg.encoder_layers
                 else ("patch_embeds", cfg.num_patch_tokens))
    return {key: 0.1 * np.random.default_rng(seed).standard_normal((batch, rows, cfg.d_model)).astype(np.float32)}


def as_ref(stub, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return {k: jnp.asarray(v).astype(jdt) for k, v in stub.items()}


def as_port(stub, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return {k: torch.from_numpy(v).to(tdt) for k, v in stub.items()}


def test_sinusoidal_matches_reference():
    """At the reduced config's positions (encoder rows < 64, decoder rows <
    128).  The frameworks' f32 ``exp`` differs in the last bit for some
    frequencies, and ``sin(pos * div)`` carries that ulp times ``pos``: the
    tables part by 3e-5 at position 447 and 1.2e-4 at 1499 (ROADMAP.md
    §3)."""
    from repro.models import common as ref_common

    pos = np.arange(128, dtype=np.int32).reshape(2, 64)
    assert_close(common.sinusoidal_at(torch.from_numpy(pos), 384),
                 ref_common.sinusoidal_at(jnp.asarray(pos), 384), TOL["f32_op"])
    got = common.sinusoidal_positions(64, 256, offset=5)
    assert got.shape == (64, 256) and got.dtype == torch.float32
    assert_close(got, ref_common.sinusoidal_positions(64, 256, offset=5), TOL["f32_op"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidirectional_and_cross_attention_match_reference(dtype):
    """``attention_full(causal=False)`` (the encoder's) and ``attention_cross``
    (decoder queries over encoder states: no positions, no mask)."""
    from repro.models import attention as ref_attention

    ref_cfg, cfg, ref_params, params = bridged(NAME, dtype=dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    lp, ref_lp = params["layers"][0], jax.tree.map(lambda a: a[0], ref_params["blocks"]["pos0"])
    (xr, sr), (xp, sp) = (as_ref({"x": x, "s": src}, dtype).values(), as_port({"x": x, "s": src}, dtype).values())
    got = attention.attention_full(lp["attn"], xp, cfg, causal=False)
    assert_close(got, ref_attention.attention_full(ref_lp["attn"], xr, ref_cfg, causal=False), tol_for(dtype))
    causal = attention.attention_full(lp["attn"], xp, cfg)
    assert not torch.allclose(got[:, :-1], causal[:, :-1])  # every query but the last sees later keys
    got = attention.attention_cross(lp["xattn"], xp, sp, cfg)
    assert got.dtype == xp.dtype
    assert_close(got, ref_attention.attention_cross(ref_lp["xattn"], xr, sr, ref_cfg), tol_for(dtype))


def test_run_encoder_and_embed_match_reference():
    """The encoder over the stubbed frames, and the audio embedding (no
    ``sqrt(d)`` scale)."""
    from repro.models import transformer as ref_transformer

    ref_cfg, cfg, ref_params, params = bridged(NAME)
    stub = frontend_stub(cfg, 2)
    got = transformer.run_encoder(params, as_port(stub, "float32")["encoder_frames"], cfg)
    want = ref_transformer.run_encoder(ref_params, as_ref(stub, "float32")["encoder_frames"], ref_cfg)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert_close(got, want, TOL["f32_layer"])
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    got = transformer.embed_tokens(params, torch.from_numpy(tokens), cfg)
    assert_close(got, ref_transformer.embed_tokens(ref_params, jnp.asarray(tokens), ref_cfg), TOL["f32_op"])
    assert_close(got, params["embed"][torch.from_numpy(tokens).long()], 0.0)


def prefill_then_decode(name, dtype="float32", kv_quant=False, S=24, D=3):
    """A prompt of ``S`` tokens then ``D`` decode steps on both sides
    (``tests/test_decode_consistency.py:43-57``): returns the port's and the
    reference's prefill logits and caches, each decode step's logits, and
    the reference's full-forward logits (``logits_fn``) at the decoded
    positions."""
    ref_cfg, cfg, ref_params, params = bridged(name, dtype=dtype, kv_quant=kv_quant)
    B = 2
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + D)).astype(np.int32)
    stub = frontend_stub(cfg, B)
    rx, px = as_ref(stub, dtype), as_port(stub, dtype)
    full, _ = ref_model.logits_fn(ref_params, jnp.asarray(tokens), ref_cfg, extra=rx)
    want_p, ref_caches = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :S]), ref_cfg, S + D + 8, extra=rx)
    got_p, caches = model.prefill(params, torch.from_numpy(tokens[:, :S]), cfg, S + D + 8, extra=px)
    out = {"prefill": (got_p, want_p), "caches": ({k: v.clone() for k, v in caches.items()}, dict(ref_caches)),
           "steps": [],
           "full": np.asarray(full[:, S:], np.float32)}
    for t in range(D):
        pos = np.full((B,), S + t, np.int32)
        want, ref_caches = ref_model.decode_step(ref_params, jnp.asarray(tokens[:, S + t : S + t + 1]), ref_caches,
                                                 jnp.asarray(pos), ref_cfg)
        got, caches = model.decode_step(params, torch.from_numpy(tokens[:, S + t : S + t + 1]), caches,
                                        torch.from_numpy(pos.astype(np.int64)), cfg)
        out["steps"].append((got, want))
    return cfg, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """Prefill logits, ``enc_out`` and KV within the table of the
    reference's; each decode step (its own sinusoidal position at each
    slot's ``cache_index``, cross attention over ``enc_out``) within it of
    the reference's decode step and of its full forward."""
    cfg, out = prefill_then_decode(NAME, dtype)
    tol = tol_for(dtype, "layer")
    assert_close(*out["prefill"], tol)
    caches, ref_caches = out["caches"]
    empty = model.init_decode_caches(cfg, 2, 35, device="cpu")
    assert set(caches) == set(ref_caches) == set(empty) and "enc_out" in caches
    for k, v in ref_caches.items():
        assert tuple(caches[k].shape) == v.shape == tuple(empty[k].shape) and caches[k].dtype == empty[k].dtype, k
        assert_close(caches[k], v, tol)
    for t, (got, want) in enumerate(out["steps"]):
        assert_close(got, want, tol)
        assert_close(got, out["full"][:, t], tol)


def test_int8_kv_decode_matches_reference():
    """The reference's whisper int8 case (``tests/test_kv_quant.py:24``):
    prefill quantises the KV once, decode reads it dequantised; int8 values
    within one step and the rest within ``TOL["f32_layer"]`` of the
    reference's, logits too, and within 0.05 of the float forward, as
    there."""
    cfg, out = prefill_then_decode(NAME, kv_quant=True, S=24, D=1)
    caches, ref_caches = out["caches"]
    for k, v in ref_caches.items():
        if k.startswith("kv_") and not k.endswith("_scale"):
            assert caches[k].dtype == torch.int8
            assert int((caches[k].int() - torch.from_numpy(np.asarray(v).astype(np.int32))).abs().max()) <= 1, k
        else:
            assert_close(caches[k], v, TOL["f32_layer"])
    got, want = out["steps"][0]
    assert_close(got, want, TOL["f32_layer"])
    err = np.abs(out["full"][:, 0] - got.numpy()).max() / np.abs(out["full"][:, 0]).max()
    assert err < 0.05, err


def test_encoder_tree_round_trips_bit_exact():
    """The reference's ``encoder`` (a vmapped stack of ``encoder_layers``
    dense layers) becomes one dict per encoder layer, ``enc_norm`` one
    dict, and the decoder layers gain ``ln_x``/``xattn``; back to the
    reference's layout bit for bit."""
    ref_cfg = dataclasses.replace(ref_get_config("whisper-tiny-reduced"), encoder_layers=3)
    tree = jax.tree.map(np.asarray, ref_model.init_params(ref_cfg, 0))
    params = bridge.params_from_jax(tree)
    assert len(params["encoder"]) == 3 and set(params["layers"][0]) == {"ln1", "attn", "ln_x", "xattn", "ln2", "ffn"}
    np.testing.assert_array_equal(bridge.tensor_to_numpy(params["encoder"][2]["attn"]["wq"]),
                                  tree["encoder"]["attn"]["wq"][2])
    torch_params = model.init_params(dataclasses.replace(get_config("whisper-tiny-reduced"), encoder_layers=3),
                                     seed=0, device="cpu")
    assert set(torch_params) == set(params) and set(torch_params["layers"][0]) == set(params["layers"][0])
    leaves = lambda t: {jax.tree_util.keystr(k): a for k, a in jax.tree_util.tree_leaves_with_path(t)}  # noqa: E731
    a, b = leaves(tree), leaves(bridge.params_to_numpy(params))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# engine streams on mono against the reference's, through extra_builder
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch=2, cache_len=128, prefill_chunk=32, scheduler="none")
STEP = dict(step_time_fn=lambda n: 2e-3, prefill_time_fn=lambda n: 1e-4 * n)
# case -> (kv_quant, engine options, request mix)
ENGINE_CASES = {
    "contiguous": (False, {}, "plain"),
    "paged": (False, dict(kv_page_size=16), "plain"),
    "int8": (True, {}, "plain"),
    "pipelined": (False, dict(n_prefill=1, **STEP), "plain"),
    "priority": (False, dict(kv_page_size=16, sched="priority", **STEP), "priority"),
    "fifo": (False, dict(kv_page_size=16, **STEP), "priority"),
}


def engine_requests(vocab, mix, ref):
    """"plain": 4 prompts of 16-40 tokens at once; "priority": two
    low-priority requests fill both slots and two high-priority ones land
    10 ms later (``tests/test_preempt.py``'s mix)."""
    if ref:
        from repro.serving.request import WorkloadSpec, sample_requests
    else:
        from repro_torch.serving.request import WorkloadSpec, sample_requests
    if mix == "plain":
        spec = WorkloadSpec(mean_input=24, mean_output=10, vocab_size=vocab, max_input=40, max_output=12, seed=0)
        return sample_requests(spec, np.zeros(4), with_prompts=True)
    spec = WorkloadSpec(mean_input=40, mean_output=24, vocab_size=vocab, max_input=90, max_output=30, seed=0)
    rs = sample_requests(spec, np.linspace(0, 0.001, 4), with_prompts=True)
    for r in rs[:2]:
        r.priority = 0
    for r in rs[2:]:
        r.priority = 5
        r.arrival += 0.01
    return rs


_WEIGHTS = {}


def weights(name, kv_quant):
    if (name, kv_quant) not in _WEIGHTS:
        _WEIGHTS[name, kv_quant] = bridged(name, kv_quant=kv_quant)
    return _WEIGHTS[name, kv_quant]


def engine_run(name, case, ref):
    """One engine case on one side; the frontend stub through
    ``extra_builder`` (``extra_builder(1)``, shared by every request).
    Returns the outcome: counters, streams and, on the port, the engine."""
    kv_quant, kw, mix = ENGINE_CASES[case]
    ref_cfg, cfg, ref_params, params = weights(name, kv_quant)
    stub = frontend_stub(cfg, 1)
    if ref:
        from repro.serving.engine import ServingEngine as Engine

        c, p, extra = ref_cfg, ref_params, dict(extra_builder=lambda b: as_ref(stub, "float32"))
    else:
        from repro_torch.serving.engine import ServingEngine as Engine

        c, p, extra = cfg, params, dict(extra_builder=lambda b: as_port(stub, "float32"), device="cpu")
    eng = Engine(c, p, **ENGINE_KW, **kw, **extra)
    m = eng.run(engine_requests(c.vocab_size, mix, ref), max_steps=2000)
    out = {k: m.get(k) for k in ("completed", "rejected", "preemptions", "restores", "kv_pages")}
    out["streams"] = {r.rid: list(r.tokens_out) for r in eng.completed}
    return out, (None if ref else eng)


@pytest.fixture(scope="module")
def reference():
    """The reference engine's outcome of each case, each run once."""
    return {case: engine_run(NAME, case, ref=True)[0] for case in ENGINE_CASES}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_equal_reference(case, reference):
    """float32 streams and counters equal the reference's; ``enc_out`` holds
    the encoder's output in every slot a request was prefilled in."""
    got, eng = engine_run(NAME, case, ref=False)
    assert got["completed"] == 4 and got == reference[case]
    if case == "priority":
        assert got["preemptions"] >= 1 and got["restores"] >= 1
        assert got["streams"] == reference["fifo"]["streams"]  # preempted equals uninterrupted
    _, cfg, _, params = weights(NAME, ENGINE_CASES[case][0])
    want = transformer.run_encoder(params, as_port(frontend_stub(cfg, 1), "float32")["encoder_frames"], cfg)
    for slot in range(2):
        torch.testing.assert_close(eng.caches["enc_out"][slot], want[0], rtol=0, atol=0)


def engine_refusals(name):
    """Disagg (no MoE layers) and speculative decode (no batched verify)
    raise ``ValueError`` with the reference's message."""
    from repro.core.aebs import ReplicaLayout as RefLayout
    from repro.serving.engine import ServingEngine as RefEngine
    from repro_torch.core.aebs import ReplicaLayout
    from repro_torch.serving.engine import ServingEngine

    ref_cfg, cfg, ref_params, params = weights(name, False)
    sides = ((ServingEngine, cfg, params, ReplicaLayout, dict(device="cpu")),
             (RefEngine, ref_cfg, ref_params, RefLayout, {}))
    for option in ("disagg", "speculative"):
        msgs = []
        for Engine, c, p, Layout, extra in sides:
            if option == "disagg":
                kw = dict(executor="disagg", layout=Layout.round_robin(4, 2, 3), scheduler="aebs")
            else:
                kw = dict(draft_config=c, spec_k=2)
            with pytest.raises(ValueError) as e:
                Engine(c, p, max_batch=2, cache_len=64, **kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], option


def test_engine_refuses_as_reference():
    engine_refusals(NAME)


def test_cli_without_frontend_raises():
    """The reference's CLI passes no ``extra_builder`` (``launch/serve.py:167``),
    so whisper's first prefill has no frames: the port raises a
    ``ValueError`` naming them (the reference a ``TypeError``)."""
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="encoder_frames"):
        serve.main(["--arch", "whisper-tiny", "--duration", "0.1", "--max-batch", "2", "--cache-len", "64",
                    "--device", "cpu"])
