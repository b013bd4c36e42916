"""The vision-patch family (``pixtral-12b``) through the port's entry points,
against the reference, on its reduced config (16 patch rows, 2 layers, d
256, 4 query heads over 2): the patch splice of ``embed_tokens``, prefill +
decode (float32 and bf16), engine streams on mono (contiguous, paged, int8,
pipelined admission, priority preemption) through ``extra_builder``, the
CLI's text-only prompts, and the refusals (a prompt shorter than its patch
rows, disagg, speculative decode).  The engine helpers and weights are
``tests/test_torch_encdec.py``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, tol_for
from repro.models import model as ref_model
from repro_torch.models import model, transformer
from test_torch_encdec import (  # noqa: F401  (_one_thread: a fixture)
    ENGINE_CASES,
    _one_thread,
    as_port,
    as_ref,
    bridged,
    engine_refusals,
    engine_run,
    frontend_stub,
    prefill_then_decode,
    weights,
)

NAME = "pixtral-12b-reduced"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens_splices_patches_as_reference(dtype):
    """The first ``num_patch_tokens`` rows are the patch embeddings, the
    rest the scaled token embeddings; without patches, text only."""
    from repro.models import transformer as ref_transformer

    ref_cfg, cfg, ref_params, params = bridged(NAME, dtype=dtype)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 20)).astype(np.int32)
    stub = frontend_stub(cfg, 1)
    got = transformer.embed_tokens(params, torch.from_numpy(tokens), cfg, as_port(stub, dtype))
    assert_close(got, ref_transformer.embed_tokens(ref_params, jnp.asarray(tokens), ref_cfg, as_ref(stub, dtype)),
                 tol_for(dtype))
    assert_close(got[:, :16], as_port(stub, dtype)["patch_embeds"], 0.0)
    text = transformer.embed_tokens(params, torch.from_numpy(tokens), cfg)
    assert_close(got[:, 16:], text[:, 16:], 0.0)
    assert_close(text, ref_transformer.embed_tokens(ref_params, jnp.asarray(tokens), ref_cfg), tol_for(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """A 24-token prompt whose first 16 rows are patches, then three decode
    steps: prefill logits and KV within the table of the reference's, each
    step within it of the reference's decode step and its full forward."""
    _, out = prefill_then_decode(NAME, dtype)
    tol = tol_for(dtype, "layer")
    assert_close(*out["prefill"], tol)
    caches, ref_caches = out["caches"]
    assert set(caches) == set(ref_caches) == {"kv_k", "kv_v"}
    for k, v in ref_caches.items():
        assert_close(caches[k], v, tol)
    for t, (got, want) in enumerate(out["steps"]):
        assert_close(got, want, tol)
        assert_close(got, out["full"][:, t], tol)


def test_short_prompt_raises():
    """A prompt shorter than the patch rows: the port raises a
    ``ValueError`` naming both lengths, where the reference's prefill fails
    inside a reshape (``transformer.py:135-139`` grows the sequence)."""
    ref_cfg, cfg, ref_params, params = weights(NAME, False)
    stub = frontend_stub(cfg, 1)
    with pytest.raises(ValueError, match="10 tokens is shorter than its 16 patch rows"):
        model.prefill(params, torch.zeros((1, 10), dtype=torch.int64), cfg, 64, extra=as_port(stub, "float32"))
    with pytest.raises(TypeError, match="cannot reshape"):
        ref_model.prefill(ref_params, jnp.zeros((1, 10), jnp.int32), ref_cfg, 64, extra=as_ref(stub, "float32"))


@pytest.fixture(scope="module")
def reference():
    """The reference engine's outcome of each case, each run once."""
    return {case: engine_run(NAME, case, ref=True)[0] for case in ENGINE_CASES}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_equal_reference(case, reference):
    """float32 streams and counters equal the reference's, every prompt's
    first 16 rows the patch stub; under priority preemption they equal
    FIFO's too."""
    got, _ = engine_run(NAME, case, ref=False)
    assert got["completed"] == 4 and got == reference[case]
    if case == "priority":
        assert got["preemptions"] >= 1 and got["restores"] >= 1
        assert got["streams"] == reference["fifo"]["streams"]


def test_engine_refuses_as_reference():
    engine_refusals(NAME)


def test_cli_serves_text_only():
    """The reference's CLI passes no ``extra_builder``: ``--arch pixtral-12b``
    serves its prompts as text, every request to the end."""
    from repro_torch.launch import serve

    m = serve.main(["--arch", "pixtral-12b", "--duration", "0.2", "--max-batch", "4", "--cache-len", "64",
                    "--device", "cpu"])
    assert m["completed"] > 0 and not m["rejected"] and not m["truncated"]
