"""The port's configs equal the reference's, and weights and caches cross
between the reference's numpy trees and the port's tensors bit for bit."""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import model


PORTED = ("dsv2-lite", "dsv2", "scaled-ds-1", "scaled-ds-2", "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b",
          "yi-34b", "phi4-mini-3.8b", "gemma-7b", "gemma2-2b", "falcon-mamba-7b", "zamba2-2.7b")


@pytest.mark.parametrize("name", [n + s for n in PORTED for s in ("", "-reduced")])
def test_config_matches_reference_field_for_field(name):
    ref, port = ref_get_config(name), get_config(name)
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(port)} == {f.name for f in dataclasses.fields(ref)}
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.has_moe == ref.has_moe


@pytest.mark.parametrize("name", ["whisper-tiny-reduced", "pixtral-12b-reduced"])
def test_frontend_family_trees_round_trip(name):
    """The encoder-decoder tree (``encoder``, ``enc_norm``, the decoder
    layers' ``ln_x``/``xattn``) and the vision-patch one cross both ways bit
    for bit, with the keys of the port's own draw."""
    ref_cfg = ref_get_config(name)
    tree = jax.tree.map(np.asarray, ref_model.init_params(ref_cfg, 0))
    params = bridge.params_from_jax(tree)
    own = model.init_params(get_config(name), seed=0, device="cpu")
    assert set(params) == set(own) and set(params["layers"][0]) == set(own["layers"][0])
    assert ("encoder" in params) == bool(ref_cfg.encoder_layers)
    a, b = _flatten(tree), _flatten(bridge.params_to_numpy(params))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_round_trip_bit_exact(dtype):
    cfg = dataclasses.replace(ref_get_config("dsv2-lite-reduced"), dtype=dtype)
    tree = jax.tree.map(np.asarray, ref_model.init_params(cfg, 0))
    params = bridge.params_from_jax(tree)
    assert len(params["layers"]) == cfg.num_layers
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert params["layers"][0]["moe"]["w_gate"].dtype == want_dt
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    a, b = _flatten(tree), _flatten(bridge.params_to_numpy(params))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_caches_round_trip_bit_exact():
    cfg_ref = ref_get_config("dsv2-lite-reduced")
    ref_caches = ref_model.init_decode_caches(cfg_ref, 3, 32)
    port_caches = model.init_decode_caches(get_config("dsv2-lite-reduced"), 3, 32, device="cpu")
    assert ref_caches.keys() == port_caches.keys()
    rng = np.random.default_rng(0)
    filled = {}
    for k, v in ref_caches.items():
        assert tuple(v.shape) == tuple(port_caches[k].shape), k
        assert str(v.dtype) == str(port_caches[k].dtype).replace("torch.", ""), k
        filled[k] = rng.standard_normal(v.shape).astype(ml_dtypes.bfloat16)
    filled["block_tables"] = rng.integers(0, 9, size=(3, 2), dtype=np.int32)
    back = bridge.caches_to_numpy(bridge.caches_from_numpy(filled))
    for k, v in filled.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes(), k
