"""Model configuration: a copy of ``repro.configs.base.ModelConfig``.

The dataclass keeps every field of the reference so the two configs compare
field for field.  ``layer_kinds`` are ``dense``, ``dense_local`` (sliding
window), ``moe``, ``ssm`` (Mamba) and ``ssm_hybrid`` (Mamba after a shared
attention block); a config with ``encoder_layers`` (whisper) runs its
``dense`` decoder layers with cross attention over an encoder's output, and
a ``vision_patches`` frontend (pixtral) splices patch embeddings over a
prompt's first rows.  ``cache_specs`` mirrors the reference's
``_cache_specs`` layout; ``InputShape``, ``SHAPES``, ``shape_supported`` and
``input_specs`` are the reference's inputs of the sharded steps
(``base.py:267-364``), with ``(shape, dtype)`` pairs in place of
``jax.ShapeDtypeStruct`` and :func:`empty_inputs` to make tensors of them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention variants
    rope_theta: float = 10_000.0
    use_rope: bool = True
    sliding_window: Optional[int] = None
    attn_pattern: str = "global"
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    use_qk_norm: bool = False

    # FFN
    ffn_activation: str = "swiglu"

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1
    router_jitter: float = 0.0
    capacity_factor: float = 1.25

    # SSM (Mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1
    ssm_head_dim: int = 64

    # hybrid shared attention
    hybrid_attn_every: int = 0

    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0

    # modality frontend stub
    frontend: Optional[str] = None
    num_patch_tokens: int = 0

    # numerics
    dtype: str = "bfloat16"
    kv_quant: bool = False
    norm_eps: float = 1e-6

    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba inner dimension."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        """Mamba-2 head count."""
        return max(1, self.d_inner // self.ssm_head_dim)

    @property
    def conv_dim(self) -> int:
        """Channels of the Mamba block's depthwise conv: x for Mamba-1,
        [x, B, C] for Mamba-2 (one group)."""
        if self.ssm_version == 2:
            return self.d_inner + 2 * self.ssm_state
        return self.d_inner

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for l in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.family == "hybrid":
                if self.hybrid_attn_every and l % self.hybrid_attn_every == 0:
                    kinds.append("ssm_hybrid")
                else:
                    kinds.append("ssm")
            elif self.has_moe and l % self.moe_every == 0:
                kinds.append("moe")
            elif self.attn_pattern == "local_global":
                kinds.append("dense_local" if l % 2 == 0 else "dense")
            else:
                kinds.append("dense")
        return tuple(kinds)

    def param_counts(self) -> Dict[str, int]:
        """Approximate parameter counts per subsystem (``base.py:199``); the
        scaling model's memory terms read them."""
        d = self.d_model
        hd = self.resolved_head_dim
        counts = dict(embed=self.vocab_size * d * (2 if self.encoder_layers else 1), attn=0, ffn=0, expert=0, ssm=0,
                      norm=self.num_layers * 4 * d)
        attn_p = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        glu_mult = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        ffn_p = glu_mult * d * self.d_ff if self.d_ff else 0
        kinds = self.layer_kinds()
        n_attn = sum(k in ("dense", "dense_local", "moe", "ssm_hybrid") for k in kinds)
        n_moe = sum(k == "moe" for k in kinds)
        n_ssm = sum(k.startswith("ssm") for k in kinds)
        counts["attn"] = n_attn * attn_p
        counts["ffn"] = sum(k in ("dense", "dense_local", "ssm_hybrid") for k in kinds) * ffn_p
        if n_moe:
            expert_p = glu_mult * d * self.d_ff_expert
            counts["expert"] = n_moe * self.num_experts * expert_p
            counts["ffn"] += n_moe * (self.num_shared_experts * expert_p + d * self.num_experts)
        if n_ssm:
            di = self.d_inner
            ssm_p = d * 2 * di + di * self.ssm_conv + di * d  # in_proj, conv, out_proj
            if self.ssm_version == 1:
                dt_rank = max(1, math.ceil(d / 16))
                ssm_p += di * (dt_rank + 2 * self.ssm_state) + dt_rank * di + di * self.ssm_state + di
            else:
                nh2 = self.ssm_num_heads
                ssm_p += d * (2 * self.ssm_state + nh2) + nh2 * 2 + di
            counts["ssm"] = n_ssm * ssm_p
        if self.encoder_layers:
            counts["attn"] += self.encoder_layers * attn_p * 2  # self + cross, as the reference approximates
            counts["ffn"] += self.encoder_layers * ffn_p
        return counts

    def total_params(self) -> int:
        return sum(self.param_counts().values())

    def expert_param_fraction(self) -> float:
        c = self.param_counts()
        tot = sum(c.values())
        return c["expert"] / tot if tot else 0.0

    def bytes_per_param(self) -> int:
        return 2 if self.dtype == "bfloat16" else 4

    def kv_bytes_per_token(self) -> int:
        """KV-cache bytes per token across all attention layers."""
        n_attn = sum(k != "ssm" for k in self.layer_kinds())
        return n_attn * 2 * self.num_kv_heads * self.resolved_head_dim * self.bytes_per_param()

    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (``base.py:156``)."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        if self.num_kv_heads < self.num_heads:
            num_kv = max(1, num_heads // 2)
        changes: Dict[str, Any] = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )
        if self.has_moe:
            changes.update(
                num_experts=min(self.num_experts, 4),
                top_k=min(self.top_k, 2),
                d_ff_expert=min(self.d_ff_expert, 128),
                num_shared_experts=min(self.num_shared_experts, 1),
            )
        if self.family in ("ssm", "hybrid"):
            changes.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32)
        if self.family == "hybrid":
            changes.update(hybrid_attn_every=1)
        if self.encoder_layers:
            changes.update(encoder_layers=1, encoder_seq=min(self.encoder_seq, 64))
        if self.num_patch_tokens:
            changes.update(num_patch_tokens=16)
        return dataclasses.replace(self, **changes)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Decode-state layout of ``repro.configs.base._cache_specs``
    (``base.py:329``): per attention kind, ``kv_k{s}``/``kv_v{s}`` stacked
    ``[n, B, L, nkv, hd]`` (int8 beside f32 ``[n, B, L, nkv]`` scales
    ``kv_k{s}_scale``/``kv_v{s}_scale`` under ``kv_quant``): suffix ``""``
    for full-attention layers (L = ``cache_len``), ``_local`` for
    sliding-window layers (a rolling buffer of L = min(``cache_len``,
    window) rows) and ``_hybrid`` for the shared attention block's calls
    (L = ``cache_len``); Mamba layers keep ``ssm_state`` f32 (``[n, B,
    d_inner, N]`` for Mamba-1, ``[n, B, heads, head_dim, N]`` for Mamba-2)
    and ``conv_state`` ``[n, B, conv - 1, conv_dim]`` in the model dtype; an
    encoder-decoder config keeps its encoder's output ``enc_out`` ``[B,
    encoder_seq, d_model]`` in the model dtype (batch axis 0)."""
    kinds = cfg.layer_kinds()
    hd = cfg.resolved_head_dim
    dt = cfg.torch_dtype
    kv_dtype = torch.int8 if cfg.kv_quant else dt
    specs: Dict[str, Tuple[tuple, torch.dtype]] = {}

    def kv(suffix: str, n: int, length: int) -> None:
        shape = (n, batch, length, cfg.num_kv_heads, hd)
        specs[f"kv_k{suffix}"] = (shape, kv_dtype)
        specs[f"kv_v{suffix}"] = (shape, kv_dtype)
        if cfg.kv_quant:
            specs[f"kv_k{suffix}_scale"] = (shape[:-1], torch.float32)
            specs[f"kv_v{suffix}_scale"] = (shape[:-1], torch.float32)

    n_full = sum(k in ("dense", "moe") for k in kinds)
    n_local = sum(k == "dense_local" for k in kinds)
    n_hyb = sum(k == "ssm_hybrid" for k in kinds)
    n_ssm = sum(k.startswith("ssm") for k in kinds)
    if n_full:
        kv("", n_full, cache_len)
    if n_local:
        kv("_local", n_local, min(cache_len, cfg.sliding_window or cache_len))
    if n_hyb:
        kv("_hybrid", n_hyb, cache_len)
    if n_ssm:
        if cfg.ssm_version == 1:
            specs["ssm_state"] = ((n_ssm, batch, cfg.d_inner, cfg.ssm_state), torch.float32)
        else:
            specs["ssm_state"] = ((n_ssm, batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state),
                                  torch.float32)
        specs["conv_state"] = ((n_ssm, batch, cfg.ssm_conv - 1, cfg.conv_dim), dt)
    if cfg.encoder_layers:
        specs["enc_out"] = ((batch, cfg.encoder_seq, cfg.d_model), dt)
    return specs


# ---------------------------------------------------------------------------
# Input shapes of the sharded steps (``base.py:267``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Sub-quadratic families allowed to run long_500k; gemma2 qualifies because
# its local layers use a sliding window.
LONG_CONTEXT_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b", "gemma2-2b")


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) runs, and the reason if not (``base.py:287``)."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        if cfg.name.endswith("-reduced") and cfg.name[: -len("-reduced")] in LONG_CONTEXT_ARCHS:
            return True, ""
        return False, "pure full-attention arch: long_500k requires sub-quadratic attention"
    return True, ""


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """The inputs the train, prefill and serve steps of this architecture
    consume (``base.py:301``), ``{name: (shape, dtype)}``: ``tokens`` (and
    ``labels`` for training) ``[B, S]`` int32; for decode ``tokens [B, 1]``,
    the scalar ``cache_index`` and the decode state of :func:`cache_specs`
    at ``S`` rows; the frontend stubs' precomputed embeddings
    (``encoder_frames``, ``patch_embeds``) outside decode, which reads the
    cached ``enc_out`` instead."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: Dict[str, Tuple[tuple, torch.dtype]] = {}
    if shape.kind == "train":
        specs["tokens"] = ((B, S), i32)
        specs["labels"] = ((B, S), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = ((B, S), i32)
    else:  # decode: one new token against a cache of S rows
        specs["tokens"] = ((B, 1), i32)
        specs["cache_index"] = ((), i32)
        specs.update(cache_specs(cfg, B, S))
    if cfg.frontend == "audio_frames" and shape.kind != "decode":
        specs["encoder_frames"] = ((B, cfg.encoder_seq, cfg.d_model), cfg.torch_dtype)
    elif cfg.frontend == "vision_patches" and shape.kind != "decode":
        specs["patch_embeds"] = ((B, cfg.num_patch_tokens, cfg.d_model), cfg.torch_dtype)
    return specs


def empty_inputs(specs: Dict[str, Tuple[tuple, torch.dtype]], device="meta") -> Dict[str, torch.Tensor]:
    """An uninitialised tensor for each spec: ``meta`` tensors by default
    (shapes and dtypes only), or fake tensors of ``device`` when called
    under a ``FakeTensorMode``."""
    return {name: torch.empty(shape, dtype=dtype, device=device) for name, (shape, dtype) in specs.items()}
