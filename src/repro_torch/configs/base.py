"""Model configuration: a copy of ``repro.configs.base.ModelConfig``.

The dataclass keeps every field of the reference so the two configs compare
field for field; the port's model code reads only the attention/MoE fields
(``layer_kinds`` kinds ``dense`` and ``moe``).  ``cache_specs`` mirrors the
reference's ``_cache_specs`` layout for the full-attention caches.
"""

from __future__ import annotations

import dataclasses
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
    def has_moe(self) -> bool:
        return self.num_experts > 0

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
        """Approximate parameter counts per subsystem (``base.py:199``), for
        the dense and MoE stacks the port runs: the scaling model's memory
        terms read them."""
        check_supported(self)
        d = self.d_model
        hd = self.resolved_head_dim
        counts = dict(embed=self.vocab_size * d, attn=0, ffn=0, expert=0, ssm=0, norm=self.num_layers * 4 * d)
        attn_p = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        glu_mult = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        kinds = self.layer_kinds()
        n_moe = sum(1 for k in kinds if k == "moe")
        counts["attn"] = len(kinds) * attn_p
        counts["ffn"] = (len(kinds) - n_moe) * (glu_mult * d * self.d_ff if self.d_ff else 0)
        if n_moe:
            expert_p = glu_mult * d * self.d_ff_expert
            counts["expert"] = n_moe * self.num_experts * expert_p
            counts["ffn"] += n_moe * (self.num_shared_experts * expert_p + d * self.num_experts)
        return counts

    def bytes_per_param(self) -> int:
        return 2 if self.dtype == "bfloat16" else 4

    def kv_bytes_per_token(self) -> int:
        """KV-cache bytes per token across all attention layers."""
        return len(self.layer_kinds()) * 2 * self.num_kv_heads * self.resolved_head_dim * self.bytes_per_param()

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


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {"dense", "moe"} or cfg.encoder_layers or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} are not ported yet "
            "(other families come in a later slice)"
        )


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Decode-state layout of ``repro.configs.base._cache_specs`` for the
    full-attention caches: ``kv_k``/``kv_v`` stacked ``[L, B, S, nkv, hd]``;
    with ``kv_quant`` they are int8, beside f32 per-(row, head) scales
    ``kv_k_scale``/``kv_v_scale`` ``[L, B, S, nkv]``."""
    check_supported(cfg)
    n_full = len(cfg.layer_kinds())
    shape = (n_full, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.torch_dtype
    specs = {"kv_k": (shape, kv_dtype), "kv_v": (shape, kv_dtype)}
    if cfg.kv_quant:
        specs["kv_k_scale"] = (shape[:-1], torch.float32)
        specs["kv_v_scale"] = (shape[:-1], torch.float32)
    return specs
