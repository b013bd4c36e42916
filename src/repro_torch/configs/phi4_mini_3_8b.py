"""Config for phi4-mini-38b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    ffn_activation="swiglu",
    source="arXiv:2412.08905 (Phi-4 family; RoPE SwiGLU GQA)",
)
