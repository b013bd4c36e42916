"""Config for gemma-7b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    ffn_activation="geglu",
    source="arXiv:2403.08295 (Gemma; GeGLU, head_dim=256; the 2b sibling is MQA)",
)
