"""Config for yi-34b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    ffn_activation="swiglu",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652 (Yi; llama-arch GQA)",
)
