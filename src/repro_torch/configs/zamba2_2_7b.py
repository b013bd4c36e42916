"""Config for zamba2-27b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_version=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,  # shared attention block applied every 6 mamba layers
    source="arXiv:2411.15242 (Zamba2; Mamba-2 backbone + shared attention blocks)",
)
