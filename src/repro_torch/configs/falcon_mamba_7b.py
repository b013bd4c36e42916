"""Config for falcon-mamba-7b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65_024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_version=1,
    use_rope=False,
    source="arXiv:2410.05355 (FalconMamba; attn-free Mamba-1)",
)
