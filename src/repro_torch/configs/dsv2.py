"""Config for deepseek-v2 (full scale) — the paper's primary evaluation model."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dsv2",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=0,
    vocab_size=102_400,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    source="arXiv:2405.04434 (DeepSeek-V2 236B: 160 routed top-6 + 2 shared; "
    "MLA approximated as MHA for the serving-system study)",
)
