"""Config for scaled-ds-2 — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="scaled-ds-2",
    family="moe",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=102_400,
    num_experts=200,
    num_shared_experts=2,
    top_k=8,
    d_ff_expert=1536,
    source="Janus §5.1 Scaled-DS-2 (200 experts, top-8, expert d_ff 1536)",
)
