"""Config for phi35-moe-42b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32_064,
    num_experts=16,
    num_shared_experts=0,
    top_k=2,
    d_ff_expert=6400,
    source="hf:microsoft/Phi-3.5-MoE-instruct (16 experts top-2)",
)
