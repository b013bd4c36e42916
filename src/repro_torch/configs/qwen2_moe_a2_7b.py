"""Config for qwen2-moe-a27b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    d_ff_expert=1408,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B (60 routed top-4 + 4 shared experts)",
)
