"""Config for dsv2-lite — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dsv2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102_400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    source="arXiv:2405.04434 (DeepSeek-V2-Lite routing structure; paper's model family)",
)
