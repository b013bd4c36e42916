"""Config for pixtral-12b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    ffn_activation="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    num_patch_tokens=256,  # one 1024px image tile -> 16x16 patch grid stub
    source="hf:mistralai/Pixtral-12B-2409 (pixtral-ViT frontend stubbed; mistral-nemo backbone)",
)
