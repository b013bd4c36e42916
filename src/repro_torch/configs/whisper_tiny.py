"""Config for whisper-tiny — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    ffn_activation="gelu",
    use_rope=False,  # sinusoidal absolute positions
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_frames",
    source="arXiv:2212.04356 (Whisper; enc-dec, conv/mel frontend stubbed)",
)
