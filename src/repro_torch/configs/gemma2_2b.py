"""Config for gemma2-2b — see `source` field for citation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    ffn_activation="geglu",
    attn_pattern="local_global",
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    source="arXiv:2408.00118 (Gemma 2; local+global alternating, logit softcap)",
)
