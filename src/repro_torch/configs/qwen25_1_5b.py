"""Qwen2.5-1.5B — paper Table 4 (Orin Nano) model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-1.5b", family="dense", source="paper §2, Table 4",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151_936, qkv_bias=True, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
