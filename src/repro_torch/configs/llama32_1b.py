"""Llama-3.2-1B — paper Table 4 (Orin Nano) model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", source="Meta 2024 (paper §2, Table 4)",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128_256, rope_theta=500_000.0, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
