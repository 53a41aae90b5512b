"""Llama-3.1-8B — paper Table 2/3 model [Meta 2024]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b", family="dense", source="Meta 2024 (paper §2)",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=128_256, rope_theta=500_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
