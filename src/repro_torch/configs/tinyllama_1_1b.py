"""TinyLlama-1.1B — Llama-2 architecture, small [arXiv:2401.02385; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense", source="arXiv:2401.02385; hf",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32_000, tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
