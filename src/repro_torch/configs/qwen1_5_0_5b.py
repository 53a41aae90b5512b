"""Qwen1.5-0.5B — QKV bias, tied embeddings [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151_936, qkv_bias=True, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
