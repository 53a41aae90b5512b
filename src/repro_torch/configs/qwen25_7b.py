"""Qwen-2.5-7B — paper Table 2/3 model [arXiv:2409.12186]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b", family="dense", source="arXiv:2409.12186 (paper §2)",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18_944, vocab_size=152_064, qkv_bias=True, tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
