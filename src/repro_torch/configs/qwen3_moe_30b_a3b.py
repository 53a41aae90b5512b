"""Qwen3-30B-A3B — MoE 128 experts top-8, normalized gates
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", source="hf:Qwen/Qwen3-30B-A3B; hf",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151_936,
    num_experts=128, num_experts_per_tok=8, tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, num_experts=8, num_experts_per_tok=2,
    dtype="float32", param_dtype="float32",
)
