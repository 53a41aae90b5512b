"""Moonshot/Moonlight-16B-A3B — MoE 64 experts top-6, 2 shared experts
(DeepSeek-style) [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163_840,
    num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256, num_experts=8, num_experts_per_tok=2,
    num_shared_experts=1, dtype="float32", param_dtype="float32",
)
