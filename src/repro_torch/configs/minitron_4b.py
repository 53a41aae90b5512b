"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679; hf].

Nemotron family: squared-ReLU non-gated FFN, untied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense", source="arXiv:2407.14679; hf",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256_000,
    mlp_act="relu2", mlp_gated=False, tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
