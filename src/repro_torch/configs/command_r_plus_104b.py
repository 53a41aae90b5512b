"""Command-R+ 104B — GQA, no bias, parallel attn/FFN blocks, tied embeddings
[hf:CohereForAI/c4ai-command-r-plus; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33_792, vocab_size=256_000, tie_embeddings=True, parallel_block=True,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
)
