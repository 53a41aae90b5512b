"""LLaVA-NeXT-34B backbone (Yi-34B trunk) [hf:llava-hf; unverified].

The vision tower and its anyres tiling are a stub: the caller supplies
precomputed patch embeddings (num_vision_tokens, d_model), prepended to
the token sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    source="hf:llava-hf/llava-v1.6-34b-hf; unverified",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20_480, vocab_size=64_000, tie_embeddings=False,
    num_vision_tokens=576,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256, num_vision_tokens=4,
    dtype="float32", param_dtype="float32",
)
