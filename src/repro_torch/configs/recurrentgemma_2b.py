"""RecurrentGemma-2B — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427; hf].

MQA (kv=1) sliding-window 2048 attention every third layer; bounded cache ->
runs long_500k.  Gemma-style scaled embeddings + final logit soft-cap.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", source="arXiv:2402.19427; hf",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local_attn"), sliding_window=2048,
    mlp_act="gelu", tie_embeddings=True, emb_scale=True, logit_softcap=30.0,
    lru_width=2560,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=80, num_heads=2, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, sliding_window=16, lru_width=80,
    recurrent_chunk=16, dtype="float32", param_dtype="float32",
)
