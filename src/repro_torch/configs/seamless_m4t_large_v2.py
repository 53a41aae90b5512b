"""SeamlessM4T-large-v2 transformer backbone [arXiv:2308.11596; hf].

Encoder-decoder; the conformer speech frontend is a stub: the encoder
takes precomputed frame embeddings (B, T_enc, d_model).  Classic
(non-gated) ReLU FFN.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", source="arXiv:2308.11596; hf",
    num_layers=24, num_encoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256_206,
    mlp_act="relu", mlp_gated=False, tie_embeddings=True, audio_frontend=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    dtype="float32", param_dtype="float32",
)
