"""xLSTM-1.3B — mLSTM + sLSTM blocks at 7:1 [arXiv:2405.04517; unverified].

Pure recurrent stack (d_ff=0 per the assignment: projections live inside the
xLSTM blocks).  State cache is O(1) in sequence length -> runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", source="arXiv:2405.04517; unverified",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    mlstm_proj_factor=2.0, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
    vocab_size=256, recurrent_chunk=16, dtype="float32", param_dtype="float32",
)
