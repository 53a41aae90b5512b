"""Nemotron-H-8B — hybrid Mamba2/attention, paper Table 2/3 model
[arXiv:2504.03624].

As in the reference package, the Mamba-2/SSD blocks are represented by
the chunkwise matrix-memory cell (mLSTM) — the same gated linear-
recurrence + matrix-state family — with rec_heads=128, head dim 64 matching
Nemotron-H's d_inner=8192 SSM geometry.  6 attention layers (kv=8, hd=128)
interleave every 8th layer, matching the paper's KV-cache scaling.
Param bytes land within ~1% of the paper's 16.20 GB (the stand-in block is
slightly leaner than Mamba-2's in_proj; FFN-only layers interleave as in the
real model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-h-8b", family="hybrid", source="arXiv:2504.03624 (paper §2)",
    num_layers=52, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=21_504, vocab_size=131_072,
    # 52 layers = 2 x this 26-slot pattern: 32 Mamba2 stand-ins (mLSTM),
    # 14 FFN-only layers, 6 attention layers (matches the paper's KV scaling)
    block_pattern=("mlstm", "mlstm", "ffn") * 7 + ("mlstm", "attn", "mlstm", "attn", "attn"),
    mlstm_proj_factor=2.0, rec_heads=128,
    mlp_act="relu2", mlp_gated=False, tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rec_heads=8, recurrent_chunk=16,
    block_pattern=("mlstm", "ffn", "attn", "mlstm"),
    dtype="float32", param_dtype="float32",
)
