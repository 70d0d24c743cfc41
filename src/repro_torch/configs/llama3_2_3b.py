"""llama3.2-3b [dense] — 28L d=3072 24H (kv=8) ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, rope_theta=500_000.0, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=512, dtype="float32", attn_q_chunk=16)
