"""deepseek-7b [dense] — 30L d=4096 32H (kv=32, MHA) ff=11008 vocab=102400.
llama-architecture. [arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400, rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=512, dtype="float32", attn_q_chunk=16)
