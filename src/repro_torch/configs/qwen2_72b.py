"""qwen2-72b [dense] — 80L d=8192 64H (kv=8) ff=29568 vocab=152064, QKV bias.
[arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=512, dtype="float32", attn_q_chunk=16)
