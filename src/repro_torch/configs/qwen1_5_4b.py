"""qwen1.5-4b [dense] — 40L d=2560 20H (kv=20, i.e. MHA) ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, qkv_bias=True, rope_theta=5_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=512, dtype="float32", attn_q_chunk=16)
