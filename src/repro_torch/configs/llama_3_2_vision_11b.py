"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (kv=8) ff=14336 vocab=128256.
Cross-attention image layers every 5th layer (8 cross blocks); patch-embedding
frontend is a stub (input_specs supplies [B, 4096, d] patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500_000.0,
    cross_attn_interval=5, num_image_tokens=4096,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=512, cross_attn_interval=2,
                        num_image_tokens=16, dtype="float32", attn_q_chunk=16)
