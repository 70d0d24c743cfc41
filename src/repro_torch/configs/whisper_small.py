"""whisper-small [audio] — enc-dec, 12+12L d=768 12H ff=3072 vocab=51865;
conv/mel frontend stubbed (input_specs supplies [B, 1500, d] frame embeds).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, encoder_layers=12, num_audio_frames=1500,
    tie_embeddings=True, qkv_bias=True, max_position=32768,
    attn_impl="chunked", attn_q_chunk=512,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=512, encoder_layers=2, num_audio_frames=24,
                        max_position=128, dtype="float32", attn_q_chunk=16)
