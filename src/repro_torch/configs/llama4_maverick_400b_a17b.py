"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (kv=8) ff=8192
vocab=202048, MoE 128 experts top-1 every other layer + shared expert
(early-fusion multimodal in the release; exercised as text LM here, the
assigned input shapes are token shapes). [hf:meta-llama/Llama-4; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, rope_theta=500_000.0,
    num_experts=128, experts_per_token=1, moe_interval=2, moe_shared_expert=True,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=512, num_experts=8, experts_per_token=1,
                        dtype="float32", attn_q_chunk=16)
