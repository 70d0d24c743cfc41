"""zamba2-7b [hybrid] — 81L d=3584, Mamba2 backbone (state=64) with one
shared attention block (32H kv=32, ff=14336) applied every 6 layers.
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, ssm_state=64, ssm_groups=1,
    ssm_expand=2, ssm_chunk=256, attn_every=6, rope_theta=10_000.0,
    attn_impl="chunked",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=512, ssm_state=16, attn_every=2,
                        ssm_chunk=16, dtype="float32", attn_q_chunk=16)
