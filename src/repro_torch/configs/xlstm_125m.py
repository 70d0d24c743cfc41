"""xlstm-125m [ssm] — 12L d=768 4H vocab=50304; mLSTM blocks with an sLSTM
block every 4th layer (xLSTM[3:1]); d_ff=0 (mixers carry internal expansion).
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, slstm_every=4, ssm_chunk=256,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                        vocab_size=512, slstm_every=2, ssm_chunk=16, dtype="float32")
